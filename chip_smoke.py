"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # everything below
    python3 chip_smoke.py --dp-shapes     # K1-K6 and K8 alone at their paths' shapes
    python3 chip_smoke.py --dp-shapes --sweep   # and K5 / K8 under forced plans
    python3 chip_smoke.py --service       # the service path alone
    python3 chip_smoke.py --families      # the MoE and SSM families alone

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, at first
use), holds each kernel against its plain PyTorch version on the card at the
shapes of the main path, then drives the main path — ``repro_torch.dp.solve``
and ``dp.batch_solve`` on ``device="cuda"`` — at the paper's sizes:

  * S-DP (paper Table I): n = 2^20, offsets range(2k, k, -1) with k = 2^10,
    op="min", with and without reconstruction;
  * MCM (paper §IV): n = 1024 with reconstruction, and batches of 8 at
    n = 512 and n = 256;
  * the other six zoo problems with reconstruction, at sizes that finish in
    seconds;
  * past the on-chip gate (the card's L2): S-DP at n = 2^23, edit_distance
    on two 2048-long strings, viterbi 64 x 2048, MCM 1024 and the 512-wide
    triangular instances, which dispatch to the streaming kernels (the
    triangular ones with the traceback fused into the launch);

and then the grid family's path through the same entry points:

  * needleman_wunsch and gotoh on two DNA sequences of length 4096;
  * edit_distance_grid and lcs_grid on the 512-long strings of the linear
    problems, against edit_distance and lcs;
  * cky on a 64-token sentence with 32 nonterminals, a vocabulary of 512
    and 1024 binary rules;
  * a batch of 8 needleman_wunsch pairs of length 1024 (one launch);

and last the blocked MCM route (``backend="blocked_mcm"``), whose split
combine over middle tiles is the tropical GEMM kernel K5:

  * MCM n = 1024 on the main path's dims with reconstruction, its table
    against K4's, and a batch of 8 at n = 256;
  * the head-to-head with ``kernel_tiled_wavefront`` at n = 1024: the
    shared encode, each route's solve, and under ``torch.profiler`` the
    device time of K5, K4, copies and the other kernels (the boundary
    wavefront's), with the device's idle share;

then the LM serving path, whose prefill runs the flash-attention kernel K7:

  * qwen3-14b at its published width (40 layers, d 5120, 40 heads, 8 kv
    heads, head dim 128, vocabulary 151936, bf16), weights from seed 0 on
    the card, serving 8 requests with prompts of 300-2000 tokens (seeded
    lengths) and 16 new tokens each through ``serving.Engine`` (4 slots,
    2064 positions) and ``Scheduler``: per-request prefill seconds,
    decode-step ms, tokens/s and peak memory; K7 launches exactly once per
    layer and prefill (320), decode never;
  * K7 at one served prompt's tensors (bf16 and float32), the prefill
    logits through K7 against the plain version, K7 at one layer of
    prefill_32k (S = 32768) and at head dims 16, 96 and 160 with GQA, each
    against its plain version and timed beside
    ``scaled_dot_product_attention`` (the yardstick, not on the path). The
    served bf16 tensors take K7's tensor-core body (all 320 launches of
    the traffic must), float32 its CUDA-core body; at the served prompt
    and at S = 32768 the CUDA-core body is also run on the same bf16
    tensors, for the two bodies' times and errors side by side;

then the MoE and SSM families through the same engine, each phase freeing
the card before the next:

  * granite-moe-3b-a800m at its published width (32 layers, d 1536, 40
    experts, top-8, expert d_ff 512, bf16) and rwkv6-1.6b (24 layers, d
    2048, 32 heads of 64, d_ff 7168), weights from seed 0, each serving the
    LM path's traffic: prefill seconds, decode-step ms, tokens/s, peak
    memory; granite's share of (token, k) assignments dropped by capacity
    in prefill and decode, K7 exactly once a layer and prefill (256, all on
    the tensor-core body), K7 at a served prompt's tensors (hd 64), its
    prefill logits through K7 against the plain version, layer 0's MoE
    against a dense oracle (every expert computes every token, drop-free)
    and twice for equal bits; rwkv6's K7 count 0 and ``chunked_gla`` at
    layer 0's inputs against its step-by-step version; for both, three
    decode steps against prefills of the longer prompt (float32,
    drop-free), and one prefill and one decode step under the profiler;
  * arctic-480b at full width (128 experts, top-2, the dense residual) cut
    to depth 2 of its 35 layers — a layer is 25.35 GiB of bf16 weights,
    two fill ~51.6 GiB of the 80 GB card with the embeddings — serving one
    2000-token request (K7 twice), with the peak memory of its weights'
    creation and of its traffic;
  * the reduced granite-moe, arctic, jamba-1.5-large-398b (one period:
    attention, Mamba, MoE every other layer; a full period is ~83 GiB) and
    rwkv6 in float32, the same weights and engine scenario on the CPU and
    on the card: equal tokens, prefill logits within 1e-4;

then the service path: ``dp.DPService(max_batch=32)`` on the card answering
256 seeded requests over eight problems (mcm 128-256, half reconstructed,
on K2; edit_distance / lcs 256-1024, viterbi 16 x 512 and knapsack 4096 on
K1; edit_distance 2048² on K3; mcm 512 reconstructed on K4, fused;
needleman_wunsch / gotoh 512-1024 on K6 antidiag; cky 16-32 tokens on K6
spandiag) with repeats, priorities and short deadlines, under
``torch.profiler``; every kernel route's launches equal its drains; three
streaming sessions, each append against a cold solve on the card; a
calibration sweep and its disagreements with the analytical order; a
sample of 32 answers (the smallest of each problem) and the largest each
route served against the plain version of that route on the card (the CPU
port's computation; edit_distance and lcs against an exact row-at-a-time
recurrence, as their plain versions take a step a cell); and the batched
walks on the card against the host walks (the grid path's gotoh 4096²
walk too, after that path's launches are counted);

and last the gated linear scan K8 through ``ops.linear_scan`` at
T = 32768, D = 2048, bit-equal to its plain version.

K1, K2, K3, K4 and K6 (both schedules) are also timed at every shape they
launch on the main and grid paths (each new shape held against the plain
version, or, where that would take minutes, K3 against K1 at viterbi 64 x
2048 and edit_distance 2048² and K4 against K2), each kernel's
``path_ms`` summed over its path launches, and every DP kernel's launches
on the main, grid and blocked paths timed by CUDA events. K4 is also timed
at K2's path shape (mcm 8 x 256), beside K2. K5 is held against its plain
version at all 76 shapes of the blocked path (MCM 1024's block diagonals
D = 2..63 and MCM 8 x 256's D = 2..15) and its ``path_ms`` is their
device time under ``torch.profiler`` (CUDA events around a K5 call time
its Python wrapper, and are printed beside).

Before the paths, the static schedule gate (``repro_torch.analysis``) runs
at the card's own geometry: every route against every family probe (the
kernel routes at the cluster sizes and grids the launchers take on this
card, and at hand-made small plans), the extension proofs and the linter.
After each of the main, grid and service paths, the geometry every kernel
launch of the path recorded (walk plan, cluster size, tile plan, CTA
count) is held against the geometry the descriptors assume for its shape,
and the kernels' geometry rules are checked there (at path sizes the gate
checks rules and geometry only; it simulates every cell at probe sizes).
Any finding fails the run.

Each answer is checked against the numpy oracle (or, where that is too slow,
against the plain route on the card and the oracle at a reduced size), its
decoded solution is recomputed to the optimum, and the kernels' launch
counters, zeroed before each path and read after it, must show that the
path ran through every one of its kernels. Any failed check exits non-zero.
The last two lines of standard output are the kernels' JSON record and the
device record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import analysis, dp  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core import mcm as core_mcm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import grid_pipeline as k6  # noqa: E402
from repro_torch.kernels import mcm_pipeline as k2  # noqa: E402
from repro_torch.kernels import mcm_tiled as k4  # noqa: E402
from repro_torch.kernels import sdp_chunked as k3  # noqa: E402
from repro_torch.kernels import sdp_pipeline as k1  # noqa: E402
from repro_torch.kernels import sdp_walk  # noqa: E402
from repro_torch.kernels import schedule as kschedule  # noqa: E402
from repro_torch.kernels import semiring_matmul as k5  # noqa: E402
from repro_torch.kernels import chunked_scan as k8  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402
from repro_torch.models.attention import _project_qkv, attn_forward  # noqa: E402
from repro_torch.models.layers import rmsnorm, silu  # noqa: E402
from repro_torch.models.model import CausalLM  # noqa: E402
from repro_torch.serving import Engine, Request, Scheduler  # noqa: E402

SEED = 0
SDP_N, SDP_K = 2 ** 20, 2 ** 10
MCM_N, MCM_BATCH_N, MCM_BATCH = 1024, 512, 8
#: past the on-chip gate: S-DP length, edit_distance string length; the
#: resident MCM batch width; the viterbi instance (states, steps) small
#: enough for the weighted K3 twin's host-looped plain version
SDP_BIG_N, EDIT_BIG_N, MCM_SMALL_N = 2 ** 23, 2048, 256
VITERBI_CHECK = (64, 256)
#: grid path: DNA alignment length, the batch leg, the reduced oracle length;
#: the CKY chart (tokens, nonterminals, vocabulary, rules) and its reduced
#: oracle instance
ALIGN_N, ALIGN_BATCH_N, ALIGN_BATCH, ALIGN_ORACLE_N = 4096, 1024, 8, 512
CKY = {"n": 64, "P": 32, "V": 512, "rules": 1024}
CKY_ORACLE = {"n": 16, "P": 8, "V": 512, "rules": 64}
#: blocked MCM: the route's tile, and K5's square check (M = K = N)
BLOCKED_TILE, K5_SQUARE = 16, 1024
#: LM path: the arch served at its published width, the traffic (requests,
#: new tokens each, prompt lengths drawn from the seed in this range), the
#: engine's slots and cache length; K7 timed at one layer of prefill_32k
LM_ARCH, LM_REQUESTS, LM_NEW, LM_PROMPT = "qwen3-14b", 8, 16, (300, 2000)
LM_BATCH, LM_MAX_LEN, LONG_S = 4, 2064, 32768
#: the MoE and SSM families served at their published widths with the LM
#: path's traffic; arctic-480b cut to its first ARCTIC_DEPTH of 35 layers
#: (25.35 GiB of bf16 weights a layer: two fit the 80 GB card with their
#: embeddings, ~51.6 GiB), one request of ARCTIC_PROMPT tokens; the reduced
#: configs held on the card against the CPU
MOE_ARCH, SSM_ARCH, ARCTIC_ARCH = "granite-moe-3b-a800m", "rwkv6-1.6b", "arctic-480b"
ARCTIC_DEPTH, ARCTIC_PROMPT = 2, 2000
REDUCED_ARCHS = (MOE_ARCH, ARCTIC_ARCH, "jamba-1.5-large-398b", SSM_ARCH)
#: the MoE block against its dense oracle (bf16, share of max|out|); decode
#: steps against prefills of the longer prompt and chunked_gla against its
#: step-by-step version (float32, shares of max|logit| and max|y|); the
#: reduced configs' prefill logits, card against CPU (float32, absolute)
MOE_ORACLE_RTOL, DECODE_RTOL, GLA_RTOL, REDUCED_TOL = 2e-2, 1e-3, 1e-4, 1e-4
#: K8's check: prefill_32k's length by rwkv6-1.6b's width
SCAN_T, SCAN_D = 32768, 2048
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s and the
#: dense bf16 tensor-core rate (K7's bound)
HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S = 3.35e12, 67e12, 989e12
#: K7 against its plain version on the card: float32 sums in another order
#: (and exp2 against exp), bf16 outputs rounded to 8 bits
#: (tests/test_kernels.py's bound)
K7_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the prefill logits through K7 against the plain version, as a share of
#: the plain logits' max abs (held in float32 compute, see phase_lm)
LOGITS_RTOL = 3e-2
#: float32 tables (sums along chains of up to ~2k cells) against float64
#: oracles and recomputations of a decoded solution
RTOL = 1e-4

_failures: list = []


def require(ok: bool, what: str) -> None:
    print(("ok      " if ok else "FAILED  ") + what, flush=True)
    if not ok:
        _failures.append(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, peak: float = F32_OPS_PER_S) -> tuple:
    """Least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate for their type (float32 by default)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


_COUNTERS = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES, k5.LAUNCHES,
             k6.LAUNCHES, k7.LAUNCHES, k8.LAUNCHES)


def reset_launches() -> None:
    """Zero every kernel's launch counter and forget the DP kernels' launch
    geometries."""
    for counts in _COUNTERS:
        for key in counts:
            counts[key] = 0
    kschedule.forget_launches()


def launches() -> dict:
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


_PEAKS: list = []


def measured(label: str, fn):
    """``fn()`` with its host time and the device memory peak it reached
    printed; the peak joins the path's own."""
    torch.cuda.synchronize()
    _PEAKS.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _PEAKS.append(peak)
    print(f"{label}: {took:.2f} s, peak device memory {peak / 2 ** 30:.3f} GiB")
    return out


def path_peak_gib() -> float:
    peak = max(_PEAKS + [torch.cuda.max_memory_allocated()])
    _PEAKS.clear()
    return peak / 2 ** 30


def kernel_record(name, source, replaces, err, ms, plain_ms, nbytes, ops,
                  peak: float = F32_OPS_PER_S, library_ms=None) -> dict:
    b, by = bound_ms(nbytes, ops, peak)
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound "
          f"{b:.4f} ms ({by}), max_abs_err {err}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms}


def timed_once(fn) -> tuple:
    """``(fn(), device ms)`` of one call, by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_err(a, b) -> float:
    """Largest absolute difference; equal entries (infinities too) count 0."""
    a, b = a.double(), b.double()
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


# ---------------------------------------------------------------------------
# Instances (numpy, from the seed)
# ---------------------------------------------------------------------------
def sdp_instance(rng) -> dict:
    offsets = tuple(range(2 * SDP_K, SDP_K, -1))       # benchmarks/table1_sdp.py:32
    return {"init": rng.normal(size=offsets[0]).astype(np.float32),
            "offsets": offsets, "op": "min", "n": SDP_N}


def viterbi_instance(rng, S: int, T: int, M: int = 16) -> dict:
    lognorm = lambda x, axis: np.log(x / x.sum(axis=axis, keepdims=True))  # noqa: E731
    return {"log_a": lognorm(rng.random((S, S)) + 0.05, 1),
            "log_b": lognorm(rng.random((S, M)) + 0.05, 1),
            "log_pi": lognorm(rng.random(S) + 0.05, 0),
            "obs": rng.integers(0, M, T)}


def mcm_dims(rng, n: int) -> np.ndarray:
    return rng.integers(1, 61, size=n + 1).astype(np.float64)


def other_instances(rng) -> dict:
    return {
        "edit_distance": {"x": rng.integers(0, 4, 512), "y": rng.integers(0, 4, 512)},
        "lcs": {"x": rng.integers(0, 4, 512), "y": rng.integers(0, 4, 512)},
        "viterbi": viterbi_instance(rng, 64, 2048),
        "unbounded_knapsack": {"item_weights": rng.integers(1, 33, 12),
                               "item_values": np.round(rng.random(12) * 10 + 0.5, 3),
                               "capacity": 4096},
        "optimal_bst": {"freq": rng.random(512) + 0.01},
        "polygon_triangulation": {"vertices": rng.integers(1, 20, 512).astype(np.float64)},
    }


# ---------------------------------------------------------------------------
# Recomputing decoded solutions to their optimum (float64)
# ---------------------------------------------------------------------------
def close(a, b) -> bool:
    return bool(np.isclose(float(a), float(b), rtol=RTOL, atol=1e-6))


def mcm_tree_cost(tree, dims) -> tuple:
    """(cost, first, last) of a parenthesization tree over matrices."""
    if isinstance(tree, int):
        return 0.0, tree, tree
    lc, i, s = mcm_tree_cost(tree[0], dims)
    rc, _, j = mcm_tree_cost(tree[1], dims)
    return lc + rc + dims[i] * dims[s + 1] * dims[j + 1], i, j


def bst_cost(tree, freq, depth=1) -> float:
    if tree is None:
        return 0.0
    root, left, right = tree
    return (freq[root] * depth + bst_cost(left, freq, depth + 1)
            + bst_cost(right, freq, depth + 1))


def check_decoded(name: str, inst: dict, ans) -> bool:
    sol = ans.solution
    if name == "sdp":
        cells, offs = sol["cells"], sol["offsets_taken"]
        chain = all(c - o == nxt for c, o, nxt in
                    zip(cells, offs, cells[1:] + [sol["terminal"]]))
        return chain and ans.table[-1] == inst["init"][sol["terminal"]]
    if name == "edit_distance":
        x, y = list(inst["x"]), list(inst["y"])
        out, i, cost = [], 0, 0
        for op in sol["ops"]:
            if op[0] in ("match", "sub"):
                out.append(y[op[2]] if op[0] == "sub" else x[op[1]])
                cost += op[0] == "sub"
                i += 1
            elif op[0] == "del":
                i, cost = i + 1, cost + 1
            else:
                out.append(y[op[1]])
                cost += 1
        return out == y and i == len(x) and cost == ans.value
    if name == "lcs":
        pairs = sol["pairs"]
        ok = all(inst["x"][i] == inst["y"][j] for i, j in pairs)
        inc = all(a[0] < b[0] and a[1] < b[1] for a, b in zip(pairs, pairs[1:]))
        return ok and inc and len(pairs) == ans.value
    if name == "viterbi":
        s, o = sol["states"], inst["obs"]
        lp = inst["log_pi"][s[0]] + inst["log_b"][s[0], o[0]]
        for t in range(1, len(s)):
            lp += inst["log_a"][s[t - 1], s[t]] + inst["log_b"][s[t], o[t]]
        return close(lp, ans.value)
    if name == "unbounded_knapsack":
        items = list(zip(inst["item_weights"].tolist(), inst["item_values"].tolist()))
        real = all(any(w == iw and close(v, iv) for iw, iv in items)
                   for w, v in sol["items"])
        return (real and sol["total_weight"] <= inst["capacity"]
                and close(sol["total_value"], ans.value))
    if name == "mcm":
        return close(mcm_tree_cost(sol["tree"], inst["dims"])[0], ans.value)
    if name == "optimal_bst":
        return close(bst_cost(sol["tree"], inst["freq"]), ans.value)
    if name == "polygon_triangulation":
        v = inst["vertices"]
        cost = sum(v[a] * v[b] * v[c] for a, b, c in sol["triangles"])
        return len(sol["triangles"]) == len(v) - 2 and close(cost, ans.value)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {len(_build.SOURCES)} "
          "sources built in parallel")
    for name in _build.SOURCES:
        info = _build.BUILD_INFO.get(name)
        if info is None:
            print(f"build {name}: library already present")
            continue
        print(f"build {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip())
    smem = _build.load("flash_attention_tc").flash_attention_tc_smem_bytes
    print("flash_attention_tc dynamic shared memory by head dim: " + ", ".join(
        f"hd {d} {smem(d)} bytes" for d in (16, 64, 96, 128, 160, 256)))


def phase_kernels(rng, cuda) -> tuple:
    """Each kernel against its plain version on the same CUDA tensors at the
    main path's shapes; returns (records, sdp instance, mcm dims)."""
    records = []

    def record(*args):
        records.append(kernel_record(*args))

    err = max_err

    # K1 at the S-DP main-path shape (unweighted, min)
    sdp = sdp_instance(rng)
    offsets, n = sdp["offsets"], sdp["n"]
    a1, k = offsets[0], len(offsets)
    init = torch.from_numpy(sdp["init"]).to(cuda)[None]
    k1_plan = sdp_walk.plan(offsets, False, ring=False)
    k1_c = sdp_walk.cluster_size("sdp_pipeline", offsets, k1_plan, "min", False, False, cuda)
    print(f"sdp_pipeline at sdp n={n}: {k1_plan}, cluster size {k1_c} (CTAs per "
          f"instance, {sdp_walk.threads(k1_plan, k1_c)} threads each)")
    for with_args in (False, True):
        name = "sdp_pipeline_with_args" if with_args else "sdp_pipeline"
        fn = k1.sdp_pipeline_with_args if with_args else k1.sdp_pipeline
        got = fn(init, offsets, "min", n)
        want = k1.sdp_pipeline_plain(init, offsets, "min", n, with_args=with_args)
        if with_args:
            require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                    f"{name} n={n} k={k}: table and args bit-equal to plain")
            got, want = got[0], want[0]
        else:
            require(torch.equal(got, want), f"{name} n={n} k={k}: table bit-equal to plain")
        ms = cuda_ms(lambda: fn(init, offsets, "min", n), reps=5)
        plain = cuda_ms(lambda: k1.sdp_pipeline_plain(init, offsets, "min", n,
                                                      with_args=with_args), reps=2)
        nbytes = 4 * a1 + 4 * k + 4 * n * (2 if with_args else 1)
        record(name, "src/repro_torch/csrc/sdp_pipeline.cu",
               "src/repro/kernels/sdp_pipeline.py:" + ("130" if with_args else "110"),
               err(got, want), ms, plain, nbytes, (n - a1) * (k - 1))

    # K1 weighted, at the knapsack main-path shape (max, with args)
    ks = dp.get_problem("unbounded_knapsack").encode(**other_instances(
        np.random.default_rng(SEED))["unbounded_knapsack"])
    kinit = torch.from_numpy(ks.init).to(cuda)
    kw = torch.from_numpy(ks.weights).to(cuda)
    got = k1.sdp_pipeline_with_args(kinit, ks.offsets, "max", ks.n, weights=kw)
    want = k1.sdp_pipeline_plain(kinit, ks.offsets, "max", ks.n, weights=kw,
                                 with_args=True)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"sdp_pipeline_with_args weighted (knapsack n={ks.n}): bit-equal to plain")

    # K2 at the MCM main-path shapes: n = 1024, and a batch of 8 at n = 512
    dims = mcm_dims(rng, MCM_N)
    wtab = torch.from_numpy(dp.get_problem("mcm").encode(dims=dims).weights
                            .astype(np.float32)).to(cuda)
    bdims = [mcm_dims(rng, MCM_BATCH_N) for _ in range(MCM_BATCH)]
    bw = torch.from_numpy(np.stack([dp.get_problem("mcm").encode(dims=d).weights
                                    .astype(np.float32) for d in bdims])).to(cuda)
    for w, nn in ((bw, MCM_BATCH_N), (wtab, MCM_N)):
        gt, ga = k2.mcm_pipeline_with_args(w, nn)
        wt, wa = k2.mcm_pipeline_plain(w, nn, with_args=True)
        require(torch.equal(gt, wt) and torch.equal(ga, wa),
                f"mcm_pipeline_with_args n={nn} batch={w.shape[0] if w.dim() == 3 else 1}: "
                "table and args bit-equal to plain")
        require(torch.equal(k2.mcm_pipeline(w, nn), wt),
                f"mcm_pipeline n={nn}: table bit-equal to plain")
    cells, needed = core_mcm.num_cells(MCM_N), sum((MCM_N - d) * d for d in range(1, MCM_N))
    for with_args in (False, True):
        name = "mcm_pipeline_with_args" if with_args else "mcm_pipeline"
        fn = k2.mcm_pipeline_with_args if with_args else k2.mcm_pipeline
        got = fn(wtab, MCM_N)
        want = k2.mcm_pipeline_plain(wtab, MCM_N, with_args=with_args)
        e = err(got[0], want[0]) if with_args else err(got, want)
        ms = cuda_ms(lambda: fn(wtab, MCM_N), reps=3)
        plain = cuda_ms(lambda: k2.mcm_pipeline_plain(wtab, MCM_N, with_args=with_args),
                        reps=2)
        # bytes: the weights the recurrence reads (e < d) once, the table out
        nbytes = 4 * needed + 4 * cells * (2 if with_args else 1)
        record(name, "src/repro_torch/csrc/mcm_pipeline.cu",
               "src/repro/kernels/mcm_pipeline.py:" + ("120" if with_args else "105"),
               e, ms, plain, nbytes, 3 * needed)
    del bw
    records += k4_records(wtab, cells, needed)
    del wtab
    torch.cuda.empty_cache()
    return records, sdp, dims


def k4_records(wtab, cells: int, needed: int) -> list:
    """K4's three twins at MCM n = 1024 on K2's instance: tables and args
    bit-equal to K2's and to the plain version, fused nodes equal to the
    host walk of K4's args; then the head-to-head with K2."""
    n = MCM_N
    k2_table, k2_args = k2.mcm_pipeline_with_args(wtab, n)
    (pt, pa, pnodes), plain = timed_once(lambda: k4.mcm_tiled_plain(wtab, n, fused=True))
    print(f"mcm_tiled tiles (T rows, E splits) = {k4.tile_plan(n)}, shared memory "
          f"{k4.smem_bytes(n, fused=True)} bytes")
    records = []
    for twin, replaces in (("", "350"), ("_with_args", "365"), ("_fused", "380")):
        name = "mcm_tiled" + twin
        fn = {"": k4.mcm_tiled, "_with_args": k4.mcm_tiled_with_args,
              "_fused": k4.mcm_tiled_fused}[twin]
        got = fn(wtab, n)
        table = got if not twin else got[0]
        same = torch.equal(table, k2_table) and torch.equal(table, pt)
        if twin:
            same = same and torch.equal(got[1], k2_args) and torch.equal(got[1], pa)
        require(same, f"{name} n={n}: table{' and args' if twin else ''} bit-equal "
                "to mcm_pipeline's and to the plain version")
        if twin == "_fused":
            nodes = torch.stack(got[2], dim=1).cpu().numpy()
            walk = core_mcm.triangular_traceback_np(got[1].cpu().numpy(), n)
            require(np.array_equal(nodes, walk) and all(
                torch.equal(a, b) for a, b in zip(got[2], pnodes)),
                f"{name} n={n}: nodes equal the host walk of its args and the "
                "plain version's")
        ms = cuda_ms(lambda: fn(wtab, n), reps=3)
        nbytes = 4 * needed + 4 * cells * (2 if twin else 1) + (12 * (n - 1) if twin == "_fused" else 0)
        records.append(kernel_record(name, "src/repro_torch/csrc/mcm_tiled.cu",
                                     "src/repro/kernels/mcm_tiled.py:" + replaces,
                                     max_err(table, pt), ms, plain, nbytes, 3 * needed))
        del got, table
    return records


def phase_streaming_kernels(cuda, sdp: dict) -> list:
    """K3 against its plain version at S-DP n = 2^23 (both twins), K1 on
    the same instance and both at 2^20 (the head-to-head), and the weighted
    K3 twin with args on a viterbi instance."""
    t0 = time.perf_counter()
    offsets, n = sdp["offsets"], SDP_BIG_N
    a1, k = offsets[0], len(offsets)
    init = torch.from_numpy(sdp["init"]).to(cuda)[None]
    C = k3.cluster_size(offsets, "min", False, False, cuda)
    print(f"sdp_chunked at sdp n={n}: {k3.plan(offsets, False)}, cluster size {C} "
          f"(CTAs per instance, {sdp_walk.threads(k3.plan(offsets, False), C)} threads "
          f"each), shared memory {k3.smem_bytes(offsets, False, C)} bytes per CTA")
    (pt, pa), plain = timed_once(lambda: k3.sdp_chunked_plain(init, offsets, "min", n,
                                                              with_args=True))
    records = []
    for with_args in (False, True):
        name = "sdp_chunked_with_args" if with_args else "sdp_chunked"
        fn = k3.sdp_chunked_with_args if with_args else k3.sdp_chunked
        got = fn(init, offsets, "min", n)
        table = got[0] if with_args else got
        require(torch.equal(table, pt) and (not with_args or torch.equal(got[1], pa)),
                f"{name} n={n} k={k}: table{' and args' if with_args else ''} "
                "bit-equal to plain")
        ms = cuda_ms(lambda: fn(init, offsets, "min", n), reps=3)
        records.append(kernel_record(
            name, "src/repro_torch/csrc/sdp_chunked.cu",
            "src/repro/kernels/sdp_pipeline.py:" + ("304" if with_args else "288"),
            max_err(table, pt), ms, plain, 4 * a1 + 4 * k + 4 * n * (2 if with_args else 1),
            (n - a1) * (k - 1)))
        del got, table
    # the head-to-head: K1 on the same instances (the gate refuses K1 at 2^23;
    # the direct call does not ask it)
    k1_table = k1.sdp_pipeline(init, offsets, "min", n)
    require(torch.equal(k1_table, pt), f"sdp_pipeline n={n}: table bit-equal to sdp_chunked's")
    k1_big = cuda_ms(lambda: k1.sdp_pipeline(init, offsets, "min", n), reps=2)
    k3_big = records[0]["ms"]
    spec20 = dp.get_problem("sdp").encode(**sdp)
    via_route = dp.solve_spec(spec20, backend="kernel_tiled", device=cuda)
    require(np.array_equal(via_route, k1.sdp_pipeline(init, offsets, "min", SDP_N)[0].cpu().numpy()),
            f"kernel_tiled route n={SDP_N}: table bit-equal to sdp_pipeline's")
    k1_20 = cuda_ms(lambda: k1.sdp_pipeline(init, offsets, "min", SDP_N), reps=3)
    k3_20 = cuda_ms(lambda: k3.sdp_chunked(init, offsets, "min", SDP_N), reps=3)
    print(f"head-to-head sdp k={k}: n={SDP_N} K1 {k1_20:.3f} ms, K3 {k3_20:.3f} ms; "
          f"n={n} K1 {k1_big:.3f} ms, K3 {k3_big:.3f} ms")
    del init, pt, pa, k1_table

    # the weighted twin with args on a viterbi instance (B = 1, k = 127)
    S, T = VITERBI_CHECK
    vs = dp.get_problem("viterbi").encode(**viterbi_instance(np.random.default_rng(SEED), S, T))
    vinit = torch.from_numpy(vs.init).to(cuda)
    vw = torch.from_numpy(vs.weights).to(cuda)
    got = k3.sdp_chunked_with_args(vinit, vs.offsets, "max", vs.n, weights=vw)
    want, vplain = timed_once(lambda: k3.sdp_chunked_plain(vinit, vs.offsets, "max", vs.n,
                                                           weights=vw, with_args=True))
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"sdp_chunked_with_args weighted (viterbi {S} x {T}, n={vs.n}, "
            f"k={len(vs.offsets)}): bit-equal to plain")
    vms = cuda_ms(lambda: k3.sdp_chunked_with_args(vinit, vs.offsets, "max", vs.n,
                                                   weights=vw), reps=3)
    k1v = cuda_ms(lambda: k1.sdp_pipeline_with_args(vinit, vs.offsets, "max", vs.n,
                                                    weights=vw), reps=3)
    print(f"viterbi {S} x {T} weighted with args: K3 {vms:.3f} ms, K1 {k1v:.3f} ms, "
          f"plain {vplain:.3f} ms")
    print(f"streaming kernels phase: {time.perf_counter() - t0:.2f} s")
    return records


@contextlib.contextmanager
def launch_times():
    """{launch counter: [device ms of each launch]} of the DP kernels (K1,
    K2, K3, K4, K5, K6) launched inside: CUDA events recorded around each
    wrapper's ``_launch``, in stream order, so a pair brackets one launch
    (with its wrapper's small copies and any host gap), read after a
    synchronise; the counter that moved names the launch."""
    pairs, times = [], {}

    def timed(mod, launch):
        def run(*args, **kw):
            before = dict(mod.LAUNCHES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*args, **kw)
            end.record()
            moved = [k for k, v in mod.LAUNCHES.items() if v != before[k]]
            if moved:
                pairs.append((moved[0], start, end))
            return out
        return run

    with contextlib.ExitStack() as stack:
        for mod in (k1, k2, k3, k4, k5, k6):
            stack.enter_context(mock.patch.object(mod, "_launch", timed(mod, mod._launch)))
        yield times
        torch.cuda.synchronize()
    for key, start, end in pairs:
        times.setdefault(key, []).append(start.elapsed_time(end))


def print_launch_times(path: str, times: dict) -> None:
    print(f"DP kernels' device ms on the {path} path (CUDA events around each "
          "launch, checks included): " + "; ".join(
              f"{k} {sum(v):.3f} over {len(v)} launches (largest {max(v):.3f})"
              for k, v in times.items()))


def linear_tensors(spec, cuda) -> tuple:
    init = torch.from_numpy(spec.init).to(cuda)
    w = None if spec.weights is None else torch.from_numpy(spec.weights).to(cuda)
    return init, w


def sdp_work(spec, with_args: bool) -> tuple:
    """(bytes, operations) of one S-DP solve: presets, offsets and weights
    read once, the table (and args) written once; per cell past the presets
    k - 1 compares, plus k semiring products where weighted."""
    n, k, a1 = spec.n, len(spec.offsets), spec.offsets[0]
    weighted = spec.weights is not None
    nbytes = 4 * (a1 + k + n * (2 if with_args else 1) + (n * k if weighted else 0))
    return nbytes, (n - a1) * (k - 1 + (k if weighted else 0))


def shape_rows(table: dict, times: dict, by_name: dict) -> dict:
    """Each record's shapes with their times and launches, printed, and the
    record's ``path_ms``: the sum of time x launches over its shapes."""
    rows = {}
    for name, shapes in table.items():
        rows[name] = []
        for shape, count, *path in shapes:
            t = times[(name, shape)]
            rows[name].append({"shape": shape, "launches": count, **t})
            where = f" ({path[0]} path)" if path else ""
            print(f"{name} at {shape}: {t['ms']:.3f} ms x {count}{where}, bound "
                  f"{t['bound_ms']:.6f} ms")
        by_name[name]["path_ms"] = sum(r["ms"] * r["launches"] for r in rows[name])
        print(f"{name}: path_ms {by_name[name]['path_ms']:.3f}")
    return rows


#: record name -> [(shape, launches of that shape on the main path)]: every
#: launch K1 and K3 make on the main path (phase_main_path), by shape
SDP_PATH_SHAPES = {
    "sdp_pipeline": [("sdp 2^20", 1), ("edit_distance 513^2", 1)],
    "sdp_pipeline_with_args": [("sdp 2^20", 1), ("edit_distance 513^2", 2),
                               ("lcs 513^2", 1), ("unbounded_knapsack 4097", 1)],
    "sdp_chunked": [("sdp 2^23", 1)],
    "sdp_chunked_with_args": [("sdp 2^23", 1), ("viterbi 64 x 2048", 1),
                              ("edit_distance 2048^2", 1)],
}


def phase_sdp_shapes(cuda, records: list) -> dict:
    """K1 and K3 at every shape they launch on the main path: each new shape
    held against the plain version (or, where that would take half a minute
    or more, K3 against K1 on the same tensors), timed, and its bound; the
    sdp shapes' times are the records'. Returns {record name: [shape
    rows]}."""
    t0 = time.perf_counter()
    by_name = {r["name"]: r for r in records}
    times = {("sdp_pipeline", "sdp 2^20"): by_name["sdp_pipeline"],
             ("sdp_pipeline_with_args", "sdp 2^20"): by_name["sdp_pipeline_with_args"],
             ("sdp_chunked", "sdp 2^23"): by_name["sdp_chunked"],
             ("sdp_chunked_with_args", "sdp 2^23"): by_name["sdp_chunked_with_args"]}
    times = {key: {"ms": r["ms"], "bound_ms": r["bound_ms"]} for key, r in times.items()}

    def timed(key, spec, fn, with_args, reps, check, what):
        ring = key[0].startswith("sdp_chunked")
        p = sdp_walk.plan(spec.offsets, spec.weights is not None, ring)
        print(f"{key[0]} at {key[1]}: {p}")
        init, w = linear_tensors(spec, cuda)
        run = lambda: fn(init, spec.offsets, spec.op, spec.n, weights=w)  # noqa: E731
        got = run()
        require(check(init, w, got), f"{key[0]} at {key[1]} (n={spec.n}, "
                f"k={len(spec.offsets)}): {what}")
        b, _ = bound_ms(*sdp_work(spec, with_args))
        times[key] = {"ms": cuda_ms(run, reps), "bound_ms": b}
        del got

    def equals_plain(plain_fn, with_args):
        def check(init, w, got):
            want = plain_fn(init, None, w)
            if with_args:
                return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            return torch.equal(got, want)
        return check

    others = other_instances(np.random.default_rng(SEED))
    for name, label in (("edit_distance", "edit_distance 513^2"), ("lcs", "lcs 513^2"),
                        ("unbounded_knapsack", "unbounded_knapsack 4097")):
        spec = dp.get_problem(name).encode(**others[name])
        plain = lambda init, _, w, s=spec: k1.sdp_pipeline_plain(  # noqa: E731
            init, s.offsets, s.op, s.n, weights=w, with_args=True)
        timed(("sdp_pipeline_with_args", label), spec, k1.sdp_pipeline_with_args,
              True, 3, equals_plain(plain, True), "table and args bit-equal to plain")
        if name == "edit_distance":
            plain = lambda init, _, w, s=spec: k1.sdp_pipeline_plain(  # noqa: E731
                init, s.offsets, s.op, s.n, weights=w)
            timed(("sdp_pipeline", label), spec, k1.sdp_pipeline, False, 3,
                  equals_plain(plain, False), "table bit-equal to plain")
    def equals_k1(spec):
        def check(init, w, got):
            want = k1.sdp_pipeline_with_args(init, spec.offsets, spec.op, spec.n, weights=w)
            return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return check

    # the plain version would take ~30 s and minutes here: K3 against K1
    # (viterbi 64 x 256 is held against the plain version above)
    vspec = dp.get_problem("viterbi").encode(**others["viterbi"])
    timed(("sdp_chunked_with_args", "viterbi 64 x 2048"), vspec, k3.sdp_chunked_with_args,
          True, 3, equals_k1(vspec), "table and args bit-equal to sdp_pipeline's (K1)")
    rs = np.random.default_rng(SEED)
    espec = dp.get_problem("edit_distance").encode(
        x=rs.integers(0, 4, EDIT_BIG_N), y=rs.integers(0, 4, EDIT_BIG_N))
    timed(("sdp_chunked_with_args", "edit_distance 2048^2"), espec, k3.sdp_chunked_with_args,
          True, 2, equals_k1(espec), "table and args bit-equal to sdp_pipeline's (K1)")

    rows = shape_rows(SDP_PATH_SHAPES, times, by_name)
    print(f"S-DP shapes phase: {time.perf_counter() - t0:.2f} s")
    return rows


#: record name -> [(shape, launches of that shape on the main path)]: every
#: launch K2 and K4 make on the main path (phase_main_path), by shape
MCM_PATH_SHAPES = {
    "mcm_pipeline": [(f"mcm {MCM_BATCH} x {MCM_SMALL_N}", 1)],
    "mcm_pipeline_with_args": [(f"mcm {MCM_BATCH} x {MCM_SMALL_N}", 1)],
    "mcm_tiled": [("polygon_triangulation 511", 1)],
    "mcm_tiled_with_args": [("optimal_bst 513", 1)],
    "mcm_tiled_fused": [("mcm 1024", 1), (f"mcm {MCM_BATCH} x 512", 1),
                        ("optimal_bst 513", 1), ("polygon_triangulation 511", 2)],
}
#: record name -> [(shape, launches, path)]: every launch K6 makes on the
#: main and grid paths (phase_main_path, phase_grid), by shape
GRID_PATH_SHAPES = {
    "grid_pipeline_antidiag": [("edit_distance_grid 2049^2", 1, "main"),
                               ("needleman_wunsch 4097^2", 1, "grid")],
    "grid_pipeline_antidiag_with_args": [
        ("needleman_wunsch 4097^2", 1, "grid"), ("gotoh 4097^2", 1, "grid"),
        ("edit_distance_grid 513^2", 2, "grid"), ("lcs_grid 513^2", 2, "grid"),
        ("needleman_wunsch 513^2", 1, "grid"), ("gotoh 513^2", 1, "grid"),
        (f"needleman_wunsch {ALIGN_BATCH} x 1025^2", 1, "grid")],
    "grid_pipeline_spandiag": [(f"cky {CKY['n']}", 1, "grid")],
    "grid_pipeline_spandiag_with_args": [(f"cky {CKY['n']}", 1, "grid"),
                                         (f"cky {CKY_ORACLE['n']}", 1, "grid")],
}
#: the shape of each K6 schedule's records (phase_grid_kernels)
GRID_RECORD_SHAPES = {"antidiag": "gotoh 4097^2", "spandiag": f"cky {CKY['n']}"}


def mcm_work(n: int, batch: int, with_args: bool, fused: bool) -> tuple:
    """(bytes, operations) of one K2 or K4 launch: the weights the recurrence
    reads (e < d) once, the table (and args, and nodes) written once; an
    add, an add and a compare per candidate."""
    needed = batch * sum((n - d) * d for d in range(1, n))
    out = core_mcm.num_cells(n) * batch * (2 if with_args or fused else 1)
    return 4 * needed + 4 * out + (12 * (n - 1) * batch if fused else 0), 3 * needed


def k2_small_shape(cuda, times: dict) -> None:
    """K2 at its main-path shape, a batch of 8 at n = 256 from the seed:
    both twins bit-equal to the plain version and timed, beside K4's twins
    on the same tensors (dispatch keeps K2 there; K4's times are printed
    for the cost model's calibration, never used)."""
    n, bt, label = MCM_SMALL_N, MCM_BATCH, f"mcm {MCM_BATCH} x {MCM_SMALL_N}"
    rng = np.random.default_rng(SEED)
    w = torch.from_numpy(np.stack([
        dp.get_problem("mcm").encode(dims=mcm_dims(rng, n)).weights.astype(np.float32)
        for _ in range(bt)])).to(cuda)
    wt, wa = k2.mcm_pipeline_plain(w, n, with_args=True)
    for name, fn in (("mcm_pipeline", k2.mcm_pipeline),
                     ("mcm_pipeline_with_args", k2.mcm_pipeline_with_args)):
        got = fn(w, n)
        args = name.endswith("args")
        require(torch.equal(got[0] if args else got, wt) and (not args or torch.equal(got[1], wa)),
                f"{name} at {label}: table{' and args' if args else ''} bit-equal to plain")
        b, _ = bound_ms(*mcm_work(n, bt, args, False))
        times[(name, label)] = {"ms": cuda_ms(lambda: fn(w, n), reps=5), "bound_ms": b}
    k4_ms = {name: cuda_ms(lambda: fn(w, n), reps=5) for name, fn in (
        ("mcm_tiled", k4.mcm_tiled), ("mcm_tiled_with_args", k4.mcm_tiled_with_args))}
    st, ar = k4.mcm_tiled_with_args(w, n)
    require(torch.equal(st, wt) and torch.equal(ar, wa),
            f"mcm_tiled_with_args at {label}: table and args bit-equal to plain")
    print(f"K2 beside K4 at {label}: mcm_pipeline "
          f"{times[('mcm_pipeline', label)]['ms']:.3f} ms, mcm_pipeline_with_args "
          f"{times[('mcm_pipeline_with_args', label)]['ms']:.3f} ms; mcm_tiled "
          f"{k4_ms['mcm_tiled']:.3f} ms, mcm_tiled_with_args "
          f"{k4_ms['mcm_tiled_with_args']:.3f} ms")


def k2_bank_wavefronts(n: int, C: int) -> str:
    """K2's shared-memory operand loads at width ``n``, counted for the
    first CTA of a cluster of ``C`` from the kernel's deal
    (``mcm_pipeline.lanes_per_cell``): for each warp-wide load of a left or
    right operand, the words it reads, the reads of a word another lane of
    the load also reads (served at once, a broadcast), and its wavefronts
    (the most distinct words in one of the 32 banks)."""
    lanes, tid = C * k2.THREADS, np.arange(k2.THREADS)
    loads = words = dup = waves = 0
    for d in range(1, n):
        cd = n - d
        wd = k2.lanes_per_cell(d, cd, lanes)
        t, q0, groups = tid % wd, (tid // wd) * C, (k2.THREADS // wd) * C
        for q in range(0, cd, groups):
            for e0 in range(0, d, wd):
                e, i = e0 + t, q0 + q
                live = (i < cd) & (e < d)
                for addr in (core_mcm.lin_index(0, e, n) + i,
                             core_mcm.lin_index(0, d - e - 1, n) + e + 1 + i):
                    for row, ok in zip(addr.reshape(-1, 32), live.reshape(-1, 32)):
                        if not ok.any():
                            continue
                        uniq = np.unique(row[ok])
                        loads += 1
                        words += int(ok.sum())
                        dup += int(ok.sum()) - uniq.size
                        waves += int(np.bincount(uniq % 32, minlength=32).max())
    return (f"{waves / loads:.3f} wavefronts a warp load ({loads} loads of {words} "
            f"words; {dup} reads of a word another lane of the load reads)")


def phase_mcm_shapes(cuda, records: list) -> dict:
    """K2 and K4 at every shape they launch on the main path: K2 held
    against the plain version, K4 against K2 (tables and args; fused nodes
    against the host walk of the args), timed, and its bound; MCM 1024's
    times are K4's records'. Returns {record name: [shape rows]}."""
    t0 = time.perf_counter()
    by_name = {r["name"]: r for r in records if r["name"] in MCM_PATH_SHAPES}
    times = {("mcm_tiled_fused", "mcm 1024"): {
        "ms": by_name["mcm_tiled_fused"]["ms"],
        "bound_ms": by_name["mcm_tiled_fused"]["bound_ms"]}}
    k2_small_shape(cuda, times)
    others = other_instances(np.random.default_rng(SEED))
    rng = np.random.default_rng(SEED)
    weights = {
        f"mcm {MCM_BATCH} x 512": np.stack([
            dp.get_problem("mcm").encode(dims=mcm_dims(rng, MCM_BATCH_N)).weights
            for _ in range(MCM_BATCH)]),
        "optimal_bst 513": dp.get_problem("optimal_bst").encode(
            **others["optimal_bst"]).weights[None],
        "polygon_triangulation 511": dp.get_problem("polygon_triangulation").encode(
            **others["polygon_triangulation"]).weights[None]}
    fns = {"mcm_tiled": k4.mcm_tiled, "mcm_tiled_with_args": k4.mcm_tiled_with_args,
           "mcm_tiled_fused": k4.mcm_tiled_fused}
    for label, wt in weights.items():
        w = torch.from_numpy(wt.astype(np.float32)).to(cuda)
        bt, n = w.shape[0], w.shape[2] + 1
        k2_table, k2_args = k2.mcm_pipeline_with_args(w, n)
        for name, shapes in MCM_PATH_SHAPES.items():
            if name not in fns or label not in (s for s, _ in shapes):
                continue
            got = fns[name](w, n)
            table = got if name == "mcm_tiled" else got[0]
            same = torch.equal(table, k2_table) and (
                name == "mcm_tiled" or torch.equal(got[1], k2_args))
            if name == "mcm_tiled_fused":
                nodes = torch.stack(got[2], dim=-1).cpu().numpy()
                args = got[1].cpu().numpy()
                same = same and all(np.array_equal(
                    nodes[b], core_mcm.triangular_traceback_np(args[b], n)) for b in range(bt))
            require(same, f"{name} at {label} (n={n}, batch={bt}): table"
                    f"{'' if name == 'mcm_tiled' else ' and args'} bit-equal to "
                    f"mcm_pipeline's (K2){', nodes the host walk' if 'fused' in name else ''}")
            b, _ = bound_ms(*mcm_work(n, bt, name != "mcm_tiled", name == "mcm_tiled_fused"))
            times[(name, label)] = {"ms": cuda_ms(lambda: fns[name](w, n), reps=3),
                                    "bound_ms": b}
            del got, table
        del w, k2_table, k2_args
    rows = shape_rows(MCM_PATH_SHAPES, times, by_name)
    print(f"MCM shapes phase: {time.perf_counter() - t0:.2f} s")
    return rows


def grid_shape_arrs(cuda) -> dict:
    """{shape label: (arrs on the card, spec, batch)} of every
    GRID_PATH_SHAPES shape but the records' (GRID_RECORD_SHAPES)."""
    insts = grid_instances(np.random.default_rng(SEED))
    m = ALIGN_ORACLE_N
    rs = np.random.default_rng(SEED)
    long = {"x": rs.integers(0, 4, EDIT_BIG_N), "y": rs.integers(0, 4, EDIT_BIG_N)}
    one = {"edit_distance_grid 2049^2": ("edit_distance_grid", long),
           "needleman_wunsch 4097^2": ("needleman_wunsch", insts["needleman_wunsch"]),
           "edit_distance_grid 513^2": ("edit_distance_grid", insts["edit_distance_grid"]),
           "lcs_grid 513^2": ("lcs_grid", insts["lcs_grid"]),
           "needleman_wunsch 513^2": ("needleman_wunsch",
                                      {k: v[:m] for k, v in insts["needleman_wunsch"].items()}),
           "gotoh 513^2": ("gotoh", {k: v[:m] for k, v in insts["gotoh"].items()}),
           f"cky {CKY_ORACLE['n']}": ("cky", cky_instance(
               np.random.default_rng(SEED), CKY_ORACLE["n"], CKY_ORACLE["P"],
               CKY_ORACLE["V"], CKY_ORACLE["rules"]))}
    out = {}
    for label, (name, inst) in one.items():
        spec = dp.get_problem(name).encode(**inst)
        out[label] = (tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                            for a in spec.device_arrays()), spec, 1)
    specs = [dp.get_problem("needleman_wunsch").encode(**i) for i in align_batch()]
    out[f"needleman_wunsch {ALIGN_BATCH} x 1025^2"] = (
        tuple(torch.from_numpy(np.stack(slot)).to(cuda)
              for slot in zip(*(s.device_arrays() for s in specs))), specs[0], len(specs))
    return out


def spandiag_work(spec, with_args: bool) -> tuple:
    """(bytes, operations) of one K6 spandiag launch on ``spec``: rule
    weights and init read once, the chart (and args) written once; two adds
    and a compare per (cell, split, rule into the cell's plane)."""
    n, NR, P = spec.rows, len(spec.rules), spec.planes
    nbytes = 4 * (NR + P * n) + 4 * P * core_mcm.num_cells(n) * (2 if with_args else 1)
    return nbytes, 3 * NR * sum((n - d) * d for d in range(1, n))


def phase_grid_shapes(cuda, records: list) -> dict:
    """K6 at every shape it launches on the main and grid paths: each held
    against the plain version (tables and args), timed, its bound and the
    device memory one launch adds (outputs and scratch); the records'
    shapes (GRID_RECORD_SHAPES) take the records' times. Returns {record
    name: [shape rows]}."""
    t0 = time.perf_counter()
    by_name = {r["name"]: r for r in records if r["name"] in GRID_PATH_SHAPES}
    times = {(name, GRID_RECORD_SHAPES[name.split("_")[2]]): {
        "ms": by_name[name]["ms"], "bound_ms": by_name[name]["bound_ms"]}
        for name in GRID_PATH_SHAPES}
    for label, (arrs, spec, bt) in grid_shape_arrs(cuda).items():
        meta = spec.static_meta()
        want = k6.grid_pipeline_plain(arrs, meta, with_args=True)
        for name, shapes in GRID_PATH_SHAPES.items():
            if label not in (s for s, *_ in shapes):
                continue
            args = name.endswith("args")
            fn = k6.grid_pipeline_with_args if args else k6.grid_pipeline
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = fn(arrs, meta)
            extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            table = got[0] if args else got
            require(torch.equal(table, want[0]) and (not args or torch.equal(got[1], want[1])),
                    f"{name} at {label}: table{' and args' if args else ''} bit-equal to plain")
            if spec.schedule == "spandiag":
                b, _ = bound_ms(*spandiag_work(spec, args))
            else:
                P, RC, L = spec.planes, spec.cells, len(spec.moves)
                b, _ = bound_ms(4 * bt * ((L + 2 * P) * RC + P * RC * (2 if args else 1)),
                                2 * bt * antidiag_candidates(spec))
            times[(name, label)] = {"ms": cuda_ms(lambda: fn(arrs, meta), reps=3),
                                    "bound_ms": b}
            print(f"{name} at {label}: one launch adds {extra:.1f} MiB of device memory")
            del got, table
        del arrs, want
        torch.cuda.empty_cache()
    rows = shape_rows(GRID_PATH_SHAPES, times, by_name)
    print(f"grid shapes phase: {time.perf_counter() - t0:.2f} s")
    return rows


EXPECTED_ROUTES = {"edit_distance": "kernel_blocked", "lcs": "kernel_blocked",
                   "viterbi": "kernel_tiled", "unbounded_knapsack": "kernel_blocked",
                   "optimal_bst": "kernel_tiled_wavefront",
                   "polygon_triangulation": "kernel_tiled_wavefront"}


def phase_main_path(rng, cuda, sdp: dict, dims: np.ndarray) -> np.ndarray:
    """The main path through the public entry points on the card; returns
    K4's MCM n = 1024 table (for the blocked path)."""
    t_all = time.perf_counter()
    print(f"on-chip budget (the L2 size the card reports): "
          f"{tkernels.on_chip_budget(cuda)} bytes")
    # dispatch names the kernel routes for the paper's shapes
    sdp_spec = dp.get_problem("sdp").encode(**sdp)
    require(dp.dispatch(sdp_spec, device=cuda).name == "kernel_blocked",
            f"dispatch(sdp n={SDP_N}) -> kernel_blocked")
    require(dp.dispatch(sdp_spec, reconstruct=True, device=cuda).name == "kernel_blocked",
            f"dispatch(sdp n={SDP_N}, reconstruct) -> kernel_blocked")

    t0 = time.perf_counter()
    table = dp.solve("sdp", device=cuda, **sdp)
    print(f"solve sdp n={SDP_N} k={SDP_K}: {time.perf_counter() - t0:.2f} s")
    plain = dp.solve_spec(sdp_spec, backend="blocked", device=cuda)
    require(np.array_equal(table, plain), "sdp table bit-equal to the plain "
            "blocked route on the card")
    t0 = time.perf_counter()
    ans = dp.solve("sdp", reconstruct=True, device=cuda, **sdp)
    print(f"solve sdp reconstruct: {time.perf_counter() - t0:.2f} s")
    require(np.array_equal(ans.table, table) and np.isfinite(table).all(),
            "sdp reconstruct table equals the plain solve, finite")
    require(check_decoded("sdp", sdp, ans), "sdp witness chain ends in the "
            "preset that holds the optimum")

    # S-DP past the gate: n = 2^23 streams through K3, with and without args
    big = dict(sdp, n=SDP_BIG_N)
    big_spec = dp.get_problem("sdp").encode(**big)
    for rec in (False, True):
        require(dp.dispatch(big_spec, reconstruct=rec, device=cuda).name == "kernel_tiled",
                f"dispatch(sdp n={SDP_BIG_N}{', reconstruct' if rec else ''}) -> kernel_tiled")
    big_table = measured(f"solve sdp n={SDP_BIG_N}",
                         lambda: dp.solve("sdp", device=cuda, **big))
    init = torch.from_numpy(sdp["init"]).to(cuda)
    require(np.array_equal(big_table, k3.sdp_chunked_plain(
        init, sdp["offsets"], "min", SDP_BIG_N).cpu().numpy()),
        f"sdp n={SDP_BIG_N} table bit-equal to the plain sdp_chunked on the card")
    ans = measured(f"solve sdp n={SDP_BIG_N} reconstruct",
                   lambda: dp.solve("sdp", reconstruct=True, device=cuda, **big))
    require(np.array_equal(ans.table, big_table), f"sdp n={SDP_BIG_N} reconstruct "
            "table equals the solve without it")
    require(check_decoded("sdp", big, ans), f"sdp n={SDP_BIG_N} witness chain ends "
            "in the preset that holds the optimum")
    del big_table, ans, big_spec

    # MCM n = 1024 past the gate: K4 with the traceback fused into its launch
    mcm_spec = dp.get_problem("mcm").encode(dims=dims)
    require(dp.dispatch(mcm_spec, reconstruct=True, device=cuda).name == "kernel_tiled_wavefront",
            f"dispatch(mcm n={MCM_N}, reconstruct) -> kernel_tiled_wavefront")
    before = k4.LAUNCHES["mcm_tiled_fused"]
    ans = measured(f"solve mcm n={MCM_N} reconstruct (encode included)",
                   lambda: dp.solve("mcm", dims=dims, reconstruct=True, device=cuda))
    print(f"  value {ans.value}")
    require(k4.LAUNCHES["mcm_tiled_fused"] - before == 1, f"mcm n={MCM_N} reconstruct "
            "is one fused launch")
    ref = dp.solve_spec(mcm_spec, backend="wavefront", device=cuda)
    require(np.array_equal(ans.table, ref), f"mcm n={MCM_N} table bit-equal to "
            "the plain wavefront route on the card")
    require(check_decoded("mcm", {"dims": dims}, ans), f"mcm n={MCM_N} tree "
            "recomputes to the optimum")
    mcm_table = ans.table
    del mcm_spec, ref

    insts = [{"dims": mcm_dims(rng, MCM_BATCH_N)} for _ in range(MCM_BATCH)]
    require(dp.dispatch("mcm", reconstruct=True, device=cuda, **insts[0]).name
            == "kernel_tiled_wavefront",
            f"dispatch(mcm n={MCM_BATCH_N}, reconstruct) -> kernel_tiled_wavefront")
    before = k4.LAUNCHES["mcm_tiled_fused"]
    answers = measured(f"batch_solve mcm {MCM_BATCH} x n={MCM_BATCH_N} reconstruct "
                       "(encode included)",
                       lambda: dp.batch_solve("mcm", insts, reconstruct=True, device=cuda))
    require(k4.LAUNCHES["mcm_tiled_fused"] - before == 1, "mcm batch is one fused launch")
    refs = dp.batch_solve_specs([dp.get_problem("mcm").encode(**i) for i in insts],
                                backend="wavefront", device=cuda)
    require(all(np.array_equal(a.table, r) for a, r in zip(answers, refs)),
            "mcm batch tables bit-equal to the plain wavefront route")
    require(all(check_decoded("mcm", i, a) for i, a in zip(insts, answers)),
            "mcm batch trees recompute to their optima")

    # MCM below the gate: a batch of 8 at n = 256 stays on K2
    small = [{"dims": mcm_dims(rng, MCM_SMALL_N)} for _ in range(MCM_BATCH)]
    require(dp.dispatch("mcm", reconstruct=True, device=cuda, **small[0]).name
            == "kernel_wavefront",
            f"dispatch(mcm n={MCM_SMALL_N}, reconstruct) -> kernel_wavefront")
    answers = measured(f"batch_solve mcm {MCM_BATCH} x n={MCM_SMALL_N} reconstruct",
                       lambda: dp.batch_solve("mcm", small, reconstruct=True, device=cuda))
    values = dp.batch_solve("mcm", small, device=cuda)
    refs = dp.batch_solve_specs([dp.get_problem("mcm").encode(**i) for i in small],
                                backend="wavefront", device=cuda)
    require(all(np.array_equal(a.table, r) and a.value == v
                for a, r, v in zip(answers, refs, values)),
            f"mcm batch n={MCM_SMALL_N} tables bit-equal to the plain wavefront route, "
            "values equal without reconstruction")
    require(all(check_decoded("mcm", i, a) for i, a in zip(small, answers)),
            f"mcm batch n={MCM_SMALL_N} trees recompute to their optima")

    for name, inst in other_instances(np.random.default_rng(SEED)).items():
        prob = dp.get_problem(name)
        spec = prob.encode(**inst)
        route = dp.dispatch(spec, reconstruct=True, device=cuda).name
        require(route == EXPECTED_ROUTES[name], f"dispatch({name} n={spec.n}, "
                f"reconstruct) -> {EXPECTED_ROUTES[name]} (got {route})")
        ans = measured(f"solve {name} (n={spec.n}) via {route}",
                       lambda: dp.solve(name, reconstruct=True, device=cuda, **inst))
        if name in ("optimal_bst", "polygon_triangulation"):   # O(n^3) oracles
            ref = prob.extract(dp.solve_spec(spec, backend="wavefront", device=cuda), spec)
            what = "the plain wavefront route on the card"
        else:
            ref = prob.extract(prob.oracle(**inst), spec)
            what = "the numpy oracle"
        print(f"  value {ans.value}")
        require(close(ans.value, ref), f"{name} value matches {what}")
        require(check_decoded(name, inst, ans), f"{name} decoded solution "
                "recomputes to the optimum")
        if name == "optimal_bst":      # args without the walk: K4's arg twin
            _, args, source = dp.routing.solve_spec_with_args(spec, device=cuda)
            require(source == "device" and np.array_equal(args, ans.args),
                    "optimal_bst args without the walk equal the fused route's")
    poly = other_instances(np.random.default_rng(SEED))["polygon_triangulation"]
    value = dp.solve("polygon_triangulation", device=cuda, **poly)
    require(close(value, dp.solve("polygon_triangulation", reconstruct=True,
                                  device=cuda, **poly).value),
            "polygon_triangulation value without reconstruction matches")

    # one cell per step without reconstruction: a kernel route, not the
    # host-looped pipeline
    edit = other_instances(np.random.default_rng(SEED))["edit_distance"]
    espec = dp.get_problem("edit_distance").encode(**edit)
    require(dp.dispatch(espec, device=cuda).name == "kernel_blocked",
            f"dispatch(edit_distance n={espec.n}) -> kernel_blocked")
    value = measured(f"solve edit_distance n={espec.n} without reconstruction",
                     lambda: dp.solve("edit_distance", device=cuda, **edit))
    require(value == dp.solve("edit_distance", reconstruct=True, device=cuda, **edit).value,
            "edit_distance value without reconstruction matches")

    # edit_distance on two 2048-long strings: 4.2 M cells stream through K3
    rs = np.random.default_rng(SEED)
    long = {"x": rs.integers(0, 4, EDIT_BIG_N), "y": rs.integers(0, 4, EDIT_BIG_N)}
    lspec = dp.get_problem("edit_distance").encode(**long)
    require(dp.dispatch(lspec, reconstruct=True, device=cuda).name == "kernel_tiled",
            f"dispatch(edit_distance n={lspec.n}, reconstruct) -> kernel_tiled")
    ans = measured(f"solve edit_distance {EDIT_BIG_N} x {EDIT_BIG_N} reconstruct",
                   lambda: dp.solve("edit_distance", reconstruct=True, device=cuda, **long))
    grid_value = dp.solve("edit_distance_grid", device=cuda, **long)
    require(ans.value == grid_value, f"edit_distance {EDIT_BIG_N}^2 equals "
            f"edit_distance_grid (K6) on the same strings ({ans.value} == {grid_value})")
    require(check_decoded("edit_distance", long, ans), f"edit_distance {EDIT_BIG_N}^2 "
            "script turns x into y at its cost")
    print(f"main path: {time.perf_counter() - t_all:.2f} s")
    return mcm_table


# ---------------------------------------------------------------------------
# The grid family (K6)
# ---------------------------------------------------------------------------
def cky_instance(rng, n: int, P: int, V: int, n_rules: int) -> dict:
    """A random PCFG in Chomsky normal form: rule r rewrites nonterminal
    r mod P (so every plane is targeted) into two random nonterminals;
    log-probabilities -U(0.3, 2.5)."""
    rules = [(r % P, int(b), int(c))
             for r, (b, c) in enumerate(rng.integers(0, P, (n_rules, 2)))]
    return {"tokens": rng.integers(0, V, n), "rules": rules,
            "rule_logp": -rng.uniform(0.3, 2.5, n_rules),
            "lex": -rng.uniform(0.3, 2.5, (P, V))}


def grid_instances(rng) -> dict:
    """The grid path's instances: DNA pairs for the alignments, the linear
    problems' 512-long strings for the grid twins, a PCFG chart for cky."""
    x, y = rng.integers(0, 4, ALIGN_N), rng.integers(0, 4, ALIGN_N)
    others = other_instances(np.random.default_rng(SEED))
    return {"needleman_wunsch": {"x": x, "y": y}, "gotoh": {"x": x, "y": y},
            "edit_distance_grid": others["edit_distance"],
            "lcs_grid": others["lcs"],
            "cky": cky_instance(rng, CKY["n"], CKY["P"], CKY["V"], CKY["rules"])}


def align_batch() -> list:
    """The batch leg: needleman_wunsch pairs of one shape, from the seed."""
    pairs = np.random.default_rng(SEED).integers(0, 4, (ALIGN_BATCH, 2, ALIGN_BATCH_N))
    return [{"x": x, "y": y} for x, y in pairs]


def alignment_score(ops, inst: dict, affine: bool) -> tuple:
    """(ops consume x and y in order, score) of an alignment script, scored
    with the zoo's default scores (match 2, mismatch -1; gap -2, or affine
    gaps opening at -3 and extending at -1, one opening per maximal run)."""
    x, y = inst["x"], inst["y"]
    gap_open, gap_extend = (-3.0, -1.0) if affine else (-2.0, -2.0)
    i = j = 0
    score, ok, prev = 0.0, True, None
    for op in ops:
        if op[0] == "align":
            ok &= op[1] == i and op[2] == j and i < len(x) and j < len(y)
            score += 2.0 if ok and x[i] == y[j] else -1.0
            i, j = i + 1, j + 1
        else:
            ok &= op[1] == (i if op[0] == "del" else j)
            score += gap_extend if prev == op[0] else gap_open
            i, j = (i + 1, j) if op[0] == "del" else (i, j + 1)
        prev = op[0]
    return ok and i == len(x) and j == len(y), score


def cky_tree_logp(tree, inst: dict) -> float:
    """Log-probability of a parse tree: lexical scores at the leaves, the
    best rule of each internal node's (A, B, C) triple."""
    if len(tree) == 2:
        return float(inst["lex"][tree[0], inst["tokens"][tree[1]]])
    a, left, right = tree
    lp = max(float(w) for (ra, rb, rc), w in zip(inst["rules"], inst["rule_logp"])
             if (ra, rb, rc) == (a, left[0], right[0]))
    return lp + cky_tree_logp(left, inst) + cky_tree_logp(right, inst)


def check_grid_decoded(name: str, inst: dict, ans) -> bool:
    sol = ans.solution
    if name in ("needleman_wunsch", "gotoh"):
        ok, score = alignment_score(sol["ops"], inst, affine=name == "gotoh")
        return ok and close(score, ans.value)
    if name == "cky":
        return close(cky_tree_logp(sol["tree"], inst), ans.value)
    return check_decoded({"edit_distance_grid": "edit_distance",
                          "lcs_grid": "lcs"}[name], inst, ans)


def antidiag_candidates(spec) -> int:
    """(move, cell) pairs the recurrence folds: cells not preset in the
    move's target plane whose source lies in the grid."""
    return sum(int((spec.init_mask[p, di:, dj:] == 0).sum())
               for p, _, di, dj in spec.moves)


def k6_records(schedule: str, arrs, meta, label: str, in_bytes: int,
               out_bytes: int, ops: int, reps: int) -> list:
    """Both K6 twins of one schedule against one call of the plain version
    (which computes the args either way, so its one time serves both)."""
    want, plain = timed_once(lambda: k6.grid_pipeline_plain(arrs, meta, with_args=True))
    records = []
    for with_args in (False, True):
        name = f"grid_pipeline_{schedule}" + ("_with_args" if with_args else "")
        fn = k6.grid_pipeline_with_args if with_args else k6.grid_pipeline
        got = fn(arrs, meta)
        table = got[0] if with_args else got
        same = torch.equal(table, want[0]) and (not with_args or torch.equal(got[1], want[1]))
        require(same, f"{name} {label}: table{' and args' if with_args else ''} "
                "bit-equal to plain")
        ms = cuda_ms(lambda: fn(arrs, meta), reps=reps)
        records.append(kernel_record(
            name, "src/repro_torch/csrc/grid_pipeline.cu",
            "src/repro/kernels/grid_pipeline.py:" + ("268" if with_args else "259"),
            max_err(table, want[0]), ms, plain,
            in_bytes + out_bytes * (2 if with_args else 1), ops))
        del got, table
    return records


def phase_grid_kernels(cuda) -> list:
    """K6 against its plain version on the same CUDA tensors: antidiag at
    gotoh 4096^2 (plus a batch of 8 needleman_wunsch 1024^2), spandiag at
    the cky chart."""
    t0 = time.perf_counter()
    insts = grid_instances(np.random.default_rng(SEED))
    specs = [dp.get_problem("needleman_wunsch").encode(**i) for i in align_batch()]
    barrs = tuple(torch.from_numpy(np.stack(slot)).to(cuda)
                  for slot in zip(*(s.device_arrays() for s in specs)))
    gt, ga = k6.grid_pipeline_with_args(barrs, specs[0].static_meta())
    wt, wa = k6.grid_pipeline_plain(barrs, specs[0].static_meta(), with_args=True)
    require(torch.equal(gt, wt) and torch.equal(ga, wa),
            f"grid_pipeline_antidiag_with_args batch {ALIGN_BATCH} x "
            f"needleman_wunsch {ALIGN_BATCH_N}^2: table and args bit-equal to plain")
    del barrs, gt, ga, wt, wa

    spec = dp.get_problem("gotoh").encode(**insts["gotoh"])
    arrs = tuple(torch.from_numpy(a).to(cuda) for a in spec.device_arrays())
    P, RC, L = spec.planes, spec.cells, len(spec.moves)
    records = k6_records("antidiag", arrs, spec.static_meta(), f"gotoh {spec.rows}^2",
                         4 * (L + 2 * P) * RC, 4 * P * RC, 2 * antidiag_candidates(spec),
                         reps=3)
    del arrs
    torch.cuda.empty_cache()

    cspec = dp.get_problem("cky").encode(**insts["cky"])
    carrs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                  for a in cspec.device_arrays())
    n, NR, P = cspec.rows, len(cspec.rules), cspec.planes
    in_bytes, ops = 4 * (NR + P * n), spandiag_work(cspec, False)[1]
    records += k6_records("spandiag", carrs, cspec.static_meta(),
                          f"cky n={n} P={P} rules={NR}", in_bytes,
                          spandiag_work(cspec, False)[0] - in_bytes, ops, reps=5)
    print(f"grid kernels phase: {time.perf_counter() - t0:.2f} s")
    return records


def phase_grid(cuda) -> None:
    """The grid family through the public entry points on the card."""
    t_all = time.perf_counter()
    insts = grid_instances(np.random.default_rng(SEED))
    answers = {}
    for name, inst in insts.items():
        prob = dp.get_problem(name)
        spec = prob.encode(**inst)
        require(dp.dispatch(spec, reconstruct=True, device=cuda).name == "kernel_grid",
                f"dispatch({name}, reconstruct) -> kernel_grid")
        t0 = time.perf_counter()
        ans = answers[name] = dp.solve(name, reconstruct=True, device=cuda, **inst)
        print(f"solve {name} ({spec.planes} x {spec.rows} x {spec.cols}) reconstruct: "
              f"{time.perf_counter() - t0:.2f} s (encode included), value {ans.value}")
        t0 = time.perf_counter()
        plain = dp.solve_spec(spec, backend="grid_wavefront", device=cuda)
        print(f"  plain grid_wavefront route: {time.perf_counter() - t0:.2f} s")
        require(np.array_equal(ans.table, plain), f"{name} table bit-equal to the "
                "plain grid_wavefront route on the card")
        require(check_grid_decoded(name, inst, ans), f"{name} decoded solution "
                "recomputes to the optimum")
        del spec, plain

    # values against the numpy oracles, at a reduced size where they are loops
    m = ALIGN_ORACLE_N
    small = {"needleman_wunsch": {k: v[:m] for k, v in insts["needleman_wunsch"].items()},
             "gotoh": {k: v[:m] for k, v in insts["gotoh"].items()},
             "cky": cky_instance(np.random.default_rng(SEED), CKY_ORACLE["n"],
                                 CKY_ORACLE["P"], CKY_ORACLE["V"], CKY_ORACLE["rules"]),
             "edit_distance_grid": insts["edit_distance_grid"],
             "lcs_grid": insts["lcs_grid"]}
    for name, inst in small.items():
        prob = dp.get_problem(name)
        ans = dp.solve(name, reconstruct=True, device=cuda, **inst)
        ref = prob.extract(prob.oracle(**inst), prob.encode(**inst))
        require(close(ans.value, ref), f"{name} value matches the numpy oracle "
                f"({'reduced' if inst is not insts[name] else 'full'} size)")
        require(check_grid_decoded(name, inst, ans), f"{name} decoded solution "
                "recomputes to the optimum (oracle size)")
    # the linear twins, through their kernel route
    for grid, linear in (("edit_distance_grid", "edit_distance"), ("lcs_grid", "lcs")):
        value = dp.solve(linear, device=cuda, **insts[grid])
        require(answers[grid].value == value, f"{grid} equals {linear} on the same "
                f"strings ({answers[grid].value} == {value})")

    batch = align_batch()
    before = k6.LAUNCHES["grid_pipeline_antidiag_with_args"]
    t0 = time.perf_counter()
    got = dp.batch_solve("needleman_wunsch", batch, reconstruct=True, device=cuda)
    print(f"batch_solve needleman_wunsch {ALIGN_BATCH} x {ALIGN_BATCH_N} reconstruct: "
          f"{time.perf_counter() - t0:.2f} s (encode included)")
    require(k6.LAUNCHES["grid_pipeline_antidiag_with_args"] - before == 1,
            "needleman_wunsch batch is one launch")
    refs = dp.batch_solve_specs([dp.get_problem("needleman_wunsch").encode(**i)
                                 for i in batch], backend="grid_wavefront", device=cuda)
    require(all(np.array_equal(a.table, r) for a, r in zip(got, refs)),
            "needleman_wunsch batch tables bit-equal to the plain grid_wavefront route")
    require(all(check_grid_decoded("needleman_wunsch", i, a) for i, a in zip(batch, got)),
            "needleman_wunsch batch alignments rescore to their optima")

    # without reconstruction, dispatch takes the kernels' table-only twins
    for name in ("needleman_wunsch", "cky"):
        value = dp.solve(name, device=cuda, **insts[name])
        require(value == answers[name].value, f"{name} value without reconstruction "
                "matches")
    print(f"grid path: {time.perf_counter() - t_all:.2f} s")


# ---------------------------------------------------------------------------
# The blocked MCM route (K5)
# ---------------------------------------------------------------------------
def k5_path_operands(cuda, dims: np.ndarray) -> tuple:
    """Operands at the blocked route's largest K5 launch for MCM n = 1024
    (block diagonal D = nt / 2: nt - D blocks of (T x K) by (K x T), K =
    (D - 1) T): table values random integers, weights the dims as the
    route slices them."""
    T = BLOCKED_TILE
    nt = MCM_N // T
    D = nt // 2
    nb, K = nt - D, (D - 1) * T
    rng = np.random.default_rng(SEED)
    p = torch.from_numpy(dims).float().to(cuda)
    a = torch.from_numpy(rng.integers(0, 10 ** 7, (nb, T, K)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 10 ** 7, (nb, K, T)).astype(np.float32)).to(cuda)
    av = p[:nb * T].reshape(nb, T)
    gv = p[T + 1:].unfold(0, K, T)[:nb].contiguous()
    bv = p[D * T + 1:D * T + 1 + nb * T].reshape(nb, T)
    return f"MCM n={MCM_N} D={D}: {nb} x ({T} x {K}) by ({K} x {T})", (a, b, av, gv, bv)


def phase_semiring_kernels(cuda, dims: np.ndarray) -> list:
    """K5 against its plain version on the same CUDA tensors, bit for bit:
    at the blocked path's largest launch and at one weighted 1024^3
    square."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    m = K5_SQUARE
    square = tuple(torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (
        rng.normal(size=(m, m)), rng.normal(size=(m, m)), rng.uniform(1, 3, m),
        rng.uniform(1, 3, m), rng.uniform(1, 3, m)))
    records = []
    for name, (label, args) in (("tropical_matmul", k5_path_operands(cuda, dims)),
                                ("tropical_matmul_square",
                                 (f"weighted {m}^3", square))):
        got = k5.tropical_matmul(*args)
        want, plain = timed_once(lambda: k5.tropical_matmul_plain(*args))
        require(torch.equal(got, want), f"{name} {label}: bit-equal to plain")
        ms = cuda_ms(lambda: k5.tropical_matmul(*args), reps=5)
        _, host_ms, groups = device_profile(
            lambda: [k5.tropical_matmul(*args) for _ in range(5)])
        describe_profile(f"{name}: 5 launches", host_ms, groups)
        nbytes, ops = k5_work(args)
        records.append(kernel_record(name, "src/repro_torch/csrc/semiring_matmul.cu",
                                     "src/repro/kernels/semiring_matmul.py:57",
                                     max_err(got, want), ms, plain, nbytes, ops))
        del got, want
    print(f"semiring kernels phase: {time.perf_counter() - t0:.2f} s")
    return records


#: every K5 launch of the blocked path (phase_blocked) by shape: (n, batch,
#: block diagonal D, launches of that shape). MCM 1024's D = 2..63 launch
#: three times (the reconstruct solve, the head-to-head's solve and its
#: profile), batch_solve MCM 8 x 256's D = 2..15 once.
K5_PATH_SHAPES = [(MCM_N, 1, D, 3) for D in range(2, MCM_N // BLOCKED_TILE)] + [
    (MCM_SMALL_N, MCM_BATCH, D, 1) for D in range(2, MCM_SMALL_N // BLOCKED_TILE)]
#: launches per shape under the profiler
K5_REPS = 5


def k5_route_operands(table, p, D: int) -> tuple:
    """K5's operands at block diagonal ``D`` of the blocked route over an
    (batch, n, n) table with dims ``p`` (batch, n + 1), as the route slices
    them, flattened into contiguous (batch * blocks, ..) tensors (the form
    every tree's K5 takes)."""
    T = BLOCKED_TILE
    bt, n = table.shape[0], table.shape[-1]
    nb, K = n // T - D, (D - 1) * T
    a = table.as_strided((bt, nb, T, K), (n * n, T * (n + 1), n, 1), T)
    b = table.as_strided((bt, nb, K, T), (n * n, T * (n + 1), n, 1), (T + 1) * n + D * T)
    av = p[:, :nb * T].reshape(bt, nb, T)
    gv = p[:, T + 1:].unfold(1, K, T)[:, :nb]
    bv = p[:, D * T + 1:D * T + 1 + nb * T].reshape(bt, nb, T)
    return tuple(x.reshape(bt * nb, *x.shape[2:]).contiguous() for x in (a, b, av, gv, bv))


def k5_work(args) -> tuple:
    """(bytes, operations) of one K5 launch: every operand read once, C
    written once; per candidate an add, a fused multiply-add (2) and a
    min, plus av*gv once per (i, k)."""
    a, b = args[0], args[1]
    bt = a.shape[0] if a.dim() == 3 else 1
    mm, kk, nn = a.shape[-2], a.shape[-1], b.shape[-1]
    return 4 * bt * (mm * kk + kk * nn + mm + kk + nn + mm * nn), bt * (4 * mm * kk * nn + mm * kk)


def k5_profiled_ms(runs: list) -> list:
    """Device ms per launch of each of ``runs`` (callables that launch K5
    once), ``K5_REPS`` launches each under ``torch.profiler``, a marker
    kernel after each run's launches: K5's kernel events in start order,
    split at the markers, averaged per run (the profiler may drop an
    event; the average is over those it kept). Empty if the profiler saw
    no K5 event (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for run in runs:
            for _ in range(K5_REPS):
                run()
            marker.add_(1)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    groups, cur = [], []
    for e in events:
        if "tropical_matmul" in e.name.lower():
            cur.append(e.time_range.elapsed_us())
        elif "memcpy" not in e.name.lower() and "memset" not in e.name.lower():
            groups.append(cur)
            cur = []
    if not any(groups):
        return []
    require(len(groups) == len(runs) and all(groups), f"K5 under the profiler: "
            f"{sum(map(len, groups))} kernel events in {len(groups)} runs for {len(runs)}")
    return [sum(g) / len(g) / 1e3 if g else float("nan") for g in groups[:len(runs)]]


def phase_k5_shapes(cuda, records: list, dims: np.ndarray) -> list:
    """K5 at every shape the blocked path launches (K5_PATH_SHAPES) on the
    route's operands (random table values, the path's dims), each held
    against the plain version bit for bit, timed by the profiler (device
    time a launch) and by CUDA events (the wrapper's pace), with its
    bound; the K5 record's ``path_ms`` is the profiled device time x
    launches summed over the shapes. Returns the shape rows."""
    t0 = time.perf_counter()
    rng, small = np.random.default_rng(SEED), np.random.default_rng(SEED + 1)
    tables = {}
    for n, bt in ((MCM_N, 1), (MCM_SMALL_N, MCM_BATCH)):   # phase_blocked's dims
        p = np.stack([dims] if bt == 1 else [mcm_dims(small, n) for _ in range(bt)])
        tables[n, bt] = (torch.from_numpy(rng.integers(0, 10 ** 7, (bt, n, n))
                                          .astype(np.float32)).to(cuda),
                         torch.from_numpy(p.astype(np.float32)).to(cuda))
    rows, runs = [], []
    for n, bt, D, count in K5_PATH_SHAPES:
        args = k5_route_operands(*tables[n, bt], D)
        got = k5.tropical_matmul(*args)
        label = f"mcm {n} D={D}" if bt == 1 else f"mcm {bt} x {n} D={D}"
        require(torch.equal(got, k5.tropical_matmul_plain(*args)),
                f"tropical_matmul at {label} {tuple(args[0].shape)} by "
                f"{tuple(args[1].shape)}: bit-equal to plain")
        b, _ = bound_ms(*k5_work(args))
        rows.append({"shape": label, "launches": count, "bound_ms": b,
                     "event_ms": cuda_ms(lambda a=args: k5.tropical_matmul(*a), reps=K5_REPS)})
        runs.append(lambda a=args: k5.tropical_matmul(*a))
    device = k5_profiled_ms(runs)
    for row, ms in zip(rows, device or [None] * len(rows)):
        row["ms"] = ms
        shown = "not measured" if ms is None else f"{ms:.4f} ms"
        print(f"tropical_matmul at {row['shape']}: device {shown} x {row['launches']}, "
              f"events {row['event_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms")
    rec = next(r for r in records if r["name"] == "tropical_matmul")
    rec["path_ms"] = sum(r["ms"] * r["launches"] for r in rows) if device else None
    event_path = sum(r["event_ms"] * r["launches"] for r in rows)
    mcm1024 = [r for r in rows if r["shape"].startswith(f"mcm {MCM_N} ")]
    print(f"tropical_matmul: path_ms {rec['path_ms']} (profiler device time x launches over "
          f"{len(rows)} shapes, {sum(r['launches'] for r in rows)} launches); CUDA events "
          f"{event_path:.3f} ms; MCM {MCM_N}'s {len(mcm1024)} shapes once each: device "
          f"{sum(r['ms'] for r in mcm1024) if device else 'not measured'} ms, events "
          f"{sum(r['event_ms'] for r in mcm1024):.3f} ms")
    del tables
    print(f"K5 shapes phase: {time.perf_counter() - t0:.2f} s")
    return rows


#: device-time groups of the blocked path's profile: group -> name parts
BLOCKED_GROUPS = {"tropical_matmul": ("tropical_matmul",), "mcm_tiled": ("mcm_tiled",),
                  "memcpy": ("memcpy",)}
#: the LM path's: K7, the matrix products (cuBLAS names: gemm, nvjet,
#: xmma, cutlass), copies
LM_GROUPS = {"flash_attention (K7)": ("flash_attention",),
             "matmul": ("gemm", "nvjet", "xmma", "cutlass"), "memcpy": ("memcpy",)}


def device_profile(fn, keys: dict = BLOCKED_GROUPS, cpu: bool = True) -> tuple:
    """``(fn(), host ms, {group: device ms})`` of one call under
    ``torch.profiler``: the CUDA activity it recorded, summed by name into
    the groups of ``keys`` (a group takes a kernel whose lower-case name
    holds one of its parts) and other kernels. An empty dict means the
    profiler saw no device activity (not measured). ``cpu=False`` records
    the device alone, for a long call whose host ops would swell the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    t_start = time.perf_counter()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    t_stop = time.perf_counter()
    groups: dict = {}
    # the recorded activity as it came (building the profiler's event tree
    # takes seconds on a long call)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().lower()
            key = next((k for k, parts in keys.items() if any(p in name for p in parts)),
                       "other kernels")
            groups[key] = groups.get(key, 0.0) + e.duration_ns() / 1e6
    start_s = t0 - t_start
    stop_s = time.perf_counter() - t0 - host_ms / 1e3
    if start_s + stop_s > 1.0:
        print(f"  the profiler's own time: {start_s:.2f} s to start, {stop_s:.2f} s to "
              "stop and read")
    return out, host_ms, groups


def describe_profile(label: str, host_ms: float, groups: dict) -> None:
    if not groups:
        print(f"{label}: host {host_ms:.3f} ms under the profiler; device time not "
              "measured (the profiler recorded no CUDA activity)")
        return
    busy = sum(groups.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(groups.items()))
    print(f"{label}: host {host_ms:.3f} ms under the profiler; device busy "
          f"{busy:.3f} ms ({parts}); device idle share {1 - busy / host_ms:.4f}")


def phase_blocked(cuda, dims: np.ndarray, k4_table: np.ndarray) -> None:
    """The blocked MCM route through the public entry points on the card:
    the main path's MCM n = 1024 against K4's table, a batch of 8 at
    n = 256, and the head-to-head with ``kernel_tiled_wavefront``."""
    t_all = time.perf_counter()
    prob = dp.get_problem("mcm")
    t0 = time.perf_counter()
    spec = prob.encode(dims=dims)
    encode_s = time.perf_counter() - t0
    ranking = [b.name for b in dp.backends.candidates(spec, cuda)]
    print(f"mcm n={MCM_N} ranking on the card: {ranking}")
    plain = [r for r in ranking if not dp.backends.get(r).kernel]
    require(plain[:2] == ["blocked_mcm", "wavefront"] and ranking[0] == "kernel_tiled_wavefront",
            f"mcm n={MCM_N}: blocked_mcm ranks behind the kernel routes, ahead of wavefront")
    ans = measured(f"solve mcm n={MCM_N} via blocked_mcm reconstruct (encode included)",
                   lambda: dp.solve("mcm", dims=dims, backend="blocked_mcm",
                                    reconstruct=True, device=cuda))
    print(f"  value {ans.value}")
    require(np.array_equal(ans.table, k4_table), f"blocked_mcm n={MCM_N} table bit-equal "
            "to kernel_tiled_wavefront's")
    require(check_decoded("mcm", {"dims": dims}, ans), f"blocked_mcm n={MCM_N} tree "
            "recomputes to the optimum")

    rng = np.random.default_rng(SEED + 1)
    insts = [{"dims": mcm_dims(rng, MCM_SMALL_N)} for _ in range(MCM_BATCH)]
    before = k5.LAUNCHES["tropical_matmul"]
    answers = measured(f"batch_solve mcm {MCM_BATCH} x n={MCM_SMALL_N} via blocked_mcm "
                       "reconstruct",
                       lambda: dp.batch_solve("mcm", insts, backend="blocked_mcm",
                                              reconstruct=True, device=cuda))
    require(k5.LAUNCHES["tropical_matmul"] - before == MCM_SMALL_N // BLOCKED_TILE - 2,
            "mcm blocked batch: one K5 launch per block diagonal past the first")
    refs = dp.batch_solve_specs([prob.encode(**i) for i in insts], backend="wavefront",
                                device=cuda)
    require(all(np.array_equal(a.table, r) for a, r in zip(answers, refs)),
            f"mcm blocked batch n={MCM_SMALL_N} tables bit-equal to the plain wavefront route")
    require(all(check_decoded("mcm", i, a) for i, a in zip(insts, answers)),
            f"mcm blocked batch n={MCM_SMALL_N} trees recompute to their optima")

    # head-to-head at n = 1024: the two routes' solves after one shared
    # encode, then each under the profiler (device time by kernel group)
    tables = {}
    for name in ("kernel_tiled_wavefront", "blocked_mcm"):
        t0 = time.perf_counter()
        tables[name] = dp.solve_spec(spec, backend=name, device=cuda)
        print(f"head-to-head mcm n={MCM_N}: route {name} {time.perf_counter() - t0:.3f} s "
              f"(host, after the shared encode of {encode_s:.3f} s)")
        _, host_ms, groups = device_profile(
            lambda: dp.solve_spec(spec, backend=name, device=cuda))
        describe_profile(f"  route {name} under the profiler", host_ms, groups)
    require(np.array_equal(tables["blocked_mcm"], tables["kernel_tiled_wavefront"]),
            "blocked_mcm and kernel_tiled_wavefront routes agree bit for bit")
    print(f"blocked path: {time.perf_counter() - t_all:.2f} s")


# ---------------------------------------------------------------------------
# The LM serving path (K7) and the linear scan (K8)
# ---------------------------------------------------------------------------
def k7_record(name: str, q, k, v, reps: int) -> dict:
    """K7 against its plain version on bf16 (B, Hq, S, D) q and GQA k, v,
    which its rule sends to the tensor-core body, with the times of the
    kernel, the plain version (one call) and
    ``scaled_dot_product_attention`` (the yardstick: one PyTorch call, used
    nowhere in the port); then the CUDA-core body on the same tensors, its
    error and time printed beside. Bound: q, k, v read and o written once;
    4·D FLOP per unmasked (query, key) pair over the bf16 tensor-core
    peak."""
    require(k7.body_for(q, k, v) == k7.TENSOR_CORES,
            f"{name}: bf16 q, k, v take the tensor-core body")
    got = k7.flash_attention(q, k, v)
    want, plain = timed_once(lambda: k7.flash_attention_plain(q, k, v))
    err = max_err(got, want)
    require(err <= K7_TOL[q.dtype], f"{name} {tuple(q.shape)} by {tuple(k.shape)} "
            f"{q.dtype}: max_abs_err {err} within {K7_TOL[q.dtype]} of plain")
    old = k7._launch(q, k, v, True, k7.CUDA_CORES)
    old_err = max_err(old, want)
    require(old_err <= K7_TOL[q.dtype], f"{name}: CUDA-core body on the same tensors, "
            f"max_abs_err {old_err} within {K7_TOL[q.dtype]} of plain")
    del got, want, old
    ms = cuda_ms(lambda: k7.flash_attention(q, k, v), reps)
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps)
    old_ms = cuda_ms(lambda: k7._launch(q, k, v, True, k7.CUDA_CORES), max(1, reps // 5))
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    nbytes = q.element_size() * d * s * b * (2 * hq + 2 * hkv)
    flops = 4 * d * b * hq * s * (s + 1) // 2
    print(f"{name}: tensor-core body {ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s, "
          f"max_abs_err {err}; CUDA-core body {old_ms:.4f} ms, "
          f"{flops / old_ms / 1e9:.2f} TFLOP/s, max_abs_err {old_err}; SDPA {lib:.4f} ms, "
          f"{flops / lib / 1e9:.2f} TFLOP/s")
    return kernel_record(name, "src/repro_torch/csrc/flash_attention_tc.cu",
                         "src/repro/kernels/flash_attention.py:68", err, ms, plain,
                         nbytes, flops, peak=BF16_OPS_PER_S, library_ms=lib)


@contextlib.contextmanager
def replaced_config(model, **fields):
    """Run ``model`` with some config fields replaced (the compute dtype,
    the MoE capacity factor) on the same weights: each matmul casts its
    weight as it goes."""
    cfg = model.cfg
    new = dataclasses.replace(cfg, **fields)
    for m in (model, *model.layers):
        m.cfg = new
    try:
        yield new
    finally:
        for m in (model, *model.layers):
            m.cfg = cfg


def compute_dtype(model, dtype):
    """Run ``model`` with another compute dtype; None leaves it as it is."""
    return replaced_config(model, **({} if dtype is None else {"compute_dtype": dtype}))


def drop_free(model, dtype):
    """Another compute dtype and, for MoE configs, a capacity no token
    outgrows (``capacity_factor = n_experts``)."""
    cfg = model.cfg
    fields = {"compute_dtype": dtype}
    if cfg.moe is not None:
        fields["moe"] = dataclasses.replace(cfg.moe,
                                            capacity_factor=float(cfg.moe.n_experts))
    return replaced_config(model, **fields)


def heads_major(x):
    """(B, S, H, D) -> the (B, H, S, D) view the model hands to K7."""
    return x.transpose(1, 2)


def lm_traffic(cfg) -> tuple:
    """(prompt lengths, prompts) of the LM traffic from the seed: lengths in
    ``LM_PROMPT``, tokens in ``cfg``'s vocabulary."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, size=LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    return lengths, prompts


def init_model(cfg, cuda, label: str):
    """``CausalLM.from_seed`` on the card, its time and peak memory printed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    t0 = time.perf_counter()
    model = CausalLM.from_seed(cfg, seed=SEED, device=cuda)
    torch.cuda.synchronize()
    gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2 ** 30
    print(f"{label}: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} kv heads, hd {cfg.hd}, vocab {cfg.vocab_size}): "
          f"{cfg.param_count()} parameters, {gib:.2f} GiB {cfg.param_dtype}, "
          f"init from seed {SEED} on the card in {time.perf_counter() - t0:.2f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated(cuda) / 2 ** 30:.3f} GiB")
    return model


def serve_traffic(model, prompts, label: str, max_batch: int = LM_BATCH) -> tuple:
    """The prompts through ``Engine`` (``max_batch`` slots, ``LM_MAX_LEN``
    positions) and ``Scheduler``, ``LM_NEW`` tokens each, with the kernels'
    counters zeroed before and read after. Prints each request's prefill
    seconds and the traffic's line; returns (done by rid, engine, launches)."""
    cuda = model.device
    engine = Engine(model, max_batch=max_batch, max_len=LM_MAX_LEN)
    sched = Scheduler(engine)
    prefill_s, step_ms = {}, []
    admit, step = engine.admit, engine.step

    def timed_admit(req):   # the prefill ends in a host read of its token
        t0 = time.perf_counter()
        out = admit(req)
        prefill_s[req.rid] = time.perf_counter() - t0
        return out

    def timed_step():       # the step ends in a host read of its tokens
        t0 = time.perf_counter()
        out = step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.admit, engine.step = timed_admit, timed_step
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=LM_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    reset_launches()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated(cuda) / 2 ** 30
    engine.admit, engine.step = admit, step

    done = sorted(done, key=lambda r: r.rid)
    new_tokens = sum(len(r.out) for r in done)
    n_prompt = sum(len(p) for p in prompts)
    for r in done:
        print(f"  request {r.rid}: prompt {len(r.prompt)} tokens, prefill "
              f"{prefill_s[r.rid]:.3f} s, {len(r.out)} tokens {r.out[:6]}...")
    print(f"{label} traffic: {len(done)} requests, {new_tokens} new tokens and "
          f"{n_prompt} prompt tokens in {wall:.3f} s "
          f"({new_tokens / wall:.2f} new tokens/s, "
          f"{(new_tokens + n_prompt) / wall:.2f} tokens/s in all); "
          f"{engine.steps_run} decode steps, mean {np.mean(step_ms):.3f} ms, median "
          f"{np.median(step_ms):.3f} (min {min(step_ms):.3f}, max {max(step_ms):.3f}); prefill "
          f"{sum(prefill_s.values()):.3f} s in all; peak device memory {peak:.3f} GiB")
    require(len(done) == len(prompts) and all(len(r.out) == LM_NEW for r in done),
            f"{label}: all {len(prompts)} requests finished with {LM_NEW} tokens")
    require(all(0 <= t < model.cfg.vocab_size for r in done for t in r.out),
            f"{label}: every token lies in the vocabulary")
    return done, engine, counts


def require_k7_traffic(label: str, counts: dict, want: int, what: str) -> None:
    """K7's launches on a traffic: exactly ``want``, all on the tensor-core
    body."""
    require(counts["flash_attention"] == want,
            f"{label}: K7 launched {counts['flash_attention']} times on the traffic, "
            f"{what} (decode launches none)")
    require(counts["flash_attention_tc"] == counts["flash_attention"],
            f"{label}: {counts['flash_attention_tc']} of K7's {counts['flash_attention']} "
            "launches on the traffic ran the tensor-core body (all must)")


def layer0_input(model, tokens):
    """Layer 0's normed input (the mixer's) for a (1, S) prompt."""
    with torch.no_grad():
        return rmsnorm(model.embed_tokens(tokens), model.layers[0].ln1, model.cfg.norm_eps)


def layer0_qkv(model, tokens) -> tuple:
    """Layer 0's q, k, v for a (1, S) prompt, heads-major as K7 gets them."""
    s = tokens.shape[1]
    with torch.no_grad():
        h = layer0_input(model, tokens)
        return tuple(heads_major(t) for t in _project_qkv(
            model.layers[0].mixer, model.cfg, h, torch.arange(s, device=tokens.device)[None]))


def k7_float32_check(label: str, q, k, v, s: int) -> None:
    qf, kf, vf = (t.float() for t in (q, k, v))
    e32 = max_err(k7.flash_attention(qf, kf, vf), k7.flash_attention_plain(qf, kf, vf))
    require(e32 <= K7_TOL[torch.float32], f"flash_attention float32 at {label}'s "
            f"tensors (S {s}): max_abs_err {e32} within {K7_TOL[torch.float32]}")


def prefill_logits_check(model, tokens, rid: int, first_token: int, label: str = "lm") -> None:
    """The prefill logits of a served request through K7 and through the
    plain version. In bf16, rounding through many random layers spreads the
    plain version against itself (KV chunk 512 against 128) by more than
    3e-2 of max|logit|, so the bound is held in float32 compute on the same
    weights, where it measures K7; the bf16 numbers are printed beside that
    floor, and the argmax must agree wherever the plain logits' top-2
    margin exceeds the bound."""
    s = tokens.shape[1]

    def logits_via(attention):
        with mock.patch.object(ops, "flash_attention", attention):
            return model.prefill(tokens)[0]

    def plain_at(chunk):
        return (lambda q, k, v, causal=True:
                k7.flash_attention_plain(q, k, v, causal=causal, chunk=chunk))

    logits_k = logits_via(ops.flash_attention)
    require(int(logits_k[0].argmax()) == first_token,
            f"{label} request {rid}: served first token equals the prefill's argmax")
    for how, dtype in (("bf16 as served", None), ("float32 compute", torch.float32)):
        with compute_dtype(model, dtype):
            lk = logits_via(ops.flash_attention) if dtype else logits_k
            lp = logits_via(plain_at(k7.PLAIN_CHUNK))
            floor = max_err(lp, logits_via(plain_at(128)))
        tol = LOGITS_RTOL * float(lp.abs().max())
        err = max_err(lk, lp)
        print(f"{label} prefill logits, {how} (request {rid}, S {s}): max |logit| "
              f"{float(lp.abs().max())}; K7 vs plain max_abs_err {err}, mean "
              f"{float((lk - lp).abs().mean())}; plain chunk 512 vs 128 {floor}")
        if dtype is not None:
            require(err <= tol, f"{label} prefill logits, {how}: K7 vs plain max_abs_err "
                    f"{err} within {tol}")
        top2 = lp[0].topk(2).values
        margin = float(top2[0] - top2[1])
        if margin > tol:
            require(int(lk[0].argmax()) == int(lp[0].argmax()),
                    f"{label} prefill argmax agrees, {how} (plain top-2 margin {margin} > {tol})")
        else:
            print(f"{label} prefill, {how}: plain top-2 margin {margin} within {tol}; "
                  "argmax not compared")


def profile_prefill_and_decode(model, engine, tokens, rid: int, label: str,
                               groups: dict = LM_GROUPS) -> None:
    """Where the time goes: one prefill of a served prompt and one decode
    step of the engine's slots, under ``torch.profiler``."""
    cuda = model.device
    _, host_ms, by = device_profile(lambda: model.prefill(tokens), groups)
    describe_profile(f"{label} prefill S {tokens.shape[1]} (request {rid})", host_ms, by)
    tok = torch.zeros((engine.b, 1), dtype=torch.int64, device=cuda)
    pos = torch.as_tensor(engine.pos, dtype=torch.int64, device=cuda)
    _, host_ms, by = device_profile(lambda: model.decode_step(tok, engine.cache, pos), groups)
    describe_profile(f"{label} decode step, batch {engine.b}, positions "
                     f"{engine.pos.tolist()}", host_ms, by)


def phase_lm(cuda) -> tuple:
    """The LM serving path through the port's entry points: qwen3-14b at its
    published width from seed 0 on the card, 8 requests through the
    Engine and Scheduler. K7's counter is zeroed before the traffic and
    read after it; the checks after it (K7 at a served prompt's tensors,
    the prefill logits through the kernel against the plain version) run
    outside that count. Returns (records, launches of the traffic)."""
    t_all = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = init_model(cfg, cuda, "lm")
    lengths, prompts = lm_traffic(cfg)
    require(any(n % 64 for n in lengths), f"lm prompt lengths {lengths.tolist()}: "
            "at least one not a multiple of 64")
    done, engine, counts = serve_traffic(model, prompts, "lm")
    require_k7_traffic("lm", counts, cfg.n_layers * LM_REQUESTS,
                       f"{cfg.n_layers} x {LM_REQUESTS} prefills")

    # K7 at one served prompt's real tensors (layer 0), bf16 and float32
    rid = next(i for i, n in enumerate(lengths) if n % 64)
    s = int(lengths[rid])
    tokens = torch.as_tensor(prompts[rid], dtype=torch.int64, device=cuda)[None]
    q, k, v = layer0_qkv(model, tokens)
    records = [k7_record("flash_attention", q, k, v, reps=10)]
    k7_float32_check(f"request {rid}", q, k, v, s)
    del q, k, v

    prefill_logits_check(model, tokens, rid, done[rid].out[0])
    # where the time goes: one prefill and one decode step of the 4 slots
    profile_prefill_and_decode(model, engine, tokens, rid, "lm")

    del model, engine, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # K7 at one layer of prefill_32k (B 1, S 32768), and at the other head
    # dims with GQA in both dtypes
    g = torch.Generator(device=cuda).manual_seed(SEED)
    q, k, v = (heads_major(torch.randn((1, LONG_S, hh, cfg.hd), generator=g, device=cuda)
                           .to(torch.bfloat16)) for hh in (cfg.n_heads, cfg.n_kv_heads,
                                                           cfg.n_kv_heads))
    records.append(k7_record("flash_attention_32k", q, k, v, reps=2))
    del q, k, v
    for d in (16, 96, 160):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (heads_major(torch.randn((2, 999, hh, d), generator=g, device=cuda)
                                   .to(dt)) for hh in (12, 3, 3))
            body = k7.body_for(q, k, v)
            before = k7.LAUNCHES["flash_attention_tc"]
            e = max_err(k7.flash_attention(q, k, v), k7.flash_attention_plain(q, k, v))
            ran_tc = k7.LAUNCHES["flash_attention_tc"] - before == 1
            require(ran_tc == (dt == torch.bfloat16) == (body == k7.TENSOR_CORES),
                    f"flash_attention hd {d} {dt}: ran the {body} body")
            require(e <= K7_TOL[dt], f"flash_attention hd {d} GQA 12/3 S 999 {dt} "
                    f"({body} body): max_abs_err {e} within {K7_TOL[dt]}")
    torch.cuda.empty_cache()
    print(f"lm path: {time.perf_counter() - t_all:.2f} s")
    return records, counts


#: device-time groups of the MoE and SSM phases' profiles: the LM path's
#: and the top-k sort, the slot cumsum and the dispatch's gathers and scatters
FAMILY_GROUPS = {**LM_GROUPS, "sort (top-k)": ("sort", "radix"), "scan (cumsum)": ("scan",),
                 "gather / scatter": ("index", "scatter", "gather")}


def moe_dense_oracle(p, cfg, x):
    """The MoE block with every expert computing every token (as
    ``tests/test_models.py::moe_oracle``): no capacity, no dispatch; the
    chosen experts' outputs combined by one weighted product."""
    m, cd = cfg.moe, cfg.compute_dtype
    tokens = x.reshape(-1, x.shape[-1])
    probs = torch.softmax((tokens @ p["router"].to(cd)).float(), dim=-1)
    top_w, top_e = moe.top_k(probs, m.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    g = torch.einsum("nd,edf->enf", tokens, p["w_gate"].to(cd))
    u = torch.einsum("nd,edf->enf", tokens, p["w_up"].to(cd))
    y = torch.einsum("enf,efd->end", silu(g) * u, p["w_down"].to(cd))
    picked = y.permute(1, 0, 2)[torch.arange(tokens.shape[0], device=x.device)[:, None], top_e]
    out = torch.einsum("nk,nkd->nd", top_w.to(cd), picked)
    if m.dense_residual:
        gg = silu(tokens @ p["res_gate"].to(cd)) * (tokens @ p["res_up"].to(cd))
        out = out + gg @ p["res_down"].to(cd)
    return out.reshape(x.shape)


def moe_layer0_input(model, tokens):
    """The MoE input of layer 0 (attention, then the second norm) for a
    (1, S) prompt."""
    cfg, blk = model.cfg, model.layers[0]
    with torch.no_grad():
        h = layer0_input(model, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = model.embed_tokens(tokens) + attn_forward(blk.mixer, cfg, h, pos)[0]
        return rmsnorm(x, blk.ln2, cfg.norm_eps)


def decode_against_prefill(model, prompt, label: str, steps: int = 3) -> None:
    """Prefill of the first T tokens, then ``steps`` decode steps on the next
    ones, each against the last logits of a prefill of the longer prompt:
    in float32 compute, MoE drop-free, within ``DECODE_RTOL`` of max|logit|."""
    cuda = model.device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=cuda)[None]
    t = toks.shape[1] - steps
    with drop_free(model, torch.float32):
        _, cache = model.prefill(toks[:, :t], max_len=t + steps, cache_dtype=torch.float32)
        worst = 0.0
        for i in range(steps):
            got, cache = model.decode_step(toks[:, t + i:t + i + 1], cache, t + i)
            want, _ = model.prefill(toks[:, :t + i + 1])
            err = max_err(got, want)
            tol = DECODE_RTOL * float(want.abs().max())
            worst = max(worst, err / float(want.abs().max()))
            require(err <= tol, f"{label}: decode step {i + 1} after a prefill of {t} "
                    f"against a prefill of {t + i + 1}: max_abs_err {err} within {tol}")
    print(f"{label}: decode against prefill, worst error {worst:.3e} of max|logit|")


def phase_moe(cuda) -> tuple:
    """granite-moe-3b-a800m at its published width, the LM path's traffic
    through the engine, and its checks: K7 exactly once a layer and
    prefill, all on the tensor-core body; the capacity drops by mode; K7
    at a served prompt; the prefill logits through K7 against the plain
    version; one MoE layer against its dense oracle and run twice; decode
    against prefill. Returns (K7 record, launches of the traffic)."""
    t_all = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    model = init_model(cfg, cuda, "moe")
    print(f"moe: {cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, expert d_ff "
          f"{cfg.moe.d_ff}, capacity factor {cfg.moe.capacity_factor}; "
          f"{cfg.active_param_count()} parameters active a token")
    for blk in model.layers:
        blk.moe_stats = {}
    lengths, prompts = lm_traffic(cfg)
    done, engine, counts = serve_traffic(model, prompts, "moe")
    require_k7_traffic("moe", counts, cfg.n_layers * LM_REQUESTS,
                       f"{cfg.n_layers} x {LM_REQUESTS} prefills")
    for mode in ("prefill", "decode"):
        assigned = sum(b.moe_stats[mode]["assigned"] for b in model.layers)
        by_layer = [int(b.moe_stats[mode]["dropped"]) / b.moe_stats[mode]["assigned"]
                    for b in model.layers]
        dropped = sum(int(b.moe_stats[mode]["dropped"]) for b in model.layers)
        print(f"moe {mode}: {dropped} of {assigned} (token, k) assignments dropped by "
              f"capacity ({dropped / assigned:.4%}); by layer: layer 0 {by_layer[0]:.4%}, "
              f"median {np.median(by_layer):.4%}, max {max(by_layer):.4%}")
    for blk in model.layers:
        blk.moe_stats = None

    rid = next(i for i, n in enumerate(lengths) if n % 64)
    s = int(lengths[rid])
    tokens = torch.as_tensor(prompts[rid], dtype=torch.int64, device=cuda)[None]
    q, k, v = layer0_qkv(model, tokens)
    record = k7_record("flash_attention_granite_moe", q, k, v, reps=10)
    k7_float32_check(f"moe request {rid}", q, k, v, s)
    del q, k, v
    prefill_logits_check(model, tokens, rid, done[rid].out[0], label="moe")

    # one MoE layer at the served prompt's hidden states
    p = model.layers[0].mlp
    x = moe_layer0_input(model, tokens)
    a, _ = moe.moe_forward(p, cfg, x)
    b, _ = moe.moe_forward(p, cfg, x)
    require(torch.equal(a, b), f"moe layer 0 at request {rid} (S {s}): two runs give "
            "equal bits")
    for dtype in (torch.bfloat16, torch.float32):
        with drop_free(model, dtype) as dcfg:
            xd = x.to(dtype)
            got, _ = moe.moe_forward(p, dcfg, xd)
            want = moe_dense_oracle(p, dcfg, xd)
        err, scale = max_err(got, want), float(want.abs().max())
        print(f"moe layer 0 drop-free against the dense oracle, {dtype}: max_abs_err "
              f"{err}, max|out| {scale} ({err / scale:.3e} of it)")
        if dtype == torch.bfloat16:
            require(err <= MOE_ORACLE_RTOL * scale, f"moe layer 0 against the dense "
                    f"oracle in bf16: {err} within {MOE_ORACLE_RTOL} of max|out|")
    del a, b, x, got, want
    decode_against_prefill(model, prompts[rid], "moe")
    profile_prefill_and_decode(model, engine, tokens, rid, "moe", FAMILY_GROUPS)
    del model, engine, tokens
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe path: {time.perf_counter() - t_all:.2f} s")
    record["launches"] = counts["flash_attention"]
    return record, counts


def phase_ssm(cuda) -> dict:
    """rwkv6-1.6b at its published width, the LM path's traffic through the
    engine (no attention: K7 never launches), ``chunked_gla`` at layer 0's
    inputs for a served prompt against its step-by-step version on the
    card, and decode against prefill. Returns the traffic's launches."""
    t_all = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    model = init_model(cfg, cuda, "ssm")
    lengths, prompts = lm_traffic(cfg)
    done, engine, counts = serve_traffic(model, prompts, "ssm")
    require(counts["flash_attention"] == 0,
            f"ssm: K7 launched {counts['flash_attention']} times (rwkv6 has no attention)")

    rid = next(i for i, n in enumerate(lengths) if n % 64)
    s = int(lengths[rid])
    tokens = torch.as_tensor(prompts[rid], dtype=torch.int64, device=cuda)[None]
    blk = model.layers[0]
    with torch.no_grad():
        h = layer0_input(model, tokens)
        r, k, v, _, ld = ssm.rwkv_projections(blk.mixer, cfg, h,
                                              torch.zeros_like(h[:, :1]))
        r, k, v = r.float(), k.float(), v.float()
        h0 = torch.zeros((1, cfg.ssm.n_heads, cfg.ssm.d_state, cfg.ssm.d_head),
                         device=cuda)
        (y, h_last), ms = timed_once(lambda: ssm.chunked_gla(
            r, k, v, ld, h0, chunk=cfg.ssm.chunk, mode="bonus", u=blk.mixer["u"]))
        (want_y, want_h), plain_ms = timed_once(lambda: ssm.gla_reference(
            r, k, v, ld, h0, mode="bonus", u=blk.mixer["u"]))
    err_y, err_h = max_err(y, want_y), max_err(h_last, want_h)
    scale_y, scale_h = float(want_y.abs().max()), float(want_h.abs().max())
    print(f"ssm chunked_gla at layer 0 of request {rid} (S {s}, {cfg.ssm.n_heads} heads "
          f"of {cfg.ssm.d_state} x {cfg.ssm.d_head}, chunk {cfg.ssm.chunk}): {ms:.3f} ms "
          f"against the step-by-step {plain_ms:.3f} ms; max_abs_err y {err_y} "
          f"(max|y| {scale_y}), state {err_h} (max|h| {scale_h})")
    require(err_y <= GLA_RTOL * scale_y and err_h <= GLA_RTOL * scale_h,
            f"ssm chunked_gla against gla_reference: within {GLA_RTOL} of max|y| and max|h|")
    del r, k, v, ld, y, want_y, h_last, want_h
    decode_against_prefill(model, prompts[rid], "ssm")
    profile_prefill_and_decode(model, engine, tokens, rid, "ssm", FAMILY_GROUPS)
    del model, engine, tokens, h
    gc.collect()
    torch.cuda.empty_cache()
    print(f"ssm path: {time.perf_counter() - t_all:.2f} s")
    return counts


def phase_arctic(cuda) -> dict:
    """arctic-480b at full width (128 experts, top-2, the dense residual) and
    depth ``ARCTIC_DEPTH``: weights from the seed, one request of
    ``ARCTIC_PROMPT`` tokens and ``LM_NEW`` new ones. Returns the traffic's
    launches."""
    t_all = time.perf_counter()
    full = get_config(ARCTIC_ARCH)
    cfg = dataclasses.replace(full, n_layers=ARCTIC_DEPTH)
    per_layer = (full.param_count() - 2 * full.vocab_size * full.d_model) / full.n_layers
    print(f"arctic: depth cut to {ARCTIC_DEPTH} of {full.n_layers} layers at full width: "
          f"{2 * per_layer / 2 ** 30:.2f} GiB of bf16 weights a layer, the card 80 GB")
    model = init_model(cfg, cuda, "arctic")
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, size=ARCTIC_PROMPT).astype(np.int32)
    done, _, counts = serve_traffic(model, [prompt], "arctic", max_batch=1)
    require_k7_traffic("arctic", counts, cfg.n_layers, f"{cfg.n_layers} layers x 1 prefill")
    tokens = torch.as_tensor(prompt, dtype=torch.int64, device=cuda)[None]
    logits, _ = model.prefill(tokens)
    require(bool(torch.isfinite(logits).all()) and int(logits[0].argmax()) == done[0].out[0],
            "arctic: prefill logits finite, their argmax the served first token")
    del model, logits, tokens
    gc.collect()
    torch.cuda.empty_cache()
    print(f"arctic path: {time.perf_counter() - t_all:.2f} s")
    return counts


def phase_reduced(cuda) -> None:
    """The reduced granite-moe, arctic, jamba (one period: attention, Mamba,
    MoE every other layer) and rwkv6 in float32: the same weights and the
    same engine scenario on the CPU and on the card give equal tokens, and
    the prefill logits agree within ``REDUCED_TOL``."""
    t_all = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)
    lengths = (5, 70, 9, 130, 3)
    for arch in REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
        cpu_model = CausalLM.from_seed(cfg, seed=SEED, device="cpu")
        card_model = CausalLM(cfg, device=cuda)
        card_model.load_state_dict(cpu_model.state_dict())
        outs, logits = [], []
        for model in (cpu_model, card_model):
            sched = Scheduler(Engine(model, max_batch=3, max_len=160))
            for i, p in enumerate(prompts):
                sched.submit(Request(rid=i, prompt=p, max_new_tokens=6))
            outs.append({r.rid: r.out for r in sched.run()})
            toks = torch.as_tensor(prompts[3], dtype=torch.int64, device=model.device)[None]
            logits.append(model.prefill(toks)[0].cpu())
        err = max_err(logits[1], logits[0])
        require(outs[1] == outs[0] and len(outs[0]) == len(prompts),
                f"reduced {arch}: the card's tokens equal the CPU's ({len(prompts)} requests)")
        require(err <= REDUCED_TOL, f"reduced {arch}: prefill logits on the card against "
                f"the CPU, max_abs_err {err} within {REDUCED_TOL}")
    torch.cuda.empty_cache()
    print(f"reduced families: {time.perf_counter() - t_all:.2f} s")


def phase_families(cuda) -> dict:
    """The MoE and SSM phases, each freeing the card before the next, with
    their seconds. Returns granite's K7 record."""
    t_all = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    record, counts = phase_moe(cuda)
    print(f"launches on the moe path's traffic: {counts}")
    seconds["moe"] = time.perf_counter() - t0
    for name, phase in (("ssm", phase_ssm), ("arctic", phase_arctic)):
        t0 = time.perf_counter()
        counts = phase(cuda)
        print(f"launches on the {name} path's traffic: {counts}")
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_reduced(cuda)
    seconds["reduced"] = time.perf_counter() - t0
    print("family phases' seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; {time.perf_counter() - t_all:.2f} in all")
    return record


def phase_scan(cuda) -> dict:
    """K8 through its entry point ``ops.linear_scan`` at T = 32768 (the
    prefill_32k length) by D = 2048 (rwkv6-1.6b's width), float32, its
    counter zeroed before the call and read after; then bit-equal to the
    plain version and timed."""
    g = torch.Generator(device=cuda).manual_seed(SEED)
    x = torch.randn((SCAN_T, SCAN_D), generator=g, device=cuda)
    decay = torch.rand((SCAN_T, SCAN_D), generator=g, device=cuda) * 0.2 + 0.8
    h0 = torch.randn((SCAN_D,), generator=g, device=cuda)
    reset_launches()
    got_all, got_last = ops.linear_scan(x, decay, h0)
    torch.cuda.synchronize()
    count = launches()["linear_scan"]
    (want_all, want_last), plain = timed_once(lambda: k8.chunked_scan_plain(x, decay, h0))
    require(torch.equal(got_all, want_all) and torch.equal(got_last, want_last),
            f"linear_scan T={SCAN_T} D={SCAN_D}: bit-equal to plain")
    err = max(max_err(got_all, want_all), max_err(got_last, want_last))
    del got_all, got_last, want_all, want_last
    ms = cuda_ms(lambda: k8.chunked_scan(x, decay, h0), reps=5)
    rec = kernel_record("linear_scan", "src/repro_torch/csrc/chunked_scan.cu",
                        "src/repro/kernels/chunked_scan.py:52", err, ms, plain,
                        4 * (3 * SCAN_T * SCAN_D + 2 * SCAN_D), 2 * SCAN_T * SCAN_D)
    rec["launches"] = count
    require(count > 0, "linear_scan launched through ops.linear_scan")
    return rec


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"


def phase_gate(cuda) -> None:
    """The static schedule gate on the card: the verifier over every route
    and family probe at the card's geometry (and the kernel routes'
    hand-made plans), the extension proofs and the linter. Any finding
    fails the run."""
    print(card_line())
    t0 = time.perf_counter()
    findings, stats = analysis.run_all(cuda)
    took = time.perf_counter() - t0
    print(f"schedule gate: {took:.3f} s on {stats['device']}; "
          f"{stats['schedules_verified']} schedules verified across "
          f"{stats['routes']} routes ({', '.join(stats['routes_verified'])}), "
          f"{stats['sweep_schedules_verified']} more at hand-made kernel "
          f"geometries, {stats['extensions_verified']} extension proofs, "
          f"{stats['files_scanned']} files linted")
    for f in findings:
        print(f"gate finding: {f.check} · {f.subject} [{f.probe}]: {f.message}")
    require(not findings, f"schedule gate on the card: {len(findings)} finding(s)")
    require(stats["routes"] == len(dp.backends.names()) == 14
            and stats["schedules_verified"] >= stats["routes"],
            f"schedule gate: {stats['routes']} routes, "
            f"{stats['schedules_verified']} schedules verified")


def gate_launches(path: str, cuda) -> None:
    """Every DP kernel launch of ``path`` (recorded since the counters were
    last reset, the path's checks included): its geometry against its
    descriptor's, and the kernel's geometry rules at the path's shapes."""
    t0 = time.perf_counter()
    findings, stats = analysis.verify_launches(cuda)
    took = time.perf_counter() - t0
    recorded = sorted({name for name, _, _ in kschedule.recorded_launches()})
    print(f"schedule gate on the {path} path: {stats['launch_shapes_checked']} "
          f"launch shapes of {recorded} checked in {took:.3f} s")
    for f in findings:
        print(f"gate finding: {f.check} · {f.subject} [{f.probe}]: {f.message}")
    launched = sorted(name for name, c in launches().items() if c > 0 and name.startswith(
        ("sdp_pipeline", "sdp_chunked", "mcm_pipeline", "mcm_tiled", "grid_pipeline")))
    require(not findings and launched == recorded,
            f"{path} path: every launch's geometry equals its descriptor's "
            f"({len(findings)} finding(s); launched {launched})")


def print_plans(cuda) -> None:
    """K4's grid and warps per cell, K6 antidiag's tiles, K2's cluster and
    table home, K5's and K8's plans, and K6 spandiag's grid and warps per
    triple at the paths' shapes."""
    n = MCM_N
    G = k4.ctas(True, True, n, cuda)
    print(f"mcm_tiled: {G} CTAs of {k4.THREADS} threads, {k4.spread_smem_bytes(n, True)} "
          f"bytes of shared memory (fused, n={n}); warps per cell at n={n} by diagonal: "
          + ", ".join(f"d={d} {k4.warps_per_cell(d, n - d, G)}"
                      for d in (1, 33, 100, 300, 512, 800, 1023)))
    for name in ("needleman_wunsch", "gotoh"):
        spec = dp.get_problem(name).encode(x=[0, 1], y=[1, 0])
        for with_args in (False, True):
            plan = k6.tile_plan(spec.planes, spec.moves, with_args)
            print(f"grid_pipeline_antidiag{'_with_args' if with_args else ''} ({name}): "
                  f"{plan}, {k6.antidiag_ctas(spec.op, with_args, plan, 10 ** 6, cuda)} CTAs")
    for n, bt in ((MCM_SMALL_N, MCM_BATCH), (MCM_N, 1)):
        C = k2.cluster_size(True, n, bt, cuda)
        print(f"mcm_pipeline at {bt} x {n}: clusters of {C} ({k2.max_clusters(True, n, C, cuda)} "
              f"resident), table in {k2.table_home(n)} memory, {k2.smem_bytes(n)} bytes "
              f"of shared memory a CTA; lanes per cell by diagonal: " + ", ".join(
                  f"d={d} {k2.lanes_per_cell(d, n - d, C * k2.THREADS)}"
                  for d in (1, 16, 64, 128, n // 2, n - 2, n - 1)))
        if k2.table_home(n) == "shared":
            print(f"mcm_pipeline at {bt} x {n}, shared-memory operand loads of one CTA: "
                  f"{k2_bank_wavefronts(n, C)}")
    sms, max_cluster = k5.card_limits(cuda)
    print(f"tropical_matmul: {sms} SMs, clusters up to {max_cluster} CTAs")
    for label, bt, m, k, n in [
            *((f"mcm {MCM_N} D={D}", MCM_N // 16 - D, 16, 16 * (D - 1), 16)
              for D in (2, 3, 16, 32, 48, 56, 63)),
            *((f"mcm {MCM_BATCH} x {MCM_SMALL_N} D={D}", MCM_BATCH * (MCM_SMALL_N // 16 - D),
               16, 16 * (D - 1), 16) for D in (2, 8, 15)),
            (f"weighted {K5_SQUARE}^3", 1, K5_SQUARE, K5_SQUARE, K5_SQUARE)]:
        p = k5.plan(bt, m, n, k, sms, max_cluster)
        ctas = bt * -(-m // p.tile) * -(-n // p.tile) * p.cluster
        print(f"tropical_matmul at {label} ({bt} x {m} x {k} x {n}): {p}, {ctas} CTAs of "
              f"{p.threads} threads, {k5.smem_bytes(p.regime, p.cluster, p.groups, p.stages)} "
              f"bytes of shared memory, {-(-p.slice // (k5.KS * p.groups))} stages a CTA")
    p = k8.plan(SCAN_T, SCAN_D)
    print(f"linear_scan at T={SCAN_T} D={SCAN_D}: {p}, {-(-SCAN_D // p.features)} CTAs, "
          f"{k8.smem_bytes(p)} bytes of shared memory, "
          f"{2 * 4 * p.stages * p.rows * p.features} bytes in flight a CTA")
    n, P, NR = CKY["n"], CKY["P"], CKY["rules"]
    G = k6.spandiag_ctas("max", True, P, NR, cuda)
    print(f"grid_pipeline_spandiag (cky {n} x {P} x {NR}): {G} CTAs of {k6.SD_THREADS} "
          f"threads, {k6.spandiag_smem_bytes(P, NR)} bytes of shared memory; warps per "
          "triple by diagonal: " + ", ".join(
              f"d={d} {k6.spandiag_warps(d * NR // P, P * (n - d), G)}"
              for d in (1, 8, 16, 32, 48, 63)))


def k2_against_k4(wtab, cells: int, needed: int) -> list:
    """K2's twins at MCM n = 1024 (the table in device memory) against K4's
    fused table and args on the same tensors, timed: ``--dp-shapes``'s K2
    records (the full smoke holds them against the plain version)."""
    n = MCM_N
    table, args, _ = k4.mcm_tiled_fused(wtab, n)
    records = []
    for name, fn in (("mcm_pipeline", k2.mcm_pipeline),
                     ("mcm_pipeline_with_args", k2.mcm_pipeline_with_args)):
        got = fn(wtab, n)
        with_args = name.endswith("args")
        require(torch.equal(got[0] if with_args else got, table)
                and (not with_args or torch.equal(got[1], args)),
                f"{name} n={n}: table{' and args' if with_args else ''} bit-equal to "
                "mcm_tiled_fused's (K4)")
        b, by = bound_ms(4 * needed + 4 * cells * (2 if with_args else 1), 3 * needed)
        records.append({"name": name, "ms": cuda_ms(lambda: fn(wtab, n), reps=3),
                        "bound_ms": b})
        print(f"{name} at mcm {n}: {records[-1]['ms']:.3f} ms, bound {b:.4f} ms ({by})")
        del got
    return records


def plan_sweeps(cuda) -> None:
    """K5 at MCM 1024's largest launch and K8 at 32768 x 2048 under forced
    plans beside the plan's own (device time by the profiler for K5, CUDA
    events for K8), each bit-equal to the plain version: what the plan
    rules chose against their neighbours."""
    dims = mcm_dims(np.random.default_rng(SEED), MCM_N)
    rng = np.random.default_rng(SEED)
    m = K5_SQUARE
    square = tuple(torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (
        rng.normal(size=(m, m)), rng.normal(size=(m, m)), rng.uniform(1, 3, m),
        rng.uniform(1, 3, m), rng.uniform(1, 3, m)))
    sms, max_cluster = k5.card_limits(cuda)
    k = (MCM_N // 32 - 1) * BLOCKED_TILE
    cases = [(f"MCM {MCM_N} D=32", k5_path_operands(cuda, dims)[1], [
        k5.Plan(k5.SPLIT, 16, 1, c, g, -(-k // c), min(k5.MAX_STAGES, -(-k // (k5.KS * c * g))))
        for c in (1, 2, 4, 8, 16) for g in (1, 2, 4)]),
        (f"weighted {m}^3", square, [k5.Plan(k5.REGISTER, 64, 4, 1, 1, m, st)
                                     for st in (1, 2, 3)]),
        (f"{m}^3", square[:2], [])]
    for label, args, forced in cases:
        a, b = args[0], args[1]
        chosen = k5.plan(a.shape[0] if a.dim() == 3 else 1, a.shape[-2], b.shape[-1],
                         a.shape[-1], sms, max_cluster)
        plans = [chosen] + [p for p in forced if p != chosen]
        want = k5.tropical_matmul_plain(*args)
        for p in plans:
            require(torch.equal(k5._launch(*args, plan=p), want),
                    f"tropical_matmul at {label} {p}: bit-equal to plain")
        for p, ms in zip(plans, k5_profiled_ms([lambda p=p, a=args: k5._launch(*a, plan=p)
                                                for p in plans])):
            print(f"tropical_matmul at {label} under cluster {p.cluster}, groups {p.groups}, "
                  f"stages {p.stages}: device {ms:.4f} ms{' (the plan)' if p == chosen else ''}")
        del want
    del cases, square
    g = torch.Generator(device=cuda).manual_seed(SEED)
    x = torch.randn((SCAN_T, SCAN_D), generator=g, device=cuda)
    decay = torch.rand((SCAN_T, SCAN_D), generator=g, device=cuda) * 0.2 + 0.8
    h0 = torch.randn((SCAN_D,), generator=g, device=cuda)
    want_all, want_last = k8.chunked_scan_plain(x, decay, h0)
    chosen = k8.plan(SCAN_T, SCAN_D)
    plans = [chosen] + [k8.Plan(f, k8.STAGE_ROWS, st, mode) for mode in (k8.TMA, k8.CP_ASYNC)
                        for f, st in ((8, 8), (16, 3), (16, 10), (32, 4), (32, 6))]
    for p in plans:
        got_all, got_last = k8._launch(x, decay, h0, plan=p)
        require(torch.equal(got_all, want_all) and torch.equal(got_last, want_last),
                f"linear_scan {p}: bit-equal to plain")
        ms = cuda_ms(lambda p=p: k8._launch(x, decay, h0, plan=p), reps=5)
        print(f"linear_scan at T={SCAN_T} D={SCAN_D} under {p}: {ms:.4f} ms"
              f"{' (the plan)' if p == chosen else ''}")


def dp_shapes_only(cuda, sweep: bool = False) -> int:
    """``--dp-shapes``: the build, then K1 and K3 (sdp 2^20 / 2^23 and
    phase_sdp_shapes), K2 and K4 (MCM 1024 and phase_mcm_shapes), K6
    (gotoh 4097^2, the cky chart and phase_grid_shapes), K5 (MCM 1024's
    largest launch, the weighted 1024^3 square and phase_k5_shapes) and K8
    (T 32768 x D 2048) alone -- each kernel's times at every shape of its
    paths, for holding two trees' kernels side by side on one card; with
    ``--sweep`` also :func:`plan_sweeps`."""
    phase_build()
    print_plans(cuda)
    rng = np.random.default_rng(SEED)
    sdp = sdp_instance(rng)
    init = torch.from_numpy(sdp["init"]).to(cuda)[None]
    offsets, a1, k = sdp["offsets"], sdp["offsets"][0], len(sdp["offsets"])
    records = []
    for name, fn, n in (("sdp_pipeline", k1.sdp_pipeline, SDP_N),
                        ("sdp_pipeline_with_args", k1.sdp_pipeline_with_args, SDP_N),
                        ("sdp_chunked", k3.sdp_chunked, SDP_BIG_N),
                        ("sdp_chunked_with_args", k3.sdp_chunked_with_args, SDP_BIG_N)):
        ms = cuda_ms(lambda: fn(init, offsets, "min", n), reps=3)
        nbytes = 4 * a1 + 4 * k + 4 * n * (2 if name.endswith("args") else 1)
        records.append({"name": name, "ms": ms,
                        "bound_ms": bound_ms(nbytes, (n - a1) * (k - 1))[0]})
    phase_sdp_shapes(cuda, records)
    dims = mcm_dims(rng, MCM_N)
    wtab = torch.from_numpy(dp.get_problem("mcm").encode(dims=dims).weights
                            .astype(np.float32)).to(cuda)
    cells = core_mcm.num_cells(MCM_N)
    needed = sum((MCM_N - d) * d for d in range(1, MCM_N))
    records = k4_records(wtab, cells, needed) + k2_against_k4(wtab, cells, needed)
    del wtab
    phase_mcm_shapes(cuda, records)
    torch.cuda.empty_cache()
    phase_grid_shapes(cuda, phase_grid_kernels(cuda))
    torch.cuda.empty_cache()
    phase_k5_shapes(cuda, phase_semiring_kernels(cuda, dims), dims)
    phase_scan(cuda)
    if sweep:
        plan_sweeps(cuda)
    return 1 if _failures else 0


# ---------------------------------------------------------------------------
# The service path: DPService on the card, bucketed drains over K1-K4 and K6
# ---------------------------------------------------------------------------
#: the service's bucket width, the traffic's request count, the share of
#: requests with a start-by deadline short enough to lapse in the backlog
SERVICE_BATCH, SERVICE_REQUESTS, SERVICE_TIGHT = 32, 256, 0.08
#: kernel route -> the launch counters of its kernel
SERVICE_ROUTES = {"kernel_blocked": k1.LAUNCHES, "kernel_tiled": k3.LAUNCHES,
                  "kernel_wavefront": k2.LAUNCHES, "kernel_tiled_wavefront": k4.LAUNCHES,
                  "kernel_grid": k6.LAUNCHES}
#: launch counters that must move in the phase: K1, K2, K3, K4, K6 by schedule
SERVICE_KERNELS = {"K1": ("sdp_pipeline", "sdp_pipeline_with_args"),
                   "K2": ("mcm_pipeline", "mcm_pipeline_with_args"),
                   "K3": ("sdp_chunked", "sdp_chunked_with_args"),
                   "K4": ("mcm_tiled", "mcm_tiled_with_args", "mcm_tiled_fused"),
                   "K6 antidiag": ("grid_pipeline_antidiag",
                                   "grid_pipeline_antidiag_with_args"),
                   "K6 spandiag": ("grid_pipeline_spandiag",
                                   "grid_pipeline_spandiag_with_args")}
#: problems of the service traffic, each with the count of its smallest
#: instances held against a plain version; the largest instance of each
#: route and recurrence is held too (K6's plain version takes ~5 s an
#: alignment of 1024², so the two alignments share one such instance)
SERVICE_CPU_SAMPLE = {"mcm": 10, "edit_distance": 5, "lcs": 5, "viterbi": 5,
                      "unbounded_knapsack": 5, "needleman_wunsch": 0, "gotoh": 1,
                      "cky": 4}
SERVICE_RECURRENCE = {"needleman_wunsch": "alignment", "gotoh": "alignment"}


def service_traffic(rng) -> list:
    """The service path's requests, seeded: per group a pool of instances
    (about one request in eight repeats an earlier one of its group), then
    40 more repeats of the cheaper groups' instances, shuffled together.
    Each request is ``(name, payload, reconstruct, size)``; ``size`` orders
    the instances for the CPU comparison."""
    grammar = cky_instance(rng, 32, 32, 512, 1024)
    knap_w = np.array([3, 5, 7, 11, 13, 17])

    def mcm(n):
        return {"dims": rng.integers(1, 30, n + 1).astype(np.float64)}

    def pair(n):
        return {"x": rng.integers(0, 4, n), "y": rng.integers(0, 4, n)}

    groups = [
        ("mcm", 64, lambda i: (mcm(int(rng.choice([128, 192, 256]))), i % 2 == 0)),
        ("edit_distance", 24, lambda i: (pair(int(rng.choice([256, 512, 1024]))), False)),
        ("lcs", 24, lambda i: (pair(int(rng.choice([256, 512, 1024]))), False)),
        ("viterbi", 32, lambda i: (viterbi_instance(rng, 16, 512), False)),
        ("needleman_wunsch", 16, lambda i: (pair(int(rng.choice([512, 1024]))), False)),
        ("gotoh", 16, lambda i: (pair(int(rng.choice([512, 1024]))), False)),
        ("cky", 16, lambda i: (dict(grammar, tokens=rng.integers(
            0, 512, int(rng.choice([16, 32])))), False)),
        ("unbounded_knapsack", 16, lambda i: ({
            "item_weights": knap_w, "capacity": 4096,
            "item_values": np.round(rng.random(len(knap_w)) * 10 + 0.5, 3)}, False)),
        ("edit_distance", 4, lambda i: (pair(2048), False)),
        ("mcm", 4, lambda i: (mcm(512), True)),
    ]
    out, cheap = [], []
    for name, count, make in groups:
        pool = []
        for i in range(count):
            if pool and i % 8 == 7 and count > 4:
                out.append(pool[int(rng.integers(len(pool)))])
                continue
            kw, recon = make(i)
            size = len(kw.get("dims", kw.get("x", kw.get("obs", kw.get("tokens", [])))))
            req = (name, kw, recon, size or int(kw.get("capacity", 0)))
            pool.append(req)
            out.append(req)
        if count > 4:
            cheap += pool
    out += [cheap[int(rng.integers(len(cheap)))] for _ in range(SERVICE_REQUESTS - len(out))]
    return [out[i] for i in rng.permutation(len(out))]


def plain_twin(route: str):
    """The kernel route ``route`` with each kernel wrapper swapped for its
    plain PyTorch version — the computation the CPU port runs — to run on
    the card; None for a plain route."""
    zero = lambda s, d: 0.0  # noqa: E731  (never ranked)
    if route in ("kernel_blocked", "kernel_tiled"):
        plain = k1.sdp_pipeline_plain if route == "kernel_blocked" else k3.sdp_chunked_plain
        return dp.backends.linear_backend(
            route, lambda i, o, op, n, weights=None: plain(i, o, op, n, weights=weights),
            zero, arg_fn=lambda i, o, op, n, weights=None: plain(
                i, o, op, n, weights=weights, with_args=True))
    if route == "kernel_wavefront":
        return dp.backends.triangular_tab_backend(
            route, lambda w, n: k2.mcm_pipeline_plain(w, n), zero,
            arg_fn=lambda w, n: k2.mcm_pipeline_plain(w, n, with_args=True))
    if route == "kernel_tiled_wavefront":
        return dp.backends.triangular_tab_backend(
            route, lambda w, n: k4.mcm_tiled_plain(w, n), zero,
            arg_fn=lambda w, n: k4.mcm_tiled_plain(w, n, with_args=True),
            fused_fn=lambda w, n: k4.mcm_tiled_plain(w, n, fused=True))
    if route == "kernel_grid":
        return dp.backends.grid_backend(
            route, lambda a, m: k6.grid_pipeline_plain(a, m), zero,
            arg_fn=lambda a, m: k6.grid_pipeline_plain(a, m, with_args=True))
    return None


def alignment_value(name: str, x, y) -> float:
    """edit_distance or lcs of ``x`` and ``y`` exactly, a row at a time
    (the in-row dependency as a running min or max): the check for K1 and
    K3 at these sizes, whose plain versions take one step a cell."""
    x, y = np.asarray(x), np.asarray(y)
    j = np.arange(len(y) + 1)
    row = j.copy() if name == "edit_distance" else np.zeros(len(y) + 1, np.int64)
    for i in range(1, len(x) + 1):
        if name == "edit_distance":
            t = np.concatenate([[i], np.minimum(row[1:] + 1, row[:-1] + (x[i - 1] != y))])
            row = np.minimum.accumulate(t - j) + j
        else:
            t = np.concatenate([[0], np.maximum(row[1:], row[:-1] + (x[i - 1] == y))])
            row = np.maximum.accumulate(t)
    return float(row[-1])


def service_sample(results: list) -> list:
    """Per problem its smallest resolved instances (``SERVICE_CPU_SAMPLE``),
    then the largest instance each (route, recurrence) served."""
    picked, largest = [], {}
    for name, want in SERVICE_CPU_SAMPLE.items():
        mine = sorted((r for r in results if r[0][0] == name and r[1].status == "done"),
                      key=lambda r: r[0][3])
        seen, chosen = set(), []
        for req, res in mine:
            if id(req[1]) not in seen:
                seen.add(id(req[1]))
                chosen.append((req, res))
        require(len(chosen) >= want, f"service: {len(chosen)} resolved {name} "
                f"instances for the comparison (want {want})")
        picked += chosen[:want]
        for req, res in chosen:
            key = (res.backend, SERVICE_RECURRENCE.get(name, name))
            if key not in largest or req[3] > largest[key][0][3]:
                largest[key] = (req, res)
    return picked + [r for r in largest.values() if all(r is not p for p in picked)]


def service_plain_check(results: list, cuda) -> None:
    """Answers of the card against the plain version of the route that
    served each (the CPU port's computation, run on the card; one batched
    call for the sampled instances of one shape), for the sample of
    :func:`service_sample`: bit-equal values; reconstructed requests also
    equal decoded solutions, recomputed to their optimum. edit_distance and
    lcs are held against :func:`alignment_value`."""
    t0 = time.perf_counter()
    picked = service_sample(results)
    groups: dict = {}
    for (name, kw, recon, size), res in picked:
        spec = dp.get_problem(name).encode(**kw)
        groups.setdefault((name, res.backend, spec.shape_key(), recon, size), []).append(
            (kw, res, spec))
    same = 0
    for (name, route, _, recon, size), items in groups.items():
        t1 = time.perf_counter()
        prob, twin = dp.get_problem(name), plain_twin(route)
        specs = [spec for _, _, spec in items]
        sols = [None] * len(items)
        if name in ("edit_distance", "lcs") and not recon:
            values = [alignment_value(name, kw["x"], kw["y"]) for kw, _, _ in items]
        elif twin is None:
            cpu = [dp.solve(name, backend=route, reconstruct=recon, device="cpu", **kw)
                   for kw, _, _ in items]
            values, sols = ([c.value for c in cpu], cpu) if recon else (cpu, sols)
        elif recon:
            tables, args, source, paths = dp.routing.run_batch_with_args(twin, specs, cuda)
            sols = dp.reconstruct.reconstruct_batch(prob, specs, tables, args, source,
                                                    paths=paths)
            values = [sol.value for sol in sols]
        else:
            values = [prob.extract(t, spec) for t, spec in
                      zip(dp.routing.run_batch(twin, specs, cuda), specs)]
        for (kw, res, _), value, sol in zip(items, values, sols):
            ok = np.float32(res.answer) == np.float32(value)
            if recon:
                ok &= res.solution is not None and res.solution.solution == sol.solution
                ok &= check_decoded(name, kw, res.solution)
            same += bool(ok)
            if not ok:
                print(f"service: {name} (size {size}) on {route}: card {res.answer} "
                      f"vs plain {value}")
        print(f"  {name} {size} on {route}{' reconstruct' if recon else ''}: "
              f"{len(items)} against the plain version in {time.perf_counter() - t1:.2f} s")
    require(len(picked) >= 32 and same == len(picked),
            f"service: {same}/{len(picked)} sampled answers equal the plain versions' "
            f"over {len(SERVICE_CPU_SAMPLE)} problems and {len(groups)} (route, shape) "
            f"groups ({time.perf_counter() - t0:.1f} s)")


def service_sessions(svc, cuda) -> None:
    """Three streaming sessions, every append checked against a cold
    ``dp.solve`` of the same full instance on the card, bit for bit."""
    rng = np.random.default_rng(SEED + 7)
    x, y = rng.integers(0, 4, 256), rng.integers(0, 4, 2048)
    dims = rng.integers(1, 30, 257).astype(np.float64)
    knap = {"item_weights": np.array([3, 5, 7, 11, 13, 17]),
            "item_values": np.round(rng.random(6) * 10 + 0.5, 3)}
    sessions = [("needleman_wunsch", [dict(x=x, y=y[:c]) for c in range(256, 2049, 256)]),
                ("mcm", [dict(dims=dims[:n + 1]) for n in (64, 128, 192, 256)]),
                ("unbounded_knapsack", [dict(knap, capacity=c)
                                        for c in (1024, 2048, 3072, 4096)])]
    for name, steps in sessions:
        sid = svc.open_session(name)
        same, kinds, took = 0, [], []
        for kw in steps:
            t0 = time.perf_counter()
            tid = svc.append(sid, **kw)
            res = svc.run()[tid]
            took.append((time.perf_counter() - t0) * 1e3)
            kinds.append("extend" if res.extended else "cold")
            cold = dp.solve(name, device=cuda, **kw)
            same += np.float32(res.answer).tobytes() == np.float32(cold).tobytes()
        spec = dp.get_problem(name).encode(**steps[-1])
        stored = svc.prefix_index.lookup(name, spec)
        table_same = stored is not None and np.array_equal(
            stored.table, dp.solve_spec(spec, device=cuda))
        summary = svc.close_session(sid)
        print(f"session {name}: {len(steps)} appends ({', '.join(kinds)}) via "
              f"{summary['affinity']}, ms per append "
              + ", ".join(f"{t:.1f}" for t in took))
        require(same == len(steps) and table_same and kinds.count("extend") == len(steps) - 1,
                f"session {name}: every append equals its cold dp.solve on the card "
                f"bit for bit ({same}/{len(steps)}), the last stored table too")


def compare_walks(cuda, buckets) -> None:
    """The batched traceback walk on the card, on the args where the route
    left them, against the per-instance host walks, which first need the
    args on the host (a reconstruct drain copies them there for its answers
    either way, so that copy is timed apart), for each ``(name, size,
    instances)`` bucket; the paths must agree."""
    from repro_torch.dp import reconstruct

    for name, size, kws in buckets:
        prob = dp.get_problem(name)
        specs = [prob.encode(**kw) for kw in kws]
        route = dp.routing.resolve_backend(specs[0], reconstruct=True, device=cuda,
                                           batch=True)
        tables, args = route.batch_run_with_args(specs, cuda)
        starts = ([reconstruct.start_cell(prob, t, s) for t, s in zip(tables, specs)]
                  if specs[0].uses_start else None)
        for _ in range(2):          # warm: a tree walk's steps are captured on the second
            reconstruct.traceback_batch(args, specs[0], starts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = reconstruct.traceback_batch(args, specs[0], starts)
        t1 = time.perf_counter()
        argss = list(args.cpu().numpy())
        t2 = time.perf_counter()
        host = [s.traceback_host(a, starts[i] if starts else -1)
                for i, (s, a) in enumerate(zip(specs, argss))]
        t3 = time.perf_counter()
        same = all(all(np.array_equal(getattr(p, f), getattr(h, f))
                       for f in ("cells", "lanes", "nodes", "stop") if hasattr(h, f))
                   for p, h in zip(paths, host))
        label = f"{name} {size}"
        print(f"walks of a {label} bucket of {len(specs)} on {route.name}: device "
              f"{(t1 - t0) * 1e3:.2f} ms, host {(t3 - t2) * 1e3:.2f} ms (the args' "
              f"copy to the host {(t2 - t1) * 1e3:.2f} ms)")
        require(same, f"the device walk of {label} equals the host walks")
        del tables, args, argss, paths, host


def service_walks(cuda) -> None:
    """:func:`compare_walks` on one bucket of each walk the service runs:
    K2's MCM 256 trees, K1's edit_distance 1024² chains, K6's gotoh 1024²
    move walks and cky 32 rule trees."""
    rng = np.random.default_rng(SEED + 9)
    grammar = cky_instance(rng, 32, 32, 512, 1024)
    pairs = lambda n, b: [{"x": rng.integers(0, 4, n),  # noqa: E731
                           "y": rng.integers(0, 4, n)} for _ in range(b)]
    compare_walks(cuda, [
        ("mcm", 256, [{"dims": rng.integers(1, 30, 257).astype(np.float64)}
                      for _ in range(8)]),
        ("edit_distance", 1024, pairs(1024, 4)),
        ("gotoh", 1024, pairs(1024, 4)),
        ("cky", 32, [dict(grammar, tokens=rng.integers(0, 512, 32)) for _ in range(8)])])


def phase_service(cuda) -> dict:
    """``DPService(max_batch=32)`` on the card answering 256 seeded
    requests over eight problems: every drain is one batched solve, one
    kernel launch on a kernel route; then three streaming sessions and a
    calibration sweep."""
    from repro_torch.dp import autotune, telemetry

    t_phase = time.perf_counter()
    autotune.reset()
    telemetry.configure(mode="spans")
    telemetry.REGISTRY.reset()
    rng = np.random.default_rng(SEED + 5)
    traffic = service_traffic(rng)
    svc = dp.DPService(max_batch=SERVICE_BATCH, device=cuda)
    drains = {r: 0 for r in SERVICE_ROUTES}
    route_launches = {r: 0 for r in SERVICE_ROUTES}
    tid_of = []

    def step():
        before = {r: sum(c.values()) for r, c in SERVICE_ROUTES.items()}
        batches = svc.engine.stats["device_batches"] + svc.engine.stats["extend_drains"]
        svc.step()
        if svc.engine.stats["device_batches"] + svc.engine.stats["extend_drains"] > batches:
            route = svc.engine.last_drain.backend
            if route in drains:
                drains[route] += 1
        for r, c in SERVICE_ROUTES.items():
            route_launches[r] += sum(c.values()) - before[r]

    def serve():
        t0 = time.perf_counter()
        for i, (name, kw, recon, _) in enumerate(traffic):
            tight = rng.random() < SERVICE_TIGHT
            tid_of.append(svc.submit(name, reconstruct=recon,
                                     priority=int(rng.integers(3)),
                                     deadline_ms=5.0 if tight else None, **kw))
            if i % 32 == 31:
                step()
                step()
        while svc.pending():
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    t_serve = time.perf_counter()
    wall, host_ms, groups = device_profile(serve, {"service drains": ("",)}, cpu=False)
    print(f"service traffic under the profiler: {time.perf_counter() - t_serve:.2f} s "
          f"in all, {wall:.2f} s of it serving")
    peak = torch.cuda.max_memory_allocated(cuda) / 2 ** 30
    results = {tid: svc.poll(tid) for tid in tid_of}
    done = [results[t] for t in tid_of if results[t].status == "done"]
    expired = sum(results[t].status == "expired" for t in tid_of)
    lat = np.array([r.latency_ms for r in done])
    solved = np.array([r.latency_ms for r in done if not r.cached])
    eng = svc.engine.stats
    n_drains = eng["device_batches"] + eng["extend_drains"]
    print(f"service: {len(tid_of)} requests, {len(done)} done, {expired} expired, "
          f"{svc.stats['cache_hits']} cache hits, {eng['dedup_hits']} deduplicated, "
          f"in {wall:.2f} s: {len(done) / wall:.1f} requests/s")
    print(f"service latency: p50 {np.percentile(lat, 50):.1f} ms, p99 "
          f"{np.percentile(lat, 99):.1f} ms (all done); solved ones p50 "
          f"{np.percentile(solved, 50):.1f} ms, p99 {np.percentile(solved, 99):.1f} ms")
    print(f"service drains: {n_drains}, mean bucket fill {eng['completed'] / n_drains:.2f} "
          f"of {SERVICE_BATCH} requests; walks: {eng['device_tracebacks']} on the "
          f"device, {eng['host_tracebacks']} on the host; peak device memory "
          f"{peak:.3f} GiB")
    print("service drains by route: " + ", ".join(
        f"{r} {drains[r]} ({route_launches[r]} launches)" for r in drains))
    hists = telemetry.REGISTRY.histograms()
    print("service phases (ms, p50/p99): " + ", ".join(
        f"{ph} {hists[f'dp_service_{ph}_ms'].quantile(0.5):.2f}/"
        f"{hists[f'dp_service_{ph}_ms'].quantile(0.99):.2f}"
        for ph in ("queue", "dispatch", "solve", "traceback", "decode")
        if f"dp_service_{ph}_ms" in hists))
    walk = hists.get("dp_engine_traceback_ms")
    if walk is not None:
        print(f"service device walks: {walk.count} buckets, {walk.sum:.1f} ms in all")
    describe_profile("service traffic", host_ms, groups)
    counts = launches()
    for label, names in SERVICE_KERNELS.items():
        n = sum(counts[k] for k in names)
        require(n > 0, f"service: {label} launched {n} times in the phase")
    for r in SERVICE_ROUTES:
        require(route_launches[r] == drains[r], f"service: {r} launches "
                f"{route_launches[r]} equal its drains {drains[r]}")
    require(eng["dedup_hits"] > 0 and svc.stats["cache_hits"] > 0,
            f"service: engine dedup {eng['dedup_hits']} and cache hits "
            f"{svc.stats['cache_hits']} both > 0")
    require(expired > 0 and len(done) + expired == len(tid_of),
            f"service: every ticket resolved ({len(done)} done + {expired} expired)")

    t_check = time.perf_counter()
    service_plain_check([(traffic[i], results[t]) for i, t in enumerate(tid_of)], cuda)
    t_walks = time.perf_counter()
    service_walks(cuda)
    t_sessions = time.perf_counter()
    service_sessions(svc, cuda)
    print(f"service sessions: {time.perf_counter() - t_sessions:.2f} s")

    t_cal = time.perf_counter()
    dp.calibrate(problems=["viterbi", "edit_distance", "sdp"], sizes=(16, 64),
                 repeats=2, device=cuda)
    rep = dp.routing_report(device=cuda)
    rows = [r for r in rep["shapes"] if r["comparable"] and r["regime"] == "single"]
    print(f"calibration on {rep['platform']}: {len(rows)} shapes timed in "
          f"{time.perf_counter() - t_cal:.2f} s, {sum(not r['agree'] for r in rows)} "
          "where the measured-fastest route is not the analytical pick")
    for r in rows:
        print(f"  {r['shape_key'][0]} n={dp.backends.shape_key_size(r['shape_key'])}: "
              f"analytical {r['analytical_choice']}, measured {r['measured_choice']} "
              f"(regret {r['analytical_regret']:.2f}x) "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["measured_ms"].items()))
    autotune.reset()
    telemetry.reset()
    t_end = time.perf_counter()
    print(f"service phase parts (s): traffic made {t_serve - t_phase:.2f}, served and "
          f"profiled {t_check - t_serve:.2f}, plain check {t_walks - t_check:.2f}, walks "
          f"{t_sessions - t_walks:.2f}, sessions and calibration {t_end - t_sessions:.2f}")
    took = t_end - t_phase
    require(took <= 60.0, f"service phase took {took:.1f} s, its checks included "
            "(limit 60 s)")
    return counts



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    cuda = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--dp-shapes"] and set(sys.argv[2:]) <= {"--sweep"}:
        return dp_shapes_only(cuda, sweep=sys.argv[2:] == ["--sweep"])
    if sys.argv[1:] == ["--families"]:
        phase_build()
        device_profile(torch.cuda.synchronize, {}, cpu=False)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line())
        print(json.dumps(phase_families(cuda)))
        return 1 if _failures else 0
    if sys.argv[1:] == ["--service"]:
        phase_build()
        # the process's first profiler start initialises the card's tracing
        # (~10 s); in the full run the earlier paths have paid it
        device_profile(torch.cuda.synchronize, {}, cpu=False)
        reset_launches()
        counts = phase_service(cuda)
        print(f"launches on the service path: {counts}")
        gate_launches("service", cuda)
        return 1 if _failures else 0
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    phase_gate(cuda)
    print_plans(cuda)
    rng = np.random.default_rng(SEED)
    records, sdp, dims = phase_kernels(rng, cuda)
    records += phase_streaming_kernels(cuda, sdp)
    phase_sdp_shapes(cuda, records)
    phase_mcm_shapes(cuda, records)
    grid_records = phase_grid_kernels(cuda)
    phase_grid_shapes(cuda, grid_records)
    blocked_records = phase_semiring_kernels(cuda, dims)
    phase_k5_shapes(cuda, blocked_records, dims)

    torch.cuda.reset_peak_memory_stats(cuda)
    reset_launches()
    with launch_times() as times:
        k4_table = phase_main_path(rng, cuda, sdp, dims)
    print_launch_times("main", times)
    counts = launches()
    print(f"launches on the main path: {counts}")
    gate_launches("main", cuda)
    print("streaming kernels' launches on the main path: "
          + ", ".join(f"{k} {counts[k]}" for k in (*k3.LAUNCHES, *k4.LAUNCHES)))
    path_shapes = {**SDP_PATH_SHAPES, **MCM_PATH_SHAPES, **GRID_PATH_SHAPES}
    for rec in records:
        rec["launches"] = counts[rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} launched on the main path")
    for name, shapes in path_shapes.items():
        want = sum(c for _, c, *path in shapes if path in ([], ["main"]))
        require(counts[name] == want, f"{name}: {counts[name]} launches on the main "
                f"path, as its shapes count ({want})")
    print(f"peak device memory on the main path: {path_peak_gib():.3f} GiB")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    reset_launches()
    with launch_times() as times:
        phase_grid(cuda)
    print_launch_times("grid", times)
    counts = launches()
    print(f"launches on the grid path: {counts}")
    gate_launches("grid", cuda)
    for rec in grid_records:
        rec["launches"] = counts[rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} launched on the grid path")
    for name, shapes in GRID_PATH_SHAPES.items():
        want = sum(c for _, c, path in shapes if path == "grid")
        require(counts[name] == want, f"{name}: {counts[name]} launches on the grid "
                f"path, as its shapes count ({want})")
    print(f"peak device memory on the grid path: {path_peak_gib():.3f} GiB")
    records += grid_records
    # the grid path's gotoh walk again, after its launches were counted
    compare_walks(cuda, [("gotoh", ALIGN_N,
                          [grid_instances(np.random.default_rng(SEED))["gotoh"]])])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    reset_launches()
    with launch_times() as times:
        phase_blocked(cuda, dims, k4_table)
    print_launch_times("blocked", times)
    counts = launches()
    print(f"launches on the blocked path: {counts}")
    for rec in blocked_records:
        rec["launches"] = counts["tropical_matmul"]
        require(rec["launches"] > 0, f"{rec['name']} launched on the blocked path")
    want = sum(c for *_, c in K5_PATH_SHAPES)
    require(counts["tropical_matmul"] == want, f"tropical_matmul: {counts['tropical_matmul']} "
            f"launches on the blocked path, as its shapes count ({want})")
    print(f"peak device memory on the blocked path: {path_peak_gib():.3f} GiB")
    records += blocked_records

    torch.cuda.empty_cache()
    reset_launches()
    counts = phase_service(cuda)
    print(f"launches on the service path: {counts}")
    gate_launches("service", cuda)

    del k4_table
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    lm_records, counts = phase_lm(cuda)
    print(f"launches on the lm path's traffic: {counts}")
    for rec in lm_records:
        rec["launches"] = counts["flash_attention"]
        require(rec["launches"] > 0, f"{rec['name']} launched on the lm path")
    records += lm_records
    torch.cuda.empty_cache()
    records.append(phase_families(cuda))
    records.append(phase_scan(cuda))

    if _failures:
        print(f"chip_smoke: {len(_failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
