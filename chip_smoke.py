"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                 # everything below
    python3 chip_smoke.py --dp-shapes     # K1-K6 and K8 alone at their paths' shapes
    python3 chip_smoke.py --dp-shapes --sweep   # and K5 / K8 under forced plans
    python3 chip_smoke.py --service       # the service path alone
    python3 chip_smoke.py --sharded       # the sharded path alone
    python3 chip_smoke.py --families      # the MoE and SSM families alone
    python3 chip_smoke.py --train         # the training path alone
    python3 chip_smoke.py --sharded-train # the sharded train step alone
    python3 chip_smoke.py --service-processes   # DPService one process a rank alone
    python3 chip_smoke.py --train-witness # phi3's 6 steps on a 6-step schedule,
                                          # bf16 and float32 compute (not in the
                                          # default run)

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

then the training path, freeing the card before it:

  * phi3-mini-3.8b at its published width and depth (32 layers, d 3072, 32
    heads of 96, d_ff 8192, vocabulary 32064, bf16), weights from seed 0:
    its bf16 gradients at one 512-token sequence against float32-compute
    ones (K7's and K7b's CUDA-core bodies; cosine per parameter; K7b once a
    layer in each pass, on its tensor-core body in bf16); then the
    first 6 steps of a 2000-step run of ``launch.train.build_step`` (AdamW
    with float32 moments, lr 3e-4 warmup-cosine, so 3e-6 to 1.8e-5 over
    these steps: on a 6-step schedule the random model's loss rises, see
    ``--train-witness``) on batches of 2 x 4096
    tokens from ``SyntheticLM``: seconds a step, tokens/s, model-FLOP
    utilisation against 989 TFLOP/s and peak memory; losses and grad norms
    finite, the last loss below the first, a held-out batch's loss lower
    after; with remat K7's forward launches twice a layer a step (the
    forward and the recompute) and its backward K7b once, all on the
    tensor-core bodies; one more step under ``torch.profiler`` (gradients,
    then the AdamW update);
  * each of K7b's bodies (tensor cores, then CUDA cores on the same bf16
    tensors) at one layer of that step's tensors and at qwen3-14b's served
    shape (Hq 40, Hkv 8, hd 128, S 1746), against the plain backward on
    the card, twice for equal bits, timed beside
    ``scaled_dot_product_attention``'s backward (the yardstick, never on
    the path);
  * the reduced qwen3-14b, granite-moe and rwkv6 in float32: 3 steps on
    the card and on the CPU from the same weights, losses within 1e-4;
  * the training CLI's supervisor on the card (reduced qwen3-14b, 12
    steps, a checkpoint every 4, a failure injected at step 6): the
    recovered run's final loss within 1e-5 of a failure-free run's, and
    whether their bits are equal; then ``launch.train.main`` itself on its
    default device with the failure-free run's flags: its last loss within
    1e-5 of that run's, one metrics row a step, checkpoints to the last
    step;

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

then the sharded path, over a mesh of four slots of the one card (each
slot its own CUDA stream):

  * K4 fused, K6 antidiag and K6 spandiag — cooperative grids sized to the
    whole card — launched on the four streams at once under a deadline,
    their spans showing whether the grids overlapped;
  * ``ShardedDPEngine`` on ragged buckets of 6 (2 pad lanes): MCM 512 (K4,
    fused under reconstruct), MCM 256 (K2), sdp 2^20 (K1) and
    needleman_wunsch 1024^2 (K6 antidiag), with and without reconstruct,
    each drain bit-equal to the single engine's on the card with the route
    forced the same, the first drain also to the route's plain twin (its
    kernels' plain versions on the card), four launches a drain, the drain
    times and one sharded drain's device idle share under the profiler;
  * ``compressed_psum`` over the four slots, each shard made late on its
    slot's stream, bit-equal to the CPU port's,
    ``best_mesh`` and ``reshard`` after a simulated loss;
  * ``pipeline_apply`` over four stage slots: qwen3-14b's blocks at full
    width cut to 8 layers (weights from seed 0, stages from
    ``stage_boundaries``), float32 compute, 6 microbatches of 1 x 1746
    tokens, against the blocks in sequence; K7 launched 48 times;

then the gated linear scan K8 through ``ops.linear_scan`` at
T = 32768, D = 2048, bit-equal to its plain version; and last the LM over a
mesh (``--sharded-lm`` alone): qwen3-14b (depth 8), granite-moe-3b-a800m,
rwkv6-1.6b and granite-20b (depth 4) at full width placed on 4 slots of the
card as (data, model) = (1, 4) and (2, 2) (``CausalLM.place``, float32
compute), 4 requests of the LM traffic through the engine, fed the single
slot's tokens (teacher-forced): every prefill's and step's logits
within 1e-3 of max|logit| of the single slot's and every greedy token
equal to the single slot's, each slot's parameter bytes
equal to ``spec_for``'s, K7 launched once a slot and attention layer a
prefill, the times and a decode step's idle share, and K7 at slot 0's share
of a served prompt against its plain version; a watchdog ends the run at
the phase's deadline if a slot hangs; and after it the sharded train step
(``--sharded-train`` alone): phi3-mini-3.8b (depth 8) and
granite-moe-3b-a800m (depth 4) at full width trained over the same (1, 4)
and (2, 2) slots (``ShardedLM.grads``, ``train_step``), in float32 and in
bf16, against the single slot on the same weights and batch, K7 launched
twice and K7b once an attention layer and slot, phi3's float32 AdamW step
against ``build_step``, and ``launch/dryrun.py``'s trace of its (2, 2) step
on ``meta`` slots against the collectives slot 0 carried and its real
argument bytes; K7 and K7b at slot 0's share of a layer beside SDPA; and
last the same program one process a rank (``--processes`` alone,
``runtime/distributed.py``): qwen3-14b (depth 8) and granite-moe-3b-a800m
(depth 4) serving 4 requests of the LM traffic on (1, 4) and (2, 2), and
phi3-mini-3.8b (depth 8) taking a float32 gradient pass and AdamW step on
(2, 2), first on the threads (the results kept on the host), then in four
rank processes of the card over gloo: tokens, logits, caches, gradients
and parameters bit-equal, K7's and K7b's launches summed over the ranks
equal to the threads', the times and each rank's peak memory, and K7 and
K7b timed in rank 0's process at a rank's shapes; over NCCL, one rank a
card, where the host has two cards or more (``--processes-nccl``, which
also runs one sharded MCM 512 bucket and the service path's traffic over
NCCL against the threads over the same cards); then the DP drains, the
pipeline and ``compressed_psum`` one process a rank (``--dp-processes``);
and last the service one process a rank (``--service-processes``): the
service path's 256 requests and three sessions through ``DPService(comm=
comm)`` in four rank processes of the card over gloo, run A (no
deadlines) bit-equal on every rank to the threaded ``DPService(mesh=...)``
on four slots of the card and to the single-engine service, launches
summed over the ranks equal to the threads', run B (the path's 5 ms
deadlines) equal on every rank with tickets expired and each done answer
the single engine's, and K3 and K6 spandiag timed in rank 0's process at
its share of their service buckets against their plain versions.

K1, K2, K3, K4 and K6 (both schedules) are also timed at every shape they
launch on the main and grid paths (each new shape held against the plain
version, the alignment grids' edit_distance and lcs read a grid row at a
time, or, where that would take minutes, K3 against K1 at viterbi 64 x
2048 and K4 against K2), each kernel's
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
import os
import re
import subprocess
import sys
import threading
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
from repro_torch.models.model import CausalLM, loss_fn, param_defs  # noqa: E402
from repro_torch.optim import grad_compress  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.runtime import distributed, elastic, pipeline_parallel  # noqa: E402
from repro_torch.runtime import sharding as rt_sharding  # noqa: E402
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
#: the training path: the arch trained at its published width and depth,
#: the batch (sequences x tokens), steps and peak lr, and the length of the
#: run whose schedule the steps follow (warmup over its first 100 steps:
#: with a 6-step schedule, warmup over 10 at 3e-5 a step, Adam's sign-like
#: first steps make the loss of the random 3.8 B model climb, on a fixed
#: batch too); the bf16 gradients held against float32-compute ones at one
#: shorter sequence (cosine per parameter, at least GRAD_COS); the reduced configs
#: held card against CPU (float32 losses, relative) over their steps; the
#: supervisor's run (steps, checkpoint interval, the injected failure's
#: step) and its bound against a failure-free run (relative: the card's
#: embedding backward and cuBLAS may change bits between runs)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = "phi3-mini-3.8b", 2, 4096, 6, 3e-4
TRAIN_SCHEDULE, GRAD_SEQ, GRAD_COS = 2000, 512, 0.99
TRAIN_REDUCED, TRAIN_REDUCED_STEPS, TRAIN_RTOL = (LM_ARCH, MOE_ARCH, SSM_ARCH), 3, 1e-4
FT_STEPS, FT_EVERY, FT_FAIL, FT_RTOL = 12, 4, 6, 1e-5
#: K7b against its plain backward on the card, a share of each gradient's
#: max |value| (float32 sums in another order; bf16 gradients round to 8
#: bits)
K7B_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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
#: the sharded LM's logits against the single slot's, same kernels and
#: float32 compute, sums over ``model`` in another order: a share of the
#: single's max|logit|. Sound runs on the H100 read at most 5.8e-5; planted
#: faults read more (PERF.md, "PR 27").
SHARDED_LOGITS_RTOL = 1e-3
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
    smem = _build.load("flash_attention_bwd_tc").flash_attention_bwd_tc_smem_bytes
    print("flash_attention_bwd_tc dynamic shared memory (dQ, dK/dV kernel) by head dim: "
          + ", ".join(f"hd {d} {smem(d, 0)}, {smem(d, 1)} bytes" for d in (16, 64, 96, 128)))
    for name in ("flash_attention_tc", "flash_attention_bwd_tc"):
        info = _build.BUILD_INFO.get(name)
        if info is not None:
            spills = re.findall(r"(\d+) bytes spill stores", info["log"])
            require(spills and not any(int(n) for n in spills),
                    f"build {name}: every instance compiles without a spill ({len(spills)} "
                    "kernels)")


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
def launch_times(spans: list = None):
    """{launch counter: [device ms of each launch]} of the DP kernels (K1,
    K2, K3, K4, K5, K6) launched inside: CUDA events recorded around each
    wrapper's ``_launch``, in stream order, so a pair brackets one launch
    (with its wrapper's small copies and any host gap), read after a
    synchronise; the counter that moved names the launch. ``spans``, where
    given, receives each launch's ``(counter, start event, end event)``."""
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
    if spans is not None:
        spans += pairs


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
    held against the plain version (the alignment grids' read a grid row at
    a time, ``k1.grid_rows_plain``: cell by cell it takes ~25 s at 513² and
    minutes at 2048²; viterbi 64 x 2048, where the plain version would take
    half a minute, K3 against K1 on the same tensors), timed, and its
    bound; the sdp shapes' times are the records'. Returns {record name:
    [shape rows]}."""
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

    def rows(s, with_args):
        return lambda init, _, w: k1.grid_rows_plain(init, s.offsets, s.op, s.n, w,
                                                     with_args=with_args)

    others = other_instances(np.random.default_rng(SEED))
    for name, label in (("edit_distance", "edit_distance 513^2"), ("lcs", "lcs 513^2"),
                        ("unbounded_knapsack", "unbounded_knapsack 4097")):
        spec = dp.get_problem(name).encode(**others[name])
        if name == "unbounded_knapsack":
            plain = lambda init, _, w, s=spec: k1.sdp_pipeline_plain(  # noqa: E731
                init, s.offsets, s.op, s.n, weights=w, with_args=True)
            what = "table and args bit-equal to plain"
        else:
            plain, what = rows(spec, True), "table and args bit-equal to plain, a row a step"
        timed(("sdp_pipeline_with_args", label), spec, k1.sdp_pipeline_with_args,
              True, 3, equals_plain(plain, True), what)
        if name == "edit_distance":
            timed(("sdp_pipeline", label), spec, k1.sdp_pipeline, False, 3,
                  equals_plain(rows(spec, False), False), "table bit-equal to plain, a row a step")
    def equals_k1(spec):
        def check(init, w, got):
            want = k1.sdp_pipeline_with_args(init, spec.offsets, spec.op, spec.n, weights=w)
            return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return check

    # the plain version would take ~30 s here: K3 against K1 (viterbi 64 x 256
    # is held against the plain version above)
    vspec = dp.get_problem("viterbi").encode(**others["viterbi"])
    timed(("sdp_chunked_with_args", "viterbi 64 x 2048"), vspec, k3.sdp_chunked_with_args,
          True, 3, equals_k1(vspec), "table and args bit-equal to sdp_pipeline's (K1)")
    rs = np.random.default_rng(SEED)
    espec = dp.get_problem("edit_distance").encode(
        x=rs.integers(0, 4, EDIT_BIG_N), y=rs.integers(0, 4, EDIT_BIG_N))
    timed(("sdp_chunked_with_args", "edit_distance 2048^2"), espec, k3.sdp_chunked_with_args,
          True, 2, equals_plain(rows(espec, True), True),
          "table and args bit-equal to plain, a row a step")

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


# ---------------------------------------------------------------------------
# The training path (K7 forward and recompute, K7b)
# ---------------------------------------------------------------------------
def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (the recompute not counted): 6 per
    parameter of every matrix product and token (the embedding's gather
    does none), and attention's 12·hd per unmasked (query, key) pair and
    head (4·hd forward, 8·hd backward)."""
    matmul = cfg.param_count() - cfg.vocab_size * cfg.d_model
    pairs = batch * cfg.n_heads * seq * (seq + 1) // 2
    n_attn = sum(cfg.mixer_of(i) == "attn" for i in range(cfg.n_layers))
    return 6.0 * matmul * batch * seq + 12.0 * cfg.hd * pairs * n_attn


def train_batches(cfg, batch: int, seq: int, device):
    from repro_torch.data.pipeline import SyntheticLM, to_device

    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=SEED,
                       frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model)
    return lambda i: to_device(data.batch(i), device)


#: K7b's two bodies: the record's name suffix and source by body
K7B_BODIES = {k7.TENSOR_CORES: ("_tc", "src/repro_torch/csrc/flash_attention_bwd_tc.cu"),
              k7.CUDA_CORES: ("", "src/repro_torch/csrc/flash_attention_bwd.cu")}


def k7b_records(name: str, q, k, v, reps: int) -> list:
    """K7b at bf16 (B, Hq, S, D) q and GQA k, v (their o and log-sum-exp
    from K7's forward, dO seeded), which its rule sends to the tensor-core
    body: each body (tensor cores, then CUDA cores on the same tensors)
    against the plain backward on the card, twice for equal bits, and
    timed; the plain backward and SDPA's backward (the yardstick: one
    PyTorch call, used nowhere in the port) timed once for both. One record
    a body (``name`` + ``_tc`` for the tensor cores). Bound: q, k, v, o, dO
    read and dQ, dK, dV written once (the log-sum-exp too); 10·D FLOP a
    unmasked pair (S, dP, dV, dQ, dK) over the bf16 tensor-core peak."""
    g = torch.Generator(device=q.device).manual_seed(SEED + 7)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    o, lse = k7._launch(q, k, v, True, k7.body_for(q, k, v), with_lse=True)
    require(k7.backward_body_for(q, k, v, o, do) == k7.TENSOR_CORES,
            f"{name}: bf16 q, k, v, o and dO take K7b's tensor-core body")
    want, plain = timed_once(lambda: k7.flash_attention_backward_plain(q, k, v, o, lse, do))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                           enable_gqa=True)
    lib = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps)
    del out, leaves
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    nbytes = q.element_size() * d * s * b * (4 * hq + 4 * hkv) + 4 * b * hq * s
    flops = 10 * d * b * hq * s * (s + 1) // 2
    tol = K7B_TOL[q.dtype]
    records = []
    for body, (suffix, source) in K7B_BODIES.items():
        label = name + suffix
        got = k7._launch_backward(q, k, v, o, lse, do, True, body)
        again = k7._launch_backward(q, k, v, o, lse, do, True, body)
        err, share = 0.0, 0.0
        for part, a, bb, w in zip("qkv", got, again, want):
            require(torch.equal(a, bb), f"{label} d{part}: two runs give equal bits")
            e = max_err(a, w)
            err, share = max(err, e), max(share, e / max(float(w.float().abs().max()), 1e-12))
        require(share <= tol, f"{label} ({body}) {tuple(q.shape)} by {tuple(k.shape)} "
                f"{q.dtype}: max_abs_err {err}, {share:.3e} of max|grad|, within {tol}")
        del got, again
        ms = cuda_ms(lambda: k7._launch_backward(q, k, v, o, lse, do, True, body),
                     reps if body == k7.TENSOR_CORES else max(1, reps // 3))
        print(f"{label}: K7b's {body} body {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
              f"plain {plain:.3f} ms, SDPA backward {lib:.4f} ms "
              f"({flops / lib / 1e9:.2f} TFLOP/s)")
        records.append(kernel_record(label, source, "src/repro/kernels/ops.py:316", err, ms,
                                     plain, nbytes, flops, peak=BF16_OPS_PER_S,
                                     library_ms=lib))
    return records


def grads_against_float32(model) -> int:
    """The model's bf16 gradients at one ``GRAD_SEQ``-token sequence
    against the same weights' gradients in float32 compute (K7's and K7b's
    CUDA-core bodies, float32 products): the cosine of every parameter's
    pair at least ``GRAD_COS``. The counters are zeroed before each pass
    and read after: K7b once a layer, on the tensor-core body in bf16 and
    on the CUDA-core body in float32. Returns the float32 pass's K7b
    launches (all on the CUDA-core body)."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    batch = train_batches(cfg, 1, GRAD_SEQ, model.device)(0)
    grads, bodies = [], []
    for dtype in (cfg.compute_dtype, torch.float32):
        reset_launches()
        with compute_dtype(model, dtype):
            loss, _ = loss_fn(model, batch)
            grads.append((float(loss.detach()), torch.autograd.grad(loss, list(params.values()))))
        counts = launches()
        bodies.append({k: counts[k] for k in ("flash_attention_bwd", "flash_attention_bwd_tc")})
    layers = cfg.n_layers
    require(bodies == [{"flash_attention_bwd": layers, "flash_attention_bwd_tc": layers},
                       {"flash_attention_bwd": layers, "flash_attention_bwd_tc": 0}],
            f"train: K7b once a layer, on the tensor-core body in {cfg.compute_dtype} and on "
            f"the CUDA-core body in float32 compute: {bodies}")
    (l16, g16), (l32, g32) = grads
    cos = sorted((float((a.float() * b).sum() / (a.float().norm() * b.norm() + 1e-30)), n)
                 for n, a, b in zip(params, g16, g32))
    print(f"train: {cfg.compute_dtype} loss {l16} against float32 compute {l32} at "
          f"{GRAD_SEQ} tokens; gradient cosine per parameter: lowest {cos[:3]}, median "
          f"{cos[len(cos) // 2][0]:.6f}")
    require(cos[0][0] >= GRAD_COS, f"train: every parameter's bf16 gradient within cosine "
            f"{GRAD_COS} of its float32-compute one (lowest {cos[0][0]:.6f}, {cos[0][1]})")
    return bodies[1]["flash_attention_bwd"]


def train_full(cuda) -> tuple:
    """phi3-mini-3.8b at full width and depth: ``TRAIN_STEPS`` steps of
    ``build_step`` with the counters zeroed before them and read after,
    then one step under the profiler and K7b at layer 0's tensors.
    Returns (K7b's records, the steps' launches, the float32-compute
    gradient pass's K7b launches)."""
    from repro_torch.launch import train
    from repro_torch.models.attention import _project_qkv
    from repro_torch.optim import adamw, schedules

    cfg = get_config(TRAIN_ARCH)
    model = init_model(cfg, cuda, "train")
    batches = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, cuda)
    state = train.init_state(model)
    f32_launches = grads_against_float32(model)
    held = batches(TRAIN_SCHEDULE)
    with torch.no_grad():
        held_before = float(loss_fn(model, held)[0])
    step = train.build_step(model, cfg, TRAIN_LR, TRAIN_SCHEDULE)
    gib = sum(t.numel() * t.element_size() for t in (
        *state[0].values(), *state[1]["m"].values(), *state[1]["v"].values())) / 2 ** 30
    print(f"train: {cfg.name} weights and float32 AdamW moments {gib:.2f} GiB")
    flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    reset_launches()
    rows, per_step = [], []
    t_all = time.perf_counter()
    for i in range(TRAIN_STEPS):
        batch = batches(i)
        before = launches()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = launches()
        per_step.append({k: after[k] - before[k] for k in
                         ("flash_attention", "flash_attention_tc", "flash_attention_bwd",
                          "flash_attention_bwd_tc")})
        row = {k: float(v) for k, v in m.items()}
        rows.append(row)
        print(f"train step {i}: loss {row['loss']:.4f}, grad_norm {row['grad_norm']:.4f}, lr "
              f"{row['lr']:.3e}; {dt:.3f} s, {tokens / dt:.1f} tokens/s, model-FLOP "
              f"utilisation {flops / dt / BF16_OPS_PER_S:.4f} of 989 TFLOP/s")
    wall = time.perf_counter() - t_all
    counts = launches()
    peak = torch.cuda.max_memory_allocated(cuda) / 2 ** 30
    print(f"train: {TRAIN_STEPS} steps of {tokens} tokens in {wall:.3f} s "
          f"(the first of a {TRAIN_SCHEDULE}-step schedule) "
          f"({TRAIN_STEPS * tokens / wall:.1f} tokens/s, {flops / 1e12:.2f} model TFLOP a "
          f"step); peak device memory {peak:.3f} GiB; launches {counts}")
    with torch.no_grad():
        held_after = float(loss_fn(model, held)[0])
    require(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
            "train: every loss and grad norm finite")
    require(rows[-1]["loss"] < rows[0]["loss"],
            f"train: the last loss {rows[-1]['loss']} below the first {rows[0]['loss']}")
    require(held_after < held_before, f"train: a held-out batch's loss {held_before} -> "
            f"{held_after}, lower after the steps")
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_tc": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers, "flash_attention_bwd_tc": cfg.n_layers}
    require(all(c == want for c in per_step), f"train: each step launched {want} (K7 "
            f"forward and recompute, K7b once a layer, all on the tensor-core bodies): "
            f"{per_step}")
    require(peak < 75.0, f"train: peak device memory {peak:.3f} GiB under 75")

    # where the time goes: one more step under the profiler, the gradients
    # and the AdamW update apart
    params, opt_state = state
    batch = batches(TRAIN_STEPS)
    opt_cfg = adamw.AdamWConfig(lr=schedules.warmup_cosine(TRAIN_LR, TRAIN_SCHEDULE // 20,
                                                           TRAIN_SCHEDULE))

    def grads():
        loss, _ = loss_fn(model, batch)
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    groups = {**LM_GROUPS, "flash_attention_bwd (K7b)": (
        "delta_tc_kernel", "dq_tc_kernel", "dkv_tc_kernel", "dq_kernel", "dkv_kernel")}
    g, host_ms, by = device_profile(grads, groups, cpu=False)
    describe_profile("train step: loss and gradients", host_ms, by)
    _, host_ms, by = device_profile(lambda: adamw.apply(opt_cfg, g, opt_state, params),
                                    groups, cpu=False)
    describe_profile("train step: AdamW update", host_ms, by)
    del g

    # K7b at layer 0's tensors of the first batch
    tokens0 = batches(0)["tokens"]
    with torch.no_grad():
        h = rmsnorm(model.embed_tokens(tokens0), model.layers[0].ln1, cfg.norm_eps)
        positions = torch.arange(TRAIN_SEQ, device=cuda).expand(TRAIN_BATCH, TRAIN_SEQ)
        q, k, v = (heads_major(t) for t in _project_qkv(model.layers[0].mixer, cfg, h,
                                                          positions))
    del model, state, params, opt_state, h, step, grads
    gc.collect()
    torch.cuda.empty_cache()
    records = k7b_records("flash_attention_bwd", q, k, v, reps=6)
    return records, counts, f32_launches


def train_reduced(cuda) -> None:
    """The reduced configs in float32: ``TRAIN_REDUCED_STEPS`` steps on the
    card and on the CPU from the same weights and batches."""
    from repro_torch.launch import train

    for arch in TRAIN_REDUCED:
        cfg = get_config(arch).reduced()
        cpu_model = CausalLM.from_seed(cfg, seed=SEED, device="cpu")
        card_model = CausalLM(cfg, device=cuda)
        card_model.load_state_dict(cpu_model.state_dict())
        losses = []
        for model in (cpu_model, card_model):
            batches = train_batches(cfg, 4, 64, model.device)
            step, state = train.build_step(model, cfg, 1e-3, 10), train.init_state(model)
            out = []
            for i in range(TRAIN_REDUCED_STEPS):
                state, m = step(state, batches(i))
                out.append(float(m["loss"]))
            losses.append(np.array(out))
        err = float(np.max(np.abs(losses[1] - losses[0]) / np.abs(losses[0])))
        require(err <= TRAIN_RTOL, f"reduced {arch}: {TRAIN_REDUCED_STEPS} train steps on the "
                f"card {losses[1].tolist()} against the CPU {losses[0].tolist()}, relative "
                f"{err:.3e} within {TRAIN_RTOL}")


def train_supervised(cuda) -> float:
    """The training CLI's pieces on the card (reduced qwen3-14b): the
    supervisor over ``FT_STEPS`` steps with a checkpoint every
    ``FT_EVERY``, once with a failure injected at ``FT_FAIL`` and once
    without, each from the seed's weights. Returns the failure-free run's
    last loss."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train
    from repro_torch.runtime.fault_tolerance import FTConfig, InjectedFailure, Supervisor

    cfg = get_config(LM_ARCH).reduced()
    runs = []
    for fail in (True, False):
        fired = []

        def hook(step):
            if fail and step == FT_FAIL and not fired:
                fired.append(step)
                raise InjectedFailure("node lost")

        model = CausalLM.from_seed(cfg, seed=SEED, device=cuda)
        with tempfile.TemporaryDirectory() as ck_dir:
            sup = Supervisor(train.build_step(model, cfg, 1e-3, FT_STEPS),
                             Checkpointer(ck_dir, keep=2),
                             FTConfig(checkpoint_every=FT_EVERY), failure_hook=hook)
            state, log = sup.run(train.init_state(model), train_batches(cfg, 4, 64, cuda),
                                 0, FT_STEPS)
        runs.append((sup.stats, log, {n: p.detach().clone() for n, p in state[0].items()}))
    (stats, log, params), (_, clean_log, clean_params) = runs
    last, clean = log[-1]["loss"], clean_log[-1]["loss"]
    bits = all(torch.equal(params[n], clean_params[n]) for n in params)
    print(f"supervisor on the card: {stats}; final loss {last} against the failure-free "
          f"{clean}; weights bit-equal: {bits}")
    require(stats.restarts == 1 and stats.steps_replayed == FT_FAIL - FT_EVERY,
            f"supervisor: one restart, {FT_FAIL - FT_EVERY} steps replayed ({stats})")
    require(abs(last - clean) <= FT_RTOL * abs(clean), f"supervisor: the recovered run's "
            f"final loss {last} within {FT_RTOL} of the failure-free run's {clean}")
    return clean


def train_cli(cuda, clean: float) -> None:
    """``launch.train.main`` on its default device (the card) with the
    flags of ``train_supervised``'s failure-free run: reduced qwen3-14b,
    ``FT_STEPS`` steps of 4 x 64 tokens at lr 1e-3, a checkpoint every
    ``FT_EVERY``. Its last loss within ``FT_RTOL`` of that run's ``clean``,
    K7b launched, one metrics row a step, the last checkpoint at the last
    step."""
    import os
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train

    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        ck_dir, metrics = os.path.join(tmp, "ckpt"), os.path.join(tmp, "metrics.jsonl")
        last = train.main(["--arch", LM_ARCH, "--reduced", "--steps", str(FT_STEPS),
                           "--ckpt-every", str(FT_EVERY), "--batch", "4", "--seq", "64",
                           "--lr", "1e-3", "--seed", str(SEED), "--ckpt-dir", ck_dir,
                           "--metrics", metrics])
        with open(metrics) as f:
            rows = [json.loads(line) for line in f]
        latest = Checkpointer(ck_dir).latest_step()
    counts = launches()
    print(f"train CLI on its default device: last loss {last} against the supervised "
          f"failure-free run's {clean}, equal bits: {last == clean}; {len(rows)} metrics "
          f"rows, latest checkpoint {latest}; K7b launches {counts['flash_attention_bwd']}")
    require(counts["flash_attention_bwd"] > 0, "train CLI: K7b launched, so it ran on the card")
    require(len(rows) == FT_STEPS and latest == FT_STEPS, f"train CLI: {FT_STEPS} metrics "
            f"rows ({len(rows)}) and the latest checkpoint at step {FT_STEPS} ({latest})")
    require(abs(last - clean) <= FT_RTOL * abs(clean), f"train CLI: the last loss {last} "
            f"within {FT_RTOL} of the supervised failure-free run's {clean}")


def train_witness(cuda) -> None:
    """phi3-mini-3.8b from the seed's weights, ``TRAIN_STEPS`` steps of
    ``build_step`` on a schedule as long as the run (``TRAIN_LR`` warmed up
    over 10 steps: 3e-5 to 1.8e-4), twice from the same weights and
    batches: in bf16 compute, then in float32 compute (K7's CUDA-core body,
    K7b's float32 instance, float32 products). Prints both loss
    trajectories and whether each last loss is below its first; checks only
    that every loss and grad norm is finite."""
    from repro_torch.launch import train

    cfg = get_config(TRAIN_ARCH)
    model = init_model(cfg, cuda, "witness")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = train_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, cuda)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for dtype in (cfg.compute_dtype, torch.float32):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        torch.cuda.reset_peak_memory_stats(cuda)
        with compute_dtype(model, dtype) as run_cfg:
            state = train.init_state(model)
            step = train.build_step(model, run_cfg, TRAIN_LR, TRAIN_STEPS)
            rows = []
            for i in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, batches(i))
                rows.append({k: float(v) for k, v in m.items()})
                dt = time.perf_counter() - t0
                print(f"witness {dtype} step {i}: loss {rows[-1]['loss']:.4f}, grad_norm "
                      f"{rows[-1]['grad_norm']:.4f}, lr {rows[-1]['lr']:.3e}; {dt:.3f} s, "
                      f"{tokens / dt:.1f} tokens/s")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        losses = [r["loss"] for r in rows]
        print(f"witness {dtype}: {TRAIN_STEPS} steps on a {TRAIN_STEPS}-step schedule, losses "
              f"{losses}; the last below the first: {losses[-1] < losses[0]}; peak device "
              f"memory {torch.cuda.max_memory_allocated(cuda) / 2 ** 30:.3f} GiB")
        require(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
                f"witness {dtype}: every loss and grad norm finite")


def phase_train(cuda) -> list:
    """The training path's parts, each freeing the card before the next.
    Returns K7b's records (each body at phi3's layer and at qwen3-14b's
    served shape) with their launches: the tensor-core body's from the full
    run's steps, the CUDA-core body's from its float32-compute gradient
    pass."""
    t_all = time.perf_counter()
    seconds = {}
    t0 = time.perf_counter()
    records, counts, f32_launches = train_full(cuda)
    body_launches = {"_tc": counts["flash_attention_bwd_tc"], "": f32_launches}
    for rec in records:
        rec["launches"] = body_launches["_tc" if rec["name"].endswith("_tc") else ""]
        require(rec["launches"] > 0, f"{rec['name']} launched on the train path")
    seconds["full"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device=cuda).manual_seed(SEED)
    qw = get_config(LM_ARCH)
    s = 1746
    q, k, v = (heads_major(torch.randn((1, s, hh, qw.hd), generator=g, device=cuda)
                           .to(torch.bfloat16)) for hh in (qw.n_heads, qw.n_kv_heads,
                                                           qw.n_kv_heads))
    served = k7b_records("flash_attention_bwd_served", q, k, v, reps=9)
    for rec in served:
        rec["launches"] = body_launches["_tc" if rec["name"].endswith("_tc") else ""]
    del q, k, v
    torch.cuda.empty_cache()
    seconds["k7b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_reduced(cuda)
    seconds["reduced"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clean = train_supervised(cuda)
    seconds["supervisor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_cli(cuda, clean)
    seconds["cli"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print("train phases' seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; {time.perf_counter() - t_all:.2f} in all")
    return records + served


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


def session_traffic() -> list:
    """The service path's three streaming sessions, seeded: ``(problem,
    each append's full instance)``."""
    rng = np.random.default_rng(SEED + 7)
    x, y = rng.integers(0, 4, 256), rng.integers(0, 4, 2048)
    dims = rng.integers(1, 30, 257).astype(np.float64)
    knap = {"item_weights": np.array([3, 5, 7, 11, 13, 17]),
            "item_values": np.round(rng.random(6) * 10 + 0.5, 3)}
    return [("needleman_wunsch", [dict(x=x, y=y[:c]) for c in range(256, 2049, 256)]),
            ("mcm", [dict(dims=dims[:n + 1]) for n in (64, 128, 192, 256)]),
            ("unbounded_knapsack", [dict(knap, capacity=c) for c in (1024, 2048, 3072, 4096)])]


def service_sessions(svc, cuda) -> None:
    """Three streaming sessions, every append checked against a cold
    ``dp.solve`` of the same full instance on the card, bit for bit."""
    for name, steps in session_traffic():
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



# ---------------------------------------------------------------------------
# The sharded path: a mesh of SHARD_SLOTS slots on the one card
# ---------------------------------------------------------------------------
#: slots of the mesh (all on cuda:0, each its own stream), the ragged
#: bucket (2 pad lanes over 4 slots), the deadline that turns a hang of the
#: slots' launches into a failure, the phase's time limit
SHARD_SLOTS, SHARD_BUCKET, SHARD_DEADLINE_S, SHARD_LIMIT_S = 4, 6, 30.0, 180.0
#: (label, problem, size, route, launch counters): the sharded buckets
SHARD_BUCKETS = (
    ("MCM 512 (K4)", "mcm", MCM_BATCH_N, "kernel_tiled_wavefront", k4.LAUNCHES),
    ("MCM 256 (K2)", "mcm", MCM_SMALL_N, "kernel_wavefront", k2.LAUNCHES),
    ("sdp 2^20 (K1)", "sdp", SDP_N, "kernel_blocked", k1.LAUNCHES),
    ("needleman_wunsch 1024^2 (K6 antidiag)", "needleman_wunsch", ALIGN_BATCH_N,
     "kernel_grid", k6.LAUNCHES),
)
#: pipeline_apply: qwen3-14b at full width cut to PIPE_DEPTH layers, in
#: PIPE_STAGES stages, over PIPE_MICRO microbatches of 1 x PIPE_S tokens
PIPE_DEPTH, PIPE_STAGES, PIPE_MICRO, PIPE_S = 8, 4, 6, 1746


def shard_instances(rng, name: str, n: int) -> list:
    if name == "mcm":
        return [{"dims": mcm_dims(rng, n)} for _ in range(SHARD_BUCKET)]
    if name == "sdp":
        return [sdp_instance(rng) for _ in range(SHARD_BUCKET)]
    return [{"x": rng.integers(0, 4, n), "y": rng.integers(0, 4, n)}
            for _ in range(SHARD_BUCKET)]


def wait_slots(label: str, ends: list) -> None:
    """Poll the events until all have completed; raise past the deadline
    (a hang of the slots' launches fails the run instead of eating its
    time limit)."""
    t0 = time.perf_counter()
    while not all(e.query() for e in ends):
        if time.perf_counter() - t0 > SHARD_DEADLINE_S:
            raise RuntimeError(f"{label}: the slots' launches did not finish in "
                               f"{SHARD_DEADLINE_S} s")
        time.sleep(0.0005)


def cooperative_probe(ctx, label: str, specs: list, launch) -> None:
    """``launch(slot's stacked inputs)`` (a cooperative kernel's wrapper):
    once alone on slot 0 (after a warm-up), then once a slot with every
    slot's stream released by one event, waited for under the deadline.
    The slots' end times against the lone launch's time say whether the
    grids ran at the same time or one after the other."""
    placed = [dp.backends._stack(list(slot), None, ctx)
              for slot in zip(*(s.device_arrays() if isinstance(s, dp.GridSpec)
                                else (s.weights,) for s in specs))]
    torch.cuda.synchronize()
    with ctx.slots[0].scope():
        launch(*(p[0] for p in placed))
        _, alone = timed_once(lambda: launch(*(p[0] for p in placed)))
    go = torch.cuda.Event(enable_timing=True)
    go.record()
    ends = []
    for k, slot in enumerate(ctx.slots):
        with slot.scope():
            torch.cuda.current_stream().wait_event(go)
            launch(*(p[k] for p in placed))
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    wait_slots(label, ends)
    at = sorted(go.elapsed_time(e) for e in ends)
    serial = at[-1] > (len(at) - 0.5) * alone
    print(f"cooperative {label}, batch {len(specs) // len(ends)} a slot: alone "
          f"{alone:.3f} ms; on {len(ends)} streams of one card released together, "
          f"done at {', '.join(f'{t:.3f}' for t in at)} ms: "
          + ("one after the other" if serial else "at the same time"))


def sharded_probes(ctx) -> None:
    """K4 fused, K6 antidiag and K6 spandiag (cooperative grids sized to the
    whole card) launched on the mesh's concurrent streams, under a deadline,
    before any drain waits on them."""
    rng = np.random.default_rng(SEED + 7)
    mcm = [dp.get_problem("mcm").encode(**kw)
           for kw in shard_instances(rng, "mcm", MCM_BATCH_N)[:2]] * SHARD_SLOTS
    cooperative_probe(ctx, "K4 fused (mcm 512)", mcm,
                      lambda w: ops.mcm_tiled_fused(w, MCM_BATCH_N))
    for label, name, kw in (
            ("K6 antidiag (needleman_wunsch 1024^2)", "needleman_wunsch",
             shard_instances(rng, "needleman_wunsch", ALIGN_BATCH_N)[0]),
            ("K6 spandiag (cky 32)", "cky", cky_instance(rng, 32, 32, 512, 1024))):
        specs = [dp.get_problem(name).encode(**kw)] * SHARD_SLOTS
        meta = specs[0].static_meta()
        cooperative_probe(ctx, label, specs, lambda *arrs: ops.grid_blocked(arrs, meta))


def same_responses(got: list, want: list) -> bool:
    """Answers, tables, args and decoded solutions equal, bit for bit."""
    if [r.rid for r in got] != [r.rid for r in want]:
        return False
    for g, w in zip(got, want):
        if not np.array_equal(np.float32(g.answer), np.float32(w.answer)):
            return False
        if (g.solution is None) != (w.solution is None):
            return False
        if g.solution is not None and not (
                np.array_equal(g.solution.table, w.solution.table)
                and np.array_equal(g.solution.args, w.solution.args)
                and g.solution.solution == w.solution.solution):
            return False
    return True


def timed_step(engine, route: str) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.step(backend=route)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def union_ms(spans) -> float:
    """Length of the union of ``(start, end)`` intervals (overlapping
    slots' work counted once)."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def profiled_drain(engine, route: str) -> tuple:
    """One drain under ``torch.profiler`` with CUDA events around each DP
    kernel launch: ``(responses, wall ms, profiler line, kernel line)``.
    The profiler's device events (kernels and copies, union of their
    intervals) give the device busy share; the launches' events give the
    kernels' alone, as a check on what the profiler recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = []
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    with launch_times(spans), profile(activities=[ProfilerActivity.CUDA]) as prof:
        ref.record()
        t0 = time.perf_counter()
        got = engine.step(backend=route)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    busy = union_ms([(e.start_ns() / 1e6, (e.start_ns() + e.duration_ns()) / 1e6)
                     for e in dev])
    kernels = union_ms([(ref.elapsed_time(a), ref.elapsed_time(b)) for _, a, b in spans])
    return (got, wall,
            f"the profiler recorded {len(dev)} device events, busy {busy:.3f} ms of "
            f"{wall:.3f}, idle share {1 - busy / wall:.4f}",
            f"its {len(spans)} kernel launches by CUDA events busy {kernels:.3f} ms, "
            f"kernel idle share {1 - kernels / wall:.4f}")


def plain_twin_bucket(prob, route: str, specs: list, cuda) -> tuple:
    """The bucket through :func:`plain_twin` of ``route`` on the card,
    unsharded, with args (each kernel's plain version at the whole bucket;
    the plain versions' tables are the same with args or without):
    ``(answers, decoded solutions, ms)``."""
    twin = plain_twin(route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables, args, source, paths = dp.routing.run_batch_with_args(twin, specs, cuda)
    sols = dp.reconstruct.reconstruct_batch(prob, specs, tables, args, source, paths=paths)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return [prob.extract(t, s) for t, s in zip(tables, specs)], sols, ms


def same_as_plain_twin(got: list, twin: tuple, recon: bool) -> bool:
    """The sharded drain's answers, and with reconstruct its tables, args
    and decoded paths, equal to :func:`plain_twin_bucket`'s bit for bit."""
    answers, sols, _ = twin
    got = sorted(got, key=lambda r: r.rid)          # submitted in the specs' order
    equal = len(got) == len(answers)
    for g, a, p in zip(got, answers, sols):
        equal &= np.array_equal(np.float32(g.answer), np.float32(p.value if recon else a))
        if recon:
            equal &= (g.solution is not None and np.array_equal(g.solution.table, p.table)
                      and np.array_equal(g.solution.args, p.args)
                      and g.solution.solution == p.solution)
    return equal


def sharded_buckets(mesh, cuda) -> dict:
    """Each of ``SHARD_BUCKETS`` as a ragged bucket of ``SHARD_BUCKET``
    instances, with and without reconstruct, through the sharded engine and
    the single engine on the card with the route forced the same: equal
    responses, the counters, 4 launches a drain, the drain times, and one
    sharded drain's device idle share under the profiler. The first
    round's sharded drain (the kernel at ``SHARD_BUCKET / SHARD_SLOTS``
    lanes a slot, pad included) is also held against the route's plain
    twin on the card (run once a bucket), bit for bit."""
    rng = np.random.default_rng(SEED + 8)
    times = {}
    for label, name, n, route, counter in SHARD_BUCKETS:
        prob = dp.get_problem(name)
        t_enc = time.perf_counter()
        keyed = ranks.encoded(prob, shard_instances(rng, name, n))   # digested once
        enc_s = time.perf_counter() - t_enc
        specs = [sp for sp, _ in keyed]
        twin = plain_twin_bucket(prob, route, specs, cuda)
        for recon in (False, True):
            tag = f"sharded {label}{' reconstruct' if recon else ''}"
            t_tag = time.perf_counter()
            shard = dp.ShardedDPEngine(mesh=mesh, max_batch=8, feedback=False)
            plain = dp.DPEngine(max_batch=8, feedback=False, device=cuda)
            ms = {"sharded": [], "single": []}
            launched, equal = [], True
            for rnd in range(3):
                for eng in (shard, plain):
                    for sp, key in keyed:
                        eng.submit_spec(prob, sp, reconstruct=recon, digest=key)
                before = sum(counter.values())
                if rnd < 2:
                    got, t_s = timed_step(shard, route)
                else:
                    got, t_s, prof_line, kernel_line = profiled_drain(shard, route)
                launched.append(sum(counter.values()) - before)
                if rnd == 0:
                    twin_equal = same_as_plain_twin(got, twin, recon)
                want, t_p = timed_step(plain, route)
                equal &= same_responses(got, want) and all(r.backend == route for r in got)
                ms["sharded"].append(t_s)
                ms["single"].append(t_p)
            st = shard.stats
            print(f"{tag}: {time.perf_counter() - t_tag:.2f} s in all; encode and digest "
                  f"{enc_s:.2f} s for {SHARD_BUCKET}; drain ms sharded "
                  f"{ms['sharded'][0]:.3f} (cold), {ms['sharded'][1]:.3f}, "
                  f"{ms['sharded'][2]:.3f} (profiled); single engine "
                  f"{ms['single'][0]:.3f} (cold), {ms['single'][1]:.3f}, "
                  f"{ms['single'][2]:.3f}; the plain twin {twin[2]:.3f} (once a bucket); the profiled "
                  f"drain: {prof_line}; {kernel_line}")
            require(twin_equal, f"{tag}: answers{', tables, args and decoded paths' if recon else ''} "
                    f"bit-equal to {route}'s plain twin on the card (its kernels' plain "
                    f"versions at batch {SHARD_BUCKET})")
            require(equal, f"{tag}: answers, tables, args and decoded paths bit-equal to "
                    f"the single engine's on the card ({route})")
            require(st["sharded_drains"] == 3 and st["padded_lanes"] == 3 * 2,
                    f"{tag}: sharded_drains {st['sharded_drains']} == 3, padded_lanes "
                    f"{st['padded_lanes']} == 6")
            require(launched == [SHARD_SLOTS] * 3,
                    f"{tag}: {route} launched {launched} times a drain (want "
                    f"{SHARD_SLOTS} each)")
            times[tag] = (ms["sharded"][1], ms["single"][1])
    return times


def sharded_runtime(mesh, cuda) -> None:
    """compressed_psum over the slots against the CPU port's, best_mesh and
    reshard after a simulated loss, over slots of the card."""
    rng = np.random.default_rng(SEED + 9)
    xs = [torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32) * (i + 1))
          for i in range(SHARD_SLOTS)]
    want = grad_compress.compressed_psum([x * 2.0 for x in xs],
                                         rt_sharding.Mesh(["cpu"] * SHARD_SLOTS, ("i",)))
    src = [x.to(cuda) for x in xs]

    def on_slots(factor: float) -> list:
        """Each shard (``factor`` times its source) made on its slot's
        stream, held back by a spin first: the collective must wait for the
        slots."""
        shards = []
        for x, slot in zip(src, mesh.slots.flat):
            slot.follow(x)
            with slot.scope():
                torch.cuda._sleep(50_000_000)
                shards.append(x * factor)
        return shards

    # a first round loads every kernel involved (a lazy module load
    # synchronizes the card and would hide a missing wait); the checked
    # round's shards are twice its shards, so a read of a block the
    # allocator handed back before its write would see other values
    grad_compress.compressed_psum(on_slots(1.0), mesh)
    torch.cuda.synchronize()
    got = grad_compress.compressed_psum(on_slots(2.0), mesh)
    torch.cuda.synchronize()
    shards = on_slots(1.0)
    torch.cuda.synchronize()
    _, ms = timed_once(lambda: grad_compress.compressed_psum(shards, mesh))
    require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
            f"compressed_psum over {SHARD_SLOTS} slots of 2^20 floats, each made late on "
            f"its slot's stream, bit-equal to the CPU port's ({ms:.3f} ms)")
    slots16 = [cuda] * 16
    shapes = [tuple(elastic.best_mesh(elastic.simulate_device_loss(slots16, lost), 4).shape.values())
              for lost in (0, 4, 6)]
    m = elastic.best_mesh(elastic.simulate_device_loss(slots16, 6), 4)
    tree = {"w": torch.arange(80.0).reshape(10, 8), "b": {"v": torch.arange(8.0)}}
    placed = elastic.reshard(tree, m, lambda path, x: ("data", "model")[: x.ndim])
    back = rt_sharding.gather(placed["w"], m, ("data", "model"))
    back_v = rt_sharding.gather(placed["b"]["v"], m, ("data",))
    require(shapes == [(4, 4), (3, 4), (5, 2)] and torch.equal(back.cpu(), tree["w"])
            and torch.equal(back_v.cpu(), tree["b"]["v"])
            and placed["w"][4, 1].device == cuda,
            f"best_mesh over 16/12/10 slots {shapes}; reshard then gather after the loss "
            "equal on the card")


def sharded_pipeline(cuda) -> int:
    """pipeline_apply over PIPE_STAGES slots of the card: qwen3-14b's blocks
    at full width (depth PIPE_DEPTH, weights from the seed), float32
    compute, PIPE_MICRO microbatches of 1 x PIPE_S tokens through the
    blocks' full-sequence causal forward, against the same blocks applied
    in sequence. Returns K7's launches in the pipeline's run."""
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=PIPE_DEPTH)
    model = init_model(cfg, cuda, "pipeline")
    layer_params = [sum(p.numel() for p in b.parameters()) for b in model.layers]
    bounds, bottleneck = pipeline_parallel.stage_boundaries(layer_params, PIPE_STAGES)
    edges = (0, *bounds, PIPE_DEPTH)
    stages = [list(model.layers[a:b]) for a, b in zip(edges, edges[1:])]
    mesh = rt_sharding.Mesh([cuda] * PIPE_STAGES, ("stage",))
    rng = np.random.default_rng(SEED + 10)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (PIPE_MICRO, PIPE_S)), device=cuda)
    positions = torch.arange(PIPE_S, device=cuda).expand(1, PIPE_S)

    def stage_fn(blocks, x):
        for blk in blocks:
            x, _ = blk(x, positions, "train")
        return x

    with torch.no_grad(), compute_dtype(model, torch.float32):
        x = model.embed_tokens(tokens)[:, None]               # (M, 1, S, d)
        # the first call is the slots' threads' first: each makes its cuBLAS
        # handle and workspace then
        _, first_ms = timed_once(lambda: pipeline_parallel.pipeline_apply(
            stage_fn, stages, x, mesh))
        reset_launches()
        got, pipe_ms = timed_once(lambda: pipeline_parallel.pipeline_apply(
            stage_fn, stages, x, mesh))
        counts = launches()
        want, seq_ms = timed_once(lambda: torch.stack([stage_fn(model.layers, x[i])
                                                       for i in range(PIPE_MICRO)]))
    err = max_err(got, want)
    scale = float(want.abs().max())
    print(f"pipeline_apply: {cfg.name} blocks at d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} kv heads, hd {cfg.hd}, {cfg.param_dtype} weights, float32 "
          f"compute; stages {[len(s) for s in stages]} (boundaries {bounds}, bottleneck "
          f"{bottleneck:.0f} parameters); {PIPE_MICRO} microbatches of 1 x {PIPE_S}: "
          f"pipeline {pipe_ms:.1f} ms on {PIPE_STAGES} streams (its first call "
          f"{first_ms:.1f} ms), the blocks in sequence "
          f"{seq_ms:.1f} ms; max_abs_err {err} of max|h| {scale:.3f}; bits equal: "
          f"{torch.equal(got, want)}; K7 launches {counts['flash_attention']} "
          f"({counts['flash_attention_tc']} on the tensor-core body)")
    require(got.shape == want.shape and bool(torch.isfinite(got).all())
            and err <= LOGITS_RTOL * scale,
            f"pipeline_apply within {LOGITS_RTOL} of max|h| of the blocks in sequence")
    require(counts["flash_attention"] == PIPE_DEPTH * PIPE_MICRO,
            f"pipeline: K7 launched {counts['flash_attention']} times "
            f"({PIPE_DEPTH} layers x {PIPE_MICRO} microbatches)")
    del model, stages, got, want, x
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention"]


def phase_sharded(cuda) -> dict:
    """A mesh of SHARD_SLOTS slots on the card: the cooperative kernels on
    concurrent streams under a deadline, ShardedDPEngine's ragged buckets
    against the single engine, compressed_psum, best_mesh and reshard, and
    pipeline_apply over qwen3-14b's blocks (``DPService`` over the mesh is
    held against the single engine on the service path's whole traffic by
    :func:`phase_service_processes`). Returns the DP kernels' launches of
    the drains."""
    print(card_line())
    t_phase = time.perf_counter()
    mesh = rt_sharding.Mesh([cuda] * SHARD_SLOTS, (dp.sharding.BATCH_AXIS,))
    ctx = dp.ShardContext(mesh)
    sharded_probes(ctx)
    reset_launches()
    t_drains = time.perf_counter()
    times = sharded_buckets(mesh, cuda)
    counts = launches()
    print(f"launches on the sharded drains: {counts}")
    for name in ("sdp_pipeline", "mcm_pipeline", "mcm_tiled", "grid_pipeline_antidiag"):
        n = sum(v for k, v in counts.items() if k.startswith(name))
        require(n > 0, f"sharded drains: {name} launched {n} times")
    gate_launches("sharded", cuda)
    t_runtime = time.perf_counter()
    sharded_runtime(mesh, cuda)
    t_pipe = time.perf_counter()
    sharded_pipeline(cuda)
    t_end = time.perf_counter()
    print(f"sharded phase parts (s): probes {t_drains - t_phase:.2f}, drains "
          f"{t_runtime - t_drains:.2f}, psum and elastic {t_pipe - t_runtime:.2f}, pipeline "
          f"{t_end - t_pipe:.2f}")
    print("sharded drain ms (warm; sharded over 4 streams, single engine): " + "; ".join(
        f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items()))
    took = t_end - t_phase
    require(took <= SHARD_LIMIT_S, f"sharded phase took {took:.1f} s (limit {SHARD_LIMIT_S:.0f} s)")
    return counts



# ---------------------------------------------------------------------------
# The sharded LM: the per-rank program over SHARD_SLOTS slots of the card
# ---------------------------------------------------------------------------
#: (arch, depth: None = the published depth) served over each mesh, the
#: meshes as (data, model), the requests of the LM traffic taken; the
#: phase's deadline (a hang of a slot fails the run there) and its limit
SLM_MODELS = (("qwen3-14b", 8), ("granite-moe-3b-a800m", None), ("rwkv6-1.6b", None),
              ("granite-20b", 4))
SLM_MESHES, SLM_REQUESTS = ((1, 4), (2, 2)), 4
SLM_DEADLINE_S, SLM_LIMIT_S = 420.0, 240.0


class Recorder:
    """A model (or sharded model) whose ``prefill`` and ``decode_step`` keep
    their logits, host ms (each call ends in a sync) and K7's launches in
    the calls; every other attribute is the model's."""

    def __init__(self, model):
        self.model, self.logits, self.k7 = model, [], 0
        self.ms = {"prefill": [], "decode": []}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _timed(self, kind: str, fn, *args, **kw):
        torch.cuda.synchronize()
        before = k7.LAUNCHES["flash_attention"]
        t0 = time.perf_counter()
        logits, cache = fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.k7 += k7.LAUNCHES["flash_attention"] - before
        self.logits.append(logits)
        return logits, cache

    def prefill(self, *args, **kw):
        return self._timed("prefill", self.model.prefill, *args, **kw)

    def decode_step(self, *args, **kw):
        return self._timed("decode", self.model.decode_step, *args, **kw)


def serve_forced(engine, prompts: list, forced: list = None) -> tuple:
    """The prompts through ``engine``, one request a slot, its next tokens
    recorded after each admit and step; where ``forced`` (another run's
    record) is given, they are replaced by it (teacher-forced). Returns
    (the requests, the record)."""
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW) for i, p in enumerate(prompts)]
    record = []

    def after():
        record.append(engine.next_tok.copy())
        if forced is not None:
            engine.next_tok[:] = forced[len(record) - 1]

    for r in reqs:
        engine.admit(r)
        after()
    while engine.active().any():
        engine.step()
        after()
    return reqs, record


def slot_bytes(sharded) -> tuple:
    """(the parameter bytes each slot holds, the bytes of ``spec_for``'s
    shard of every parameter: each sharded dim over its axes' size)."""
    mesh, defs = sharded.mesh, param_defs(sharded.cfg)
    first = sharded.params.flat[0]

    def count(entry) -> int:
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        return int(np.prod([mesh.shape[a] for a in axes]))

    want = sum(int(np.prod([d // count(e) for d, e in zip(defs[n].shape, spec)]))
               * first[n].element_size() for n, spec in sharded.specs.items())
    held = [sum(t.numel() * t.element_size() for t in sharded.params[idx].values())
            for idx in np.ndindex(mesh.slots.shape)]
    return held, want


def step_idle(fn) -> str:
    """One call of ``fn`` under ``torch.profiler`` (device activity only):
    host ms, device busy ms (the union of the kernels' and copies'
    intervals: the slots' streams overlap) and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not dev:
        return f"host {wall:.3f} ms; device time not measured (no CUDA activity recorded)"
    busy = union_ms([(e.start_ns() / 1e6, (e.start_ns() + e.duration_ns()) / 1e6)
                     for e in dev])
    return (f"host {wall:.3f} ms, {len(dev)} device events, busy {busy:.3f} ms, "
            f"idle share {1 - busy / wall:.4f}")


def k7_slot_record(model, prompts, cuda) -> dict:
    """K7 at slot 0's share of a served prompt's layer-0 heads on a (1, 4)
    mesh, float32 as the phase computes (the CUDA-core body), against its
    plain version and timed beside SDPA."""
    s = len(prompts[0])
    tokens = torch.as_tensor(prompts[0], dtype=torch.int64, device=cuda)[None]
    q, k, v = layer0_qkv(model, tokens)
    hq, hkv = q.shape[1] // SHARD_SLOTS, k.shape[1] // SHARD_SLOTS
    q, k, v = q[:, :hq], k[:, :hkv], v[:, :hkv]
    got = k7.flash_attention(q, k, v)
    want, plain = timed_once(lambda: k7.flash_attention_plain(q, k, v))
    err = max_err(got, want)
    require(err <= K7_TOL[q.dtype], f"flash_attention at slot 0's share {tuple(q.shape)} "
            f"by {tuple(k.shape)} {q.dtype}: max_abs_err {err} within {K7_TOL[q.dtype]}")
    ms = cuda_ms(lambda: k7.flash_attention(q, k, v), 5)
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 5)
    d = q.shape[3]
    nbytes = q.element_size() * d * s * (2 * hq + 2 * hkv)
    flops = 4 * d * hq * s * (s + 1) // 2
    return kernel_record("flash_attention_sharded_slot", "src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/kernels/flash_attention.py:68", err, ms, plain,
                         nbytes, flops, peak=F32_OPS_PER_S, library_ms=lib)


def sharded_lm_model(arch: str, depth, meshes: dict, cuda) -> tuple:
    """One model over each of ``SLM_MESHES``: the first ``SLM_REQUESTS``
    requests of the LM traffic through the single-slot engine, then through
    the sharded engine fed the single's tokens (teacher-forced), float32
    compute on bf16 weights from the seed. Checks the logits of every prefill and step,
    each slot's parameter bytes and K7's launches; prints the times and a
    sharded decode step's idle share. Returns (K7's launches on the
    sharded traffic, the K7 record where taken)."""
    full = get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
    model = init_model(cfg, cuda, f"sharded lm {arch}")
    prompts = lm_traffic(cfg)[1][:SLM_REQUESTS]
    attn = sum(cfg.mixer_of(i) == "attn" for i in range(cfg.n_layers))
    k7_sharded, record = 0, None
    with compute_dtype(model, torch.float32):
        single = Recorder(model)
        single_eng = Engine(single, max_batch=LM_BATCH, max_len=LM_MAX_LEN)
        single_reqs, forced = serve_forced(single_eng, prompts)
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.int64, device=cuda)
        pos = torch.as_tensor(single_eng.pos, dtype=torch.int64, device=cuda)
        print(f"sharded lm {arch}: one decode step, single slot: "
              + step_idle(lambda: model.decode_step(tok, single_eng.cache, pos)))
        require(single.k7 == attn * len(prompts), f"sharded lm {arch}: K7 launched "
                f"{single.k7} times on the single slot's traffic ({attn} x {len(prompts)})")
        del single_eng
        for shape, mesh in meshes.items():
            label = f"sharded lm {arch} {shape[0]}x{shape[1]}"
            t0 = time.perf_counter()
            sharded = model.place(mesh)
            torch.cuda.synchronize()
            place_s = time.perf_counter() - t0
            held, want = slot_bytes(sharded)
            require(held == [want] * SHARD_SLOTS,
                    f"{label}: each slot holds {held} parameter bytes, spec_for's {want}")
            shard = Recorder(sharded)
            eng = Engine(shard, max_batch=LM_BATCH, max_len=LM_MAX_LEN)
            reset_launches()
            reqs, _ = serve_forced(eng, prompts, forced)
            counts = launches()
            k7_sharded += counts["flash_attention"]
            errs = [max_err(a, b) / float(b.abs().max())
                    for a, b in zip(shard.logits, single.logits)]
            agree = sum(int(a == b) for r1, r2 in zip(single_reqs, reqs)
                        for a, b in zip(r1.out, r2.out))
            total = sum(len(r.out) for r in single_reqs)
            print(f"{label}: placed in {place_s:.2f} s; {len(errs)} logits (prefill and steps), "
                  f"largest error {np.max(errs):.3e} of max|logit|; greedy tokens agree "
                  f"{agree} of {total}; prefill ms sharded "
                  f"{', '.join(f'{x:.1f}' for x in shard.ms['prefill'])}, single "
                  f"{', '.join(f'{x:.1f}' for x in single.ms['prefill'])}; decode step ms "
                  f"median sharded {np.median(shard.ms['decode']):.3f}, single "
                  f"{np.median(single.ms['decode']):.3f} ({len(shard.ms['decode'])} steps)")
            require(len(errs) == len(single.logits) == len(forced)
                    and all(np.isfinite(e) and e <= SHARDED_LOGITS_RTOL for e in errs),
                    f"{label}: the logits of every prefill and decode step within "
                    f"{SHARDED_LOGITS_RTOL} of max|logit| of the single slot's")
            require(agree == total, f"{label}: every greedy token equals the single "
                    f"slot's ({agree} of {total})")
            require(counts["flash_attention"] == shard.k7 == SHARD_SLOTS * attn * len(prompts),
                    f"{label}: K7 launched {counts['flash_attention']} times on the sharded "
                    f"traffic ({SHARD_SLOTS} slots x {attn} attention layers x "
                    f"{len(prompts)} prefills)")
            pos = torch.as_tensor(eng.pos, dtype=torch.int64, device=cuda)
            print(f"{label}: one decode step, sharded: "
                  + step_idle(lambda: sharded.decode_step(tok, eng.cache, pos)))
            del sharded, shard, eng
            gc.collect()
            torch.cuda.empty_cache()
        if arch == LM_ARCH:
            record = k7_slot_record(model, prompts, cuda)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return k7_sharded, record


def phase_sharded_lm(cuda) -> dict:
    """Every model of ``SLM_MODELS`` over ``SLM_MESHES`` (4 slots of the
    card, a stream and a thread each), under a deadline: a hang of a slot
    ends the run with a failure. Returns K7's record at a slot's share,
    its launches the sharded traffic's."""
    print(card_line())
    t0 = time.perf_counter()
    # cuBLAS keeps a workspace for each stream it ran on (64 MiB on this
    # card) for the life of the process: not the phase's tensors
    torch._C._cuda_clearCublasWorkspaces()
    held = torch.cuda.memory_allocated(cuda)
    # one stream a slot, shared by every mesh of the phase
    slots = rt_sharding.Mesh([cuda] * SHARD_SLOTS, ("slot",)).slots
    meshes = {shape: rt_sharding.Mesh.of_slots(slots.reshape(shape), ("data", "model"))
              for shape in SLM_MESHES}

    def hung():
        print(f"FAILED  sharded lm: the phase passed its {SLM_DEADLINE_S:.0f} s deadline "
              "(a slot hangs)", flush=True)
        os._exit(1)

    watchdog = threading.Timer(SLM_DEADLINE_S, hung)
    watchdog.daemon = True
    watchdog.start()
    try:
        launched, record = 0, None
        for arch, depth in SLM_MODELS:
            t_model = time.perf_counter()
            n, rec = sharded_lm_model(arch, depth, meshes, cuda)
            launched += n
            record = rec or record
            print(f"sharded lm {arch}: {time.perf_counter() - t_model:.2f} s")
    finally:
        watchdog.cancel()
    took = time.perf_counter() - t0
    del meshes, slots
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(cuda) - held
    print(f"sharded lm phase: {took:.2f} s; device memory allocated {held / 2 ** 30:.3f} GiB "
          f"before it, {left / 2 ** 20:.1f} MiB more after it, "
          f"{torch.cuda.memory_reserved(cuda) / 2 ** 30:.3f} GiB reserved; {card_line()}")
    require(left <= 64 * 2 ** 20, f"sharded lm: the phase left {left / 2 ** 20:.1f} MiB "
            "allocated behind it (at most 64)")
    require(took <= SLM_LIMIT_S, f"sharded lm phase took {took:.1f} s (limit {SLM_LIMIT_S:.0f} s)")
    record["launches"] = launched
    require(launched > 0, f"flash_attention_sharded_slot: K7 launched {launched} times on "
            "the sharded traffic")
    return record


# ---------------------------------------------------------------------------
# Sharded training: the per-rank train step over SHARD_SLOTS slots of the card
# ---------------------------------------------------------------------------
#: (arch, depth) trained at full width over each of SLM_MESHES, each in
#: float32 (parameters and compute: K7's and K7b's CUDA-core bodies) and in
#: bf16 (their tensor-core bodies); the batch (sequences x tokens) and lr;
#: float32 held to the CPU tests' bounds (tests/test_torch_sharded_train.py:
#: the loss relative, each gradient a share of its max |value|, the step's
#: loss and grad norm relative and the parameters after it a share of max
#: |value|, an element whose gradient is noise within two steps of lr), bf16
#: the loss and every gradient to 2e-2 of max|·| over every gradient of the
#: single slot's; the phase's collective timeout (a hang fails the run
#: there), deadline and limit
SHT_MODELS = (("phi3-mini-3.8b", 8), ("granite-moe-3b-a800m", 4))
SHT_BATCH, SHT_SEQ, SHT_LR = 4, 1024, 3e-4
SHT_LOSS_RTOL, SHT_GRAD_TOL, SHT_STEP_RTOL, SHT_BF16_RTOL = 1e-5, 1e-4, 1e-4, 2e-2
SHT_TIMEOUT_S, SHT_DEADLINE_S, SHT_LIMIT_S = 120.0, 420.0, 120.0


def single_grads(model, batch, upstream: dict = None) -> tuple:
    """(loss, {name: gradient}) of ``loss_fn`` on the single slot;
    ``upstream``, where given, receives the gradient at the token
    embeddings (``upstream["u"]``, (B, T, d))."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    if upstream is not None:
        def embed(tokens, frontend=None):
            x = type(model).embed_tokens(model, tokens, frontend)
            x.register_hook(lambda g: upstream.__setitem__("u", g))
            return x

        model.embed_tokens = embed
    try:
        loss, _ = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    finally:
        if upstream is not None:
            del model.embed_tokens
    return float(loss.detach()), {n: torch.zeros_like(p) if g is None else g
                                  for (n, p), g in zip(params.items(), grads)}


def embedding_witness(model, batch, u, port: torch.Tensor, truth: torch.Tensor,
                      label: str) -> None:
    """The bf16 embedding gradient's rounding, apart from the bf16 noise
    upstream of it: the single slot's gradient at the token embeddings
    (``u``) summed per token by PyTorch's gradient of a bf16 table's lookup
    (``index_put_`` with accumulate into the bf16 table) and in float32;
    the float32 sum against float32 compute on the same weights
    (``truth``: the upstream noise), and the port's gradient (``port``,
    the lookup in float32) against the float32 sum."""
    tok = batch["tokens"].reshape(-1).long()
    u = u.reshape(tok.numel(), -1)
    w = model.embed.detach()
    bf16_sum = torch.zeros_like(w).index_put_((tok,), u.to(w.dtype), accumulate=True).float()
    f32_sum = torch.zeros(w.shape, dtype=torch.float32, device=w.device).index_put_(
        (tok,), u.float(), accumulate=True)
    scale = float(f32_sum.abs().max())
    share = lambda a, b: float((a.float() - b.float()).abs().max()) / scale
    print(f"{label}: embedding witness on the same upstream gradient: PyTorch's bf16 lookup "
          f"gradient {share(bf16_sum, f32_sum):.3e} of max|g| from the float32 sum; the "
          f"float32 sum {share(f32_sum, truth):.3e} from float32 compute; the port's "
          f"gradient {share(port, f32_sum):.3e} from the float32 sum")


def whole_share(got: dict, want: dict) -> float:
    """The largest error over every tensor as a share of the largest
    |want| over every tensor (NaN where ``got`` is not finite)."""
    err = np.max([float((got[n].float() - w.float()).abs().max()) for n, w in want.items()])
    scale = max(float(w.float().abs().max()) for w in want.values())
    return float(err) / max(scale, 1e-30)


def worst_share(got: dict, want: dict, skip: dict = None) -> tuple:
    """(the largest error as a share of its tensor's max |want|, its name);
    where ``skip[name]`` (a mask) is given those elements are left out."""
    worst = (0.0, "")
    for n, w in want.items():
        err = (got[n].float() - w.float()).abs()
        if skip is not None:
            err = torch.where(skip[n], 0.0, err)
        share = float(err.max()) / max(float(w.float().abs().max()), 1e-30)
        if not np.isfinite(float(got[n].float().abs().max())):
            share = float("inf")
        worst = max(worst, (share, n))
    return worst


def sharded_step_check(model, cfg, sharded, batch, label: str) -> None:
    """One AdamW step on the single slot (``build_step``) and over the mesh
    from the same weights: the loss and grad norm within ``SHT_STEP_RTOL``,
    the parameters within ``SHT_STEP_RTOL`` of max |value| (an element
    whose gradient is noise, within two steps of lr)."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw, schedules

    _, grads = single_grads(model, batch)
    noise = {n: g.abs() <= SHT_GRAD_TOL * g.abs().max() for n, g in grads.items()}
    del grads
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = train.init_state(model)
    single = train.build_step(model, cfg, SHT_LR, 20)(state, batch)[1]
    del state
    opt_cfg = adamw.AdamWConfig(lr=schedules.warmup_cosine(SHT_LR, 10, 20))
    opt = sharded.init_opt(opt_cfg)
    got = sharded.train_step(opt_cfg, opt, batch)
    del opt
    lr = float(single["lr"])
    gathered = sharded.gather_params()
    rel = {k: abs(float(got[k]) - float(single[k])) / abs(float(single[k]))
           for k in ("loss", "grad_norm")}
    share, name = worst_share(gathered, {n: p.detach() for n, p in model.named_parameters()},
                              noise)
    moved = max(float(torch.where(noise[n], (gathered[n] - p.detach()).abs(), 0.0).max())
                for n, p in model.named_parameters())
    print(f"{label}: one AdamW step, loss {float(got['loss'])} against {float(single['loss'])}, "
          f"grad norm {float(got['grad_norm'])} against {float(single['grad_norm'])}; "
          f"parameters within {share:.3e} of max|p| ({name}), noise elements within "
          f"{moved:.3e} (lr {lr:.3e})")
    require(all(r <= SHT_STEP_RTOL for r in rel.values()) and share <= SHT_STEP_RTOL
            and moved <= 2 * lr, f"{label}: the step's loss and grad norm within "
            f"{SHT_STEP_RTOL} ({rel}), the parameters within {SHT_STEP_RTOL} of max|p|, "
            "noise elements within two steps of lr")
    with torch.no_grad():   # the next mesh starts from the same weights
        for n, p in model.named_parameters():
            p.copy_(start[n])


def sharded_train_dryrun(cfg, arch: str, sharded, batch, label: str) -> None:
    """One train step over the (2, 2) mesh with slot 0's collectives logged,
    against ``dryrun.run_cell`` of the same step on a (2, 2) mesh of
    ``meta`` slots: the collectives' kinds, counts and bytes, and the
    argument bytes against slot 0's real shards."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.optim import adamw, schedules

    opt_cfg = adamw.AdamWConfig(lr=schedules.warmup_cosine(3e-4, 100, 10_000))
    opt = sharded.init_opt(opt_cfg)
    shards, b = sharded.split_batch(batch)

    def fn(comm):
        if comm.rank == 0:
            comm.log = []
        sharded.rank_train_step(comm, opt_cfg, opt[comm.index], shards[comm.index], b)
        return comm.log

    with rt_sharding.activate(sharded.mesh, sharded.rules):
        log = rt_sharding.run(sharded.mesh, fn)[0, 0]
    real = sum(t.numel() * t.element_size()
               for t in (*sharded.params[0, 0].values(), *opt[0, 0]["m"].values(),
                         *opt[0, 0]["v"].values(), opt[0, 0]["step"],
                         *shards[0, 0][0].values()))
    del opt
    grid = np.empty(tuple(sharded.mesh.shape.values()), dtype=object)
    grid[...] = torch.device("meta")
    mesh = rt_sharding.Mesh(grid, sharded.mesh.axis_names)
    base = dryrun.get_config(arch)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, "smoke_train", False, microbatches=1,
                          cfg_overrides={f.name: getattr(cfg, f.name)
                                         for f in dataclasses.fields(cfg)
                                         if getattr(cfg, f.name) != getattr(base, f.name)},
                          mesh=mesh, shape=ShapeCell("smoke_train", SHT_SEQ, SHT_BATCH, "train"))
    nbytes, counts = op_analysis.collectives(log)
    print(f"{label}: the dry run of the step on meta slots in {time.perf_counter() - t0:.2f} s: "
          f"collectives {rec['collective_counts']} / {rec['collectives']}, the real step's "
          f"{counts} / {nbytes}; argument bytes {rec['argument_size_in_bytes']} against slot "
          f"0's {real}; {rec['flops']:.4e} FLOP, {rec['hbm_per_device'] / 2 ** 30:.3f} GiB "
          f"a slot predicted")
    require(rec["collective_counts"] == counts and rec["collectives"] == nbytes,
            f"{label}: the dry run's collective kinds, counts and bytes equal the real step's")
    require(rec["argument_size_in_bytes"] == real,
            f"{label}: the dry run's argument bytes equal slot 0's real shards")


def sharded_train_model(arch: str, depth: int, meshes: dict, cuda) -> dict:
    """``arch`` at full width and ``depth`` layers, in float32 and bf16: the
    loss and gradients over each mesh against the single slot's, K7's and
    K7b's launches counted on each; phi3's float32 step checked and its
    bf16 step's collectives against the dry run. Returns the launches by
    counter over the sharded runs and, for phi3, q, k and v at slot 0's
    share of layer 0 on (1, 4) in bf16."""
    totals = {k: 0 for k in k7.LAUNCHES}
    slot_qkv = None
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_config(arch), n_layers=depth, param_dtype=dtype,
                                  compute_dtype=dtype)
        model = init_model(cfg, cuda, f"sharded train {arch} {str(dtype)[6:]}")
        batch = {k: v if v.is_floating_point() else v.int()   # int32 tokens, as the dry run's
                 for k, v in train_batches(cfg, SHT_BATCH, SHT_SEQ, cuda)(0).items()}
        attn = sum(cfg.mixer_of(i) == "attn" for i in range(cfg.n_layers))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upstream = {} if dtype == torch.bfloat16 else None
        loss, want = single_grads(model, batch, upstream)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        truth = None
        if dtype == torch.bfloat16:   # float32 compute on the same (bf16) weights
            wide = dataclasses.replace(cfg, param_dtype=torch.float32,
                                       compute_dtype=torch.float32)
            model32 = CausalLM(wide, device=cuda)
            model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
            truth = single_grads(model32, batch)[1]
            del model32
            counts = np.bincount(batch["tokens"].flatten().cpu().numpy())
            print(f"sharded train {arch} bf16: the single slot's gradients against float32 "
                  f"compute on the same weights: {worst_share(want, truth)}, all within "
                  f"{whole_share(want, truth):.3e}; the batch's most frequent token "
                  f"{counts.max()} times of {counts.sum()}")
            embedding_witness(model, batch, upstream.pop("u"), want["embed"], truth["embed"],
                              f"sharded train {arch} bf16")
        for shape, mesh in meshes.items():
            label = f"sharded train {arch} {str(dtype)[6:]} {shape[0]}x{shape[1]}"
            sharded = model.place(mesh)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads, metrics = sharded.grads(batch)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            counts = launches()
            for key in totals:
                totals[key] += counts[key]
            rel = abs(float(metrics["loss"]) - loss) / abs(loss)
            share, name = worst_share(grads, want)
            whole = whole_share(grads, want)
            if truth is not None:
                print(f"{label}: against float32 compute on the same weights: "
                      f"{worst_share(grads, truth)}, all within {whole_share(grads, truth):.3e}; "
                      "per tensor against the single slot: "
                      + ", ".join(f"{n} {worst_share({n: grads[n]}, {n: want[n]})[0]:.2e}"
                                  for n in sorted(want, key=lambda n: -worst_share(
                                      {n: grads[n]}, {n: want[n]})[0])[:6]))
            print(f"{label}: loss {float(metrics['loss'])} against the single slot's {loss} "
                  f"(relative {rel:.3e}); each gradient within {share:.3e} of its max|g| "
                  f"({name}), all within {whole:.3e} of the largest; "
                  f"{took:.3f} s (single slot {single_s:.3f} s); K7 {counts['flash_attention']} "
                  f"(tensor cores {counts['flash_attention_tc']}), K7b "
                  f"{counts['flash_attention_bwd']} (tensor cores "
                  f"{counts['flash_attention_bwd_tc']})")
            if dtype == torch.float32:
                require(rel <= SHT_LOSS_RTOL and share <= SHT_GRAD_TOL,
                        f"{label}: the loss within {SHT_LOSS_RTOL} and each gradient within "
                        f"{SHT_GRAD_TOL} of its max|g| of the single slot's")
            else:
                require(np.isfinite(float(metrics["loss"])) and rel <= SHT_BF16_RTOL
                        and whole <= SHT_BF16_RTOL, f"{label}: the loss and every gradient "
                        f"finite and within {SHT_BF16_RTOL} of max|·| of the single slot's")
            slots = SHARD_SLOTS
            tc = dtype == torch.bfloat16
            want_counts = {"flash_attention": 2 * attn * slots,
                           "flash_attention_tc": 2 * attn * slots if tc else 0,
                           "flash_attention_bwd": attn * slots,
                           "flash_attention_bwd_tc": attn * slots if tc else 0}
            require({k: counts[k] for k in want_counts} == want_counts,
                    f"{label}: K7 twice and K7b once an attention layer, slot and "
                    f"microbatch ({attn} x {slots} x 1): {want_counts}")
            del grads
            if dtype == torch.float32 and arch == SHT_MODELS[0][0]:
                sharded_step_check(model, cfg, sharded, batch, label)
            if tc and arch == SHT_MODELS[0][0] and shape == (2, 2):
                sharded_train_dryrun(cfg, arch, sharded, batch, label)
            if tc and arch == SHT_MODELS[0][0] and shape == (1, 4):
                with torch.no_grad():
                    h = rmsnorm(model.embed_tokens(batch["tokens"]), model.layers[0].ln1,
                                cfg.norm_eps)
                    positions = torch.arange(SHT_SEQ, device=cuda).expand(SHT_BATCH, SHT_SEQ)
                    q, k, v = (heads_major(t) for t in _project_qkv(model.layers[0].mixer,
                                                                     cfg, h, positions))
                    hq, hkv = cfg.n_heads // slots, cfg.n_kv_heads // slots
                    slot_qkv = tuple(t.contiguous() for t in (q[:, :hq], k[:, :hkv], v[:, :hkv]))
            del sharded
            gc.collect()
            torch.cuda.empty_cache()
        del model, want, batch, truth
        gc.collect()
        torch.cuda.empty_cache()
    return totals, slot_qkv


def phase_sharded_train(cuda) -> list:
    """Every model of ``SHT_MODELS`` trained over ``SLM_MESHES`` (4 slots of
    the card), under a collective timeout of ``SHT_TIMEOUT_S`` and a
    deadline; then K7 and K7b at slot 0's share of phi3's layer 0 in bf16,
    against their plain versions and beside SDPA. Returns their records,
    launches the phase's."""
    props = torch.cuda.get_device_properties(0)
    print(f"{card_line()}; total_memory {props.total_memory} bytes")
    t0 = time.perf_counter()
    torch._C._cuda_clearCublasWorkspaces()
    held = torch.cuda.memory_allocated(cuda)
    slots = rt_sharding.Mesh([cuda] * SHARD_SLOTS, ("slot",)).slots
    meshes = {shape: rt_sharding.Mesh.of_slots(slots.reshape(shape), ("data", "model"))
              for shape in SLM_MESHES}
    timeout = rt_sharding.COLLECTIVE_TIMEOUT_S
    rt_sharding.COLLECTIVE_TIMEOUT_S = SHT_TIMEOUT_S

    def hung():
        print(f"FAILED  sharded train: the phase passed its {SHT_DEADLINE_S:.0f} s deadline "
              "(a slot hangs)", flush=True)
        os._exit(1)

    watchdog = threading.Timer(SHT_DEADLINE_S, hung)
    watchdog.daemon = True
    watchdog.start()
    try:
        totals, qkv = {k: 0 for k in k7.LAUNCHES}, None
        for arch, depth in SHT_MODELS:
            t_model = time.perf_counter()
            counts, got = sharded_train_model(arch, depth, meshes, cuda)
            totals = {k: totals[k] + counts[k] for k in totals}
            qkv = got or qkv
            print(f"sharded train {arch}: {time.perf_counter() - t_model:.2f} s")
    finally:
        watchdog.cancel()
        rt_sharding.COLLECTIVE_TIMEOUT_S = timeout
    took = time.perf_counter() - t0
    del meshes, slots
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(cuda) - held
    print(f"sharded train phase: {took:.2f} s; launches {totals}; {left / 2 ** 20:.1f} MiB "
          f"more allocated after it; {card_line()}")
    require(took <= SHT_LIMIT_S, f"sharded train phase took {took:.1f} s "
            f"(limit {SHT_LIMIT_S:.0f} s)")
    q, k, v = qkv
    fwd = k7_record("flash_attention_sharded_train_slot", q, k, v, reps=10)
    fwd["launches"] = totals["flash_attention_tc"]
    bwd = k7b_records("flash_attention_bwd_sharded_train_slot", q, k, v, reps=6)
    for rec in bwd:
        rec["launches"] = (totals["flash_attention_bwd_tc"] if rec["name"].endswith("_tc")
                           else totals["flash_attention_bwd"] - totals["flash_attention_bwd_tc"])
    for rec in (fwd, *bwd):
        require(rec["launches"] > 0, f"{rec['name']}: launched on the sharded train path")
    return [fwd, *bwd]


# ---------------------------------------------------------------------------
# The sharded LM one process a rank (runtime/distributed.py), against threads
# ---------------------------------------------------------------------------
#: (arch, depth) served over each of SLM_MESHES at full width, float32
#: compute on the seed's weights, PROC_REQUESTS requests of the LM traffic
#: with PROC_NEW tokens each (a prefill each, then one decode step of all
#: four); (arch, depth) trained in float32 on (2, 2) (one train step of
#: SHT_BATCH x SHT_SEQ tokens, its gradients kept); four
#: ranks as four processes of the card (gloo: NCCL refuses two ranks on a
#: device); the ranks' collective timeout and the phase's limit. The phase
#: took 101.8-108.7 s on an H100 80GB HBM3 at 700 W, most of it (2, 2)'s
#: FSDP gathers crossing gloo through host memory (a qwen3-14b call ~6 s):
#: the limit is 1.2 x the slowest, and every call past the first decode
#: step would add one such call a request batch, so one step is timed.
PROC_SERVE = (("qwen3-14b", 8), ("granite-moe-3b-a800m", 4))
PROC_TRAIN, PROC_TRAIN_MESH = ("phi3-mini-3.8b", 8), (2, 2)
PROC_REQUESTS, PROC_NEW = 4, 2
PROC_TIMEOUT_S, PROC_LIMIT_S = 120.0, 130.0
#: new tokens a request over NCCL (one rank a card: decode steps to time)
PROC_NCCL_NEW = 6
K7_COUNTERS = ("flash_attention", "flash_attention_tc", "flash_attention_bwd",
               "flash_attention_bwd_tc")


def process_jobs(cuda) -> list:
    """The phase's rank programs as ``(fn, kwargs)`` (``launch/ranks.py``),
    each run by the threads and by the processes: serving on each mesh,
    then the train step."""
    jobs = []
    for arch, depth in PROC_SERVE:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth, compute_dtype=torch.float32)
        prompts = lm_traffic(cfg)[1][:PROC_REQUESTS]
        for shape in SLM_MESHES:
            jobs.append((ranks.serve, {"cfg": cfg, "prompts": prompts, "max_new": PROC_NEW,
                                       "max_len": LM_MAX_LEN, "mesh": shape, "seed": SEED}))
    arch, depth = PROC_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=depth, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    batch = {k: (v if v.is_floating_point() else v.int()).cpu().numpy()
             for k, v in train_batches(cfg, SHT_BATCH, SHT_SEQ, cuda)(0).items()}
    jobs.append((ranks.train, {"cfg": cfg, "batch": batch, "mesh": PROC_TRAIN_MESH,
                               "seed": SEED, "lr": SHT_LR, "warmup": 10, "total": 20}))
    return jobs


def job_label(fn, kw) -> str:
    return (f"{'serve' if fn is ranks.serve else 'train'} {kw['cfg'].name} "
            f"{kw['mesh'][0]}x{kw['mesh'][1]}")


def threaded_job(fn, kw, mesh, cuda) -> dict:
    """One job through the threaded ``ShardedLM`` (``CausalLM.from_seed`` on
    the card, placed on ``mesh``): its record with every large tensor as
    each slot's digest, the logits on the host."""
    cfg = kw["cfg"]
    model = CausalLM.from_seed(cfg, seed=SEED, device=cuda)
    sharded = model.place(mesh)
    del model
    if fn is ranks.serve:
        eng, rec = ranks.serve_requests(sharded, kw["prompts"], kw["max_new"], kw["max_len"])
        rec["cache"] = {tuple(int(i) for i in idx): ranks.digest(eng.cache.shards[idx])
                        for idx in np.ndindex(mesh.slots.shape)}
        rec["logits"] = [t.cpu() for t in rec["logits"]]
        del eng
    else:
        batch = {k: torch.as_tensor(v, device=cuda) for k, v in kw["batch"].items()}
        rec = ranks.train_record(sharded, batch, ranks.opt_config(kw["lr"], kw["warmup"],
                                                                    kw["total"]))
        rec["grads"] = {idx: ranks.digest(g) for idx, g in rec["grads"].items()}
        rec["params"] = {idx: ranks.digest(p) for idx, p in rec["params"].items()}
        rec["metrics"] = {k: v.cpu() for k, v in rec["metrics"].items()}
    del sharded
    return rec


def same_job(label: str, want: dict, got: list, fn, shape: tuple) -> None:
    """The ranks' records of one job over a ``shape`` mesh (rank order)
    against the threads': bit for bit."""
    first = got[0]["result"]
    by_index = list(zip(np.ndindex(*shape), got))
    if fn is ranks.serve:
        tokens = all(g["result"]["tokens"] == want["tokens"] for g in got)
        logits = (len(first["logits"]) == len(want["logits"])
                  and all(torch.equal(a, b) for a, b in zip(first["logits"], want["logits"])))
        others = all(g["result"]["logits"] == ranks.digest(want["logits"]) for g in got[1:])
        err = max(max_err(a, b) for a, b in zip(first["logits"], want["logits"]))
        cache = all(g["result"]["cache"] == want["cache"][idx] for idx, g in by_index)
        require(tokens and logits and others and cache,
                f"{label}: every rank's tokens, rank 0's {len(want['logits'])} logits (largest "
                f"gap {err}) and the other ranks' digests of them, and every rank's cache "
                "shards bit-equal to the threaded ShardedLM's")
    else:
        grads = all(g["result"]["grads"] == want["grads"][idx] for idx, g in by_index)
        params = all(g["result"]["params"] == want["params"][idx] for idx, g in by_index)
        metrics = all(ranks.digest(g["result"]["metrics"]) == ranks.digest(want["metrics"])
                      for g in got)
        require(grads and params and metrics,
                f"{label}: every rank's gradient shards of the step, parameters after it and "
                f"metrics (loss {float(want['metrics']['loss'])}, grad norm "
                f"{float(want['metrics']['grad_norm'])}) bit-equal to the threaded step's")


def k7_counts(counts: dict) -> dict:
    return {k: counts.get(k, 0) for k in K7_COUNTERS}


def phase_processes(cuda) -> list:
    """The sharded LM's serving and train step one process a rank: every
    job of :func:`process_jobs` first through the threaded ``ShardedLM``
    on four slots of the card (its results kept on the host, the model
    freed), then in four rank processes of the card over gloo, bit-equal,
    with K7's and K7b's launches summed over the ranks equal to the
    threads'; K7 and K7b timed in rank 0 at a rank's shapes. Over NCCL,
    one rank a card, where the host has two cards or more. Returns the
    records of K7 and K7b in the rank processes."""
    print(card_line())
    t0 = time.perf_counter()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    jobs = process_jobs(cuda)
    slots = rt_sharding.Mesh([cuda] * SHARD_SLOTS, ("slot",)).slots
    meshes = {shape: rt_sharding.Mesh.of_slots(slots.reshape(shape), ("data", "model"))
              for shape in SLM_MESHES}
    threads = []
    for fn, kw in jobs:
        reset_launches()
        torch.cuda.synchronize()
        t_job = time.perf_counter()
        rec = threaded_job(fn, kw, meshes[kw["mesh"]], cuda)
        torch.cuda.synchronize()
        threads.append((rec, time.perf_counter() - t_job, k7_counts(launches())))
        gc.collect()
        torch.cuda.empty_cache()
    threads_s = time.perf_counter() - t0
    del meshes, slots
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()

    prompts = jobs[0][1]["prompts"]
    qwen = jobs[0][1]["cfg"]
    hq, hkv = qwen.n_heads // SHARD_SLOTS, qwen.n_kv_heads // SHARD_SLOTS
    k7_shape = ((1, hq, len(prompts[0]), qwen.hd), (1, hkv, len(prompts[0]), qwen.hd))
    phi3 = jobs[-1][1]["cfg"]
    d_, m_ = PROC_TRAIN_MESH
    k7b_shape = ((SHT_BATCH // d_, phi3.n_heads // m_, SHT_SEQ, phi3.hd),
                 (SHT_BATCH // d_, phi3.n_kv_heads // m_, SHT_SEQ, phi3.hd))
    rank_jobs = [(fn, {**kw, "digest_out": True}) for fn, kw in jobs] + [
        (ranks.attention_ms, {"q_shape": k7_shape[0], "kv_shape": k7_shape[1]}),
        (ranks.attention_ms, {"q_shape": k7b_shape[0], "kv_shape": k7b_shape[1],
                              "backward": True})]
    t1 = time.perf_counter()
    done = distributed.launch(ranks.sequence, (1, SHARD_SLOTS), ("data", "model"),
                              [cuda] * SHARD_SLOTS, args=(rank_jobs,), timeout=PROC_TIMEOUT_S)
    procs_s = time.perf_counter() - t1
    print("dp processes, rank 0's jobs (s): " + ", ".join(
        f"{job['seconds']:.2f}" for job in done.reports[0].result))
    require(done.backend == "gloo" and not any(r.foreign for r in done.reports)
            and all(r.contexts == [cuda.index] for r in done.reports),
            f"processes: four ranks on one card over {done.backend} (gloo), none loading jax "
            f"or repro, each holding a context on card {cuda.index} alone "
            f"{[r.contexts for r in done.reports]}")
    path = {k: 0 for k in K7_COUNTERS}
    for j, (fn, kw) in enumerate(jobs):
        label = f"processes {job_label(fn, kw)}"
        got = [r.result[j] for r in done.reports]
        want, t_s, t_counts = threads[j]
        same_job(label, want, got, fn, kw["mesh"])
        counts = {k: sum(g["launches"].get(k, 0) for g in got) for k in K7_COUNTERS}
        path = {k: path[k] + counts[k] for k in K7_COUNTERS}
        require(counts == t_counts and counts["flash_attention"] > 0
                and (fn is ranks.serve or counts["flash_attention_bwd"] > 0),
                f"{label}: K7 and K7b launches summed over the ranks {counts} equal the "
                f"threads' {t_counts}")
        peaks = [(g["peak_bytes"] or 0) / 2 ** 30 for g in got]
        line = (f"{label}: processes {max(g['seconds'] for g in got):.2f} s, threads "
                f"{t_s:.2f} s; peak device memory by rank "
                f"{', '.join(f'{p:.3f}' for p in peaks)} GiB")
        if fn is ranks.serve:
            line += (f"; decode ms of each step ({len(want['ms']['decode'])}) processes "
                     f"(rank 0) {', '.join(f'{x:.3f}' for x in got[0]['result']['ms']['decode'])}"
                     f", threads {', '.join(f'{x:.3f}' for x in want['ms']['decode'])}"
                     f"; prefill ms processes "
                     f"{', '.join(f'{x:.1f}' for x in got[0]['result']['ms']['prefill'])}, "
                     f"threads {', '.join(f'{x:.1f}' for x in want['ms']['prefill'])}")
        print(line + f"; {card_line()}")
    records = []
    for j, (name, source, replaces, shapes, backward) in enumerate((
            ("flash_attention_rank_process", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:68", k7_shape, False),
            ("flash_attention_bwd_rank_process", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/ops.py:316", k7b_shape, True))):
        t = done.reports[0].result[len(jobs) + j]["result"]
        (b, h, s, d), (_, g, _, _) = shapes
        if backward:
            nbytes = 4 * d * s * b * (4 * h + 4 * g) + 4 * b * h * s
            flops = 10 * d * b * h * s * (s + 1) // 2
        else:
            nbytes = 4 * d * s * b * (2 * h + 2 * g)
            flops = 4 * d * b * h * s * (s + 1) // 2
        tol = (K7B_TOL if backward else K7_TOL)[torch.float32]
        require(t["share"] <= tol, f"{name} in rank 0's process at q {shapes[0]}, k and v "
                f"{shapes[1]} float32: {t['share']:.3e} of max|·| from its plain version, "
                f"within {tol}")
        rec = kernel_record(name, source, replaces, t["max_abs_err"], t["ms"], t["plain_ms"],
                            nbytes, flops, peak=F32_OPS_PER_S, library_ms=t["library_ms"])
        rec["launches"] = path["flash_attention_bwd" if backward else "flash_attention"]
        require(rec["launches"] > 0, f"{name}: launched in the rank processes")
        records.append(rec)
    print(f"processes phase: threads {threads_s:.2f} s, processes {procs_s:.2f} s (spawn, "
          f"weights drawn in each rank and every job); K7 and K7b launches in the ranks "
          f"{path}; {card_line()}")
    processes_nccl(cuda, jobs[0])
    took = time.perf_counter() - t0
    require(took <= PROC_LIMIT_S, f"processes phase took {took:.1f} s "
            f"(limit {PROC_LIMIT_S:.0f} s)")
    return records


def processes_nccl(cuda, job) -> None:
    """The first serving job over NCCL, one rank a card on up to four cards
    as a (1, n) mesh, against the threaded ``ShardedLM`` over the same
    cards (``--processes-nccl`` alone); where the host has one card, a
    line saying so (not a check)."""
    n = min(SHARD_SLOTS, torch.cuda.device_count())
    if n < 2:
        print(f"processes over NCCL: not run, {torch.cuda.device_count()} card on this host "
              "(NCCL takes one rank a card)")
        return
    fn, kw = job
    kw = {**kw, "mesh": (1, n), "max_new": PROC_NCCL_NEW}
    cards = [torch.device("cuda", i) for i in range(n)]
    mesh = rt_sharding.Mesh(np.array(cards, dtype=object).reshape(1, n), ("data", "model"))
    t0 = time.perf_counter()
    want = threaded_job(fn, kw, mesh, cuda)
    threads_s = time.perf_counter() - t0
    del mesh
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    done = distributed.launch(ranks.sequence, (1, n), ("data", "model"), cards,
                              args=([(fn, {**kw, "digest_out": True})],), timeout=PROC_TIMEOUT_S)
    got = done.result[0]
    peaks = ", ".join(f"{r.result[0]['peak_bytes'] / 2 ** 30:.3f}" for r in done.reports)
    print(f"processes over NCCL {job_label(fn, kw)}: launch {time.perf_counter() - t0:.2f} s "
          f"(job {got['seconds']:.2f} s in rank 0), threads {threads_s:.2f} s; decode step ms "
          f"processes (rank 0) {np.median(got['result']['ms']['decode']):.3f}, threads "
          f"{np.median(want['ms']['decode']):.3f}; prefill ms processes "
          f"{', '.join(f'{x:.1f}' for x in got['result']['ms']['prefill'])}, threads "
          f"{', '.join(f'{x:.1f}' for x in want['ms']['prefill'])}; peak device memory by rank "
          f"{peaks} GiB; {card_line()}")
    require(done.backend == "nccl" and [r.contexts for r in done.reports] == [[i] for i in range(n)]
            and not any(r.foreign for r in done.reports),
            f"processes over {n} cards: backend {done.backend} (nccl), rank r holding a "
            f"context on card r alone {[r.contexts for r in done.reports]}, none loading jax "
            "or repro")
    same_job(f"processes over NCCL {job_label(fn, kw)}", want,
             [r.result[0] for r in done.reports], fn, kw["mesh"])


# ---------------------------------------------------------------------------
# The sharded DP drains, the pipeline and compressed_psum one process a rank
# ---------------------------------------------------------------------------
#: drains of each bucket (a cold one, a warm one); the ranks' collective
#: timeout and the phase's time limit (at most the processes phase's)
DPP_ROUNDS, DPP_TIMEOUT_S, DPP_LIMIT_S = 2, 120.0, 130.0
#: the kernels timed in rank 0's process at its share of a bucket, by
#: SHARD_BUCKETS' route: (record name, source, replaced Pallas function,
#: reconstruct: the variant the drains launch)
DPP_KERNELS = {
    "kernel_blocked": ("sdp_pipeline_rank_process", "src/repro_torch/csrc/sdp_pipeline.cu",
                       "src/repro/kernels/sdp_pipeline.py:110", False),
    "kernel_wavefront": ("mcm_pipeline_rank_process", "src/repro_torch/csrc/mcm_pipeline.cu",
                         "src/repro/kernels/mcm_pipeline.py:105", False),
    "kernel_tiled_wavefront": ("mcm_tiled_fused_rank_process",
                               "src/repro_torch/csrc/mcm_tiled.cu",
                               "src/repro/kernels/mcm_tiled.py:380", True),
    "kernel_grid": ("grid_pipeline_antidiag_rank_process",
                    "src/repro_torch/csrc/grid_pipeline.cu",
                    "src/repro/kernels/grid_pipeline.py:259", False),
}


def fmt(xs, digits: int) -> str:
    return ", ".join(f"{x:.{digits}f}" for x in xs)


def dpp_work(spec, lanes: int, reconstruct: bool) -> tuple:
    """(bytes, operations) of a DP kernel's launch at ``lanes`` instances
    of ``spec``'s shape, as the smoke's kernel records count them."""
    if isinstance(spec, dp.GridSpec) and spec.schedule == "spandiag":
        nbytes, ops_ = spandiag_work(spec, reconstruct)
        return lanes * nbytes, lanes * ops_
    if isinstance(spec, dp.GridSpec):
        P, RC, L = spec.planes, spec.cells, len(spec.moves)
        nbytes = 4 * (L + 2 * P) * RC + 4 * P * RC * (2 if reconstruct else 1)
        return lanes * nbytes, lanes * 2 * antidiag_candidates(spec)
    if isinstance(spec, dp.TriangularSpec):
        return mcm_work(spec.n, lanes, reconstruct, reconstruct)
    nbytes, ops = sdp_work(spec, reconstruct)
    return lanes * nbytes, lanes * ops


def threaded_drains(buckets: list, mesh, cuda) -> list:
    """Each bucket through the threaded ``ShardedDPEngine`` over ``mesh``
    and the single engine on the card (fresh engines each, the route
    forced, ``DPP_ROUNDS`` drains; buckets that share their instances
    share their encoding): for each, {"sharded", "single": (the records,
    each drain's seconds), "stats", "launches": the sharded drains' kernel
    launches}."""
    out, specs = [], {}
    for prob_name, route, instances, recon in buckets:
        prob = dp.get_problem(prob_name)
        if id(instances) not in specs:
            specs[id(instances)] = ranks.encoded(prob, instances)
        shard = dp.ShardedDPEngine(mesh=mesh, max_batch=8, feedback=False)
        reset_launches()
        sharded = ranks.drain_rounds(shard, prob, specs[id(instances)], route, recon,
                                     DPP_ROUNDS, True)
        counts = launches()
        single = ranks.drain_rounds(dp.DPEngine(max_batch=8, feedback=False, device=cuda),
                                    prob, specs[id(instances)], route, recon, DPP_ROUNDS, True)
        out.append({"sharded": sharded, "single": single, "stats": dict(shard.stats),
                    "launches": counts})
    return out


def threaded_pipeline(cfg, tokens, cuda) -> tuple:
    """``pipeline_apply`` over ``SHARD_SLOTS`` slots of the card of
    ``CausalLM.from_seed(cfg)``'s blocks, staged by
    ``ranks.pipeline_stages``: (the outputs' digest, seconds, K7's
    launches)."""
    model = init_model(cfg, cuda, "dp processes, threaded pipeline")
    bounds, _ = ranks.pipeline_stages(cfg, SHARD_SLOTS)
    edges = (0, *bounds, cfg.n_layers)
    stages = [list(model.layers[a:b]) for a, b in zip(edges, edges[1:])]
    mesh = rt_sharding.Mesh([cuda] * SHARD_SLOTS, ("stage",))
    with torch.no_grad():
        x = ranks.pipeline_input(model.embed, cfg, tokens)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_parallel.pipeline_apply(ranks.block_stage, stages, x, mesh)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
    counts = launches()["flash_attention"]
    got = ranks.digest(out)
    del model, stages, x, out, mesh
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return got, took, counts


def phase_dp_processes(cuda) -> list:
    """``ShardedDPEngine``'s drains, ``pipeline_apply`` and ``compressed_psum``
    one process a rank: four rank processes of the card over gloo drain
    every ``SHARD_BUCKETS`` bucket (ragged, with and without reconstruct),
    run qwen3-14b's blocks (depth ``PIPE_DEPTH``, full width, float32
    compute) as ``PIPE_STAGES`` stages over ``PIPE_MICRO`` microbatches of
    ``PIPE_S`` tokens, and ``compressed_psum_rank``, each bit-equal to the
    threaded engine, ``pipeline_apply`` and ``compressed_psum`` on
    ``SHARD_SLOTS`` slots of the card (the drains to the single engine
    too), the kernels' launches summed over the ranks equal to the
    threads'. K1, K2, K4 fused, K6 antidiag and K7 timed in rank 0 at a
    rank's shapes. Returns their records."""
    print(card_line())
    t0 = time.perf_counter()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 11)
    buckets, labels = [], []
    for label, name, n, route, _ in SHARD_BUCKETS:
        instances = shard_instances(rng, name, n)
        for recon in (False, True):
            buckets.append((name, route, instances, recon))
            labels.append(f"{label}{' reconstruct' if recon else ''}")
    mesh = rt_sharding.Mesh([cuda] * SHARD_SLOTS, (dp.sharding.BATCH_AXIS,))
    threads = threaded_drains(buckets, mesh, cuda)
    t_psum = time.perf_counter()
    xs = [rng.standard_normal(1 << 20).astype(np.float32) * (i + 1) for i in range(SHARD_SLOTS)]
    shards = []
    for x, slot in zip(xs, mesh.slots.flat):
        with slot.scope():
            shards.append(torch.from_numpy(x).to(cuda))
    psum = ranks.digest(grad_compress.compressed_psum(shards, mesh))
    del mesh, shards
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=PIPE_DEPTH,
                              compute_dtype=torch.float32)
    tokens = rng.integers(0, cfg.vocab_size, (PIPE_MICRO, PIPE_S))
    t_pipe = time.perf_counter()
    pipe_digest, pipe_s, pipe_k7 = threaded_pipeline(cfg, tokens, cuda)
    threads_s = time.perf_counter() - t0
    print(f"dp processes, the threads' parts (s): drains {t_psum - t0:.2f}, compressed_psum "
          f"{t_pipe - t_psum:.2f}, pipeline with its model's draw "
          f"{time.perf_counter() - t_pipe:.2f}")

    # a job an instance set, with and without reconstruct (one encoding)
    jobs = [(ranks.dp_drains, {"buckets": buckets[k:k + 2], "rounds": DPP_ROUNDS,
                               "digest_out": True}) for k in range(0, len(buckets), 2)]
    jobs += [(ranks.pipeline, {"cfg": cfg, "tokens": tokens, "seed": SEED, "digest_out": True}),
             (ranks.compressed, {"shards": xs, "digest_out": True})]
    timed = {}
    for (name, route, instances, recon), label in zip(buckets, labels):
        if DPP_KERNELS[route][3] == recon:
            timed[route] = len(jobs)
            jobs.append((ranks.dp_kernel_ms, {"problem": name, "route": route,
                                              "instances": instances, "reconstruct": recon}))
    q_shape, kv_shape = (1, cfg.n_heads, PIPE_S, cfg.hd), (1, cfg.n_kv_heads, PIPE_S, cfg.hd)
    jobs.append((ranks.attention_ms, {"q_shape": q_shape, "kv_shape": kv_shape}))
    t1 = time.perf_counter()
    done = distributed.launch(ranks.sequence, (SHARD_SLOTS,), (dp.sharding.BATCH_AXIS,),
                              [cuda] * SHARD_SLOTS, args=(jobs,), timeout=DPP_TIMEOUT_S)
    procs_s = time.perf_counter() - t1
    print("dp processes, rank 0's jobs (s): " + ", ".join(
        f"{job['seconds']:.2f}" for job in done.reports[0].result))
    require(done.backend == "gloo" and not any(r.foreign for r in done.reports)
            and all(r.contexts == [cuda.index] for r in done.reports),
            f"dp processes: four ranks on one card over {done.backend} (gloo), none loading "
            f"jax or repro, each holding a context on card {cuda.index} alone")

    def summed(j: int) -> dict:
        got = [r.result[j]["launches"] for r in done.reports]
        return {k: sum(g.get(k, 0) for g in got) for k in got[0]}

    def peaks(j: int) -> str:
        return fmt([(r.result[j]["peak_bytes"] or 0) / 2 ** 30 for r in done.reports], 3)

    path = {}
    for k, (label, want) in enumerate(zip(labels, threads)):
        j = k // 2
        got = [r.result[j]["result"][k % 2] for r in done.reports]
        records, _ = want["sharded"]
        single, single_s = want["single"]
        same = all(g["responses"] == records for g in got) and records == single
        stats = all(g["stats"]["sharded_drains"] == want["stats"]["sharded_drains"]
                    and g["stats"]["padded_lanes"] == want["stats"]["padded_lanes"] for g in got)
        procs = [max(g["seconds"][i] for g in got) for i in range(DPP_ROUNDS)]
        print(f"dp processes {label}: drain s processes (slowest rank) {fmt(procs, 4)}, "
              f"threads {fmt(want['sharded'][1], 4)}, single engine {fmt(single_s, 4)} "
              f"(cold, warm); {card_line()}")
        require(same and stats,
                f"dp processes {label}: every rank's answers, tables, args and decoded paths "
                f"of {DPP_ROUNDS} drains bit-equal to the threaded sharded engine's and the "
                f"single engine's, sharded_drains and padded_lanes as the threads' "
                f"({want['stats']['sharded_drains']}, {want['stats']['padded_lanes']})")
        if k % 2:
            counts = {key: v for key, v in summed(j).items() if v}
            for key, v in counts.items():
                path[key] = path.get(key, 0) + v
            want_counts = {key: v for t in threads[k - 1:k + 1]
                           for key, v in t["launches"].items() if v}
            print(f"dp processes {label[:-len(' reconstruct')]}: peak device memory by rank "
                  f"{peaks(j)} GiB (both buckets)")
            require(counts == want_counts and sum(counts.values()) > 0,
                    f"dp processes {label[:-len(' reconstruct')]}, with and without "
                    f"reconstruct: launches summed over the ranks {counts} equal the "
                    f"threads' {want_counts}")
    j = len(buckets) // 2
    got = [r.result[j] for r in done.reports]
    k7 = summed(j)["flash_attention"]
    path["flash_attention"] = path.get("flash_attention", 0) + k7
    bounds = ranks.pipeline_stages(cfg, SHARD_SLOTS)[0]
    layers = [b - a for a, b in zip((0, *bounds), (*bounds, cfg.n_layers))]
    print(f"dp processes pipeline: {cfg.name} blocks (depth {cfg.n_layers}, d {cfg.d_model}) "
          f"in stages of {layers} layers, {PIPE_MICRO} x {PIPE_S} tokens: processes "
          f"{max(g['seconds'] for g in got):.2f} s (slowest rank, its draw included), threads "
          f"{pipe_s:.2f} s (the pipeline alone); peak device memory by rank {peaks(j)} GiB; "
          f"{card_line()}")
    require(all(g["result"] == pipe_digest for g in got),
            "dp processes pipeline: every rank's outputs bit-equal to the threaded "
            "pipeline_apply's")
    require(k7 == pipe_k7 == PIPE_DEPTH * PIPE_MICRO,
            f"dp processes pipeline: K7 launched {k7} times over the ranks, the threads' "
            f"{pipe_k7} ({PIPE_DEPTH} layers x {PIPE_MICRO} microbatches)")
    got = [r.result[j + 1] for r in done.reports]
    require([g["result"] for g in got] == psum,
            f"dp processes compressed_psum_rank of {SHARD_SLOTS} x 2^20 floats: every rank's "
            f"sum bit-equal to the threaded compressed_psum's "
            f"({max(g['seconds'] for g in got):.3f} s)")

    records = []
    for (name, route, instances, recon) in buckets:
        if route not in timed or DPP_KERNELS[route][3] != recon:
            continue
        rec_name, source, replaces, _ = DPP_KERNELS[route]
        t = done.reports[0].result[timed[route]]["result"]
        spec = dp.get_problem(name).encode(**instances[0])
        nbytes, ops_ = dpp_work(spec, t["lanes"], recon)
        require(t["equal"], f"{rec_name}: rank 0's {t['lanes']} lanes bit-equal to the plain "
                "version on the card")
        rec = kernel_record(rec_name, source, replaces, t["max_abs_err"], t["ms"],
                            t["plain_ms"], nbytes, ops_)
        prefix = rec_name[:-len("_rank_process")].replace("_fused", "")
        rec["launches"] = sum(v for k, v in path.items() if k.startswith(prefix))
        require(rec["launches"] > 0, f"{rec_name}: launched in the rank processes")
        records.append(rec)
    t = done.reports[0].result[-1]["result"]
    (b, h, sq, d), g = q_shape, kv_shape[1]
    require(t["share"] <= K7_TOL[torch.float32], f"flash_attention in rank 0's process at a "
            f"stage's shapes q {q_shape}, k and v {kv_shape} float32: {t['share']:.3e} of "
            f"max|·| from its plain version")
    rec = kernel_record("flash_attention_pipeline_rank_process",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68", t["max_abs_err"], t["ms"],
                        t["plain_ms"], 4 * d * sq * b * (2 * h + 2 * g),
                        4 * d * b * h * sq * (sq + 1) // 2, library_ms=t["library_ms"])
    rec["launches"] = path["flash_attention"]
    records.append(rec)
    took = time.perf_counter() - t0
    print(f"dp processes phase: threads {threads_s:.2f} s, processes {procs_s:.2f} s (spawn, "
          f"encodes and draws in each rank, every job); launches in the ranks "
          f"{ {k: v for k, v in path.items() if v} }; {card_line()}")
    require(took <= DPP_LIMIT_S, f"dp processes phase took {took:.1f} s "
            f"(limit {DPP_LIMIT_S:.0f} s)")
    return records


# ---------------------------------------------------------------------------
# DPService one process a rank
# ---------------------------------------------------------------------------
#: the ranks' collective timeout and the phase's time limit
SVP_TIMEOUT_S, SVP_LIMIT_S = 120.0, 150.0
#: the service-path kernels rank 0 times at its share of their service
#: bucket: route -> (record name, source, replaced Pallas function, the
#: problem whose bucket is timed (None: the route's largest), its counters)
SVP_KERNELS = {
    "kernel_tiled": ("sdp_chunked_rank_process", "src/repro_torch/csrc/sdp_chunked.cu",
                     "src/repro/kernels/sdp_pipeline.py:288", None, SERVICE_KERNELS["K3"]),
    "kernel_grid": ("grid_pipeline_spandiag_rank_process", "src/repro_torch/csrc/grid_pipeline.cu",
                    "src/repro/kernels/grid_pipeline.py:259", "cky",
                    SERVICE_KERNELS["K6 spandiag"]),
}


def service_requests(tight: bool) -> list:
    """The service path's 256 requests (``service_traffic``) as
    ``ranks.serve_dp`` takes them, each with a seeded priority 0-2 and,
    where ``tight``, the path's 5 ms start-by deadline on a share
    ``SERVICE_TIGHT`` of them (the same draws either way)."""
    rng = np.random.default_rng(SEED + 5)
    traffic = service_traffic(rng)
    out = []
    for name, kw, recon, _ in traffic:
        short = rng.random() < SERVICE_TIGHT
        out.append((name, kw, recon, int(rng.integers(3)), 5.0 if short and tight else None))
    return out


def timed_bucket(requests: list, records: list, route: str, problem) -> tuple:
    """(problem, reconstruct, the distinct instances of the largest group of
    one shape that ``route`` solved in ``records`` (those of ``problem``
    where given), at most ``SERVICE_BATCH``)."""
    groups: dict = {}
    for (name, kw, recon, _, _), rec in zip(requests, records):
        if rec["backend"] == route and not rec["cached"] and problem in (None, name):
            spec = dp.get_problem(name).encode(**kw)
            group = groups.setdefault((name, spec.shape_key(), recon), {})
            group[id(kw)] = kw
    if not groups:
        return None
    (name, _, recon), got = max(groups.items(), key=lambda g: len(g[1]))
    return name, recon, list(got.values())[:SERVICE_BATCH]


def same_service(a: dict, b: dict) -> bool:
    """Two ``ranks.serve_dp`` results' tickets (records) and sessions equal."""
    return a["records"] == b["records"] and a["sessions"] == b["sessions"]


def phase_service_processes(cuda) -> list:
    """``DPService`` one process a rank: the service path's 256 requests
    (``SERVICE_BATCH`` 32, priorities 0-2) and its three sessions through a
    ``DPService(comm=comm)`` in each of four rank processes of the card
    over gloo. Run A (no deadlines) is bit-equal on every rank to the
    threaded ``DPService(mesh=...)`` on ``SHARD_SLOTS`` slots of the card
    and to the single-engine service, the kernels' launches summed over the
    ranks equal to the threads'; run B (5 ms deadlines on a share
    ``SERVICE_TIGHT``) is equal on every rank, expires tickets, and answers
    each done ticket as the single engine does. K3 and K6 spandiag are
    timed in rank 0 at a rank's share of their service buckets. Returns
    their records."""
    from repro_torch.dp import autotune

    print(card_line())
    t0 = time.perf_counter()
    plain, tight, sessions = service_requests(False), service_requests(True), session_traffic()
    mesh = rt_sharding.Mesh([cuda] * SHARD_SLOTS, (dp.sharding.BATCH_AXIS,))
    autotune.reset()
    reset_launches()
    threads = ranks.serve_dp(dp.DPService(mesh=mesh, max_batch=SERVICE_BATCH, feedback=False),
                             plain, sessions, digest_out=True)
    thread_counts = launches()
    autotune.reset()
    single = ranks.serve_dp(dp.DPService(mesh=None, max_batch=SERVICE_BATCH, feedback=False,
                                         device=cuda), plain, sessions, digest_out=True)
    del mesh
    gc.collect()
    torch.cuda.empty_cache()
    print(f"service processes run A, threads and single: {threads['seconds']:.3f} s and "
          f"{single['seconds']:.3f} s, {single['stats']['cache_hits']} cache hits, routes "
          f"{ {f'{k[0]} {k[1]}': v for k, v in sorted(single['routes'].items())} }")
    n = len(plain)
    jobs = [(ranks.dp_service, {"requests": plain, "sessions": sessions,
                                "max_batch": SERVICE_BATCH, "timing": True, "digest_out": True}),
            (ranks.dp_service, {"requests": tight, "max_batch": SERVICE_BATCH,
                                "digest_out": True})]
    timed = {}
    for route, (_, _, _, problem, _) in SVP_KERNELS.items():
        bucket = timed_bucket(plain, single["records"][:n], route, problem)
        require(bucket is not None, f"service processes: {route} served a bucket of the "
                "single engine's traffic")
        if bucket is not None:
            name, recon, instances = bucket
            kw = instances[0]
            size = len(kw.get("x", kw.get("tokens", kw.get("dims", []))))
            print(f"service processes: {route} timed in rank 0 at its share of the {name} "
                  f"{size} bucket of {len(instances)}{' reconstruct' if recon else ''}")
            timed[route] = (len(jobs), name, recon, instances)
            jobs.append((ranks.dp_kernel_ms, {"problem": name, "route": route,
                                              "instances": instances, "reconstruct": recon}))
    t1 = time.perf_counter()
    done = distributed.launch(ranks.sequence, (SHARD_SLOTS,), (dp.sharding.BATCH_AXIS,),
                              [cuda] * SHARD_SLOTS, args=(jobs,), timeout=SVP_TIMEOUT_S)
    procs_s = time.perf_counter() - t1
    require(done.backend == "gloo" and not any(r.foreign for r in done.reports)
            and all(r.contexts == [cuda.index] for r in done.reports),
            f"service processes: four ranks on one card over {done.backend} (gloo), none "
            f"loading jax or repro, each holding a context on card {cuda.index} alone")
    runs_a = [r.result[0]["result"] for r in done.reports]
    runs_b = [r.result[1]["result"] for r in done.reports]
    print(f"service processes run A: wall s by rank {fmt([g['seconds'] for g in runs_a], 3)} "
          f"(sessions {fmt([g['sessions_seconds'] for g in runs_a], 3)}), threads "
          f"{threads['seconds']:.3f} (sessions {threads['sessions_seconds']:.3f}), single "
          f"{single['seconds']:.3f} (sessions {single['sessions_seconds']:.3f}); {card_line()}")
    print("service processes, each rank's encode and digest s of the traffic's distinct "
          "instances: " + "; ".join(f"rank {r} encode {g['host']['encode']:.3f}, digest "
                                    f"{g['host']['digest']:.3f}" for r, g in enumerate(runs_a)))
    print(f"service processes run B: wall s by rank {fmt([g['seconds'] for g in runs_b], 3)}; "
          f"expired by rank {[g['stats']['expired'] for g in runs_b]} of {n}; {card_line()}")
    first = runs_a[0]
    require(all(same_service(g, first) and g["stats"] == first["stats"]
                and g["engine"] == first["engine"] and g["routes"] == first["routes"]
                for g in runs_a[1:]),
            f"service processes run A: every rank's {len(first['records'])} tickets (answers, "
            "decoded solutions, routes, statuses), sessions and counters equal rank 0's")
    require(same_service(first, threads) and first["stats"] == threads["stats"]
            and first["engine"] == threads["engine"] and first["routes"] == threads["routes"],
            f"service processes run A: rank 0's tickets, sessions and counters bit-equal to the "
            f"threaded DPService over {SHARD_SLOTS} slots of the card "
            f"({first['engine']['sharded_drains']} sharded drains)")
    require(same_service(first, single) and first["stats"] == single["stats"]
            and first["routes"] == single["routes"],
            "service processes run A: rank 0's tickets and sessions bit-equal to the "
            "single-engine DPService on the card")
    done_a = sum(r["status"] == "done" for r in first["records"])
    require(done_a == len(first["records"]) and first["stats"]["cache_hits"] > 0
            and first["engine"]["dedup_hits"] > 0,
            f"service processes run A: every ticket done ({done_a}), cache hits "
            f"{first['stats']['cache_hits']} and dedup {first['engine']['dedup_hits']} > 0")
    summed = {}
    for r in done.reports:
        for k, v in r.result[0]["launches"].items():
            summed[k] = summed.get(k, 0) + v
    names = [k for ks in SERVICE_KERNELS.values() for k in ks]
    got_counts = {k: summed.get(k, 0) for k in names}
    want_counts = {k: thread_counts[k] for k in names}
    require(got_counts == want_counts and all(sum(got_counts[k] for k in ks) > 0
                                              for ks in SERVICE_KERNELS.values()),
            f"service processes run A: launches summed over the ranks {got_counts} equal the "
            f"threads' {want_counts}, every kernel of {sorted(SERVICE_KERNELS)} launched")
    first_b = runs_b[0]
    expired = first_b["stats"]["expired"]
    require(all(g["records"] == first_b["records"] and g["stats"] == first_b["stats"]
                for g in runs_b[1:]) and expired > 0,
            f"service processes run B: every rank's statuses and tickets equal rank 0's, "
            f"{expired} expired")
    same_b = all(rb["status"] == "expired"
                 or (rb["answer"], rb["solution"]) == (ra["answer"], ra["solution"])
                 for rb, ra in zip(first_b["records"], single["records"][:n]))
    require(len(first_b["records"]) == n and same_b,
            f"service processes run B: each of {n - expired} done answers equals the single "
            "engine's for the same request")

    records = []
    for route, (j, name, recon, instances) in timed.items():
        rec_name, source, replaces, _, counters = SVP_KERNELS[route]
        t = done.reports[0].result[j]["result"]
        spec = dp.get_problem(name).encode(**instances[0])
        nbytes, ops_ = dpp_work(spec, t["lanes"], recon)
        require(t["equal"], f"{rec_name}: rank 0's {t['lanes']} lanes of a {name} bucket of "
                f"{len(instances)}{' reconstruct' if recon else ''} bit-equal to the plain "
                "version on the card")
        rec = kernel_record(rec_name, source, replaces, t["max_abs_err"], t["ms"],
                            t["plain_ms"], nbytes, ops_)
        rec["launches"] = sum(got_counts[k] for k in counters)
        require(rec["launches"] > 0, f"{rec_name}: launched in the rank processes' run A")
        records.append(rec)
    took = time.perf_counter() - t0
    print(f"service processes phase: threads and single {t1 - t0:.2f} s, processes "
          f"{procs_s:.2f} s (spawn, both runs and the timings); {card_line()}")
    require(took <= SVP_LIMIT_S, f"service processes phase took {took:.1f} s "
            f"(limit {SVP_LIMIT_S:.0f} s)")
    return records


def dp_over_ranks(devices: list, cuda) -> None:
    """One sharded DP bucket (``SHARD_BUCKETS``' MCM 512 on K4 with
    reconstruct, ``DPP_ROUNDS`` drains) and the service path's run A
    traffic in one rank a device of ``devices`` (NCCL where each holds a
    card of its own), bit-equal to the threaded ``ShardedDPEngine`` and
    ``DPService`` over the same devices."""
    from repro_torch.dp import autotune

    n = len(devices)
    mesh = rt_sharding.Mesh(devices, (dp.sharding.BATCH_AXIS,))
    _, name, size, route, _ = SHARD_BUCKETS[0]
    bucket = (name, route, shard_instances(np.random.default_rng(SEED + 11), name, size), True)
    autotune.reset()
    drains = threaded_drains([bucket], mesh, cuda)[0]
    requests, sessions = service_requests(False), session_traffic()
    autotune.reset()
    t0 = time.perf_counter()
    service = ranks.serve_dp(dp.DPService(mesh=mesh, max_batch=SERVICE_BATCH, feedback=False),
                             requests, sessions, digest_out=True)
    threads_s = time.perf_counter() - t0
    del mesh
    gc.collect()
    torch.cuda.empty_cache()
    jobs = [(ranks.dp_drains, {"buckets": [bucket], "rounds": DPP_ROUNDS, "digest_out": True}),
            (ranks.dp_service, {"requests": requests, "sessions": sessions,
                                "max_batch": SERVICE_BATCH, "digest_out": True})]
    t0 = time.perf_counter()
    done = distributed.launch(ranks.sequence, (n,), (dp.sharding.BATCH_AXIS,), devices,
                              args=(jobs,), timeout=SVP_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    label = f"dp over {n} ranks ({done.backend})"
    require(not any(r.foreign for r in done.reports),
            f"{label}: no rank loading jax or repro")
    got = [r.result[0]["result"][0] for r in done.reports]
    records, seconds = drains["sharded"]
    procs = [max(g["seconds"][i] for g in got) for i in range(DPP_ROUNDS)]
    print(f"{label} MCM {size} (K4) reconstruct: drain s processes (slowest rank) "
          f"{fmt(procs, 4)}, threads {fmt(seconds, 4)}, single engine "
          f"{fmt(drains['single'][1], 4)} (cold, warm); {card_line()}")
    require(all(g["responses"] == records for g in got) and records == drains["single"][0],
            f"{label}: every rank's MCM {size} answers, tables, args and paths of {DPP_ROUNDS} "
            "drains bit-equal to the threaded sharded engine's and the single engine's")
    runs = [r.result[1]["result"] for r in done.reports]
    print(f"{label} service: wall s by rank {fmt([g['seconds'] for g in runs], 3)}, threads "
          f"{service['seconds']:.3f} ({threads_s:.2f} with the service's build); launch "
          f"{launch_s:.2f} s; {card_line()}")
    require(all(same_service(g, service) and g["stats"] == service["stats"]
                and g["engine"] == service["engine"] and g["routes"] == service["routes"]
                for g in runs),
            f"{label} service: every rank's {len(service['records'])} tickets, sessions and "
            "counters bit-equal to the threaded DPService over the same devices")


def service_nccl(cuda) -> None:
    """:func:`dp_over_ranks` over NCCL, one rank a card on up to four cards
    (``--processes-nccl``); where the host has one card, a line saying so
    (not a check)."""
    n = min(SHARD_SLOTS, torch.cuda.device_count())
    if n < 2:
        print(f"dp and service over NCCL: not run, {torch.cuda.device_count()} card on this "
              "host (NCCL takes one rank a card)")
        return
    dp_over_ranks([torch.device("cuda", i) for i in range(n)], cuda)


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
    if sys.argv[1:] == ["--train"]:
        phase_build()
        device_profile(torch.cuda.synchronize, {}, cpu=False)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line())
        print(json.dumps(phase_train(cuda)))
        return 1 if _failures else 0
    if sys.argv[1:] == ["--train-witness"]:
        phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line())
        train_witness(cuda)
        return 1 if _failures else 0
    if sys.argv[1:] == ["--sharded"]:
        phase_build()
        device_profile(torch.cuda.synchronize, {}, cpu=False)
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_sharded(cuda)
        return 1 if _failures else 0
    if sys.argv[1:] == ["--sharded-train"]:
        phase_build()
        device_profile(torch.cuda.synchronize, {}, cpu=False)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(phase_sharded_train(cuda)))
        return 1 if _failures else 0
    if sys.argv[1:] == ["--processes-nccl"]:
        phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card_line())
        processes_nccl(cuda, process_jobs(cuda)[0])
        gc.collect()
        torch.cuda.empty_cache()
        service_nccl(cuda)
        return 1 if _failures else 0
    if sys.argv[1:] == ["--processes"]:
        phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(phase_processes(cuda)))
        return 1 if _failures else 0
    if sys.argv[1:] == ["--dp-processes"]:
        phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(phase_dp_processes(cuda)))
        return 1 if _failures else 0
    if sys.argv[1:] == ["--service-processes"]:
        phase_build()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(phase_service_processes(cuda)))
        return 1 if _failures else 0
    if sys.argv[1:] == ["--sharded-lm"]:
        phase_build()
        device_profile(torch.cuda.synchronize, {}, cpu=False)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(phase_sharded_lm(cuda)))
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

    torch.cuda.empty_cache()
    phase_sharded(cuda)

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
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_train(cuda)
    records.append(phase_scan(cuda))
    gc.collect()
    torch.cuda.empty_cache()
    records.append(phase_sharded_lm(cuda))
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_sharded_train(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_processes(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_dp_processes(cuda)
    gc.collect()
    torch.cuda.empty_cache()
    records += phase_service_processes(cuda)

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
