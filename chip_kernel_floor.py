"""What bounds K2 (``mcm_pipeline``), K6 spandiag, K5 (``semiring_matmul``)
and K8 (``chunked_scan``) on the card: each timed at its path shape beside
variants of its source with part of the work taken out.

    python3 chip_kernel_floor.py

Each variant is the checked-out ``csrc`` source with one text substitution,
built with the repo's nvcc flags into a temporary directory and loaded in
place of the kernel's library. Only the source as it is ("as built") is
held against the plain version; the other variants compute wrong tables by
design and are timing probes:

  * K2 at MCM 8 x 256 and 1 x 1024: "no fold" (no split is folded: the
    barriers, the merge, the replica writes and the weight loads remain),
    "no weights" (every weight read is a constant), "no fold, no weights"
    (the per-diagonal fixed cost), and that last with the cluster barrier's
    arrive relaxed (what its release costs);
  * K6 spandiag at cky 64 x 32 x 1024: "no fold" (the grid barriers and
    the writes remain), each on the wrapper's grid and on one CTA a SM;
  * K5 at MCM 1024's largest launch (D = 32) and at the weighted 1024^3
    square, device time under the profiler: "plain min" (min without the
    NaN rule), "no candidates" (the loads, barriers and merges remain),
    "no loads" (no operand is staged: the candidates run on stale shared
    memory);
  * K8 at T 32768 x D 2048: "no chain" (the ring runs, no row is folded or
    stored), "no store" (the chains run, no h tile is sent back).

Variants run in turns (all, then all again in reverse), CUDA-event means
over five calls after a warm-up, on one card; the card's name and power
limit come first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (CKY, K5_SQUARE, MCM_N, SCAN_D, SCAN_T, SEED, cky_instance,  # noqa: E402
                        cuda_ms, k5_path_operands, k5_profiled_ms, mcm_dims)
from repro_torch import dp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import grid_pipeline as k6  # noqa: E402
from repro_torch.kernels import chunked_scan as k8  # noqa: E402
from repro_torch.kernels import mcm_pipeline as k2  # noqa: E402
from repro_torch.kernels import semiring_matmul as k5  # noqa: E402

NO_FOLD = ("for (int e0 = t; e0 < d; e0 += PF * wd)", "for (int e0 = t; e0 < 0; e0 += PF * wd)")
NO_WEIGHTS = [("wv[u] = ahead ? wpf[u] : __ldcs(wr + e);", "wv[u] = 1.0f;"),
              ("if (e < d) wpf[u] = __ldcs(wr + e);", "if (e < d) wpf[u] = 1.0f;")]
RELAXED = ("barrier.cluster.arrive.release.aligned", "barrier.cluster.arrive.relaxed.aligned")
K5_LOADS = [("if (i0 + i < M && k0 + kk < k_hi)", "if (false)"),
            ("if (k0 + kk < k_hi && j0 + j < N)", "if (false)"),
            ("if (k0 + e < k_hi) cp_async4", "if (false) cp_async4")]
VARIANTS = {
    "semiring_matmul": {"as built": [], "plain min": [("min.NaN.f32", "min.f32")],
                        "no candidates": [("if (kn == KS) {", "if (false) {"),
                                          ("for (int kk = 0; kk < kn; ++kk)",
                                           "for (int kk = 0; kk < 0; ++kk)")],
                        "no loads": K5_LOADS,
                        "stages of 32 columns": [("constexpr int KS = 16;", "constexpr int KS = 32;")]},
    "chunked_scan": {"as built": [],
                     "no chain": [("if (TMA && lane < F) {", "if (false) {")],
                     "no store": [("tma_store(&hmap, smem_addr(outs + (s & 1) * tile), f0, t0);",
                                   "")]},
    "mcm_pipeline": {"as built": [], "no fold": [NO_FOLD], "no weights": NO_WEIGHTS,
                     "no fold, no weights": [NO_FOLD, *NO_WEIGHTS],
                     "no fold, no weights, relaxed arrive": [NO_FOLD, *NO_WEIGHTS, RELAXED]},
    "grid_pipeline": {"as built": [], "no fold": [(
        "for (int k = t; k < cand; k += SD_PF * T)", "for (int k = t; k < 0; k += SD_PF * T)")]},
}


def build(tmp: Path) -> dict:
    """{(source, variant): library}, every variant compiled at once."""
    jobs = {}
    for name, variants in VARIANTS.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        for label, subs in variants.items():
            src = text
            for old, new in subs:
                if old not in src:
                    raise RuntimeError(f"{name}.cu has no {old!r}: the variant is stale")
                src = src.replace(old, new)
            cu = tmp / f"{name}-{len(jobs)}.cu"
            cu.write_text(src)
            so = cu.with_suffix(".so")
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
            jobs[(name, label)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def use(libs: dict, name: str, label: str) -> None:
    _build._LIBS[name] = libs[(name, label)]
    k2._ACTIVE.clear()
    k6._BLOCKS_PER_SM.clear()
    k5._FN = k8._FN = None
    k5._LIMITS.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_floor: no CUDA device", file=sys.stderr)
        return 2
    cuda = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        rng = np.random.default_rng(SEED)
        mcm = {}
        for n, bt in ((256, 8), (1024, 1)):
            w = torch.from_numpy(np.stack([dp.get_problem("mcm").encode(dims=mcm_dims(rng, n))
                                           .weights.astype(np.float32) for _ in range(bt)])).to(cuda)
            mcm[(n, bt)] = (w, k2.mcm_pipeline_plain(w, n, with_args=True))
        inst = cky_instance(np.random.default_rng(SEED), CKY["n"], CKY["P"], CKY["V"], CKY["rules"])
        spec = dp.get_problem("cky").encode(**inst)
        arrs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in spec.device_arrays())
        meta = spec.static_meta()
        chart = k6.grid_pipeline_plain(arrs, meta, with_args=True)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        square = tuple(torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (
            rng.normal(size=(K5_SQUARE, K5_SQUARE)), rng.normal(size=(K5_SQUARE, K5_SQUARE)),
            rng.uniform(1, 3, K5_SQUARE), rng.uniform(1, 3, K5_SQUARE),
            rng.uniform(1, 3, K5_SQUARE)))
        k5_cases = {"MCM 1024 D=32": k5_path_operands(cuda, mcm_dims(
            np.random.default_rng(SEED), MCM_N))[1], f"weighted {K5_SQUARE}^3": square}
        k5_want = {key: k5.tropical_matmul_plain(*args) for key, args in k5_cases.items()}
        g = torch.Generator(device=cuda).manual_seed(SEED)
        scan = (torch.randn((SCAN_T, SCAN_D), generator=g, device=cuda),
                torch.rand((SCAN_T, SCAN_D), generator=g, device=cuda) * 0.2 + 0.8,
                torch.randn((SCAN_D,), generator=g, device=cuda))
        scan_want = k8.chunked_scan_plain(*scan)
        failed = False
        for turn in (1, -1):
            for name, label in list(libs)[::turn]:
                use(libs, name, label)
                if name == "mcm_pipeline":
                    for (n, bt), (w, (wt, wa)) in mcm.items():
                        got = k2.mcm_pipeline_with_args(w, n)
                        equal = torch.equal(got[0], wt) and torch.equal(got[1], wa)
                        failed |= label == "as built" and not equal
                        print(f"K2 {label} at mcm {bt} x {n} (cluster of "
                              f"{k2.cluster_size(True, n, bt, cuda)}): with args "
                              f"{cuda_ms(lambda: k2.mcm_pipeline_with_args(w, n), 5):.3f} ms, "
                              f"table {cuda_ms(lambda: k2.mcm_pipeline(w, n), 5):.3f} ms, "
                              f"bit-equal to plain {equal}", flush=True)
                elif name == "semiring_matmul":
                    for key, args in k5_cases.items():
                        equal = torch.equal(k5.tropical_matmul(*args), k5_want[key])
                        failed |= label == "as built" and not equal
                        ms = k5_profiled_ms([lambda a=args: k5.tropical_matmul(*a)])
                        print(f"K5 {label} at {key}: device "
                              f"{ms[0] if ms else 'not measured'} ms, bit-equal to plain "
                              f"{equal}", flush=True)
                elif name == "chunked_scan":
                    got = k8.chunked_scan(*scan)
                    equal = torch.equal(got[0], scan_want[0]) and torch.equal(got[1], scan_want[1])
                    failed |= label == "as built" and not equal
                    print(f"K8 {label} at T={SCAN_T} D={SCAN_D}: "
                          f"{cuda_ms(lambda: k8.chunked_scan(*scan), 5):.4f} ms, bit-equal to "
                          f"plain {equal}", flush=True)
                else:
                    got = k6.grid_pipeline_with_args(arrs, meta)
                    equal = torch.equal(got[0], chart[0]) and torch.equal(got[1], chart[1])
                    failed |= label == "as built" and not equal
                    G = k6.spandiag_ctas(meta[1], True, spec.planes, len(spec.rules), cuda)
                    times = ", ".join(
                        f"grid {g} {cuda_ms(lambda: k6._launch_spandiag(arrs, meta, True, grid=g), 5):.3f} ms"
                        for g in (G, sms))
                    print(f"K6 spandiag {label} at cky {CKY['n']} with args: {times}, "
                          f"bit-equal to plain {equal}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
