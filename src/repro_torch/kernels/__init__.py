"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and their registration as dispatchable routes.

  * ``sdp_pipeline`` — blocked pipelined S-DP solver (weighted and
                       arg-emitting), replacing ``repro``'s Pallas K1
  * ``mcm_pipeline`` — diagonal pipeline for the triangular split
                       recurrence on a thread-block cluster per
                       instance, replacing ``repro``'s Pallas K2
  * ``sdp_chunked``  — the S-DP pipeline streamed through a shared-memory
                       ring of the last ``a_1`` cells, replacing K3 (K1 and
                       K3 walk the table by ``sdp_walk``'s plan)
  * ``mcm_tiled``    — the triangular recurrence over row × split tiles
                       staged in shared memory, with the traceback fused
                       into the launch, replacing K4
  * ``grid_pipeline`` — frontier-major wavefront pipeline for the grid
                        family (antidiag/spandiag), replacing ``repro``'s
                        Pallas K6
  * ``semiring_matmul`` — weighted tropical (min,+) product, the split
                          combine of blocked MCM, replacing K5
  * ``flash_attention`` — causal online-softmax attention with GQA read in
                          place, the prefill of the LM path
                          (``ops.flash_attention``), replacing K7; its
                          gradient (``FlashAttention``) runs the backward
                          kernel K7b, ``csrc/flash_attention_bwd.cu``
  * ``chunked_scan``  — gated linear scan behind ``ops.linear_scan``,
                        replacing K8

Routes: ``kernel_blocked`` (K1) and ``kernel_tiled`` (K3) for the linear
family, ``kernel_wavefront`` (K2) and ``kernel_tiled_wavefront`` (K4, with
a fused pair) for the triangular one, ``kernel_grid`` (K6) for the grid.
Each registers its schedule descriptor (``schedule``: the kernels' own read
and finalize order and geometry rules) for the static gate,
``repro_torch.analysis``.
Their costs keep ``repro``'s factor structure: the resident routes ×0.5
where the kernel runs (a CUDA device) and ×1.25 where the plain version
stands in (the CPU); the streaming routes ×0.6 + 8 and ×1.2 + 8 (linear),
×0.6 and ×1.2 (triangular).

The on-chip gate. K1 keeps its working set (table, args, weights) in
device memory and leans on L2 to hold it between steps; K2 holds its
table in shared memory up to n = 340 and reads the rest from device
memory; past L2 both chain reads to DRAM. So on a CUDA device they
support a spec only while ``repro``'s working-set formulas (``_linear_vmem_bytes``,
``_triangular_vmem_bytes``) stay within :func:`on_chip_budget`, the L2
size the card reports (50 MiB on an H100) — ``repro``'s VMEM budget gate
with the card's own budget and no knob. Past it K3 and K4 take over; they
keep only a window or a tile on chip and have no size cap beyond their
shared memory. Where that cap refuses a spec (a horizon ``a_1`` of more
than some 57k cells), K1 or K2 keeps it past the budget, as no kernel
route would serve it otherwise. On the CPU there is no gate (``repro``'s
``ref`` mode).
K6 has no on-chip gate, unlike ``repro``'s ``_kernel_grid_supports``: it
has no streaming twin, and its plain route is some 30× slower on the card.
On a CUDA device it admits only the specs its launchers take
(:func:`_grid_supports`: the antidiag tile plan fits shared memory in both
arg modes and its tile count fits int32; the spandiag rule table fits
shared memory); any other spec goes to the plain ``grid_wavefront``, as
``repro`` falls back through its gate. On the CPU it admits every spec.
"""
import functools
from typing import Optional

import torch

from repro_torch.core.mcm import num_cells
from repro_torch.dp import backends as _dp_backends
from repro_torch.kernels import (_build, grid_pipeline, mcm_tiled, ops,
                                 sdp_chunked)
from repro_torch.kernels import schedule as _schedule


def on_chip_budget(device) -> Optional[int]:
    """Bytes a resident kernel's working set may take on ``device``: the
    L2 cache size a CUDA device reports, or None (no gate) elsewhere."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


def _linear_vmem_bytes(spec) -> int:
    """float32 working set of the (weighted, arg-emitting) S-DP kernel:
    padded table + int32 arg table + the optional (n, k) weight slab
    (``repro.kernels._linear_vmem_bytes``)."""
    n_pad = spec.n + int(spec.offsets[-1])           # ≤ one block of padding
    k = len(spec.offsets) if spec.weights is not None else 0
    return 4 * n_pad * (2 + k)


def _triangular_vmem_bytes(spec) -> int:
    """float32 working set of the triangular kernel: padded cost and arg
    tables plus the dense (cells, n-1) weight table, with K2's padded
    geometry (``repro.kernels.mcm_pipeline._geometry``)."""
    lanes = max(spec.n - 1, 1)
    size = num_cells(spec.n) + lanes + 1
    return 4 * size * (2 + lanes)


def _resident(nbytes: int, device) -> bool:
    budget = on_chip_budget(device)
    return budget is None or nbytes <= budget


def _fits_smem(nbytes: int, device) -> bool:
    return device.type != "cuda" or nbytes <= _build.SMEM_OPTIN_BYTES


def _tiled_supports(spec, device) -> bool:
    return spec.n < 2 ** 31 and _fits_smem(
        sdp_chunked.window_bytes(spec.offsets, spec.weights is not None), device)


def _tiled_wavefront_supports(spec, device) -> bool:
    return num_cells(spec.n) < 2 ** 31 and _fits_smem(
        mcm_tiled.smem_bytes(spec.n, fused=True), device)


def _grid_supports(spec, device) -> bool:
    """K6's domain on ``device``: int32 cell indices everywhere; on a CUDA
    device also the launchers' own rules (``grid_pipeline._launch_antidiag``
    / ``_launch_spandiag``). ``supports`` does not see ``reconstruct``, so
    the antidiag plan must fit with and without the arg tile."""
    if spec.planes * spec.cells >= 2 ** 31:
        return False
    if device.type != "cuda":
        return True
    if spec.schedule == "antidiag":
        for with_args in (False, True):
            plan = grid_pipeline.tile_plan(spec.planes, spec.moves, with_args)
            if plan is None or (-(-spec.rows // plan.T)
                                * -(-spec.cols // plan.T)) >= 2 ** 31:
                return False
        return True
    NR = len(spec.rules)
    return spec.rows * NR < 2 ** 31 and (
        grid_pipeline.spandiag_smem_bytes(spec.planes, NR)
        <= _build.SMEM_OPTIN_BYTES - grid_pipeline._STATIC_SMEM)


def _device_factor(device) -> float:
    return 0.5 if device.type == "cuda" else 1.25


def _tiled_factor(device) -> float:
    return 0.6 if device.type == "cuda" else 1.2


_dp_backends.register(_dp_backends.linear_backend(
    "kernel_blocked", ops.sdp_blocked,
    cost=lambda s, device: (_dp_backends.linear_costs(s)["blocked"]
                            * _device_factor(device)),
    supports=lambda s, device: s.n < 2 ** 31 and (
        _resident(_linear_vmem_bytes(s), device)
        or not _tiled_supports(s, device)),
    arg_fn=ops.sdp_blocked_with_args, kernel=True,
    schedule=functools.partial(_schedule.schedules, "kernel_blocked"),
    doc="ops.sdp_blocked: the sdp_pipeline CUDA kernel on the card (working "
        "set within L2, or a window too large for kernel_tiled), its plain "
        "PyTorch version on the CPU"))

_dp_backends.register(_dp_backends.linear_backend(
    "kernel_tiled", ops.sdp_chunked,
    cost=lambda s, device: (_dp_backends.linear_costs(s)["blocked"]
                            * _tiled_factor(device) + 8.0),
    supports=_tiled_supports,
    arg_fn=ops.sdp_chunked_with_args, kernel=True,
    schedule=functools.partial(_schedule.schedules, "kernel_tiled"),
    doc="ops.sdp_chunked: the sdp_chunked CUDA kernel on the card (the last "
        "a_1 cells in a shared-memory ring; no cap on n), its plain PyTorch "
        "version on the CPU"))

_dp_backends.register(_dp_backends.triangular_tab_backend(
    "kernel_wavefront", ops.mcm_blocked,
    cost=lambda s, device: (_dp_backends.triangular_costs(s)["wavefront"]
                            * _device_factor(device)),
    supports=lambda s, device: num_cells(s.n) < 2 ** 31 and (
        _resident(_triangular_vmem_bytes(s), device)
        or not _tiled_wavefront_supports(s, device)),
    arg_fn=ops.mcm_blocked_with_args, kernel=True,
    schedule=functools.partial(_schedule.schedules, "kernel_wavefront"),
    doc="ops.mcm_blocked: the mcm_pipeline CUDA kernel on the card (working "
        "set within L2, or a stack too large for kernel_tiled_wavefront), its "
        "plain PyTorch version on the CPU"))

_dp_backends.register(_dp_backends.triangular_tab_backend(
    "kernel_tiled_wavefront", ops.mcm_tiled,
    cost=lambda s, device: (_dp_backends.triangular_costs(s)["tiled_wavefront"]
                            * _tiled_factor(device)),
    supports=_tiled_wavefront_supports,
    arg_fn=ops.mcm_tiled_with_args, fused_fn=ops.mcm_tiled_fused, kernel=True,
    schedule=functools.partial(_schedule.schedules, "kernel_tiled_wavefront"),
    doc="ops.mcm_tiled: the mcm_tiled CUDA kernel on the card (row x split "
        "tiles staged in shared memory, traceback fused into the launch; no "
        "cap on n), its plain PyTorch version on the CPU"))

_dp_backends.register(_dp_backends.grid_backend(
    "kernel_grid", ops.grid_blocked,
    cost=lambda s, device: (_dp_backends.grid_costs(s)["grid_wavefront"]
                            * _device_factor(device)),
    supports=_grid_supports,
    arg_fn=ops.grid_blocked_with_args, kernel=True,
    schedule=functools.partial(_schedule.schedules, "kernel_grid"),
    doc="ops.grid_blocked: the grid_pipeline CUDA kernel on the card (specs "
        "its tile plan or rule table fits), its plain PyTorch version on the "
        "CPU"))
