"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and their registration as dispatchable routes.

  * ``sdp_pipeline`` — blocked pipelined S-DP solver (weighted and
                       arg-emitting), replacing ``repro``'s Pallas K1
  * ``mcm_pipeline`` — diagonal pipeline for the triangular split
                       recurrence, replacing ``repro``'s Pallas K2
  * ``grid_pipeline`` — frontier-major wavefront pipeline for the grid
                        family (antidiag/spandiag), replacing ``repro``'s
                        Pallas K6

``kernel_blocked`` (linear), ``kernel_wavefront`` (triangular) and
``kernel_grid`` (grid) route through ``ops``. Their costs keep ``repro``'s
factor structure: ×0.5 where the kernel runs (a CUDA device), ×1.25 where
the plain version stands in (the CPU), so dispatch prefers the kernel routes
on the card exactly as ``repro`` prefers them on a TPU. ``supports`` states
what the kernels need: int32 cell indices (over all planes, for the grid).
The tables live in device memory, so there is no on-chip size cap.
"""
from repro_torch.core.mcm import num_cells
from repro_torch.dp import backends as _dp_backends
from repro_torch.kernels import ops


def _device_factor(device) -> float:
    return 0.5 if device.type == "cuda" else 1.25


_dp_backends.register(_dp_backends.linear_backend(
    "kernel_blocked", ops.sdp_blocked,
    cost=lambda s, device: (_dp_backends.linear_costs(s)["blocked"]
                            * _device_factor(device)),
    supports=lambda s: s.n < 2 ** 31,
    arg_fn=ops.sdp_blocked_with_args,
    doc="ops.sdp_blocked: the sdp_pipeline CUDA kernel on the card, its "
        "plain PyTorch version on the CPU"))

_dp_backends.register(_dp_backends.triangular_tab_backend(
    "kernel_wavefront", ops.mcm_blocked,
    cost=lambda s, device: (_dp_backends.triangular_costs(s)["wavefront"]
                            * _device_factor(device)),
    supports=lambda s: num_cells(s.n) < 2 ** 31,
    arg_fn=ops.mcm_blocked_with_args,
    doc="ops.mcm_blocked: the mcm_pipeline CUDA kernel on the card, its "
        "plain PyTorch version on the CPU"))

_dp_backends.register(_dp_backends.grid_backend(
    "kernel_grid", ops.grid_blocked,
    cost=lambda s, device: (_dp_backends.grid_costs(s)["grid_wavefront"]
                            * _device_factor(device)),
    supports=lambda s: s.planes * s.cells < 2 ** 31,
    arg_fn=ops.grid_blocked_with_args,
    doc="ops.grid_blocked: the grid_pipeline CUDA kernel on the card, its "
        "plain PyTorch version on the CPU"))
