"""Peaks of one NVIDIA H100 and the work of one S-DP solve.

A frozen copy of ``chip_smoke.py``'s ``sdp_work`` and ``bound_ms``: the
work is counted from the instance alone (n, the offsets, the weights,
whether the arguments are written), never from the route that solves it,
so a later route that does less or more work than the recurrence needs
moves its roofline share and not the yardstick.

Peaks: NVIDIA's data sheet for the H100 SXM part at its 700 W limit, dense
rates: 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def sdp_work(n: int, offsets, weighted: bool, with_args: bool) -> tuple:
    """(bytes, operations) of one S-DP solve: presets, offsets and weights
    read once, the table (and args) written once; per cell past the presets
    k - 1 compares, plus k semiring products where weighted."""
    k, a1 = len(offsets), int(offsets[0])
    nbytes = 4 * (a1 + k + n * (2 if with_args else 1) + (n * k if weighted else 0))
    return nbytes, (n - a1) * (k - 1 + (k if weighted else 0))


def bound_s(nbytes: float, ops: float, peak: float = F32_OPS_PER_S) -> tuple:
    """Least time for the work, in seconds: the larger of bytes over the
    HBM rate and operations over the peak rate for their type (float32 by
    default), and which of the two it is."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / peak
    return (tb, "bytes") if tb >= to else (to, "operations")
