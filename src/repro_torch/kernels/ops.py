"""Dispatch layer between the routes and the kernels. The device of the
data decides the path: the CUDA kernel for a CUDA tensor, the kernel's plain
PyTorch version for a CPU tensor — there is no mode knob and no fallback."""
from __future__ import annotations

from repro_torch.kernels.chunked_scan import chunked_scan as _chunked_scan
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.grid_pipeline import grid_pipeline, grid_pipeline_with_args
from repro_torch.kernels.mcm_pipeline import mcm_pipeline, mcm_pipeline_with_args
from repro_torch.kernels.mcm_tiled import (mcm_tiled as _mcm_tiled,
                                           mcm_tiled_fused as _mcm_tiled_fused,
                                           mcm_tiled_with_args as _mcm_tiled_with_args)
from repro_torch.kernels.sdp_chunked import (sdp_chunked as _sdp_chunked,
                                             sdp_chunked_with_args as _sdp_chunked_with_args)
from repro_torch.kernels.sdp_pipeline import sdp_pipeline, sdp_pipeline_with_args
from repro_torch.kernels.semiring_matmul import tropical_matmul as _tropical_matmul


def tropical_matmul(a, b, av=None, gv=None, bv=None):
    """Weighted (min,+) product through the ``semiring_matmul`` kernel:
    ``C[.., i, j] = min_k (A[i,k] + B[k,j] + av[i]·gv[k]·bv[j])``, with up
    to two leading batch axes."""
    return _tropical_matmul(a, b, av, gv, bv)


def sdp_blocked(init, offsets, op: str, n: int, block: int = 512,
                weights=None):
    """Blocked S-DP solve through the ``sdp_pipeline`` kernel."""
    return sdp_pipeline(init, tuple(offsets), op, n, block=block,
                        weights=weights)


def sdp_blocked_with_args(init, offsets, op: str, n: int, block: int = 512,
                          weights=None):
    """Arg-emitting blocked S-DP: the winning lane beside each cost cell,
    with the first-occurrence tie rule of the plain blocked solver."""
    return sdp_pipeline_with_args(init, tuple(offsets), op, n, block=block,
                                  weights=weights)


def mcm_blocked(wtab, n: int):
    """Triangular (split-form) table solve through the ``mcm_pipeline``
    kernel."""
    return mcm_pipeline(wtab, n)


def mcm_blocked_with_args(wtab, n: int):
    """``mcm_blocked`` + the best-split table."""
    return mcm_pipeline_with_args(wtab, n)


def sdp_chunked(init, offsets, op: str, n: int, block: int = 512,
                weights=None):
    """Streaming S-DP solve through the ``sdp_chunked`` kernel: the table's
    last ``a_1`` cells in a shared-memory ring, no size cap on ``n``."""
    return _sdp_chunked(init, tuple(offsets), op, n, block=block,
                        weights=weights)


def sdp_chunked_with_args(init, offsets, op: str, n: int, block: int = 512,
                          weights=None):
    """``sdp_chunked`` + the winning lane per cell, first-occurrence tie
    rule."""
    return _sdp_chunked_with_args(init, tuple(offsets), op, n, block=block,
                                  weights=weights)


def mcm_tiled(wtab, n: int):
    """Triangular table solve through the ``mcm_tiled`` kernel (tiles of
    rows × splits staged in shared memory)."""
    return _mcm_tiled(wtab, n)


def mcm_tiled_with_args(wtab, n: int):
    """``mcm_tiled`` + the best-split table."""
    return _mcm_tiled_with_args(wtab, n)


def mcm_tiled_fused(wtab, n: int):
    """``mcm_tiled_with_args`` + the preorder traceback walked inside the
    same launch: ``(st, args, (node_i, node_d, node_e))``."""
    return _mcm_tiled_fused(wtab, n)


def grid_blocked(arrs, meta: tuple):
    """Grid (antidiag/spandiag) table solve through the ``grid_pipeline``
    kernel — ``arrs``/``meta`` per ``GridSpec.device_arrays()`` /
    ``static_meta()``."""
    return grid_pipeline(arrs, meta)


def grid_blocked_with_args(arrs, meta: tuple):
    """``grid_blocked`` + the winning move / packed-split table."""
    return grid_pipeline_with_args(arrs, meta)


def linear_scan(x, decay, h0, chunk: int = 128):
    """``h_t = decay_t ⊙ h_{t-1} + x_t`` through the ``chunked_scan`` kernel;
    returns ``(h_all, h_final)``."""
    return _chunked_scan(x, decay, h0, chunk=chunk)


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D). Returns (B, Hq, S, D) through
    the ``flash_attention`` kernel (GQA read in place, any S, the causal
    mask aligned at the end)."""
    return _flash_attention(q, k, v, causal=causal)
