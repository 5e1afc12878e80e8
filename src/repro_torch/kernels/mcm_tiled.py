"""Tiled triangular solver with the traceback fused into its launch: CUDA
kernel and its plain PyTorch version.

Port of ``repro/kernels/mcm_tiled.py`` (``mcm_tiled_pallas``, its arg twin
and its fused twin). The recurrence is K2's (``mcm_pipeline``): split ``e``
of row ``i`` on diagonal ``d`` combines ``st[off(e)+i]``,
``st[off(d-e-1)+e+1+i]`` and ``W[off(d)+i, e]`` as ``(left + right) + w``,
folded by min with the first best split winning. What differs is how the
operands reach the SM: each diagonal is cut into tiles of ``T`` rows ×
``E`` splits (:func:`tile_plan`, sized from the shared memory a block can
use), whose left runs, right runs and ``T × E`` weight tile are staged in
shared memory with coalesced copies. The fused twin then walks the split
tree in preorder over the finished args, inside the same launch.

``wtab`` is ``(cells, n-1)`` or ``(batch, cells, n-1)`` float32 (never
copied or padded). A CPU tensor goes through :func:`mcm_tiled_plain`; a
CUDA tensor launches ``csrc/mcm_tiled.cu`` (one CTA per instance, one
launch per batch). ``n ≤ 1`` returns the preset-only table.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.mcm import lin_index, num_cells, triangular_traceback_np
from repro_torch.kernels import _build

#: E splits per tile, at most T rows (threads) per tile
TILE_E, TILE_T = 64, 256

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"mcm_tiled": 0, "mcm_tiled_with_args": 0, "mcm_tiled_fused": 0}


def _lanes(n: int) -> int:
    """Row width of the split-major weight table."""
    return max(n - 1, 1)


def tile_plan(n: int) -> tuple:
    """``(T, E)``: rows per tile (the CTA's threads) and splits per tile.
    ``E`` splits (a 256-byte run of a weight row) and as many whole warps
    of rows, up to ``TILE_T``, as the shared memory a block can use holds
    (:func:`smem_bytes`: 256 rows, 194.5 KB); both shrink to the band of a
    small table."""
    L = _lanes(n)
    E = min(TILE_E, L)
    fit = _build.SMEM_OPTIN_BYTES // (4 * (2 * E + (E | 1))) // 32 * 32
    return min(TILE_T, fit, -(-L // 32) * 32), E


def smem_bytes(n: int, fused: bool) -> int:
    """Dynamic shared memory of one CTA: left and right runs plus the
    weight tile (row stride ``E | 1``); the fused walk reuses it for its
    stack of ``n + 2`` int32 pairs."""
    T, E = tile_plan(n)
    tiles = 4 * (2 * E * T + T * (E | 1))
    return max(tiles, 8 * (n + 2)) if fused else tiles


def _degenerate(wtab, n: int, bt: int, with_args: bool, fused: bool):
    dev = wtab.device
    st = torch.zeros((bt, num_cells(n)), dtype=torch.float32, device=dev)
    ar = torch.full((bt, num_cells(n)), -1, dtype=torch.int32, device=dev)
    nodes = torch.zeros((bt, 3, 0), dtype=torch.int32, device=dev)
    return st, (ar if with_args or fused else None), (nodes if fused else None)


def _result(st, ar, nodes, squeeze: bool, with_args: bool, fused: bool):
    if squeeze:
        st, ar = st[0], None if ar is None else ar[0]
        nodes = None if nodes is None else nodes[0]
    if fused:
        return st, ar, (nodes[..., 0, :], nodes[..., 1, :], nodes[..., 2, :])
    return (st, ar) if with_args else st


def mcm_tiled_plain(wtab, n: int, with_args: bool = False,
                    fused: bool = False):
    """The kernel's computation in PyTorch, vectorized over rows: per
    diagonal, split tiles of ``E`` lanes in ascending order, each folded by
    a tile-local first-occurrence min, then a strict improve across tiles
    (together: the first best split). The fused twin walks the finished
    args on the host, in the kernel's preorder. Returns ``st``,
    ``(st, args)`` or ``(st, args, (ii, dd, ee))``."""
    squeeze = wtab.dim() == 2
    if squeeze:
        wtab = wtab[None]
    bt, dev = wtab.shape[0], wtab.device
    if n <= 1:
        return _result(*_degenerate(wtab, n, bt, with_args, fused), squeeze,
                       with_args, fused)
    _, E = tile_plan(n)
    st = torch.zeros((bt, num_cells(n)), dtype=wtab.dtype, device=dev)
    ar = torch.full(st.shape, -1, dtype=torch.int32, device=dev)
    for d in range(1, n):
        rows, off_d = n - d, lin_index(0, d, n)
        t = torch.arange(rows, device=dev)[:, None]
        acc = torch.full((bt, rows), float("inf"), dtype=wtab.dtype, device=dev)
        arg = torch.zeros((bt, rows), dtype=torch.int64, device=dev)
        for e0 in range(0, d, E):
            e = torch.arange(e0, min(e0 + E, d), device=dev)[None, :]
            vals = ((st[:, lin_index(0, e, n) + t]
                     + st[:, lin_index(0, d - e - 1, n) + e + 1 + t])
                    + wtab[:, off_d + t, e])                 # (batch, rows, en)
            tmin, targ = vals.min(dim=2)
            better = tmin < acc
            acc = torch.where(better, tmin, acc)
            arg = torch.where(better, targ + e0, arg)
        st[:, off_d:off_d + rows] = acc
        ar[:, off_d:off_d + rows] = arg.to(torch.int32)
    nodes = None
    if fused:
        walks = [triangular_traceback_np(a, n).T for a in ar.cpu().numpy()]
        nodes = torch.from_numpy(np.stack(walks).astype(np.int32)).to(dev)
    return _result(st, ar, nodes, squeeze, with_args, fused)


def _launch(wtab, n, with_args, fused):
    name = ("mcm_tiled_fused" if fused else
            "mcm_tiled_with_args" if with_args else "mcm_tiled")
    squeeze = wtab.dim() == 2
    if squeeze:
        wtab = wtab[None]
    cells, L = num_cells(n), _lanes(n)
    if (wtab.dtype != torch.float32 or wtab.dim() != 3
            or tuple(wtab.shape[1:]) != (cells, L)):
        raise ValueError(f"{name}: wtab must be float32 (batch, {cells}, {L}), "
                         f"got {tuple(wtab.shape)} {wtab.dtype}")
    if not wtab.is_contiguous():
        raise ValueError(f"{name}: wtab must be contiguous")
    if cells >= 2 ** 31:
        raise ValueError(f"{name}: n={n} exceeds int32 cell counts")
    smem = smem_bytes(n, fused)
    if smem > _build.SMEM_OPTIN_BYTES:
        raise ValueError(f"{name}: tiles take {smem} bytes of shared memory, "
                         f"over the {_build.SMEM_OPTIN_BYTES} a block can use")
    dev, bt = wtab.device, wtab.shape[0]
    if n <= 1:
        return _result(*_degenerate(wtab, n, bt, with_args, fused), squeeze,
                       with_args, fused)
    T, E = tile_plan(n)
    st = torch.empty((bt, cells), dtype=torch.float32, device=dev)
    ar = (torch.empty((bt, cells), dtype=torch.int32, device=dev)
          if with_args or fused else None)
    nodes = (torch.empty((bt, 3, L), dtype=torch.int32, device=dev)
             if fused else None)
    fn = _build.load("mcm_tiled").mcm_tiled_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(wtab.data_ptr(), st.data_ptr(),
                None if ar is None else ar.data_ptr(),
                None if nodes is None else nodes.data_ptr(), bt, n, L, T, E,
                smem, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return _result(st, ar, nodes, squeeze, with_args, fused)


def mcm_tiled(wtab, n: int):
    """Linearized cost table: the CUDA kernel for a CUDA ``wtab``, the plain
    version for a CPU one."""
    if wtab.is_cuda:
        return _launch(wtab, n, False, False)
    return mcm_tiled_plain(wtab, n)


def mcm_tiled_with_args(wtab, n: int):
    """``mcm_tiled`` + the best-split table (-1 on diagonal 0). Returns
    ``(st, args)``."""
    if wtab.is_cuda:
        return _launch(wtab, n, True, False)
    return mcm_tiled_plain(wtab, n, with_args=True)


def mcm_tiled_fused(wtab, n: int):
    """Solve, args and the preorder traceback in one launch. Returns
    ``(st, args, (ii, dd, ee))``, the node arrays of length ``n-1`` in
    ``core.mcm.triangular_traceback_np``'s order."""
    if wtab.is_cuda:
        return _launch(wtab, n, True, True)
    return mcm_tiled_plain(wtab, n, with_args=True, fused=True)
