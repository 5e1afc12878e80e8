"""Triangular solver with the traceback fused into its launch: CUDA
kernel and its plain PyTorch version.

Port of ``repro/kernels/mcm_tiled.py`` (``mcm_tiled_pallas``, its arg twin
and its fused twin). The recurrence is K2's (``mcm_pipeline``): split ``e``
of row ``i`` on diagonal ``d`` combines ``st[off(e)+i]``,
``st[off(d-e-1)+e+1+i]`` and ``W[off(d)+i, e]`` as ``(left + right) + w``,
folded by min with the first best split winning. The fused twin then walks
the split tree in preorder over the finished args, inside the same launch.

The kernel (``csrc/mcm_tiled.cu``) is one persistent, cooperative launch
per batch that spreads every diagonal over the whole card: its cells go to
groups of :func:`warps_per_cell` warps, a grid barrier separates the
diagonals, and the left and right operands are read from row- and
column-major copies of the finished table (scratch, ``2·n²`` floats per
instance), so every operand is contiguous in ``e``. :func:`tile_plan` and
:func:`smem_bytes` describe the first design's row × split tiles: the plain
version folds in those tiles and the route's admission keeps their
formula.

``wtab`` is ``(cells, n-1)`` or ``(batch, cells, n-1)`` float32 (never
copied or padded). A CPU tensor goes through :func:`mcm_tiled_plain`; a
CUDA tensor launches the kernel. ``n ≤ 1`` returns the preset-only table.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.mcm import lin_index, num_cells, triangular_traceback_np
from repro_torch.kernels import _build

#: E splits per tile, at most T rows (threads) per tile (the first design,
#: kept for the plain version's fold and the route's admission)
TILE_E, TILE_T = 64, 256
#: threads (warps) of one CTA of the kernel, and CTAs it keeps on one SM
THREADS, CTAS_PER_SM = 512, 1
WARPS = THREADS // 32

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"mcm_tiled": 0, "mcm_tiled_with_args": 0, "mcm_tiled_fused": 0}
#: geometry of the last launch at each shape, per wrapper (``_build.record``)
GEOMETRY: dict = {}


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
    """The route's admission rule: the first design's shared memory (left
    and right runs plus the weight tile, row stride ``E | 1``, or the fused
    walk's stack of ``n + 2`` int32 pairs), kept so that the route serves
    the specs it served. The kernel needs no more (:func:`spread_smem_bytes`)."""
    T, E = tile_plan(n)
    tiles = 4 * (2 * E * T + T * (E | 1))
    return max(tiles, 8 * (n + 2)) if fused else tiles


def spread_smem_bytes(n: int, fused: bool) -> int:
    """Dynamic shared memory of one CTA of the kernel: a (value, split)
    pair per warp for the merge; the fused walk reuses it for its stack."""
    return max(8 * WARPS, 8 * (n + 2)) if fused else 8 * WARPS


def warps_per_cell(d: int, cells_d: int, ctas: int) -> int:
    """Warps folding one cell of diagonal ``d`` (``cells_d`` cells over the
    batch, ``ctas`` CTAs): the least power of two whose lanes cover the
    ``d`` splits, at most :data:`WARPS`, halved while the cells would not
    each get a group. The kernel computes the same
    (``csrc/mcm_tiled.cu::warps_per_cell``)."""
    g = 1
    while g < WARPS and 32 * g < d:
        g *= 2
    while g > 1 and cells_d * g > ctas * WARPS:
        g //= 2
    return g


_BLOCKS_PER_SM: dict = {}


def blocks_per_sm(with_args: bool, fused: bool, n: int, device) -> int:
    """CTAs of the variant one SM of ``device`` keeps resident (the
    occupancy API, asked once per variant and shared memory)."""
    smem = spread_smem_bytes(n, fused)
    dev = torch.device(device)
    key = (dev.index, with_args or fused, fused, smem)
    if key not in _BLOCKS_PER_SM:
        fn = _build.load("mcm_tiled").mcm_tiled_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            _BLOCKS_PER_SM[key] = fn(int(with_args or fused), int(fused), smem)
    return _BLOCKS_PER_SM[key]


def ctas(with_args: bool, fused: bool, n: int, device) -> int:
    """The kernel's grid on ``device``: :data:`CTAS_PER_SM` on every SM,
    fewer if the occupancy API says an SM keeps fewer resident. Raises if
    it keeps none."""
    smem = spread_smem_bytes(n, fused)
    dev = torch.device(device)
    per_sm = blocks_per_sm(with_args, fused, n, dev)
    if per_sm < 1:
        raise RuntimeError(f"mcm_tiled: the card keeps no CTA of {THREADS} threads "
                           f"and {smem} bytes of shared memory resident")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * min(per_sm, CTAS_PER_SM)


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


def _launch(wtab, n, with_args, fused, grid=None):
    """The kernel on CUDA ``wtab``; ``grid`` overrides :func:`ctas` (a
    grid the card cannot keep resident raises)."""
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
    smem = spread_smem_bytes(n, fused)
    if smem > _build.SMEM_OPTIN_BYTES:
        raise ValueError(f"{name}: the walk's stack takes {smem} bytes of shared "
                         f"memory, over the {_build.SMEM_OPTIN_BYTES} a block can use")
    dev, bt = wtab.device, wtab.shape[0]
    if n <= 1:
        return _result(*_degenerate(wtab, n, bt, with_args, fused), squeeze,
                       with_args, fused)
    G = ctas(with_args, fused, n, dev) if grid is None else grid
    st = torch.empty((bt, cells), dtype=torch.float32, device=dev)
    ar = (torch.empty((bt, cells), dtype=torch.int32, device=dev)
          if with_args or fused else None)
    nodes = (torch.empty((bt, 3, L), dtype=torch.int32, device=dev)
             if fused else None)
    rowm = torch.empty((bt, n, n), dtype=torch.float32, device=dev)
    colm = torch.empty((bt, n, n), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _build.load("mcm_tiled").mcm_tiled_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(wtab.data_ptr(), st.data_ptr(),
                None if ar is None else ar.data_ptr(),
                None if nodes is None else nodes.data_ptr(), rowm.data_ptr(),
                colm.data_ptr(), bar.data_ptr(), bt, n, L, G, smem,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    _build.count(LAUNCHES, name)
    _build.record(GEOMETRY, name, (n,), G=G, smem=smem)
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
