"""Blocked pipelined S-DP solver (the paper's Fig. 2): CUDA kernel and its
plain PyTorch version.

Port of ``repro/kernels/sdp_pipeline.py`` (``sdp_pipeline_pallas`` and its
arg twin). Each step finalizes ``B = min(a_k, block)`` cells — the geometry
of ``_plan`` — and every read of a block uses an offset ``≥ a_k ≥ B``, so it
touches only cells of earlier steps. Lanes fold in ascending ``j``; with
args, a lane wins only by strict improvement (argmin/argmax's
first-occurrence rule) and preset cells carry -1. ``n ≤ a_1`` returns the
clamped presets.

Inputs carry a leading batch axis or none: ``init`` ``(a_1,)`` or
``(batch, a_1)``, ``weights`` ``(n, k)`` or ``(batch, n, k)``. A CPU tensor
goes through :func:`sdp_pipeline_plain`; a CUDA tensor launches
``csrc/sdp_pipeline.cu`` (one CTA or one cluster per instance, one launch
per batch), which walks the table in chunks of its own length
(``csrc/sdp_walk.cuh``, planned by ``sdp_walk.plan`` without a ring): the
step geometry above is the reference's and the plain version's, and no
result depends on it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sdp import _check_offsets
from repro_torch.core.semiring import SEMIGROUP_TO_SEMIRING
from repro_torch.kernels import _build, sdp_walk

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"sdp_pipeline": 0, "sdp_pipeline_with_args": 0}
#: geometry of the last launch at each shape, per wrapper (``_build.record``)
GEOMETRY: dict = {}


def _plan(offsets, n: int, block: int):
    """Shared block geometry: (B, num_blocks, n_pad)."""
    a1, ak = offsets[0], offsets[-1]
    B = max(1, min(ak, block))
    num_blocks = -(-(n - a1) // B)
    return B, num_blocks, a1 + num_blocks * B


def _runs_tensor(offsets, device) -> torch.Tensor:
    """``sdp_walk.runs(offsets)`` as an int32 ``(runs, 4)`` tensor on
    ``device``, the kernels' offset table."""
    return torch.tensor(sdp_walk.runs(offsets), dtype=torch.int32, device=device)


def _check_args(op: str, offsets, with_args: bool) -> tuple:
    offsets = tuple(int(a) for a in _check_offsets(offsets))
    if op not in sdp_walk.OP_CODE:
        raise ValueError(f"unknown op {op!r}")
    if with_args and op == "add":
        raise ValueError("argument tracking is undefined for op='add' "
                         "(every lane contributes to the reduction)")
    return offsets


def fold_lanes(vals, op: str) -> tuple:
    """Fold ``(batch, k, cells)`` candidates over their lanes in ascending
    ``j``: ``(sum, None)`` for add, else the min/max with its first best
    lane (as the kernels' strict-improve fold) as int32."""
    if op == "add":
        acc = vals[:, 0]
        for j in range(1, vals.shape[1]):
            acc = acc + vals[:, j]
        return acc, None
    _, arg = vals.min(dim=1) if op == "min" else vals.max(dim=1)
    return vals.gather(1, arg[:, None])[:, 0], arg.to(torch.int32)


def sdp_pipeline_plain(init, offsets, op: str, n: int, block: int = 512,
                       weights=None, with_args: bool = False):
    """The kernel's computation in PyTorch: same cells, same steps, same
    ``B``, lanes folded in ascending ``j`` (min/max keep the first best
    lane, as the strict-improve fold does). Returns ``st`` or
    ``(st, args)``."""
    offsets = _check_args(op, offsets, with_args)
    squeeze = init.dim() == 1
    if squeeze:
        init = init[None]
        weights = None if weights is None else weights[None]
    a1, bt, dev = offsets[0], init.shape[0], init.device
    if n <= a1:
        st = init[:, :n].clone()
        ar = torch.full((bt, n), -1, dtype=torch.int32, device=dev)
    else:
        B, num_blocks, _ = _plan(offsets, n, block)
        mul = SEMIGROUP_TO_SEMIRING[op].mul
        offs = torch.tensor(offsets, device=dev)
        st = torch.zeros((bt, n), dtype=init.dtype, device=dev)
        st[:, :a1] = init
        ar = torch.full((bt, n), -1, dtype=torch.int32, device=dev)
        for blk in range(num_blocks):
            start = a1 + blk * B
            end = min(start + B, n)
            src = torch.arange(start, end, device=dev)[None, :] - offs[:, None]
            vals = st[:, src]                                # (batch, k, cells)
            if weights is not None:
                vals = mul(vals, weights[:, start:end].transpose(1, 2))
            acc, arg = fold_lanes(vals, op)
            if arg is not None:
                ar[:, start:end] = arg
            st[:, start:end] = acc
    if squeeze:
        st, ar = st[0], ar[0]
    return (st, ar) if with_args else st


def grid_rows_plain(init, offsets, op: str, n: int, weights, with_args: bool = False):
    """:func:`sdp_pipeline_plain`'s table (and args) for specs whose offsets
    are ``(w + 1, w, 1)`` (an alignment grid of rows of ``w`` cells,
    linearized; ``init`` (batch, w + 1) or (w + 1,), ``weights`` (batch, n,
    3) or (n, 3)), a grid
    row at a time instead of a cell a step: the two lanes from the row
    above at once, the in-row chain ``t[c] = op(a[c], t[c - 1] + g[c])`` as
    a running min (max) of ``a - P`` plus ``P``, ``P`` the row's prefix
    sums of ``g``, and each cell's first best lane read off the exact
    values. That equals the cell-by-cell fold exactly where every finite
    value is an integer below 2^24 (edit distance, lcs), which it checks:
    it raises ``ValueError`` otherwise, and where a row's first cell has
    an in-row weight other than the op's zero. Returns ``st`` or
    ``(st, args)``."""
    w = offsets[1]
    if tuple(offsets) != (w + 1, w, 1) or op not in ("min", "max") or weights is None:
        raise ValueError(f"grid_rows_plain: offsets {tuple(offsets)} and op {op!r} are not "
                         "an alignment grid's (w + 1, w, 1) under min or max, with weights")
    squeeze = init.dim() == 1
    if squeeze:
        init, weights = init[None], weights[None]
    finite = weights[torch.isfinite(weights)]
    if not bool((finite == finite.round()).all()) or float(finite.abs().max()) * n >= 2 ** 24:
        raise ValueError("grid_rows_plain: weights are not small integers")
    lane, scan = (torch.minimum, torch.cummin) if op == "min" else (torch.maximum, torch.cummax)
    zero = float("inf") if op == "min" else float("-inf")
    a1, wt, dev = w + 1, weights.double(), init.device
    t = torch.empty((init.shape[0], n), dtype=torch.float64, device=dev)
    t[:, :a1] = init
    ar = torch.full((init.shape[0], n), -1, dtype=torch.int32, device=dev)
    s = a1
    while s < n:
        e = min((s // w + 1) * w, n)
        c = torch.arange(s, e, device=dev)
        v0, v1 = t[:, c - w - 1] + wt[:, c, 0], t[:, c - w] + wt[:, c, 1]
        a = lane(v0, v1)
        if s % w:   # a1's row: its first cell's in-row lane reads the preset before it
            base = torch.cat([t[:, s - 1:s], a], dim=1)
            g = torch.cat([torch.zeros_like(a[:, :1]), wt[:, s:e, 2]], dim=1)
        else:       # a grid row's first cell has no in-row lane (its weight is the zero)
            if not bool((wt[:, s, 2] == zero).all()):
                raise ValueError("grid_rows_plain: the in-row weight of a row's first "
                                 f"cell is not {zero}: not an alignment grid's layout")
            base, g = a, torch.cat([torch.zeros_like(a[:, :1]), wt[:, s + 1:e, 2]], dim=1)
        if not bool(torch.isfinite(g).all()):
            raise ValueError("grid_rows_plain: an in-row weight past a row's first cell "
                             "is not finite")
        prefix = g.cumsum(dim=1)
        row = (scan(base - prefix, dim=1).values + prefix)[:, -(e - s):]
        t[:, s:e] = row
        if with_args:
            ar[:, s:e] = torch.where(v0 == row, 0, torch.where(v1 == row, 1, 2)).to(torch.int32)
        s = e
    st = t.float()
    if squeeze:
        st, ar = st[0], ar[0]
    return (st, ar) if with_args else st


def _launch(init, offsets, op, n, block, weights, with_args):
    name = "sdp_pipeline_with_args" if with_args else "sdp_pipeline"
    offsets = _check_args(op, offsets, with_args)
    squeeze = init.dim() == 1
    if squeeze:
        init = init[None]
        weights = None if weights is None else weights[None]
    bt, a1, k = init.shape[0], offsets[0], len(offsets)
    if init.dtype != torch.float32 or init.shape[1] != a1:
        raise ValueError(f"{name}: init must be float32 (batch, {a1}), got "
                         f"{tuple(init.shape)} {init.dtype}")
    if weights is not None and (weights.device != init.device
                                or weights.dtype != torch.float32
                                or tuple(weights.shape) != (bt, n, k)):
        raise ValueError(f"{name}: weights must be float32 ({bt}, {n}, {k}) "
                         f"on {init.device}, got {tuple(weights.shape)} "
                         f"{weights.dtype} on {weights.device}")
    if not (init.is_contiguous() and (weights is None or weights.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: n={n} exceeds int32 cell indices")
    dev = init.device
    if n <= a1:  # preset-only: nothing to pipeline, clamp the presets
        st = init[:, :n].clone()
        ar = torch.full((bt, n), -1, dtype=torch.int32, device=dev)
    else:
        weighted = weights is not None
        p = sdp_walk.plan(offsets, weighted, ring=False)
        C = sdp_walk.cluster_size("sdp_pipeline", offsets, p, op, weighted, with_args, dev)
        S = sdp_walk.splits(offsets, p, op, C)
        st = torch.empty((bt, n), dtype=torch.float32, device=dev)
        ar = (torch.empty((bt, n), dtype=torch.int32, device=dev)
              if with_args else None)
        runs = _runs_tensor(offsets, dev)
        fn = _build.load("sdp_pipeline").sdp_pipeline_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            rc = fn(init.data_ptr(), None if weights is None else weights.data_ptr(),
                    runs.data_ptr(), st.data_ptr(),
                    None if ar is None else ar.data_ptr(),
                    bt, n, a1, k, runs.shape[0], p.Q, p.near, int(p.stage), C, S,
                    sdp_walk.threads(p, C, S), sdp_walk.OP_CODE[op],
                    sdp_walk.smem_bytes(offsets, p, C, S),
                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, name)
        _build.count(LAUNCHES, name)
        _build.record(GEOMETRY, name, (offsets, op, weighted), Q=p.Q, R=p.R,
                      near=p.near, stage=p.stage, C=C, S=S,
                      threads=sdp_walk.threads(p, C, S),
                      smem=sdp_walk.smem_bytes(offsets, p, C, S))
    if squeeze:
        st = st[0]
        ar = None if ar is None else ar[0]
    return (st, ar) if with_args else st


def sdp_pipeline(init, offsets, op: str, n: int, block: int = 512,
                 weights=None):
    """ST[0..n-1]: the CUDA kernel for a CUDA ``init``, the plain version
    for a CPU one."""
    if init.is_cuda:
        return _launch(init, offsets, op, n, block, weights, with_args=False)
    return sdp_pipeline_plain(init, offsets, op, n, block, weights)


def sdp_pipeline_with_args(init, offsets, op: str, n: int, block: int = 512,
                           weights=None):
    """``sdp_pipeline`` + the per-cell winning lane (-1 on presets).
    Returns ``(st, args)``."""
    if init.is_cuda:
        return _launch(init, offsets, op, n, block, weights, with_args=True)
    return sdp_pipeline_plain(init, offsets, op, n, block, weights,
                              with_args=True)
