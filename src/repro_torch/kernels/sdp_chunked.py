"""Streaming S-DP solver (the paper's Fig. 2 past the on-chip budget): CUDA
kernel and its plain PyTorch version.

Port of ``repro/kernels/sdp_pipeline.py``'s ``sdp_chunked_pallas`` and its
arg twin. The recurrence, fold order and arg rule are K1's
(``sdp_pipeline``); what differs is where the table lives while it is
built. A cell reads at most ``a_1`` cells back, so the kernel keeps only
that horizon on chip: a ring of ``R ≥ a_1 + Q`` cells in shared memory,
cell ``c`` in slot ``c mod R``, walked in chunks of ``Q`` cells
(``csrc/sdp_walk.cuh``, planned by :func:`plan`). Finished cells also go
straight to the output table, which nothing reads back. A plan whose lanes
are all far and whose chunk is long runs each instance on a thread-block
cluster (:func:`cluster_size`).

Inputs carry a leading batch axis or none: ``init`` ``(a_1,)`` or
``(batch, a_1)``, ``weights`` ``(n, k)`` or ``(batch, n, k)``. A CPU tensor
goes through :func:`sdp_chunked_plain`, which walks the reference's ring
step by step (``B = min(a_k, block)`` cells per step); a CUDA tensor
launches ``csrc/sdp_chunked.cu`` (one CTA or one cluster per instance, one
launch per batch). ``n ≤ a_1`` returns the clamped presets.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.semiring import SEMIGROUP_TO_SEMIRING
from repro_torch.kernels import _build, sdp_walk
from repro_torch.kernels.sdp_pipeline import _check_args, _runs_tensor, fold_lanes

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"sdp_chunked": 0, "sdp_chunked_with_args": 0}
#: geometry of the last launch at each shape, per wrapper (``_build.record``)
GEOMETRY: dict = {}


def _plain_ring(offsets, block: int = 512) -> tuple:
    """``(B, R)`` of the plain version: the reference's ``B = min(a_k,
    block)`` cells per step and a ring of ``R`` slots, the least multiple
    of 32 that is ``≥ a_1 + B``."""
    a1, ak = offsets[0], offsets[-1]
    B = max(1, min(ak, block))
    return B, -(-(a1 + B) // 32) * 32


def window_bytes(offsets, weighted: bool, block: int = 512) -> int:
    """The streaming route's admission rule: the shared memory of K3's first
    design (a ring of ``_plain_ring``'s ``R`` slots, the offsets and, when
    weighted, a staged tile of ``B·(J | 1)`` floats, ``J = min(k, 8192 //
    B)``), kept so that the route serves the specs it served. Every spec
    within the card's limit has a walk :func:`plan` that fits: its one-cell,
    unstaged chunk needs no more than this ring."""
    B, R = _plain_ring(offsets, block)
    k = len(offsets)
    J = min(k, max(1, 8192 // B))
    return 4 * (R + k + (B * (J | 1) if weighted else 0))


def plan(offsets, weighted: bool) -> sdp_walk.WalkPlan:
    """The chunk walk with a ring (``sdp_walk.plan``); raises where not
    even a one-cell chunk's ring fits the card's shared memory."""
    p = sdp_walk.plan(offsets, weighted, ring=True)
    if p is None:
        raise ValueError(f"sdp_chunked: a window of a_1={offsets[0]} cells does "
                         f"not fit the {_build.SMEM_OPTIN_BYTES} bytes of shared "
                         "memory a block can use")
    return p


def smem_bytes(offsets, weighted: bool, C: int = 1) -> int:
    """Dynamic shared memory of one CTA of :func:`plan`'s walk."""
    return sdp_walk.smem_bytes(offsets, plan(offsets, weighted), C)


def cluster_size(offsets, op: str, weighted: bool, with_args: bool, device) -> int:
    """CTAs per instance of :func:`plan`'s walk on ``device``
    (``sdp_walk.cluster_size``)."""
    return sdp_walk.cluster_size("sdp_chunked", offsets, plan(offsets, weighted), op,
                                 weighted, with_args, device)


def sdp_chunked_plain(init, offsets, op: str, n: int, block: int = 512,
                      weights=None, with_args: bool = False):
    """The reference's computation in PyTorch: a ring of the last cells,
    steps of ``B`` cells (vectorized per step), lanes folded in ascending
    ``j`` (min/max keep the first best lane). Returns ``st`` or
    ``(st, args)``."""
    offsets = _check_args(op, offsets, with_args)
    squeeze = init.dim() == 1
    if squeeze:
        init = init[None]
        weights = None if weights is None else weights[None]
    a1, bt, dev = offsets[0], init.shape[0], init.device
    ar = torch.full((bt, n), -1, dtype=torch.int32, device=dev)
    if n <= a1:
        st = init[:, :n].clone()
    else:
        B, R = _plain_ring(offsets, block)
        mul = SEMIGROUP_TO_SEMIRING[op].mul
        offs = torch.tensor(offsets, device=dev)
        ring = torch.zeros((bt, R), dtype=init.dtype, device=dev)
        ring[:, :a1] = init
        st = torch.empty((bt, n), dtype=init.dtype, device=dev)
        st[:, :a1] = init
        for s in range(a1, n, B):
            cnt = min(B, n - s)
            slot = torch.arange(s, s + cnt, device=dev) % R
            vals = ring[:, (slot[None, :] - offs[:, None]) % R]   # (batch, k, cnt)
            if weights is not None:
                vals = mul(vals, weights[:, s:s + cnt].transpose(1, 2))
            acc, arg = fold_lanes(vals, op)
            if arg is not None:
                ar[:, s:s + cnt] = arg
            ring[:, slot] = acc
            st[:, s:s + cnt] = acc
    if squeeze:
        st, ar = st[0], ar[0]
    return (st, ar) if with_args else st


def _launch(init, offsets, op, n, block, weights, with_args):
    name = "sdp_chunked_with_args" if with_args else "sdp_chunked"
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
    weighted = weights is not None
    p = plan(offsets, weighted)
    dev = init.device
    if n <= a1:  # preset-only: nothing to pipeline, clamp the presets
        st = init[:, :n].clone()
        ar = torch.full((bt, n), -1, dtype=torch.int32, device=dev)
    else:
        C = cluster_size(offsets, op, weighted, with_args, dev)
        S = sdp_walk.splits(offsets, p, op, C)
        st = torch.empty((bt, n), dtype=torch.float32, device=dev)
        ar = (torch.empty((bt, n), dtype=torch.int32, device=dev)
              if with_args else None)
        runs = _runs_tensor(offsets, dev)
        fn = _build.load("sdp_chunked").sdp_chunked_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            rc = fn(init.data_ptr(), None if weights is None else weights.data_ptr(),
                    runs.data_ptr(), st.data_ptr(),
                    None if ar is None else ar.data_ptr(),
                    bt, n, a1, k, runs.shape[0], p.Q, p.R, p.near, int(p.stage),
                    C, S, sdp_walk.threads(p, C, S), sdp_walk.OP_CODE[op],
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


def sdp_chunked(init, offsets, op: str, n: int, block: int = 512,
                weights=None):
    """ST[0..n-1]: the CUDA kernel for a CUDA ``init``, the plain version
    for a CPU one."""
    if init.is_cuda:
        return _launch(init, offsets, op, n, block, weights, False)
    return sdp_chunked_plain(init, offsets, op, n, block, weights)


def sdp_chunked_with_args(init, offsets, op: str, n: int, block: int = 512,
                          weights=None):
    """``sdp_chunked`` + the per-cell winning lane (-1 on presets).
    Returns ``(st, args)``."""
    if init.is_cuda:
        return _launch(init, offsets, op, n, block, weights, True)
    return sdp_chunked_plain(init, offsets, op, n, block, weights,
                             with_args=True)
