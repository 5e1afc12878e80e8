"""The plan of the chunk walk that the S-DP kernels K1 (``sdp_pipeline``)
and K3 (``sdp_chunked``) share (``csrc/sdp_walk.cuh``).

The walk finishes the cells past the presets in chunks of ``Q``. For the
cell at position ``p`` of a chunk, the lanes with ``a_j > p`` (a prefix of
``j``: offsets descend) read earlier chunks and are folded for the whole
chunk in parallel; the others ("near" lanes, ``a_j ≤ p``) read the same
chunk and are folded afterwards, in ascending ``j``, by one warp. The plan
is a pure function of the offsets, whether weights are staged, and the
shared memory a CTA may use; no table or arg depends on it (the plain
versions keep the reference's step geometry, ``block``). A wide plan (all
lanes far, a long chunk) runs each instance on a thread-block cluster of
:func:`cluster_size` CTAs, which split every chunk.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build

OP_CODE = {"min": 0, "max": 1, "add": 2}

#: (library, device index, op, weighted, args, Q, smem per candidate) -> the
#: cluster size read from the card
_CLUSTERS: dict = {}

#: cells per chunk at most: one thread each in the far fold
MAX_CHUNK = 1024
#: cells the near warp holds (two a thread): near offsets stay below it
WINDOW = 64
#: an all-far chunk at least this long spreads over a cluster (K3), each of
#: its CTAs keeping at least CLUSTER_MIN_CELLS cells of every chunk
CLUSTER_MIN_CHUNK, CLUSTER_MIN_CELLS = 256, 128
#: cluster sizes tried, largest first (8 is the portable maximum)
CLUSTER_SIZES = (8, 4, 2)
#: threads per cell of a min/max chunk's far fold at most, and the lanes
#: each takes at least
MAX_SPLITS, SPLIT_MIN_LANES = 4, 32


@dataclass(frozen=True)
class WalkPlan:
    """``Q`` cells per chunk; ``R`` ring slots (K3, 0 for K1); ``near``:
    0 when every lane is far, 1 when offset 1 is the only near one, 2 for
    the warp window; ``stage``: weight rows staged in shared memory."""
    Q: int
    R: int
    near: int
    stage: bool

    @property
    def wide(self) -> bool:
        """All lanes far and the chunk long enough to split over a cluster."""
        return self.near == 0 and self.Q >= CLUSTER_MIN_CHUNK


def runs(offsets) -> list:
    """Maximal runs of consecutive offsets as ``(a0, j0, len, 0)``: lanes
    ``j0 .. j0+len-1`` have offsets ``a0, a0-1, …``."""
    out = []
    for j, a in enumerate(offsets):
        if out and out[-1][0] - out[-1][2] == a:
            out[-1][2] += 1
        else:
            out.append([a, j, 1, 0])
    return [tuple(r) for r in out]


def near_mode(offsets, Q: int) -> int:
    near = [a for a in offsets if a < Q]
    return 0 if not near else 1 if near == [1] else 2


def _rows(p: WalkPlan, C: int) -> tuple:
    """Cells of a chunk one CTA finishes, and the threads of one lane block
    (whole warps)."""
    rows = -(-p.Q // C)
    return rows, max(32, -(-rows // 32) * 32)


def splits(offsets, p: WalkPlan, op: str, C: int = 1,
           limit: int = _build.SMEM_OPTIN_BYTES) -> int:
    """Threads per cell in the far fold: for min and max (whose fold merges
    exactly by value, then lane), up to ``MAX_SPLITS`` blocks of at least
    ``SPLIT_MIN_LANES`` lanes, while the CTA stays within 1024 threads and
    its shared memory within ``limit``; 1 for add, which folds strictly in
    order."""
    if op == "add":
        return 1
    S = max(1, min(MAX_SPLITS, 1024 // _rows(p, C)[1],
                   len(offsets) // SPLIT_MIN_LANES))
    while S > 1 and smem_bytes(offsets, p, C, S) > limit:
        S -= 1
    return S


def smem_bytes(offsets, p: WalkPlan, C: int = 1, S: int = 1) -> int:
    """Dynamic shared memory of one CTA (``sdp_walk.cuh::smem_words``):
    ring, the weight double buffer of its ``ceil(Q / C)`` rows at stride
    ``k | 1``, (near lanes) the chunk's partials and the lane table, and
    (``S`` lane blocks) the blocks' partials."""
    k, (rows, stride) = len(offsets), _rows(p, C)
    words = p.R + (2 * rows * (k | 1) if p.stage else 0)
    if p.near:
        words += 2 * p.Q + WINDOW + 1
    if S > 1:
        words += 2 * S * stride
    return 4 * words


def plan(offsets, weighted: bool, ring: bool,
         limit: int = _build.SMEM_OPTIN_BYTES) -> Optional[WalkPlan]:
    """The longest chunk (≤ ``MAX_CHUNK``) whose near offsets stay below
    ``WINDOW``, halved until the CTA's shared memory fits ``limit``; weights
    staged if any chunk then fits, else read from device memory. ``ring``:
    K3's ring of ``R`` = the least multiple of 32 ≥ ``a_1 + Q`` slots. None
    if not even a one-cell chunk fits."""
    a1 = offsets[0]
    far = [a for a in offsets if a >= WINDOW]
    q0 = min(MAX_CHUNK, min(far)) if far else MAX_CHUNK
    for stage in ((True, False) if weighted else (False,)):
        Q = q0
        while Q >= 1:
            R = -(-(a1 + Q) // 32) * 32 if ring else 0
            p = WalkPlan(Q=Q, R=R, near=near_mode(offsets, Q), stage=stage)
            if smem_bytes(offsets, p) <= limit:
                return p
            Q //= 2
    return None


def threads(p: WalkPlan, C: int = 1, S: int = 1) -> int:
    """Threads of one CTA: ``S`` per cell of its share of a chunk, each
    lane block whole warps."""
    return S * _rows(p, C)[1]


def cluster_candidates(p: WalkPlan) -> tuple:
    """Cluster sizes a wide plan may take, largest first; () otherwise."""
    if not p.wide:
        return ()
    return tuple(c for c in CLUSTER_SIZES if p.Q // c >= CLUSTER_MIN_CELLS)


def cluster_size(library: str, offsets, p: WalkPlan, op: str, weighted: bool,
                 with_args: bool, device) -> int:
    """CTAs per instance: the largest of :func:`cluster_candidates` of which
    the card can run a cluster at this plan's threads and shared memory
    (``<library>_max_clusters``, asked once per shape), else 1."""
    cands = cluster_candidates(p)
    if not cands:
        return 1
    ss = tuple(splits(offsets, p, op, c) for c in cands)
    smems = tuple(smem_bytes(offsets, p, c, S) for c, S in zip(cands, ss))
    key = (library, torch.device(device).index, op, weighted, with_args, p.Q, smems)
    if key not in _CLUSTERS:
        fn = getattr(_build.load(library), f"{library}_max_clusters")
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            _CLUSTERS[key] = next(
                (c for c, S, sm in zip(cands, ss, smems)
                 if fn(OP_CODE[op], int(weighted), int(with_args), c,
                       threads(p, c, S), sm) >= 1), 1)
    return _CLUSTERS[key]
