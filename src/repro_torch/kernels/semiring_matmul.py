"""Weighted tropical (min,+) matrix product: CUDA kernel (K5) and its plain
PyTorch version.

    C[b,i,j] = min_k ( A[b,i,k] + B[b,k,j] + (av[b,i]·gv[b,k])·bv[b,j] )

Port of ``repro/kernels/semiring_matmul.py`` (``tropical_matmul_pallas``),
the compute core of the blocked MCM route (``core/blocked_mcm.py``): the
split combine over a block's middle tiles is this product. Every candidate
rounds as ``repro`` computes it on the CPU, where XLA contracts the
weighted term into one fused multiply-add: ``fma(av·gv, bv, A + B)``, with
``A + B`` and ``av·gv`` each rounded to float32 first. Without weights the
candidate is ``A + B``. Min is exact, so the order of ``k`` does not
matter; NaN propagates, as in ``torch.amin``.

The contract is on values only: where the minimum is a zero reached as
both +0 and −0, the sign of the zero returned is not pinned (the kernel
splits K over a cluster and folds the CTAs' minima; the plain version keeps
the first it meets), as the reference's ``jnp.min`` pins none.
``torch.equal`` compares values, so "bit-equal" for K5 means equal up to
the sign of a zero minimum.

``a``: ``(M, K)`` or ``(.., M, K)`` with one or two batch axes, ``b``:
``(.., K, N)``, float32; the weights ``av (.., M)``, ``gv (.., K)``, ``bv
(.., N)`` are all given or all None. Any shape works (no block
divisibility). A CPU tensor goes through :func:`tropical_matmul_plain`; a
CUDA tensor launches ``csrc/semiring_matmul.cu``, one launch per call, as
:func:`plan` lays it out. On the card the operands may be strided views
(unit stride along their last axis, any other strides): the blocked route
passes its views of the table as they are.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.semiring import fma_f32
from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"tropical_matmul": 0}
#: candidates the plain version materializes per K chunk (float64 at most
#: 4 · 2^24 bytes per temporary)
_CHUNK_ELEMS = 2 ** 24

#: K columns a group stages per step; threads of a group; most groups a
#: CTA; largest cluster (16 is non-portable: the card must allow it); most
#: stages of the ring (split regime; the register regime, compute-bound,
#: keeps fewer)
KS, GROUP, MAX_GROUPS, MAX_CLUSTER, MAX_STAGES, REGISTER_STAGES = 32, 256, 4, 16, 8, 4
#: fewest K columns a CTA of a cluster takes (below it a split costs more
#: than the columns it saves)
MIN_SLICE = 16
#: output tile side and outputs a thread holds along each side, per regime
SPLIT, REGISTER = "split", "register"
_GEOM = {SPLIT: (16, 1), REGISTER: (64, 4)}


class Plan(NamedTuple):
    """How one launch lays out its work: the regime (``"split"``: 16 x 16
    output tiles, one output a thread; ``"register"``: 64 x 64 tiles, 4 x 4
    outputs a thread), the cluster of CTAs over K of one output tile, the
    K groups of 256 threads inside a CTA, the K columns a CTA takes (rank
    ``r`` takes ``[r·slice, (r+1)·slice)``) and the stages of its ring
    (each ``32·groups`` columns)."""
    regime: str
    tile: int
    per_thread: int
    cluster: int
    groups: int
    slice: int
    stages: int

    @property
    def threads(self) -> int:
        return GROUP * self.groups


def smem_bytes(regime: str, cluster: int, groups: int, stages: int) -> int:
    """Dynamic shared memory of one CTA: a ring of ``stages`` stages of
    ``32·groups`` columns (A as rows padded by 4 floats, B, gv; the group
    merge reuses it) and one receive slot of a tile for each other CTA of
    the cluster (``csrc/semiring_matmul.cu::smem_floats``)."""
    tile, _ = _GEOM[regime]
    w = KS * groups
    ring = stages * (tile * (w + 4) + w * tile + w)
    merge = (groups - 1) * tile * tile
    return 4 * (max(ring, merge) + (cluster - 1) * tile * tile)


def plan(batch: int, m: int, n: int, k: int, sms: int,
         max_cluster: int = MAX_CLUSTER) -> Plan:
    """The launch's layout on a card of ``sms`` SMs that allows clusters
    of ``max_cluster`` CTAs. The split regime takes products of at most
    16 x 16 outputs, the register regime the rest. The cluster doubles
    (up to ``max_cluster``) while the launch stays within two CTAs an SM
    and every CTA keeps at least :data:`MIN_SLICE` columns; groups (split
    regime) double while the CTAs' groups stay within one an SM and a CTA
    has more than one stage of columns; the ring holds the whole slice
    where :data:`MAX_STAGES` (:data:`REGISTER_STAGES`) stages do, and
    everything fits shared memory. Slices are multiples of 4 columns, so
    every rank's rows start on 16 bytes where the operands' rows do."""
    regime = SPLIT if m <= 16 and n <= 16 else REGISTER
    tile, r = _GEOM[regime]
    units = batch * -(-m // tile) * -(-n // tile)
    c = 1
    while (c * 2 <= max_cluster and units * c * 2 <= 2 * sms and k >= MIN_SLICE * c * 2
           and smem_bytes(regime, c * 2, 1, 1) <= _build.SMEM_OPTIN_BYTES):
        c *= 2
    slice_ = max(4, -(-k // (4 * c)) * 4)     # a multiple of 4: 16-byte copies
    g = 1
    if regime == SPLIT:
        while g < MAX_GROUPS and units * c * g * 2 <= sms and slice_ > g * KS:
            g *= 2
    stages = min(-(-slice_ // (KS * g)), MAX_STAGES if regime == SPLIT else REGISTER_STAGES)
    while stages > 1 and smem_bytes(regime, c, g, stages) > _build.SMEM_OPTIN_BYTES:
        stages -= 1
    return Plan(regime, tile, r, c, g, slice_, stages)


def _batched(a, b, av, gv, bv):
    """Lift unbatched operands to a batch of one; returns the operands and
    whether to squeeze the result."""
    weights = (av, gv, bv)
    if any(w is None for w in weights) and any(w is not None for w in weights):
        raise ValueError("tropical_matmul: give all of av, gv, bv or none")
    if a.dim() == 2:
        return (a[None], b[None]) + tuple(
            None if w is None else w[None] for w in weights) + (True,)
    return (a, b) + weights + (False,)


def tropical_matmul_plain(a, b, av=None, gv=None, bv=None):
    """The kernel's function in PyTorch, ``K`` in chunks with a running
    min, so memory stays bounded at any ``K``."""
    a, b, av, gv, bv, squeeze = _batched(a, b, av, gv, bv)
    bt, m, k = a.shape
    n = b.shape[-1]
    acc = torch.full((bt, m, n), float("inf"), dtype=a.dtype, device=a.device)
    kc = max(1, _CHUNK_ELEMS // max(1, bt * m * n))
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        cand = a[:, :, k0:k1, None] + b[:, None, k0:k1, :]     # (bt, m, kc, n)
        if av is not None:
            w = av[:, :, None] * gv[:, None, k0:k1]             # (bt, m, kc)
            cand = fma_f32(w[..., None], bv[:, None, None, :], cand)
        acc = torch.minimum(acc, cand.amin(dim=2))
    return acc[0] if squeeze else acc


_FN = None
_LIMITS: dict = {}


def _lib():
    """The launcher, its argument types set once."""
    global _FN
    if _FN is None:
        fn = _build.load("semiring_matmul").tropical_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def card_limits(device) -> tuple:
    """``(SMs, largest cluster)`` of the card: its multiprocessor count and
    16 if the occupancy API keeps a cluster of 16 of the largest
    split-regime CTAs resident, else 8 (asked once per device)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _LIMITS:
        fn = _build.load("semiring_matmul").tropical_matmul_max_clusters
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        with torch.cuda.device(idx):
            big = fn(1, MAX_CLUSTER, MAX_GROUPS, MAX_STAGES) >= 1
        _LIMITS[idx] = (torch.cuda.get_device_properties(idx).multi_processor_count,
                        MAX_CLUSTER if big else 8)
    return _LIMITS[idx]


@functools.lru_cache(maxsize=1024)
def _cached_plan(batch, m, n, k, sms, max_cluster) -> Plan:
    return plan(batch, m, n, k, sms, max_cluster)


def _lead(t, want: int):
    """``(outer stride, inner stride)`` of ``t``'s batch axes (``want``
    trailing axes after them); raises unless its last axis has unit
    stride."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError("tropical_matmul: operands need unit stride along "
                         f"their last axis, got strides {tuple(t.stride())}")
    lead = t.dim() - want
    if lead == 0:
        return 0, 0
    if lead == 1:
        return 0, t.stride(0)
    return t.stride(0), t.stride(1)


def _launch(a, b, av=None, gv=None, bv=None, plan: Plan = None):
    """The kernel on CUDA operands; ``plan`` overrides :func:`plan`."""
    name = "tropical_matmul"
    weights = (av, gv, bv)
    if any(w is None for w in weights) and any(w is not None for w in weights):
        raise ValueError("tropical_matmul: give all of av, gv, bv or none")
    weighted = av is not None
    if a.dim() not in (2, 3, 4) or b.dim() != a.dim():
        raise ValueError(f"{name}: a and b must be 2-D to 4-D alike, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    *lead, m, k = a.shape
    lead, n = tuple(lead), b.shape[-1]
    want = [(b, lead + (k, n))] + ([(av, lead + (m,)), (gv, lead + (k,)),
                                    (bv, lead + (n,))] if weighted else [])
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, "
                             f"expected {shape}")
    dev = a.device
    for t in (a, b) + (weights if weighted else ()):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: operands must be float32 on one device")
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"{name}: a matrix of 2^31 or more entries")
    nb1, nb0 = (1, 1) if not lead else (1, lead[0]) if len(lead) == 1 else lead
    strides = (*_lead(a, 2), a.stride(-2), *_lead(b, 2), b.stride(-2))
    strides += sum((_lead(w, 1) for w in weights), ()) if weighted else (0,) * 6
    c = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    if c.numel() == 0:
        return c
    if plan is None:
        plan = _cached_plan(nb1 * nb0, m, n, k, *card_limits(dev))
    fn = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), ptr(av), ptr(gv), ptr(bv), c.data_ptr(),
                (ctypes.c_longlong * 12)(*strides), nb1, nb0, m, n, k,
                plan.per_thread, plan.cluster, plan.groups, plan.slice, plan.stages,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    _build.count(LAUNCHES, name)
    return c


def tropical_matmul(a, b, av=None, gv=None, bv=None):
    """Weighted (min,+) product: the CUDA kernel for CUDA operands, the
    plain version for CPU ones (two batch axes flattened into one)."""
    if a.is_cuda:
        return _launch(a, b, av, gv, bv)
    if a.dim() == 4:
        lead = a.shape[:2]
        flat = [None if t is None else t.reshape(-1, *t.shape[2:]) for t in (a, b, av, gv, bv)]
        out = tropical_matmul_plain(*flat)
        return out.reshape(*lead, *out.shape[1:])
    return tropical_matmul_plain(a, b, av, gv, bv)
