"""Diagonal pipeline for the canonical triangular split recurrence: CUDA
kernel and its plain PyTorch version.

Port of ``repro/kernels/mcm_pipeline.py`` (``mcm_pipeline_pallas`` and its
arg twin). On the diagonal-major table one whole diagonal is finalized per
step; split ``e`` of lane ``t`` on diagonal ``d`` reads ``st[off(e)+t]``,
``st[off(d-e-1)+e+1+t]`` and ``W[off(d)+t, e]``, combined as
``(left + right) + w`` and folded by min over ascending ``e`` (strict
improve: the first best split wins; -1 on diagonal 0).

``wtab`` is ``(cells, n-1)`` or ``(batch, cells, n-1)`` float32. A CPU tensor
goes through :func:`mcm_pipeline_plain`; a CUDA tensor launches
``csrc/mcm_pipeline.cu``: one launch per batch, one thread-block cluster of
:func:`cluster_size` CTAs per instance, the table in shared memory
(:func:`table_home`), each diagonal's cells folded by groups of
:func:`lanes_per_cell` lanes over the splits, merged by (value, split).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.mcm import lin_index, num_cells
from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"mcm_pipeline": 0, "mcm_pipeline_with_args": 0}
#: geometry of the last launch at each shape, per wrapper (``_build.record``)
GEOMETRY: dict = {}

#: threads of one CTA; bytes of its merge slots (a value and a split a warp)
THREADS = 512
MERGE_BYTES = 8 * (THREADS // 32)
#: CTAs per instance tried, largest first (above 8 a non-portable size)
CLUSTER_SIZES = (16, 8, 4, 2, 1)


def _lanes(n: int) -> int:
    """Row width of the split-major weight table."""
    return max(n - 1, 1)


def _table_bytes(n: int) -> int:
    return -(-4 * num_cells(n) // 16) * 16


def table_home(n: int) -> str:
    """Where the kernel keeps an instance's cost table: ``"shared"`` (a
    replica in every CTA of its cluster) while the table fits beside the
    merge slots in the shared memory a block can use (every ``n ≤ 340``),
    else ``"device"`` (the output table, read past L1). The kernel computes
    the same (``csrc/mcm_pipeline.cu::table_in_smem``)."""
    fits = _table_bytes(n) + MERGE_BYTES <= _build.SMEM_OPTIN_BYTES
    return "shared" if fits else "device"


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one CTA: the table (at home there) and the
    merge slots."""
    return (_table_bytes(n) if table_home(n) == "shared" else 0) + MERGE_BYTES


def lanes_per_cell(d: int, cells_d: int, lanes: int) -> int:
    """Lanes folding one cell of diagonal ``d`` (``cells_d`` cells, ``lanes``
    threads in the instance's cluster): the least power of two covering
    the ``d`` splits, at most :data:`THREADS`, halved while the cells would
    not each get a group. The kernel computes the same
    (``csrc/mcm_pipeline.cu::lanes_per_cell``)."""
    w = 1
    while w < THREADS and w < d:
        w *= 2
    while w > 1 and cells_d * w > lanes:
        w //= 2
    return w


def pick_cluster(batch: int, active: dict) -> int:
    """CTAs per instance: the largest size of :data:`CLUSTER_SIZES` of which
    the card keeps ``batch`` clusters resident at once (``active``: size →
    clusters the occupancy API reports), else 1 (the batch runs in waves
    either way; single CTAs waste no SM on a wave's tail)."""
    return next((c for c in CLUSTER_SIZES if active.get(c, 0) >= batch), 1)


_ACTIVE: dict = {}


def max_clusters(with_args: bool, n: int, C: int, device) -> int:
    """Clusters of ``C`` CTAs of the variant the card runs at once at width
    ``n`` (the occupancy API, asked once per variant, home and size)."""
    dev = torch.device(device)
    key = (dev.index, with_args, smem_bytes(n), C)
    if key not in _ACTIVE:
        fn = _build.load("mcm_pipeline").mcm_pipeline_max_clusters
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            _ACTIVE[key] = fn(int(with_args), n, C)
    return _ACTIVE[key]


def cluster_size(with_args: bool, n: int, batch: int, device) -> int:
    """:func:`pick_cluster` over what the card reports. Raises if it keeps
    not even one CTA resident."""
    active = {c: max_clusters(with_args, n, c, device) for c in CLUSTER_SIZES}
    if active[1] < 1:
        raise RuntimeError(f"mcm_pipeline: the card keeps no CTA of {THREADS} "
                           f"threads and {smem_bytes(n)} bytes of shared memory resident")
    return pick_cluster(batch, active)


def mcm_pipeline_plain(wtab, n: int, with_args: bool = False):
    """The kernel's computation in PyTorch: one diagonal per step, the same
    association and the same first-best split. Returns ``st`` or
    ``(st, args)``."""
    squeeze = wtab.dim() == 2
    if squeeze:
        wtab = wtab[None]
    dev, cells = wtab.device, num_cells(n)
    st = torch.zeros((wtab.shape[0], cells), dtype=wtab.dtype, device=dev)
    ar = torch.full(st.shape, -1, dtype=torch.int32, device=dev)
    for d in range(1, n):
        t = torch.arange(n - d, device=dev)[:, None]       # lanes of diagonal d
        e = torch.arange(d, device=dev)[None, :]           # splits, ascending
        off_d = lin_index(0, d, n)
        vals = ((st[:, lin_index(0, e, n) + t]
                 + st[:, lin_index(0, d - e - 1, n) + e + 1 + t])
                + wtab[:, off_d + t, e])                   # (batch, lanes, d)
        _, arg = vals.min(dim=2)
        st[:, off_d:off_d + n - d] = vals.gather(2, arg[..., None])[..., 0]
        ar[:, off_d:off_d + n - d] = arg.to(torch.int32)
    if squeeze:
        st, ar = st[0], ar[0]
    return (st, ar) if with_args else st


def _launch(wtab, n, with_args, cluster=None):
    """The kernel on CUDA ``wtab``; ``cluster`` overrides
    :func:`cluster_size` (CTAs per instance)."""
    name = "mcm_pipeline_with_args" if with_args else "mcm_pipeline"
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
    dev, bt = wtab.device, wtab.shape[0]
    C = cluster_size(with_args, n, bt, dev) if cluster is None else cluster
    st = torch.empty((bt, cells), dtype=torch.float32, device=dev)
    ar = torch.empty((bt, cells), dtype=torch.int32, device=dev) if with_args else None
    lib = _build.load("mcm_pipeline")
    fn = lib.mcm_pipeline_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(wtab.data_ptr(), st.data_ptr(),
                None if ar is None else ar.data_ptr(), bt, n, L, C,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    _build.count(LAUNCHES, name)
    _build.record(GEOMETRY, name, (n, bt), C=C, home=table_home(n),
                  smem=smem_bytes(n))
    if squeeze:
        st = st[0]
        ar = None if ar is None else ar[0]
    return (st, ar) if with_args else st


def mcm_pipeline(wtab, n: int):
    """Linearized cost table: the CUDA kernel for a CUDA ``wtab``, the plain
    version for a CPU one."""
    if wtab.is_cuda:
        return _launch(wtab, n, with_args=False)
    return mcm_pipeline_plain(wtab, n)


def mcm_pipeline_with_args(wtab, n: int):
    """``mcm_pipeline`` + the best-split table (-1 on diagonal 0).
    Returns ``(st, args)``."""
    if wtab.is_cuda:
        return _launch(wtab, n, with_args=True)
    return mcm_pipeline_plain(wtab, n, with_args=True)
