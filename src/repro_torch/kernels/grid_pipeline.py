"""Wavefront pipeline for the grid family: CUDA kernel and its plain
PyTorch version.

Port of ``repro/kernels/grid_pipeline.py`` (``grid_pipeline_pallas`` and
its arg twin). ``arrs``/``meta`` are a ``GridSpec``'s ``device_arrays()``
slots (as tensors, per instance or with a leading batch axis) and its
``static_meta()``.

``antidiag`` — the kernel runs a wavefront of ``T × T`` tiles over the
caller's row-major planes (:func:`tile_plan`), each tile sweeping its inner
anti-diagonals in shared memory. The plain version walks the cell fronts
``t = i + j`` in *frontier-major* order: cell ``(i, j)`` of front ``t``
sits at ``base(t) + j - c0(t)``, with ``c0(t) = max(0, t - rows + 1)`` and
``base(t)`` the sum of the earlier fronts' lengths (:func:`front_base`, a
closed form in three regimes), so each front is one contiguous run. Each
cell's fold is the same in both. A move whose source lies outside the grid
contributes nothing; a preset cell takes its ``init`` value and arg -1; a
plane that no move targets keeps its initial value (``init`` where preset,
the semiring zero elsewhere).

``spandiag`` — the table is diagonal-major per plane already. Per span
diagonal, each (plane ``A``, lane ``i``) folds ``(left + right) + rw[r]``
over the splits ``e`` ascending and, per split, the rules into ``A`` in
declaration order; the packed arg is ``e·len(rules) + r``.

Both fold with strict improvement from the semiring zero, starting from the
first move or rule into the plane, so ties keep the first candidate in
declaration order — the tie rule of ``repro_torch.core.grid``'s
``argmin``/``argmax``, against which the CPU tests hold this module.

A CPU tensor goes through :func:`grid_pipeline_plain`; a CUDA tensor
launches ``csrc/grid_pipeline.cu``, one launch per batch: a persistent
cooperative grid over the tiles of the whole batch (antidiag), or over
each span diagonal's (instance, plane, cell) triples, a grid barrier
between diagonals, a triple's candidates split over the lanes of
:func:`spandiag_warps` warps and merged by (value, key) (spandiag).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.grid import batched, plane_lists, semiring_zero, unbatched
from repro_torch.core.mcm import lin_index, num_cells
from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"grid_pipeline_antidiag": 0, "grid_pipeline_antidiag_with_args": 0,
            "grid_pipeline_spandiag": 0, "grid_pipeline_spandiag_with_args": 0}
#: geometry of the last launch at each shape, per wrapper (``_build.record``)
GEOMETRY: dict = {}


#: tile sides the antidiag plan tries, largest first, and the deepest halo
#: it stages (longer moves read the finished table in device memory)
TILE_SIDES = (64, 56, 48, 40, 32, 24, 16, 8, 4, 2, 1)
HALO = 4
#: bytes of static shared memory the antidiag kernel declares, kept free
_STATIC_SMEM = 64
#: spandiag: threads (warps) of one CTA, CTAs it keeps on one SM at most
SD_THREADS, SD_CTAS_PER_SM = 512, 1
SD_WARPS = SD_THREADS // 32


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The antidiag kernel's tiles: side ``T``; ``HI`` rows and ``HJ``
    columns of halo; even row strides ``S1`` (table tile with halo) and
    ``SW`` (weight, mask and arg tiles), so a warp's reads along an
    anti-diagonal fall on distinct banks; ``tab`` ints of move table
    (padded to 4); threads (one per plane and tile row) and the dynamic
    shared memory of one CTA."""
    T: int
    HI: int
    HJ: int
    S1: int
    SW: int
    tab: int
    threads: int
    smem: int


def _tile_smem(T: int, HI: int, HJ: int, tab: int, P: int, L: int,
               with_args: bool) -> tuple:
    S1, SW = -(-(T + HJ) // 2) * 2, -(-T // 2) * 2
    planes = L + P + (P if with_args else 0)        # weights, mask, args
    return S1, SW, 4 * (tab + P * (T + HI) * S1 + planes * T * SW)


def tile_plan_at(P: int, moves, with_args: bool, T: int) -> TilePlan:
    """The antidiag plan at tile side ``T``: the halo the moves reach (at
    most :data:`HALO`), the row strides, a thread for each (plane, row)
    pair in whole warps, and the shared memory it takes."""
    L = len(moves)
    HI = min(max(int(m[2]) for m in moves), HALO)
    HJ = min(max(int(m[3]) for m in moves), HALO)
    tab = -(-(P + 1 + 4 * L) // 4) * 4
    S1, SW, smem = _tile_smem(T, HI, HJ, tab, P, L, with_args)
    return TilePlan(T, HI, HJ, S1, SW, tab, -(-P * T // 32) * 32, smem)


def tile_plan(P: int, moves, with_args: bool):
    """The largest tile of :data:`TILE_SIDES` with a thread for each of its
    ``P·T`` (plane, row) pairs in one CTA whose staged planes (table with
    halo, weights, mask and, with args, the arg tile) and move table fit
    the shared memory a block can use; None if not even a 1 × 1 tile
    does."""
    for T in (t for t in TILE_SIDES if P * t <= 1024):
        plan = tile_plan_at(P, moves, with_args, T)
        if plan.smem <= _build.SMEM_OPTIN_BYTES - _STATIC_SMEM:
            return plan
    return None


_BLOCKS_PER_SM: dict = {}


def antidiag_blocks_per_sm(op: str, with_args: bool, plan: TilePlan, device) -> int:
    """CTAs of the antidiag variant one SM of ``device`` keeps resident at
    ``plan``'s threads and shared memory (the occupancy API, asked once per
    shape)."""
    dev = torch.device(device)
    key = (dev.index, op, with_args, plan.threads, plan.smem)
    if key not in _BLOCKS_PER_SM:
        fn = _build.load("grid_pipeline").grid_antidiag_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            _BLOCKS_PER_SM[key] = fn(int(op == "min"), int(with_args), plan.threads,
                                     plan.smem)
    return _BLOCKS_PER_SM[key]


def antidiag_ctas(op: str, with_args: bool, plan: TilePlan, tiles: int, device) -> int:
    """The antidiag grid on ``device``: every CTA the SMs keep resident
    (:func:`antidiag_blocks_per_sm`), at most one per tile. Raises if an SM
    keeps none."""
    dev = torch.device(device)
    per_sm = antidiag_blocks_per_sm(op, with_args, plan, dev)
    if per_sm < 1:
        raise RuntimeError(f"grid_pipeline_antidiag: the card keeps no CTA of "
                           f"{plan.threads} threads and {plan.smem} bytes of shared "
                           "memory resident")
    return min(tiles, per_sm * torch.cuda.get_device_properties(dev).multi_processor_count)


def spandiag_smem_bytes(P: int, NR: int) -> int:
    """Dynamic shared memory of one spandiag CTA: the rule table (index,
    left and right plane, padded to 16 bytes a rule), the plane starts,
    the targeted planes and the merge slots
    (``csrc/grid_pipeline.cu::grid_spandiag_smem_bytes``)."""
    return 16 * NR + 4 * (2 * P + 1) + 8 * SD_WARPS


def spandiag_warps(cand: int, triples: int, ctas: int) -> int:
    """Warps folding one (instance, plane, cell) triple of a span diagonal
    whose triples hold at most ``cand`` candidates (splits × rules into the
    plane), ``triples`` of them over ``ctas`` CTAs: the least power of two
    whose lanes cover the candidates, at most :data:`SD_WARPS`, halved
    while the triples would not each get a group. The kernel computes the
    same (``csrc/grid_pipeline.cu::spandiag_warps``)."""
    g = 1
    while g < SD_WARPS and 32 * g < cand:
        g *= 2
    while g > 1 and triples * g > ctas * SD_WARPS:
        g //= 2
    return g


def spandiag_blocks_per_sm(op: str, with_args: bool, P: int, NR: int, device) -> int:
    """CTAs of the spandiag variant one SM of ``device`` keeps resident
    (the occupancy API, asked once per variant and shared memory)."""
    dev = torch.device(device)
    smem = spandiag_smem_bytes(P, NR)
    key = (dev.index, "spandiag", op, with_args, smem)
    if key not in _BLOCKS_PER_SM:
        fn = _build.load("grid_pipeline").grid_spandiag_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            _BLOCKS_PER_SM[key] = fn(int(op == "min"), int(with_args), smem)
    return _BLOCKS_PER_SM[key]


def spandiag_ctas(op: str, with_args: bool, P: int, NR: int, device) -> int:
    """The spandiag grid on ``device``: :data:`SD_CTAS_PER_SM` CTAs on every
    SM, fewer if the occupancy API says an SM keeps fewer resident. Raises
    if it keeps none."""
    dev = torch.device(device)
    smem = spandiag_smem_bytes(P, NR)
    per_sm = spandiag_blocks_per_sm(op, with_args, P, NR, dev)
    if per_sm < 1:
        raise RuntimeError(f"grid_pipeline_spandiag: the card keeps no CTA of "
                           f"{SD_THREADS} threads and {smem} bytes of shared "
                           "memory resident")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * min(per_sm, SD_CTAS_PER_SM)


# ---------------------------------------------------------------------------
# antidiag geometry: the frontier-major layout (the plain version's)
# ---------------------------------------------------------------------------
def front_base(t, R: int, C: int):
    """Frontier-major offset of front ``t``'s first cell: fronts grow by one
    lane up to ``min(R, C)``, hold that width up to ``max(R, C)``, then
    shrink. ``t`` is an int or an integer tensor."""
    m, M = min(R, C), max(R, C)
    grow = t * (t + 1) // 2
    band = m * (m + 1) // 2 + (t - m) * m
    u = t - M
    shrink = m * (m + 1) // 2 + (M - m) * m + u * m - u * (u + 1) // 2
    if isinstance(t, torch.Tensor):
        return torch.where(t <= m, grow, torch.where(t <= M, band, shrink))
    return grow if t <= m else band if t <= M else shrink


def front_positions(R: int, C: int, device) -> torch.Tensor:
    """Frontier-major position of every row-major cell, ``(R·C,)`` int64."""
    i = torch.arange(R, device=device)[:, None]
    j = torch.arange(C, device=device)[None, :]
    t = i + j
    return (front_base(t, R, C) + j - (t - (R - 1)).clamp(min=0)).reshape(-1)


def to_frontier(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``(..., R, C)`` row-major → ``(..., R·C)`` frontier-major."""
    flat = x.reshape(*x.shape[:-2], -1)
    out = torch.empty_like(flat)
    out[..., pos] = flat
    return out


def _ranks(items, planes: int, dev):
    """The fold's schedule, as device tensors (indexing a CUDA tensor with
    a Python list copies the list to the card each time): the targeted
    planes ``live``, each one's first move / rule (``(P', 1)`` int32), and
    per rank k the positions ``q`` in ``live`` of the planes that have a
    k-th item with that item's index and fields as ``(Q, 1)`` columns."""
    by_plane = plane_lists(items, planes)
    live = [p for p in range(planes) if by_plane[p]]
    first = torch.tensor([by_plane[p][0] for p in live], dtype=torch.int32,
                         device=dev)[:, None]
    ranks = []
    for k in range(max(len(lst) for lst in by_plane)):
        q = [m for m, p in enumerate(live) if len(by_plane[p]) > k]
        rk = torch.tensor([[by_plane[live[m]][k], *items[by_plane[live[m]][k]][1:]]
                           for m in q], device=dev)
        ranks.append((torch.tensor(q, device=dev),
                      *(rk[:, c:c + 1] for c in range(rk.shape[1]))))
    return torch.tensor(live, device=dev), first, ranks


def _antidiag_plain(arrs, meta, with_args: bool):
    _, op, P, R, C, moves, _ = meta
    squeeze, (w, init, pmask) = batched(arrs, meta)
    dev, dt, B = w.device, w.dtype, w.shape[0]
    zero = semiring_zero(op)
    pos = front_positions(R, C, dev)
    w_ad, init_ad, pm_ad = (to_frontier(a, pos) for a in (w, init, pmask))
    st = torch.empty((B, P, R * C), dtype=dt, device=dev)
    ar = torch.empty((B, P, R * C), dtype=torch.int32, device=dev)
    live, first, ranks = _ranks(moves, P, dev)
    better = torch.lt if op == "min" else torch.gt
    for t in range(R + C - 1):
        c0, c1 = max(0, t - R + 1), min(t, C - 1)
        base = front_base(t, R, C)
        front = slice(base, base + c1 - c0 + 1)
        preset = pm_ad[:, :, front] > 0
        s0 = torch.where(preset, init_ad[:, :, front], zero)
        st[:, :, front] = s0
        ar[:, :, front] = -1
        if t == 0:
            continue
        j = torch.arange(c0, c1 + 1, device=dev)
        i = t - j
        lanes = torch.arange(base, base + c1 - c0 + 1, device=dev)
        acc = torch.full((B, len(live), c1 - c0 + 1), zero, dtype=dt, device=dev)
        arg = first.expand(B, -1, c1 - c0 + 1).clone()
        for q, l, pf, di, dj in ranks:
            ok = (i >= di) & (j >= dj)                           # (Q, lanes)
            ts = t - di - dj
            src = front_base(ts, R, C) + (j - dj) - (ts - (R - 1)).clamp(min=0)
            src = torch.where(ok, src, 0)
            val = st[:, pf, src] + w_ad[:, l, lanes]             # (B, Q, lanes)
            improve = ok & better(val, acc[:, q])
            acc[:, q] = torch.where(improve, val, acc[:, q])
            arg[:, q] = torch.where(improve, l.to(torch.int32), arg[:, q])
        hold = preset[:, live]
        st[:, live, front] = torch.where(hold, s0[:, live], acc)
        ar[:, live, front] = torch.where(hold, -1, arg)
    return unbatched(squeeze, st[..., pos].reshape(B, -1),
                      ar[..., pos].reshape(B, -1), with_args)


def _spandiag_plain(arrs, meta, with_args: bool):
    _, op, P, n, _, _, rules = meta
    squeeze, (rw, init) = batched(arrs, meta)
    dev, dt, B, NR = rw.device, rw.dtype, rw.shape[0], len(rules)
    zero = semiring_zero(op)
    cells = num_cells(n)
    st = torch.full((B, P, cells), zero, dtype=dt, device=dev)
    st[:, :, :n] = init
    ar = torch.full((B, P, cells), -1, dtype=torch.int32, device=dev)
    live, first, ranks = _ranks(rules, P, dev)
    better = torch.lt if op == "min" else torch.gt
    for d in range(1, n):
        lanes, off_d = n - d, lin_index(0, d, n)
        i = torch.arange(lanes, device=dev)[:, None]              # (lanes, 1)
        e = torch.arange(d, device=dev)[None, :]                  # (1, d)
        li, ri = lin_index(i, e, n), lin_index(i + e + 1, d - e - 1, n)
        # the kernel's fold over (split e, rule r), e-major: first over the
        # rules of every split at once, then over the splits ascending —
        # strict improve at both levels keeps the same first best
        acc_e = torch.full((B, len(live), lanes, d), zero, dtype=dt, device=dev)
        arg_e = torch.zeros((B, len(live), lanes, d), dtype=torch.int32, device=dev)
        for q, r, rb, rc in ranks:
            r, rb, rc = r[:, 0], rb[..., None], rc[..., None]      # (Q,), (Q, 1, 1)
            val = (st[:, rb, li] + st[:, rc, ri]) + rw[:, r][:, :, None, None]
            improve = better(val, acc_e[:, q])
            acc_e[:, q] = torch.where(improve, val, acc_e[:, q])
            packed = (e * NR + r[:, None, None]).to(torch.int32)
            arg_e[:, q] = torch.where(improve, packed, arg_e[:, q])
        acc = torch.full((B, len(live), lanes), zero, dtype=dt, device=dev)
        arg = first.expand(B, -1, lanes).clone()
        for s in range(d):
            improve = better(acc_e[..., s], acc)
            acc = torch.where(improve, acc_e[..., s], acc)
            arg = torch.where(improve, arg_e[..., s], arg)
        st[:, live, off_d:off_d + lanes] = acc
        ar[:, live, off_d:off_d + lanes] = arg
    return unbatched(squeeze, st.reshape(B, -1), ar.reshape(B, -1), with_args)


def grid_pipeline_plain(arrs, meta: tuple, with_args: bool = False):
    """The kernel's computation in PyTorch: the same layout, step order,
    association and strict-improve folds. Returns ``st`` or ``(st, args)``,
    flat per instance."""
    if meta[0] == "antidiag":
        return _antidiag_plain(arrs, meta, with_args)
    return _spandiag_plain(arrs, meta, with_args)


# ---------------------------------------------------------------------------
# The CUDA launch
# ---------------------------------------------------------------------------
def _plane_table(items, planes: int, fields) -> list:
    """int32 payload of the kernel's per-plane lists: ``planes + 1`` start
    offsets, the item indices grouped by target plane in declaration
    order, then each of ``fields`` (columns of the items) in that order."""
    by_plane = plane_lists(items, planes)
    order = [k for lst in by_plane for k in lst]
    starts = [0]
    for lst in by_plane:
        starts.append(starts[-1] + len(lst))
    return starts + order + [int(items[k][f]) for f in fields for k in order]


@functools.lru_cache(maxsize=64)
def _table_on(items: tuple, planes: int, fields: tuple, device) -> torch.Tensor:
    """:func:`_plane_table` as int32 on ``device``, built once per move or
    rule set (a 1024-rule table takes milliseconds of Python to build)."""
    return torch.tensor(_plane_table(items, planes, fields), dtype=torch.int32,
                        device=device)


def _check(name: str, tensors: dict, shapes: dict) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be float32 {shapes[key]}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _launch(fn_name: str, name: str, pointers: list, ints: list) -> None:
    """Call launcher ``fn_name``: device pointers, int arguments, then the
    current stream."""
    lib = _build.load("grid_pipeline")
    fn = getattr(lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(torch.cuda.current_device()).cuda_stream
    _build.check(fn(*pointers, *ints, stream), name)
    _build.count(LAUNCHES, name)


def _launch_antidiag(arrs, meta, with_args: bool, grid=None):
    """The tile wavefront on CUDA tensors; ``grid`` overrides
    :func:`antidiag_ctas` (a grid the card cannot keep resident raises)."""
    name = "grid_pipeline_antidiag" + ("_with_args" if with_args else "")
    _, op, P, R, C, moves, _ = meta
    squeeze, (w, init, pmask) = batched(arrs, meta)
    B, L, dev = w.shape[0], len(moves), w.device
    _check(name, {"weights": w, "init": init, "init_mask": pmask},
           {"weights": (B, L, R, C), "init": (B, P, R, C),
            "init_mask": (B, P, R, C)})
    if P * R * C >= 2 ** 31:
        raise ValueError(f"{name}: {P}·{R}·{C} cells exceed int32 indices")
    plan = tile_plan(P, moves, with_args)
    if plan is None:
        raise ValueError(f"{name}: {L} moves exceed shared memory")
    tiles = B * -(-R // plan.T) * -(-C // plan.T)
    if tiles >= 2 ** 31:
        raise ValueError(f"{name}: {tiles} tiles exceed int32 tickets")
    G = antidiag_ctas(op, with_args, plan, tiles, dev) if grid is None else grid
    mtab = _table_on(moves, P, (1, 2, 3), dev)
    st = torch.empty((B, P, R * C), dtype=torch.float32, device=dev)
    ar = torch.empty((B, P, R * C), dtype=torch.int32, device=dev) if with_args else None
    sync = torch.zeros(1 + tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("grid_antidiag_launch", name,
                [w.data_ptr(), init.data_ptr(), pmask.data_ptr(), mtab.data_ptr(),
                 st.data_ptr(), None if ar is None else ar.data_ptr(), sync.data_ptr()],
                [B, P, R, C, L, int(op == "min"), plan.T, plan.HI, plan.HJ, plan.S1,
                 plan.SW, plan.tab, plan.threads, G, plan.smem])
    _build.record(GEOMETRY, name, (op, P, moves, R, C, B), G=G, tiles=tiles,
                  **dataclasses.asdict(plan))
    return unbatched(squeeze, st.reshape(B, -1),
                     None if ar is None else ar.reshape(B, -1), with_args)


def _launch_spandiag(arrs, meta, with_args: bool, grid=None):
    """The chart on CUDA tensors; ``grid`` overrides :func:`spandiag_ctas`
    (a grid the card cannot keep resident raises)."""
    name = "grid_pipeline_spandiag" + ("_with_args" if with_args else "")
    _, op, P, n, _, _, rules = meta
    squeeze, (rw, init) = batched(arrs, meta)
    B, NR, dev = rw.shape[0], len(rules), rw.device
    _check(name, {"rule_weights": rw, "init": init},
           {"rule_weights": (B, NR), "init": (B, P, n)})
    cells = num_cells(n)
    if P * cells >= 2 ** 31 or n * NR >= 2 ** 31:
        raise ValueError(f"{name}: {P} planes × {cells} cells or {n}·{NR} "
                         "packed args exceed int32")
    if spandiag_smem_bytes(P, NR) > _build.SMEM_OPTIN_BYTES - _STATIC_SMEM:
        raise ValueError(f"{name}: {NR} rules exceed shared memory")
    G = spandiag_ctas(op, with_args, P, NR, dev) if grid is None else grid
    rtab = _table_on(rules, P, (1, 2), dev)
    st = torch.empty((B, P * cells), dtype=torch.float32, device=dev)
    ar = torch.empty((B, P * cells), dtype=torch.int32, device=dev) if with_args else None
    cm = torch.empty((B, cells, P), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("grid_spandiag_launch", name,
                [rw.data_ptr(), init.data_ptr(), rtab.data_ptr(), st.data_ptr(),
                 None if ar is None else ar.data_ptr(), cm.data_ptr(), bar.data_ptr()],
                [B, P, n, NR, int(op == "min"), G])
    _build.record(GEOMETRY, name, (op, P, n, NR), G=G, smem=spandiag_smem_bytes(P, NR))
    return unbatched(squeeze, st, ar, with_args)


def _run(arrs, meta, with_args: bool):
    if arrs[0].is_cuda:
        launch = _launch_antidiag if meta[0] == "antidiag" else _launch_spandiag
        return launch(arrs, meta, with_args)
    return grid_pipeline_plain(arrs, meta, with_args)


def grid_pipeline(arrs, meta: tuple):
    """Flat grid table: the CUDA kernel for CUDA tensors, the plain version
    for CPU ones."""
    return _run(arrs, meta, with_args=False)


def grid_pipeline_with_args(arrs, meta: tuple):
    """``grid_pipeline`` + the winning move / packed-split table (-1 on
    preset cells). Returns ``(st, args)``."""
    return _run(arrs, meta, with_args=True)
