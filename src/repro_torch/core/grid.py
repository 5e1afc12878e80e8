"""Grid-family wavefront solvers (``GridSpec``).

Two frontier schedules fill a multi-plane grid table:

  * ``antidiag`` — cells on one anti-diagonal ``i + j = t`` are mutually
    independent because every shift move steps strictly forward
    (``di + dj ≥ 1``), so the table fills in ``rows + cols - 1`` fronts.
  * ``spandiag`` — the triangular split recurrence with a plane axis: the
    span diagonals of a parse chart, one per step, with binary rules
    ``(A → B C, rw)`` instead of a per-cell split weight.

The tensor solvers take the spec's ``device_arrays()`` slots, each either
per instance or with a leading batch axis, and run on their device. Each
front gathers every candidate of every plane at once (moves padded per
plane with a never-winning filler) and reduces them with ``argmin`` /
``argmax``, whose first-occurrence rule is the declaration-order tie rule
of the kernel's strict-improve folds; the winner's value is gathered from
its index. The arg-emitting variants store the winning move index
(antidiag) or the packed split ``e·len(rules) + r`` (spandiag), -1 on
preset cells.

``grid_reference``, ``grid_args_np`` and ``grid_traceback_np`` are plain
numpy loops: the float64 oracle, the host args fallback and the host walk.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dp.problem import GridPath, GridSpec, lin_index, num_cells


def semiring_zero(op: str) -> float:
    """The identity of the combine: +inf for min, -inf for max."""
    return float("inf") if op == "min" else float("-inf")


def plane_lists(items, planes: int) -> list:
    """Indices of the moves / rules into each plane, in declaration order."""
    return [[k for k, it in enumerate(items) if int(it[0]) == p]
            for p in range(planes)]


def batched(arrs, meta):
    """``(squeeze, arrs)`` with a leading batch axis on every slot; slot 0
    (weights, or rule weights) tells a single instance by its rank."""
    squeeze = arrs[0].dim() == (3 if meta[0] == "antidiag" else 1)
    return squeeze, tuple(a[None] for a in arrs) if squeeze else tuple(arrs)


def unbatched(squeeze: bool, st, ar, with_args: bool):
    """The solvers' return value: ``st`` or ``(st, ar)``, batch axis dropped
    again for a single instance."""
    if squeeze:
        st = st[0]
        ar = None if ar is None else ar[0]
    return (st, ar) if with_args else st


def _padded(lists, filler: int):
    """(targeted planes, (planes', width) index table): each targeted
    plane's list right-padded with ``filler``."""
    live = [p for p, lst in enumerate(lists) if lst]
    width = max(len(lists[p]) for p in live)
    table = [lists[p] + [filler] * (width - len(lists[p])) for p in live]
    return live, table


def _reduce(cand: torch.Tensor, op: str, dim: int):
    """(best, first index of best) along ``dim``; the value is gathered from
    the index, so ties keep the first candidate's bits."""
    idx = cand.argmin(dim) if op == "min" else cand.argmax(dim)
    return cand.gather(dim, idx.unsqueeze(dim)).squeeze(dim), idx


def _antidiag(arrs, meta, with_args: bool):
    _, op, P, R, C, moves, _ = meta
    squeeze, (w, init, pmask) = batched(arrs, meta)
    dev, dt, B, RC, L = w.device, w.dtype, w.shape[0], R * C, len(moves)
    zero = semiring_zero(op)
    preset = pmask.reshape(B, P, RC) > 0
    st = torch.where(preset, init.reshape(B, P, RC), zero)
    ar = torch.full((B, P, RC), -1, dtype=torch.int32, device=dev)
    # the filler "move" L reads a weight row of the semiring zero and is
    # masked out, so it never wins (it sits after every real move)
    wf = torch.cat([w.reshape(B, L, RC),
                    torch.full((B, 1, RC), zero, dtype=dt, device=dev)], 1)
    live, table = _padded(plane_lists(moves, P), L)
    mid = torch.tensor(table, device=dev)                       # (P', M)
    mv = torch.tensor([list(m) for m in moves] + [[0, 0, 0, 0]], device=dev)
    pf, di, dj = (mv[mid, k][..., None] for k in (1, 2, 3))     # (P', M, 1)
    real = (mid < L)[..., None]
    pl = torch.tensor(live, device=dev)
    for t in range(1, R + C - 1):
        j = torch.arange(max(0, t - R + 1), min(t, C - 1) + 1, device=dev)
        i = t - j
        cell = i * C + j                                        # (lanes,)
        si, sj = i - di, j - dj                                 # (P', M, lanes)
        ok = real & (si >= 0) & (sj >= 0)
        src = (si * C + sj).clamp(0, RC - 1)
        cand = st[:, pf, src] + wf[:, mid[..., None], cell]     # (B, P', M, lanes)
        cand = torch.where(ok, cand, zero)
        best, k = _reduce(cand, op, 2)                          # (B, P', lanes)
        hold = preset[:, pl[:, None], cell]
        st[:, pl[:, None], cell] = torch.where(hold, st[:, pl[:, None], cell], best)
        if with_args:
            arg = mid[torch.arange(len(live), device=dev)[:, None], k].to(torch.int32)
            ar[:, pl[:, None], cell] = torch.where(hold, -1, arg)
    return unbatched(squeeze, st.reshape(B, -1), ar.reshape(B, -1), with_args)


def _spandiag_fill(st, rw, meta, ar=None, n_old: int = 1):
    """Fill the span diagonals of ``(batch, planes, cells)`` charts in
    place: rows ``i ≥ max(0, n_old - d)`` of each diagonal ``d`` (every row
    for a cold solve, ``n_old = 1``; the trailing rows of a warm
    extension). Each cell folds the same candidates in the same order
    either way; ``ar`` (when given) receives the packed args."""
    _, op, P, n, _, _, rules = meta
    B, dt, dev, NR = rw.shape[0], rw.dtype, rw.device, len(rules)
    zero = semiring_zero(op)
    # filler rule NR: planes (0, 0) and weight zero, masked out; it sits
    # after every real rule of its split, so it never wins a tie
    rwf = torch.cat([rw, torch.full((B, 1), zero, dtype=dt, device=dev)], 1)
    live, table = _padded(plane_lists(rules, P), NR)
    rid = torch.tensor(table, device=dev)                       # (P', K)
    rl = torch.tensor([list(r) for r in rules] + [[0, 0, 0]], device=dev)
    rb, rc = rl[rid, 1], rl[rid, 2]
    real = rid < NR
    pl = torch.tensor(live, device=dev)
    for d in range(1, n):
        i = torch.arange(max(0, n_old - d), n - d, device=dev)[:, None, None]
        e = torch.arange(d, device=dev)[None, :, None]          # (1, d, 1)
        left = st[:, rb[:, None, None], lin_index(i, e, n)]     # (B, P', lanes, d, K)
        right = st[:, rc[:, None, None], lin_index(i + e + 1, d - e - 1, n)]
        cand = (left + right) + rwf[:, rid][:, :, None, None]
        cand = torch.where(real[:, None, None], cand, zero)
        best, k = _reduce(cand.flatten(3), op, 3)               # split-major
        row = lin_index(i[:, 0, 0], d, n)
        st[:, pl[:, None], row] = best
        if ar is not None:
            ee, kk = k // rid.shape[1], k % rid.shape[1]
            r = rid[torch.arange(len(live), device=dev)[:, None], kk]
            ar[:, pl[:, None], row] = (ee * NR + r).to(torch.int32)


def _spandiag(arrs, meta, with_args: bool):
    _, op, P, n, _, _, _ = meta
    squeeze, (rw, init) = batched(arrs, meta)
    dev, dt, B = rw.device, rw.dtype, rw.shape[0]
    cells = num_cells(n)
    st = torch.full((B, P, cells), semiring_zero(op), dtype=dt, device=dev)
    st[:, :, :n] = init
    ar = torch.full((B, P, cells), -1, dtype=torch.int32, device=dev)
    _spandiag_fill(st, rw, meta, ar if with_args else None)
    return unbatched(squeeze, st.reshape(B, -1), ar.reshape(B, -1), with_args)


def solve_grid(arrs: tuple, meta: tuple) -> torch.Tensor:
    """Flat ``(planes·cells,)`` table (or ``(batch, planes·cells)``) of a
    grid instance — ``arrs`` the spec's ``device_arrays()`` slots as
    tensors, ``meta`` its ``static_meta()``."""
    if meta[0] == "antidiag":
        return _antidiag(arrs, meta, with_args=False)
    return _spandiag(arrs, meta, with_args=False)


def solve_grid_with_args(arrs: tuple, meta: tuple):
    """``solve_grid`` + the winning-argument table: move index (antidiag)
    or packed split ``e·len(rules) + r`` (spandiag), -1 on preset cells.
    Returns ``(st, args)``."""
    if meta[0] == "antidiag":
        return _antidiag(arrs, meta, with_args=True)
    return _spandiag(arrs, meta, with_args=True)


# ---------------------------------------------------------------------------
# Warm-start extension.
#
# antidiag (column append): a new-column cell reaches back at most
# W = frontier_cols() columns (max dj over the moves), so the extension is
# the cold solver run on a rows × (W + k) sub-grid whose first W columns
# are preset to the saved frontier and whose appended columns carry their
# own weight/init/mask slices: every move source is in range and every
# cell folds the same candidates, so the new columns equal the cold solve's.
#
# spandiag (leaf append): the split recurrence keeps the whole prefix chart
# live; the prefix is re-embedded on the host and the cold fill recomputes
# only the trailing rows of each span diagonal.
# ---------------------------------------------------------------------------
def extend_antidiag_arrays(spec: GridSpec, c_old: int, suffix: np.ndarray):
    """``(arrs, meta)`` of the extension sub-grid of the EXTENDED ``spec``;
    ``suffix`` is the saved ``(planes, rows, W)`` frontier."""
    W = spec.frontier_cols()
    k = spec.cols - c_old
    P, R = spec.planes, spec.rows
    init_sub = np.empty((P, R, W + k), np.float32)
    init_sub[:, :, :W] = np.asarray(suffix)
    init_sub[:, :, W:] = spec.init[:, :, c_old:]
    mask_sub = np.ones((P, R, W + k), np.float32)
    mask_sub[:, :, W:] = spec.init_mask[:, :, c_old:]
    arrs = (np.asarray(spec.weights[:, :, c_old - W:], np.float32),
            init_sub, mask_sub)
    meta = ("antidiag", spec.op, P, R, W + k, spec.shape_key()[6], ())
    return arrs, meta


def embed_spandiag_prefix(spec: GridSpec, n_old: int,
                          suffix: np.ndarray) -> np.ndarray:
    """Full-width ``(planes, cells)`` start chart: the prefix chart
    embedded, every diagonal-0 cell preset from ``init``, the semiring zero
    on the extension cells — the cold fill's state once it has finished
    the prefix region."""
    P, n = spec.planes, spec.rows
    old = np.asarray(suffix).reshape(P, num_cells(n_old))
    out = np.full((P, num_cells(n)), semiring_zero(spec.op), old.dtype)
    out[:, :n] = np.asarray(spec.init, old.dtype)
    for d in range(1, n_old):
        src, dst = lin_index(0, d, n_old), lin_index(0, d, n)
        out[:, dst:dst + (n_old - d)] = old[:, src:src + (n_old - d)]
    return out


def extend_grid_spandiag(st0: torch.Tensor, rw: torch.Tensor, meta: tuple,
                         n_old: int) -> torch.Tensor:
    """Windowed spandiag extension: ``st0`` the ``(planes, cells)``
    embedded prefix (:func:`embed_spandiag_prefix`), ``rw`` the rule
    weights. Returns the full flat table."""
    st = st0.clone()[None]
    _spandiag_fill(st, rw[None], meta, n_old=n_old)
    return st.reshape(-1)


def _run_extend(spec: GridSpec, old_len: int, state: dict, device) -> np.ndarray:
    """``Backend.run_extend`` for the grid_wavefront route on ``device``:
    the ``(planes, rows, k)`` new columns (antidiag) or the full flat chart
    (spandiag)."""
    old_len = int(old_len)
    if spec.schedule == "antidiag":
        arrs, meta = extend_antidiag_arrays(spec, old_len, state["suffix"])
        sub = solve_grid(tuple(torch.as_tensor(a, device=device) for a in arrs),
                         meta).cpu().numpy()
        return sub.reshape(spec.planes, spec.rows, -1)[:, :, spec.frontier_cols():]
    st0 = embed_spandiag_prefix(spec, old_len,
                                np.asarray(state["suffix"], np.float32))
    rw = torch.as_tensor(np.asarray(spec.rule_weights, np.float32), device=device)
    return extend_grid_spandiag(torch.as_tensor(st0, device=device), rw,
                                spec.static_meta(), old_len).cpu().numpy()


# ---------------------------------------------------------------------------
# Traceback on the device, every instance of a bucket in step
# ---------------------------------------------------------------------------
def grid_traceback(args: torch.Tensor, start: torch.Tensor, meta: tuple):
    """Walk ``(batch, planes·cells)`` arg tables from packed cells
    ``start`` (``(batch,)``) on their device.

    antidiag — the move walk. A cell with arg ``a ≥ 0`` steps to the
    source of move ``a``, a preset cell ends the walk; ``i + j`` falls at
    every step, so the walk is a chain that
    :func:`repro_torch.core.sdp.path_walk` lays out in log depth. Returns
    ``(cells, moves, count)``: the ``(batch, L)`` cells in walk order,
    their moves, and each walk's count of nodes (``cells[b, count[b]]`` is
    the preset cell it ends in). Only these leave the device.

    spandiag — the rule tree in preorder
    (:func:`repro_torch.core.mcm.tree_preorder`, a child's plane from its
    rule). Returns ``(pp, aa, bb, vv)``, each ``(batch, n-1)``: node t is
    ``(plane, i, d, packed)``."""
    from repro_torch.core.mcm import span_coords, split_kids, tree_preorder
    from repro_torch.core.sdp import path_walk

    schedule, _, P, R, C, moves, rules = meta
    B, dev = args.shape[0], args.device
    start = start.to(torch.int64)
    if schedule == "antidiag":
        # int32 arithmetic (planes·cells < 2³¹): the tables are grid-sized
        RC = R * C
        mv = torch.tensor([list(m) for m in moves], dtype=torch.int32, device=dev)
        cell = torch.arange(P * RC, dtype=torch.int32, device=dev)
        a = args.to(torch.int32).clamp(0, len(moves) - 1)
        si = (cell % RC) // C - mv[:, 2][a]
        sj = cell % C - mv[:, 3][a]
        ok = (args >= 0) & (si >= 0) & (sj >= 0)
        nxt = torch.where(ok, mv[:, 1][a] * RC + si * C + sj, cell)
        del a, si, sj
        cells, count = path_walk(nxt, start, ok, R + C)
        return cells, args.gather(1, cells.to(torch.int64)), count
    n, NR = R, len(rules)
    if n < 2:
        empty = torch.zeros((B, 0), dtype=torch.int64, device=dev)
        return empty, empty, empty, empty
    cells = num_cells(n)
    rl, rr = torch.as_tensor(np.asarray(rules, np.int64).reshape(-1, 3)[:, 1:].T.copy(),
                             device=dev)
    i, d = span_coords(n, dev)
    a = args.to(torch.int64).clamp(min=0).view(B, P, cells)
    e = torch.minimum(a // NR, (d - 1).clamp(min=0))
    kids = split_kids(i, d, e, rl[a % NR], rr[a % NR], n, P * cells)
    root = start // cells * cells + lin_index(0, n - 1, n)
    node = tree_preorder(kids, root, n, (i, d))
    c = node % cells
    return node // cells, i[c], d[c], args.to(torch.int64).gather(1, node)


# ---------------------------------------------------------------------------
# Plain numpy loops: the float64 oracle, the host args fallback, the walk
# ---------------------------------------------------------------------------
def grid_reference(spec: GridSpec) -> np.ndarray:
    """Reference solve in float64 Python loops — the family's independent
    cross-check."""
    zero = semiring_zero(spec.op)
    better = (lambda a, b: a < b) if spec.op == "min" else (lambda a, b: a > b)
    P = spec.planes
    if spec.schedule == "antidiag":
        R, C = spec.rows, spec.cols
        tab = np.full((P, R, C), zero)
        for t in range(R + C - 1):
            for j in range(max(0, t - R + 1), min(t, C - 1) + 1):
                i = t - j
                for p in range(P):
                    if spec.init_mask[p, i, j]:
                        tab[p, i, j] = spec.init[p, i, j]
                        continue
                    best = zero
                    for l, (p_to, p_from, di, dj) in enumerate(spec.moves):
                        if p_to != p or i - di < 0 or j - dj < 0:
                            continue
                        v = tab[p_from, i - di, j - dj] + spec.weights[l, i, j]
                        if better(v, best):
                            best = v
                    tab[p, i, j] = best
        return tab.reshape(-1)
    n = spec.rows
    tab = np.full((P, num_cells(n)), zero)
    tab[:, :n] = spec.init
    for d in range(1, n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            for r, (A, B, Cc) in enumerate(spec.rules):
                for e in range(d):
                    v = (tab[B, lin_index(i, e, n)]
                         + tab[Cc, lin_index(i + e + 1, d - e - 1, n)]
                         + spec.rule_weights[r])
                    if better(v, tab[A, c]):
                        tab[A, c] = v
    return tab.reshape(-1)


def grid_args_np(table: np.ndarray, spec: GridSpec) -> np.ndarray:
    """Winning-argument table re-ranked from a finished cost table, with
    the solvers' first-occurrence tie order and float32 arithmetic, so
    near-ties rank identically."""
    zero = np.float32(semiring_zero(spec.op))
    better = (lambda a, b: a < b) if spec.op == "min" else (lambda a, b: a > b)
    P = spec.planes
    table = np.asarray(table, dtype=np.float32)
    if spec.schedule == "antidiag":
        R, C = spec.rows, spec.cols
        tab = table.reshape(P, R, C)
        wts = np.asarray(spec.weights, dtype=np.float32)
        args = np.full((P, R, C), -1, np.int32)
        for p in range(P):
            for i in range(R):
                for j in range(C):
                    if spec.init_mask[p, i, j]:
                        continue
                    best, sel = zero, -1
                    for l, (p_to, p_from, di, dj) in enumerate(spec.moves):
                        if p_to != p or i - di < 0 or j - dj < 0:
                            continue
                        v = tab[p_from, i - di, j - dj] + wts[l, i, j]
                        if sel < 0 or better(v, best):
                            best, sel = v, l
                    args[p, i, j] = sel
        return args.reshape(-1)
    n = spec.rows
    cells = num_cells(n)
    tab = table.reshape(P, cells)
    rw = np.asarray(spec.rule_weights, dtype=np.float32)
    args = np.full((P, cells), -1, np.int32)
    NR = len(spec.rules)
    for d in range(1, n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            for A in range(P):
                best, sel = zero, -1
                for e in range(d):
                    for r, (rA, B, Cc) in enumerate(spec.rules):
                        if rA != A:
                            continue
                        v = (tab[B, lin_index(i, e, n)]
                             + tab[Cc, lin_index(i + e + 1, d - e - 1, n)]
                             + rw[r])
                        if sel < 0 or better(v, best):
                            best, sel = v, e * NR + r
                args[A, c] = sel
    return args.reshape(-1)


def grid_traceback_np(args: np.ndarray, spec: GridSpec,
                      start: int) -> GridPath:
    """Host walk: the move walk from ``start`` to the first preset cell
    (antidiag), or the rule tree in preorder from root cell ``start``
    (spandiag)."""
    P = spec.planes
    if spec.schedule == "antidiag":
        R, C = spec.rows, spec.cols
        RC = R * C
        p, i, j = start // RC, (start % RC) // C, start % C
        nodes = []
        while True:
            a = int(args[p * RC + i * C + j])
            if a < 0:
                break
            nodes.append((p, i, j, a))
            _, p_from, di, dj = spec.moves[a]
            p, i, j = p_from, i - di, j - dj
        return GridPath(nodes=np.asarray(nodes, np.int64).reshape(-1, 4),
                        stop=p * RC + i * C + j)
    n = spec.rows
    cells = num_cells(n)
    NR = len(spec.rules)
    nodes = []
    stack = [(start // cells, 0, n - 1)] if n >= 2 else []
    while stack:
        p, i, d = stack.pop()
        a = int(args[p * cells + lin_index(i, d, n)])
        nodes.append((p, i, d, a))
        e, r = max(a, 0) // NR, max(a, 0) % NR
        _, B, Cc = spec.rules[r]
        if d - e - 1 >= 1:
            stack.append((Cc, i + e + 1, d - e - 1))
        if e >= 1:
            stack.append((B, i, e))
    return GridPath(nodes=np.asarray(nodes, np.int64).reshape(-1, 4), stop=-1)


# ---------------------------------------------------------------------------
# Backend registration (repro_torch.dp): the grid route.
# ---------------------------------------------------------------------------
from repro_torch.dp import backends as _dp_backends  # noqa: E402
from repro_torch.dp import schedule as _sched  # noqa: E402

_dp_backends.register(_dp_backends.grid_backend(
    "grid_wavefront", solve_grid,
    cost=lambda s, device: _dp_backends.grid_costs(s)["grid_wavefront"],
    arg_fn=solve_grid_with_args, run_extend=_run_extend,
    schedule=_sched.plain_route(_sched.grid_wavefront_schedule),
    doc="masked wavefront over anti-diagonals (alignment grids) or span "
        "diagonals (parse charts): one gathered combine per frontier"))
