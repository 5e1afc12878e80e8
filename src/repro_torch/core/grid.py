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


def _spandiag(arrs, meta, with_args: bool):
    _, op, P, n, _, _, rules = meta
    squeeze, (rw, init) = batched(arrs, meta)
    dev, dt, B, NR = rw.device, rw.dtype, rw.shape[0], len(rules)
    zero = semiring_zero(op)
    cells = num_cells(n)
    st = torch.full((B, P, cells), zero, dtype=dt, device=dev)
    st[:, :, :n] = init
    ar = torch.full((B, P, cells), -1, dtype=torch.int32, device=dev)
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
        i = torch.arange(n - d, device=dev)[:, None, None]      # (lanes, 1, 1)
        e = torch.arange(d, device=dev)[None, :, None]          # (1, d, 1)
        left = st[:, rb[:, None, None], lin_index(i, e, n)]     # (B, P', lanes, d, K)
        right = st[:, rc[:, None, None], lin_index(i + e + 1, d - e - 1, n)]
        cand = (left + right) + rwf[:, rid][:, :, None, None]
        cand = torch.where(real[:, None, None], cand, zero)
        best, k = _reduce(cand.flatten(3), op, 3)               # split-major
        row = lin_index(i[:, 0, 0], d, n)
        st[:, pl[:, None], row] = best
        if with_args:
            ee, kk = k // rid.shape[1], k % rid.shape[1]
            r = rid[torch.arange(len(live), device=dev)[:, None], kk]
            ar[:, pl[:, None], row] = (ee * NR + r).to(torch.int32)
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

_dp_backends.register(_dp_backends.grid_backend(
    "grid_wavefront", solve_grid,
    cost=lambda s, device: _dp_backends.grid_costs(s)["grid_wavefront"],
    arg_fn=solve_grid_with_args,
    doc="masked wavefront over anti-diagonals (alignment grids) or span "
        "diagonals (parse charts): one gathered combine per frontier"))
