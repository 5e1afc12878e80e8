"""Solvers for the paper's Simplified DP problem (Definition 1).

``ST[i] = ⊗_{1≤j≤k} ST[i - a_j]`` with offsets ``a_1 > a_2 > … > a_k > 0``
and preset initial values ``ST[0..a_1-1]``. Every solver accepts an optional
``(n, k)`` ``weights`` array: with ``(⊕, ⊙)`` the semiring whose ``add``
matches ``op``, the recurrence becomes ``ST[i] = ⊕_j (ST[i - a_j] ⊙ w[i, j])``.

The tensor solvers take a leading batch axis — ``init`` of shape
``(a_1,)`` or ``(batch, a_1)``, ``weights`` of shape ``(n, k)`` or
``(batch, n, k)`` — and run on the device of ``init``:

  * :func:`sdp_reference`    — numpy sequential oracle (paper Fig. 1).
  * :func:`solve_sequential` — the same loop on tensors.
  * :func:`solve_tournament` — per element, gather k values and tree-reduce
                               (the ``O(n log k)`` baseline of §II-B).
  * :func:`solve_pipeline`   — the paper's pipeline (Fig. 2), one
                               gather/⊗/scatter per outer step.
  * :func:`solve_blocked`    — ``B = min(a_k, block)`` outputs per step as a
                               (k×B) gather + tree reduce.
  * :func:`solve_companion_scan` — log-depth prefix products of the
                               recurrence's companion matrices (small a_1).

The first four build their table in place, one step at a time.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.semiring import SEMIGROUP_TO_SEMIRING, SEMIGROUPS

__all__ = [
    "sdp_reference",
    "solve_sequential",
    "solve_tournament",
    "solve_pipeline",
    "solve_blocked",
    "solve_companion_scan",
    "solve_tournament_with_args",
    "solve_blocked_with_args",
    "solve_extend",
    "linear_traceback_steps",
    "linear_traceback",
    "linear_args_np",
    "linear_traceback_np",
    "pipeline_num_steps",
]


def _check_offsets(offsets: Sequence[int]) -> np.ndarray:
    a = np.asarray(offsets, dtype=np.int64)
    if a.ndim != 1 or a.size == 0:
        raise ValueError("offsets must be a non-empty 1-D sequence")
    if not (np.all(np.diff(a) < 0) and a[-1] > 0):
        raise ValueError(f"offsets must satisfy a_1 > … > a_k > 0, got {offsets}")
    return a


def pipeline_num_steps(n: int, offsets: Sequence[int]) -> int:
    """Outer-step count of the paper's pipeline: ``n + k - a_1 - 1`` (§III-A)."""
    a = _check_offsets(offsets)
    k, a1 = len(a), int(a[0])
    return n + k - a1 - 1


def _mul_for(op: str):
    """The semiring ``⊙`` paired with semigroup ``op``."""
    return SEMIGROUP_TO_SEMIRING[op].mul


def _batched(init: torch.Tensor, weights):
    """Lift unbatched inputs to a batch of one; returns (init, weights,
    squeeze)."""
    if init.dim() == 1:
        return init[None], (None if weights is None else weights[None]), True
    return init, weights, False


def _init_table(init: torch.Tensor, a1: int, n: int) -> torch.Tensor:
    """The ``(batch, n)`` preset table every solver starts from. Preset-only
    tables (``n ≤ a_1``) clamp the presets; the loops then run no live
    step."""
    if n <= a1:
        return init[:, :n].clone()
    st = torch.zeros((init.shape[0], n), dtype=init.dtype, device=init.device)
    st[:, :a1] = init
    return st


def _out(t: torch.Tensor, squeeze: bool) -> torch.Tensor:
    return t[0] if squeeze else t


def _argbest_for(op: str):
    if op == "min":
        return torch.argmin
    if op == "max":
        return torch.argmax
    raise ValueError(f"argument tracking is undefined for op={op!r} "
                     "(every lane contributes to the reduction)")


# ---------------------------------------------------------------------------
# Oracle (paper Fig. 1, numpy)
# ---------------------------------------------------------------------------
def sdp_reference(init: np.ndarray, offsets: Sequence[int], op: str, n: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    a = _check_offsets(offsets)
    sg = SEMIGROUPS[op]
    a1 = int(a[0])
    if len(init) != a1:
        raise ValueError(f"need a_1={a1} initial values, got {len(init)}")
    if weights is not None:
        weights = np.asarray(weights)
        if weights.shape != (n, len(a)):
            raise ValueError(f"weights must be (n, k)=({n}, {len(a)}), "
                             f"got {weights.shape}")
    np_mul = SEMIGROUP_TO_SEMIRING[op].np_mul
    if n <= a1:  # preset-only table: clamp, like the tensor solvers
        return np.asarray(init)[:n].copy()
    st = np.empty(n, dtype=np.asarray(init).dtype)
    st[:a1] = init
    for i in range(a1, n):
        if weights is None:
            terms = [st[i - aj] for aj in a]
        else:
            terms = [np_mul(st[i - aj], weights[i, j]) for j, aj in enumerate(a)]
        v = terms[0]
        for t in terms[1:]:
            v = sg.np_op(v, t)
        st[i] = v
    return st


# ---------------------------------------------------------------------------
# Sequential: the oracle's loop on tensors (lanes folded in ascending j)
# ---------------------------------------------------------------------------
def solve_sequential(init, offsets, op: str, n: int, weights=None):
    a = _check_offsets(offsets)
    sg, mul = SEMIGROUPS[op], _mul_for(op)
    init, weights, squeeze = _batched(init, weights)
    a1 = int(a[0])
    st = _init_table(init, a1, n)
    for i in range(a1, n):
        v = None
        for j, aj in enumerate(a.tolist()):
            t = st[:, i - aj]
            if weights is not None:
                t = mul(t, weights[:, i, j])
            v = t if v is None else sg.op(v, t)
        st[:, i] = v
    return _out(st, squeeze)


# ---------------------------------------------------------------------------
# Warm-start extension: resume the sequential loop from a solved prefix —
# k = n - n_old steps instead of n. Cell i ≥ n_old reads only cells
# i - a_j ≥ n_old - a_1, all inside the saved suffix, and folds its lanes
# in solve_sequential's order, so the new cells equal the cold solve's tail
# bit for bit.
# ---------------------------------------------------------------------------
def solve_extend(suffix, offsets, op: str, k: int, weights=None):
    """``suffix`` is the prefix table's last a₁ cells (``(a_1,)`` or
    ``(batch, a_1)``), ``weights`` the ``(k, lanes)`` weight rows of the
    appended cells. Returns the ``k`` new cells."""
    a = _check_offsets(offsets)
    if k < 1:
        raise ValueError(f"need at least one appended cell, got k={k}")
    a1 = int(a[0])
    if weights is not None:
        # solve_sequential reads weight row i at cell i: pad the a_1 preset rows
        pad = torch.zeros(weights.shape[:-2] + (a1, weights.shape[-1]),
                          dtype=weights.dtype, device=weights.device)
        weights = torch.cat([pad, weights], dim=-2)
    return solve_sequential(suffix, offsets, op, a1 + k, weights=weights)[..., a1:]


# ---------------------------------------------------------------------------
# Tournament baseline (§II-B): per element, gather k values, tree-reduce
# ---------------------------------------------------------------------------
def _tournament(init, offsets, op, n, weights, with_args):
    a = _check_offsets(offsets)
    sg, mul = SEMIGROUPS[op], _mul_for(op)
    argbest = _argbest_for(op) if with_args else None
    init, weights, squeeze = _batched(init, weights)
    a1 = int(a[0])
    offs = torch.as_tensor(a, device=init.device)
    st = _init_table(init, a1, n)
    ar = torch.full(st.shape, -1, dtype=torch.int32, device=st.device)
    for i in range(a1, n):
        vals = st[:, i - offs]                            # (batch, k)
        if weights is not None:
            vals = mul(vals, weights[:, i])
        st[:, i] = sg.reduce(vals, dim=1)
        if with_args:
            ar[:, i] = argbest(vals, dim=1).to(torch.int32)
    return (_out(st, squeeze), _out(ar, squeeze)) if with_args else _out(st, squeeze)


def solve_tournament(init, offsets, op: str, n: int, weights=None):
    return _tournament(init, offsets, op, n, weights, with_args=False)


def solve_tournament_with_args(init, offsets, op: str, n: int, weights=None):
    """``solve_tournament`` + per-cell winning-lane index (first occurrence
    on ties; preset cells carry -1). Returns ``(st, args)``."""
    return _tournament(init, offsets, op, n, weights, with_args=True)


# ---------------------------------------------------------------------------
# The paper's pipeline (Fig. 2), vectorized over the k stages. At outer step
# i, stage j serves element idx = i - j and applies its j-th offset term; the
# write addresses {i - j} are consecutive, hence distinct (Theorem 1).
# ---------------------------------------------------------------------------
def solve_pipeline(init, offsets, op: str, n: int, weights=None):
    a = _check_offsets(offsets)
    sg, mul = SEMIGROUPS[op], _mul_for(op)
    init, weights, squeeze = _batched(init, weights)
    k, a1 = len(a), int(a[0])
    dev = init.device
    offs = torch.as_tensor(a, device=dev)
    js = torch.arange(k, device=dev)
    st = _init_table(init, a1, n)
    for i in range(a1, n + k - 1):
        idx = i - js                                   # element served by stage j
        active = (idx >= a1) & (idx < n)
        cidx = idx.clamp(0, n - 1)
        src = (idx - offs).clamp(0, n - 1)
        vals = st[:, src]                              # k distinct reads
        if weights is not None:
            vals = mul(vals, weights[:, cidx, js])
        new = torch.where(js == 0, vals, sg.op(st[:, cidx], vals))
        st[:, idx[active]] = new[:, active]
    return _out(st, squeeze)


# ---------------------------------------------------------------------------
# Blocked pipeline: finalize B = min(a_k, block) elements per outer step. All
# reads for block [t, t+B) use offsets ≥ a_k ≥ B, i.e. only finalized cells.
# ---------------------------------------------------------------------------
def _blocked(init, offsets, op, n, block, weights, with_args):
    a = _check_offsets(offsets)
    sg, mul = SEMIGROUPS[op], _mul_for(op)
    argbest = _argbest_for(op) if with_args else None
    init, weights, squeeze = _batched(init, weights)
    a1, ak = int(a[0]), int(a[-1])
    B = max(1, min(ak, block))
    dev = init.device
    offs = torch.as_tensor(a, device=dev)
    st = _init_table(init, a1, n)
    ar = torch.full(st.shape, -1, dtype=torch.int32, device=dev)
    lane = torch.arange(B, device=dev)
    for b in range(-(-(n - a1) // B)):
        pos = a1 + b * B + lane                        # (B,)
        ok = pos < n
        src = (pos[None, :] - offs[:, None]).clamp(0, n - 1)   # (k, B)
        vals = st[:, src]                              # (batch, k, B)
        if weights is not None:
            vals = mul(vals, weights[:, pos.clamp(0, n - 1)].transpose(1, 2))
        st[:, pos[ok]] = sg.reduce(vals, dim=1)[:, ok]
        if with_args:
            ar[:, pos[ok]] = argbest(vals, dim=1).to(torch.int32)[:, ok]
    return (_out(st, squeeze), _out(ar, squeeze)) if with_args else _out(st, squeeze)


def solve_blocked(init, offsets, op: str, n: int, block: int = 512,
                  weights=None):
    return _blocked(init, offsets, op, n, block, weights, with_args=False)


def solve_blocked_with_args(init, offsets, op: str, n: int, block: int = 512,
                            weights=None):
    """``solve_blocked`` + per-cell winning-lane index. Returns (st, args)."""
    return _blocked(init, offsets, op, n, block, weights, with_args=True)


# ---------------------------------------------------------------------------
# Companion-matrix scan. S-DP with a semigroup drawn from a semiring is a
# semiring-linear recurrence: the state v_i = (ST[i-1], …, ST[i-a_1])
# evolves by a companion matrix M (row 0: one — or the step's weight — at
# column a_j - 1 for every offset; one on the subdiagonal; zero elsewhere).
# Prefix products of the matrices give every cell from the presets in
# log depth, with O(n·a_1³) work.
# ---------------------------------------------------------------------------
def _companion_shift(a1: int, ring) -> np.ndarray:
    """The shift structure shared by every companion matrix: semiring
    ``one`` on the subdiagonal, ``zero`` elsewhere."""
    m = np.full((a1, a1), ring.zero, dtype=np.float64)
    for r in range(1, a1):
        m[r, r - 1] = ring.one
    return m


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(combine, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along axis 0 with the combination tree of
    ``jax.lax.associative_scan`` (odd/even recursion): pair neighbours,
    scan the pairs, fill in the even positions, interleave. ``combine``
    must be associative; the tree fixes where a non-exact one rounds."""
    n = elems.shape[0]
    if n < 2:
        return elems
    odd = associative_scan(combine, combine(elems[0:-1:2], elems[1::2]))
    if n % 2 == 0:
        even = combine(odd[:-1], elems[2::2])
    else:
        even = combine(odd, elems[2::2])
    return _interleave(torch.cat([elems[:1], even]), odd)


def solve_companion_scan(init, offsets, op: str, n: int, weights=None):
    """The table from prefix products ``P_t = M_t ⊙ … ⊙ M_0`` of the
    companion matrices: ``ST[a_1 + t] = (P_t ⊙ v_0)[0]`` with ``v_0 =
    (ST[a_1-1], …, ST[0])``. The scan combines in ``repro``'s tree, so
    min/max tables are bit-equal to ``repro``'s; ``op="add"`` multiplies
    with ``torch.matmul``, which sums in another order than XLA's dot."""
    a = _check_offsets(offsets)
    ring = SEMIGROUP_TO_SEMIRING[op]
    init, weights, squeeze = _batched(init, weights)
    a1 = int(a[0])
    steps = n - a1
    if steps <= 0:
        return _out(init[:, :n], squeeze)
    dtype = torch.promote_types(init.dtype, torch.float32)
    dev, bt = init.device, init.shape[0]
    shift = torch.as_tensor(_companion_shift(a1, ring), dtype=dtype, device=dev)
    mats = shift.expand(steps, bt, a1, a1).clone()        # (steps, batch, a1, a1)
    cols = torch.as_tensor(a - 1, device=dev)
    if weights is None:
        mats[:, :, 0, cols] = ring.one
    else:
        # step t computes ST[a1+t]: row 0 carries w[a1+t, j] at column a_j-1
        row0 = torch.full((steps, bt, a1), ring.zero, dtype=dtype, device=dev)
        row0[:, :, cols] = weights[:, a1:n].to(dtype).transpose(0, 1)
        mats[:, :, 0, :] = row0
    prefix = associative_scan(lambda x, y: ring.matmul(y, x), mats)
    v0 = init.flip(1).to(dtype)                           # (batch, a1)
    tail = ring.matvec(prefix[:, :, :1, :], v0)[..., 0]   # (steps, batch)
    st = torch.cat([init, tail.transpose(0, 1).to(init.dtype)], dim=1)
    return _out(st, squeeze)


# ---------------------------------------------------------------------------
# Traceback on the host: follow the winning lanes from a start cell down into
# the preset region (every step retreats by ≥ a_k).
# ---------------------------------------------------------------------------
def linear_traceback_steps(n: int, offsets: Sequence[int]) -> int:
    a = _check_offsets(offsets)
    return max((n - 1 - int(a[0])) // int(a[-1]) + 1, 1)


def path_walk(nxt: torch.Tensor, start: torch.Tensor, live: torch.Tensor,
              steps: int) -> tuple:
    """The walks ``c → nxt[c]`` from ``start`` (``(batch,)``) over
    ``(batch, cells)`` tables, by binary lifting: after round r the first
    2^r cells of every walk are known and the jump table maps each cell 2^r
    steps on, so the next 2^r cells are the jumps of these. A cell not
    ``live`` is a fixed point (``nxt[c] = c``) and ends its walk; rounds
    stop once every walk has reached one (one host sync a round), within
    ``steps`` steps. The jump table is int32 (``batch·cells < 2³¹``): two
    of them at a time. Returns ``(cells, count)``: ``(batch, 2^r)`` cells
    after r rounds, in walk order, then the end cell repeated, and each
    walk's count of live cells (the end cell is ``cells[b, count[b]]``)."""
    B, n = nxt.shape
    if B * n >= 2 ** 31:
        raise ValueError(f"path_walk: {B} x {n} cells pass int32 indices")
    base = torch.arange(B, device=nxt.device, dtype=torch.int32)[:, None] * n
    jump = (nxt.to(torch.int32) + base).view(-1)
    live = live.reshape(-1)
    pos = start.to(torch.int32)[:, None] + base

    def at(table, idx):         # int32 gathers: no int64 copy of the index
        return table.index_select(0, idx.reshape(-1)).view(idx.shape)

    rounds = max(1, int(steps).bit_length())
    for r in range(rounds):
        if not bool(at(live, pos[:, -1]).any()):
            break
        pos = torch.cat([pos, at(jump, pos)], dim=1)
        if r + 1 < rounds:
            jump = at(jump, jump)
    return pos - base, at(live, pos).sum(1)


def linear_traceback(args: torch.Tensor, offsets, n: int, start: torch.Tensor):
    """Walk ``(batch, n)`` arg tables from ``start`` (``(batch,)``) on their
    device. Cell ``c ≥ a_1`` steps to ``c - a[args[c]]``, a preset cell
    ends the walk; :func:`path_walk` lays every walk out in log depth
    instead of one step at a time. Returns ``(cells, lanes, count)``: the
    ``(batch, L)`` cells in walk order, their lanes, and each walk's count
    of live steps (``cells[b, count[b]]`` is the preset cell it ends in) —
    only these leave the device, never a table-sized array. Cut at the
    counts, they are :func:`linear_traceback_np`'s walk."""
    a = _check_offsets(offsets)
    a1 = int(a[0])
    offs = torch.as_tensor(a, dtype=torch.int32, device=args.device)
    cell = torch.arange(n, dtype=torch.int32, device=args.device)
    live = (cell >= a1).expand(args.shape[0], n)
    nxt = torch.where(live, cell - offs[args.clamp(0, len(a) - 1)], cell)
    cells, count = path_walk(nxt, start, live,
                             linear_traceback_steps(n, offsets))
    return cells, args.gather(1, cells.to(torch.int64)), count


def linear_args_np(table: np.ndarray, offsets: Sequence[int], op: str,
                   weights: np.ndarray | None = None) -> np.ndarray:
    """Winning-lane table recovered from a finished cost table (for routes
    that only return costs). Candidates are recomputed in float64."""
    a = _check_offsets(offsets)
    if op not in ("min", "max"):
        raise ValueError(f"argument tracking is undefined for op={op!r}")
    ring = SEMIGROUP_TO_SEMIRING[op]
    n = len(table)
    args = np.full(n, -1, dtype=np.int32)
    a1 = int(a[0])
    idx = np.arange(a1, n)
    cand = np.asarray(table, dtype=np.float64)[idx[:, None] - a[None, :]]
    if weights is not None:
        with np.errstate(invalid="ignore"):
            cand = ring.np_mul(cand, np.asarray(weights, dtype=np.float64)[a1:])
        cand = np.where(np.isnan(cand), ring.zero, cand)  # ±inf collisions
    args[a1:] = (np.argmin if op == "min" else np.argmax)(cand, axis=1)
    return args


def linear_traceback_np(args: np.ndarray, offsets: Sequence[int], start: int):
    """Walk ``args`` from ``start``; returns the live steps
    ``(cells, lanes, stop)`` with ``stop`` the preset cell reached."""
    a = _check_offsets(offsets)
    a1 = int(a[0])
    cells, lanes = [], []
    cur = int(start)
    while cur >= a1:
        lane = int(args[cur])
        cells.append(cur)
        lanes.append(lane)
        cur -= int(a[lane])
    return np.asarray(cells, dtype=np.int64), np.asarray(lanes, dtype=np.int64), cur


# ---------------------------------------------------------------------------
# Backend registration (repro_torch.dp): each solver is a dispatchable route
# with a step-count cost model.
# ---------------------------------------------------------------------------
from repro_torch.dp import backends as _dp_backends  # noqa: E402


def _run_extend(spec, n_old: int, state: dict, device) -> np.ndarray:
    """``Backend.run_extend`` for the sequential route: the warm-start loop
    over the ``k = n - n_old`` appended cells on ``device``."""
    n_old = int(n_old)
    a1 = int(spec.offsets[0])
    if not a1 < n_old < spec.n:
        raise ValueError(f"need a_1={a1} < n_old={n_old} < n={spec.n}")
    suffix = torch.as_tensor(np.asarray(state["suffix"], np.float32),
                             device=device)
    w = (None if spec.weights is None else torch.as_tensor(
        np.asarray(spec.weights[n_old:], np.float32), device=device))
    return solve_extend(suffix, spec.offsets, spec.op, spec.n - n_old,
                        weights=w).cpu().numpy()


def _register_backends() -> None:
    from repro_torch.dp import schedule as _sched

    table = [
        ("sequential", solve_sequential, None,
         _sched.plain_route(_sched.linear_sequential_schedule, route="sequential"),
         "Fig.-1 double loop (oracle parity)"),
        ("tournament", solve_tournament, solve_tournament_with_args,
         _sched.plain_route(_sched.linear_sequential_schedule, route="tournament",
                            kind="sequential_tree"),
         "per-element gather + tree reduce (§II-B)"),
        ("pipeline", solve_pipeline, None,
         _sched.plain_route(_sched.linear_pipeline_schedule),
         "the paper's Fig.-2 skewed pipeline, vectorized over stages"),
        ("blocked", solve_blocked, solve_blocked_with_args,
         _sched.plain_route(_sched.linear_blocked_schedule),
         "blocked pipeline: min(a_k, B) outputs per step"),
        ("companion_scan", solve_companion_scan, None,
         _sched.plain_route(_sched.linear_companion_scan_schedule),
         "log-depth associative scan over companion matrices (small a_1)"),
    ]
    for name, fn, arg_fn, schedule, doc in table:
        _dp_backends.register(_dp_backends.linear_backend(
            name, fn,
            cost=lambda s, device, _n=name: _dp_backends.linear_costs(s)[_n],
            supports=((lambda s, device: int(s.offsets[0]) <= 16)
                      if name == "companion_scan" else None),
            arg_fn=arg_fn,
            run_extend=_run_extend if name == "sequential" else None,
            schedule=schedule, doc=doc))


_register_backends()
