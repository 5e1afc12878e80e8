"""Symbolic schedule models of the DP routes: the data of the static
schedule gate (``repro_torch.analysis``).

Two data types carry the schedule-hazard verifier's contract:

:class:`DependencyModel` — the *family* side, produced by each spec class's
``schedule_model()`` hook: per cell, the preset set and the ordered operand
tuples of every candidate of the recurrence. This is ground truth derived
from the recurrence alone; no route can change it.

:class:`ScheduleModel` — the *route* side, produced by the ``schedule``
descriptor a backend registers: at which symbolic step each candidate is
read (``consume``), at which step each cell holds its final value
(``finalize``), plus the route's garbage writes (``clobbers``) and benign
full rewrites (``rewrites``). ``repro_torch.analysis.verifier`` checks the
two against each other by exhaustive small-n symbolic simulation plus a
distance-vector margin proof: every read happens strictly after its
operand's finalize step, every clobbered cell is overwritten before
anything reads it, every cell ends final.

The constructors below are the plain routes' schedules, re-derived from
first principles (closed forms) — deliberately *not* by calling the
solvers' own table builders, so a scheduling bug in a solver cannot
silently certify itself. The kernel routes' descriptors, built from the
CUDA launchers' plan helpers, are in ``repro_torch.kernels.schedule``. The
one shared convention: ``candidates`` are ordered canonically per family —
linear by offset index, triangular by split offset ``e`` ascending,
grid-antidiag by move declaration order, grid-spandiag split-major then
rule order — and every ``consume`` tuple aligns with that order.

A step is an interval of the route's execution that ends where every
write of the step is visible to every later read: a barrier, a kernel
boundary, or program order within one thread. Reads and writes of one
step are unordered with respect to each other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.dp.problem import lin_index, num_cells

__all__ = [
    "PRESET", "DependencyModel", "ScheduleModel", "plain_route",
    "linear_sequential_schedule", "linear_pipeline_schedule",
    "linear_blocked_schedule", "linear_companion_scan_schedule",
    "triangular_wavefront_schedule", "mcm_pipeline_schedule",
    "blocked_mcm_schedule", "grid_wavefront_schedule",
]

#: finalize step of a cell whose final value exists before step 0 — preset
#: init cells, and cells no route ever writes (their initialized value IS
#: the answer, e.g. unreachable semiring-zero grid cells).
PRESET = -1


@dataclasses.dataclass(frozen=True)
class DependencyModel:
    """Ground-truth dependency structure of one probe instance.

    ``candidates[c]`` is a tuple of operand-id tuples in the family's
    canonical order; preset cells carry ``()``. Cell ids are the family's
    linearized table indices (plane-major flat for grids)."""

    label: str
    cells: int
    preset: frozenset
    candidates: tuple


@dataclasses.dataclass(frozen=True)
class ScheduleModel:
    """One route's symbolic schedule over a probe instance.

    ``finalize[c]`` is the step during which cell ``c`` receives its final
    value (:data:`PRESET` when it holds it from initialization);
    ``consume[c][k]`` the step at which candidate ``k`` of ``c`` is read,
    aligned with ``DependencyModel.candidates[c]``. A read at step ``s``
    of operand ``o`` is safe iff ``finalize[o] < s``. ``clobbers`` are
    ``(step, cell)`` garbage writes (padded-lane spills); ``rewrites``
    are ``(step, cell)`` benign full rewrites restoring the cell's correct
    value (preset re-blends). ``invariants`` are pre-evaluated
    route-specific checks ``(name, ok, detail)`` the verifier folds into
    its findings. ``algebraic`` marks routes (associative scans) whose
    correctness rests on semiring algebra, not operand scheduling — the
    read simulation does not apply and is skipped."""

    route: str
    kind: str
    steps: int
    finalize: tuple
    consume: tuple
    clobbers: tuple = ()
    rewrites: tuple = ()
    invariants: tuple = ()
    algebraic: bool = False
    notes: str = ""


def plain_route(fn: Callable, **kw) -> Callable:
    """``Backend.schedule`` of a plain route: the one model
    ``fn(spec, **kw)``, the same on every device."""
    return lambda spec, device: (fn(spec, **kw),)


# ---------------------------------------------------------------------------
# Linear family (weighted S-DP): cells 0..n-1, preset [0, a1)
# ---------------------------------------------------------------------------
def _linear_uniform(spec, route: str, kind: str, step_of: Callable[[int], int],
                    steps: int, invariants=(), notes="") -> ScheduleModel:
    """Linear schedules where all k candidates of a cell are consumed at the
    cell's own step (sequential, tournament, blocked)."""
    a1, k = int(spec.offsets[0]), len(spec.offsets)
    finalize, consume = [], []
    for c in range(spec.n):
        if c < a1:
            finalize.append(PRESET)
            consume.append(())
        else:
            s = step_of(c)
            finalize.append(s)
            consume.append((s,) * k)
    return ScheduleModel(route=route, kind=kind, steps=steps,
                         finalize=tuple(finalize), consume=tuple(consume),
                         invariants=tuple(invariants), notes=notes)


def linear_sequential_schedule(spec, route: str = "sequential",
                               kind: str = "sequential") -> ScheduleModel:
    """One cell per step in index order (Fig. 1 double loop; ``tournament``
    shares the timing — only the per-cell reduction tree differs)."""
    a1 = int(spec.offsets[0])
    return _linear_uniform(spec, route, kind,
                           step_of=lambda c: c - a1, steps=spec.n - a1)


def linear_pipeline_schedule(spec, route: str = "pipeline") -> ScheduleModel:
    """The paper's Fig.-2 skewed pipeline: stage ``j`` serves cell
    ``i - j`` at outer step ``i``, so candidate ``j`` of cell ``c`` (offset
    ``a_{j+1}``) is consumed at step ``c + j`` and the cell finalizes at
    ``c + k - 1``. Safe for every strictly-decreasing offset tuple: the
    read margin is ``a_{j+1} + j - (k - 1) ≥ 1``."""
    a1, k = int(spec.offsets[0]), len(spec.offsets)
    finalize, consume = [], []
    for c in range(spec.n):
        if c < a1:
            finalize.append(PRESET)
            consume.append(())
        else:
            finalize.append(c + k - 1 - a1)
            consume.append(tuple(c + j - a1 for j in range(k)))
    return ScheduleModel(route=route, kind="skewed_pipeline",
                         steps=spec.n - a1 + k - 1,
                         finalize=tuple(finalize), consume=tuple(consume))


def linear_blocked_schedule(spec, route: str = "blocked",
                            block: int = 512, kind: str = "blocked",
                            invariants=(), notes="") -> ScheduleModel:
    """Blocked pipeline: ``B = min(a_k, block)`` cells finalize
    per step; every read reaches back ≥ ``a_k ≥ B`` cells, i.e. strictly
    before the current block."""
    a1, ak = int(spec.offsets[0]), int(spec.offsets[-1])
    B = max(1, min(ak, block))
    steps = max(1, math.ceil((spec.n - a1) / B))
    return _linear_uniform(spec, route, kind,
                           step_of=lambda c: (c - a1) // B, steps=steps,
                           invariants=invariants, notes=notes)


def linear_companion_scan_schedule(spec,
                                   route: str = "companion_scan"
                                   ) -> ScheduleModel:
    """Log-depth ``associative_scan`` over companion matrices: table cells
    are never read back — each cell is an entry of a prefix matrix power
    applied to the init vector, so the hazard class does not apply
    (``algebraic``). Correctness rests on semiring associativity."""
    a1, n = int(spec.offsets[0]), spec.n
    levels = max(1, math.ceil(math.log2(max(n - a1, 1)))) + 1
    finalize = tuple(PRESET if c < a1 else levels - 1 for c in range(n))
    return ScheduleModel(route=route, kind="associative_scan", steps=levels,
                         finalize=finalize,
                         consume=tuple(() for _ in range(n)),
                         algebraic=True,
                         notes="prefix powers of one companion matrix; no "
                               "table reads")


# ---------------------------------------------------------------------------
# Triangular family: diagonal-major cells, preset diagonal 0
# ---------------------------------------------------------------------------
def _tri_diag_of(n: int):
    """cell -> diagonal lookup for an n-wide triangular table."""
    diag = [0] * num_cells(n)
    for d in range(n):
        for i in range(n - d):
            diag[lin_index(i, d, n)] = d
    return diag


def triangular_wavefront_schedule(spec, route: str = "wavefront",
                                  kind: str = "wavefront", clobbers=(),
                                  invariants=(), notes="") -> ScheduleModel:
    """One masked combine per diagonal: every candidate of a diag-``d``
    cell is consumed at step ``d - 1``; operands live on diagonals
    ``< d``, finalized at strictly earlier steps."""
    n = spec.n
    finalize, consume = [], []
    for c, d in enumerate(_tri_diag_of(n)):
        if d == 0:
            finalize.append(PRESET)
            consume.append(())
        else:
            finalize.append(d - 1)
            consume.append((d - 1,) * d)
    return ScheduleModel(route=route, kind=kind, steps=max(1, n - 1),
                         finalize=tuple(finalize), consume=tuple(consume),
                         clobbers=tuple(clobbers),
                         invariants=tuple(invariants), notes=notes)


def _mcm_finals(n: int):
    """Closed-form pipeline finalize steps: cell ``c`` on diagonal ``d``
    occupies slots at steps ``c .. c + d - 1`` and is final after
    ``c + d - 1`` (diag-0 cells: ``c - 1``, i.e. ready before any write)."""
    return [c + d - 1 for c, d in enumerate(_tri_diag_of(n))]


def _hall_invariant(n: int, final, ready_of) -> tuple:
    """The mechanized Hall/SDR argument for the safe order (DESIGN.md §2):
    slots are fillable greedily iff for every cell ``c`` on diagonal ``d``
    and every ``t < d``, at least ``t + 1`` candidates are ready by step
    ``c + t``. The earliest-ready-first stable sort then realizes a
    hazard-free slot assignment (Hall's condition for the interval
    bipartite graph, where it is also sufficient)."""
    worst = None
    for d in range(1, n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            readies = sorted(ready_of(i, d, e) for e in range(d))
            for t in range(d):
                have = sum(1 for r in readies if r <= c + t)
                if have < t + 1:
                    worst = (f"cell {c} (i={i}, d={d}): only {have} "
                             f"candidates ready by step {c + t}, "
                             f"need {t + 1}")
                    return ("hall_condition", False, worst)
    return ("hall_condition", True,
            f"≥ t+1 candidates ready by step c+t for all cells, n={n}")


def mcm_pipeline_schedule(spec, route: str = "mcm_pipeline",
                          order: str = "safe") -> ScheduleModel:
    """The paper's Fig.-8 one-cell-per-step pipeline, re-derived in closed
    form (independent of ``core.mcm.build_tables``): cell ``c`` consumes
    its slot-``j`` candidate at step ``c + j``; a candidate with split
    ``e`` is *ready* at ``max(final(L_e), final(R_e)) + 1``.

    ``order="paper"`` fills slot ``j`` with split ``e = j`` — the published
    order, which reads operands before they finalize (the Fig.-8 hazard);
    ``order="safe"`` assigns slots by the earliest-ready-first stable sort,
    whose feasibility is the Hall invariant."""
    n = spec.n
    final = _mcm_finals(n)
    diag = _tri_diag_of(n)

    def ready_of(i, d, e):
        left = lin_index(i, e, n)
        right = lin_index(i + e + 1, d - e - 1, n)
        return max(final[left], final[right]) + 1

    finalize, consume = [], []
    for c, d in enumerate(diag):
        if d == 0:
            finalize.append(PRESET)
            consume.append(())
            continue
        i = c - lin_index(0, d, n)
        readies = [ready_of(i, d, e) for e in range(d)]
        if order == "paper":
            slot_of = list(range(d))
        else:
            perm = sorted(range(d), key=lambda e: readies[e])  # stable
            slot_of = [0] * d
            for j, e in enumerate(perm):
                slot_of[e] = j
        finalize.append(final[c])
        consume.append(tuple(c + slot_of[e] for e in range(d)))
    invariants = ()
    if order == "safe":
        invariants = (_hall_invariant(n, final, ready_of),)
    return ScheduleModel(route=route, kind=f"skewed_pipeline[{order}]",
                         steps=num_cells(n) + n,
                         finalize=tuple(finalize), consume=tuple(consume),
                         invariants=invariants,
                         notes=f"slot j of cell c read at step c + j; "
                               f"order={order}")


def blocked_mcm_schedule(spec, route: str = "blocked_mcm") -> ScheduleModel:
    """Tropical-tile GEMM MCM (``core.blocked_mcm``): block-diagonal ``D``
    runs one GEMM sub-step (all middle-tile splits, reading frozen earlier
    block-diagonals) followed by a ``2T - 1``-step local boundary
    wavefront. Global step of cell ``(i, j)`` in block ``(I, J)``:
    ``D·2T + 1 + (lj - li + T - 1)``; middle-tile candidates consume at
    the block-diagonal's GEMM sub-step ``D·2T``."""
    from repro_torch.core.blocked_mcm import _pick_tile

    n = spec.n
    T = _pick_tile(n)
    if T is None:
        raise ValueError(f"blocked_mcm has no tile for n={n}")
    nt = n // T

    def gstep(i, j):
        I, J = i // T, j // T
        return (J - I) * 2 * T + 1 + ((j - J * T) - (i - I * T) + T - 1)

    finalize = [0] * num_cells(n)
    consume = [()] * num_cells(n)
    for d in range(n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            j = i + d
            if d == 0:
                finalize[c] = PRESET
                continue
            g = gstep(i, j)
            finalize[c] = g
            I, J = i // T, j // T
            steps_c = []
            for e in range(d):
                s = i + e
                S = s // T
                if I < S < J:
                    steps_c.append((J - I) * 2 * T)   # GEMM sub-step
                else:
                    steps_c.append(g)                 # boundary wavefront
            consume[c] = tuple(steps_c)
    return ScheduleModel(route=route, kind="tile_gemm_wavefront",
                         steps=nt * 2 * T,
                         finalize=tuple(finalize), consume=tuple(consume),
                         notes=f"tile T={T}; GEMM reads frozen earlier "
                               "block-diagonals, boundary splits resolve in "
                               "the local 2T-1 wavefront")


# ---------------------------------------------------------------------------
# Grid family: plane-major flat cells; antidiag or spandiag fronts
# ---------------------------------------------------------------------------
def _grid_written_planes(spec) -> set:
    """Planes the solvers write at all: targets of at least one move/rule.
    Cells of unwritten planes keep their initialized value (preset or
    semiring zero) — finalize PRESET."""
    if spec.schedule == "antidiag":
        return {int(m[0]) for m in spec.moves}
    return {int(r[0]) for r in spec.rules}


def grid_wavefront_schedule(spec, route: str = "grid_wavefront",
                            kind: str = "grid_wavefront", clobbers=(),
                            rewrites=(), notes="") -> ScheduleModel:
    """One masked combine per frontier: anti-diagonals ``t = i + j``
    (step ``t - 1``) or span diagonals ``d`` (step ``d - 1``). All operands
    of a front sit on strictly earlier fronts."""
    dep = spec.schedule_model()
    written = _grid_written_planes(spec)
    finalize = [PRESET] * dep.cells
    consume = [()] * dep.cells
    if spec.schedule == "antidiag":
        R, C = spec.rows, spec.cols
        per = R * C
        steps = max(1, R + C - 2)
        for p in range(spec.planes):
            for i in range(R):
                for j in range(C):
                    cell = p * per + i * C + j
                    t = i + j
                    if cell in dep.preset or p not in written or t == 0:
                        consume[cell] = ()
                        continue
                    finalize[cell] = t - 1
                    consume[cell] = (t - 1,) * len(dep.candidates[cell])
    else:
        n = spec.rows
        per = num_cells(n)
        steps = max(1, n - 1)
        diag = _tri_diag_of(n)
        for p in range(spec.planes):
            for c0, d in enumerate(diag):
                cell = p * per + c0
                if d == 0 or p not in written:
                    continue
                finalize[cell] = d - 1
                consume[cell] = (d - 1,) * len(dep.candidates[cell])
    return ScheduleModel(route=route, kind=kind, steps=steps,
                         finalize=tuple(finalize), consume=tuple(consume),
                         clobbers=tuple(clobbers), rewrites=tuple(rewrites),
                         notes=notes)
