"""Schedule descriptors of the kernel routes: the order in which the Hopper
kernels read and finalize table cells, and the rules their launch
geometry must keep. They are the route side of the static schedule gate
(``repro_torch.analysis``) for ``kernel_blocked`` (K1), ``kernel_tiled``
(K3), ``kernel_wavefront`` (K2), ``kernel_tiled_wavefront`` (K4) and
``kernel_grid`` (K6, both schedules).

Each descriptor models the CUDA kernel in ``csrc/`` and takes its geometry
as an argument: a dict of what the launcher passes to the kernel (the walk
plan and cluster size, the tile plan, the CTA count). :func:`launch_geometry`
builds that dict with the launchers' own plan helpers for one launch shape
on one device, and the launchers record the geometry they launched with
under the same shape (their ``GEOMETRY`` tables), so the gate can hold the
two against each other. On a CUDA device the card-dependent values
(cluster sizes, co-resident CTAs) are the card's answers; on the CPU
:func:`schedules` takes every candidate. At probe sizes the launchers'
plans are degenerate (one chunk, one tile), so :func:`sweep` adds
hand-made small geometries under which the far fold, the cluster split,
the tile halo and the ticket order do real work.

A step (``repro_torch.dp.schedule``) ends where every write of it is
visible to every later read: a CTA, cluster or grid barrier, a ready flag
acquired after its release, or the program order of the one warp that
walks a chunk's near lanes. Each descriptor also takes the faults that a
test or a planned redesign may want to model (a lane folded early, a
barrier dropped, splits folded ahead of a barrier, another ticket order),
so the gate can be shown to catch them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from repro_torch.dp.problem import lin_index, num_cells
from repro_torch.dp.schedule import PRESET, ScheduleModel
from repro_torch.kernels import (_build, grid_pipeline, mcm_pipeline, mcm_tiled,
                                 sdp_chunked, sdp_pipeline, sdp_walk)

__all__ = [
    "walk_schedule", "mcm_cluster_schedule", "mcm_grid_schedule",
    "antidiag_schedule", "spandiag_schedule", "launch_geometry",
    "launch_invariants", "launch_resident", "schedules", "sweep",
    "independent_splits", "antidiag_ticket", "antidiag_waits", "recorded_launches", "forget_launches", "CPU_GRIDS",
]

#: CTA counts the cooperative kernels' descriptors take where no occupancy
#: API answers (the CPU): one CTA, and grids smaller than a probe's tiles
CPU_GRIDS = (1, 2, 3)
#: chunk lengths and tile sides of the hand-made geometries of :func:`sweep`
SWEEP_CHUNKS = (1, 2, 4)
SWEEP_TILES = (1, 2, 4)
#: the chunk walk's library for each of its routes
WALK_LIBRARIES = {"kernel_blocked": "sdp_pipeline", "kernel_tiled": "sdp_chunked"}


def _inv(name: str, ok, detail: str) -> tuple:
    return (name, bool(ok), detail)


# ---------------------------------------------------------------------------
# K1 / K3: the chunk walk (csrc/sdp_walk.cuh)
# ---------------------------------------------------------------------------
def walk_far(a: int, p: int) -> bool:
    """The walk's rule: at chunk position ``p`` the lane of offset ``a`` is
    folded by the far fold (it reads an earlier chunk) iff ``a > p``."""
    return a > p


def walk_geometry(offsets, op: str, p: sdp_walk.WalkPlan, C: int) -> dict:
    """What the launcher passes for plan ``p`` on a cluster of ``C``."""
    S = sdp_walk.splits(offsets, p, op, C)
    return {"Q": p.Q, "R": p.R, "near": p.near, "stage": p.stage, "C": C, "S": S,
            "threads": sdp_walk.threads(p, C, S),
            "smem": sdp_walk.smem_bytes(offsets, p, C, S)}


def walk_invariants(offsets, op: str, g: dict, ring: bool) -> tuple:
    """The walk's geometry rules, checkable at any size: the chunk, the
    near mode the offsets give, near offsets within the warp's window, a
    cluster only where every lane is far, lane splits only for min and max,
    the threads and shared memory the layout needs, and (K3) a ring that
    holds a chunk's reads and writes apart."""
    p = sdp_walk.WalkPlan(Q=g["Q"], R=g["R"], near=g["near"], stage=g["stage"])
    Q, C, S, a1 = g["Q"], g["C"], g["S"], offsets[0]
    near = [a for a in offsets if a < Q]
    need = sdp_walk.smem_bytes(offsets, p, C, S)
    out = [
        _inv("chunk_within_max", 1 <= Q <= sdp_walk.MAX_CHUNK,
             f"Q={Q}, MAX_CHUNK={sdp_walk.MAX_CHUNK}"),
        _inv("near_mode_matches_offsets", g["near"] == sdp_walk.near_mode(offsets, Q),
             f"near={g['near']}, offsets below Q={Q}: {near}"),
        _inv("near_offsets_below_window", all(a < sdp_walk.WINDOW for a in near),
             f"near offsets {near}, WINDOW={sdp_walk.WINDOW}"),
        _inv("cluster_only_all_far", C == 1 or g["near"] == 0,
             f"C={C}, near={g['near']}"),
        _inv("cluster_within_max", 1 <= C <= max(sdp_walk.CLUSTER_SIZES),
             f"C={C}, largest portable cluster {max(sdp_walk.CLUSTER_SIZES)}"),
        _inv("splits_only_selective", S == 1 or op != "add", f"S={S}, op={op}"),
        _inv("threads_cover_splits",
             g["threads"] == sdp_walk.threads(p, C, S) <= 1024,
             f"threads={g['threads']}, layout {sdp_walk.threads(p, C, S)}"),
        _inv("smem_covers_layout", need <= g["smem"] <= _build.SMEM_OPTIN_BYTES,
             f"layout {need} B, launch {g['smem']} B, limit "
             f"{_build.SMEM_OPTIN_BYTES} B"),
    ]
    if ring:
        out.append(_inv("ring_holds_window", g["R"] >= a1 + Q and g["R"] % 32 == 0,
                        f"R={g['R']}, a_1 + Q = {a1 + Q}"))
    return tuple(out)


def _near_folds(near: int, j: int, k: int, a: int, p: int) -> bool:
    """Whether the near walk of mode ``near`` folds lane ``j`` (of ``k``,
    offset ``a``) at chunk position ``p``: only a source of the same chunk
    (``a ≤ p``); mode 1 folds lane ``k-1`` as offset 1, mode 2 every offset
    its window table holds."""
    if a > p:
        return False
    if near == 1:
        return j == k - 1 and a == 1
    return near == 2 and a <= sdp_walk.WINDOW


def _ring_reuse(offsets, n: int, g: dict, far) -> tuple:
    """K3's ring, read by read: the far fold of cell ``c`` reads operand
    ``o`` from slot ``o mod R``, which cell ``o + R`` takes next. That write
    must come later: a chunk's writes follow all its far reads where a near
    walk lies between them; with every lane far each cell is written right
    after its own fold, while the chunk's other cells still read."""
    a1, Q, R = offsets[0], g["Q"], g["R"]
    for c in range(a1, n):
        m, p = divmod(c - a1, Q)
        for a in offsets:
            w = c - a + R
            if not far(a, p) or w >= n:
                continue
            mw = (w - a1) // Q if w >= a1 else -1
            if mw < m or (mw == m and g["near"] == 0):
                return _inv("ring_slot_not_reused", False,
                            f"cell {c} reads cell {c - a} from slot {(c - a) % R} "
                            f"while or after cell {w} takes it (R={R}, Q={Q})")
    return _inv("ring_slot_not_reused", True, f"R={R}, Q={Q}, n={n}")


def walk_schedule(spec, route: str, g: dict,
                  far: Callable[[int, int], bool] = walk_far) -> ScheduleModel:
    """The chunk walk of K1 (``route="kernel_blocked"``) or K3
    (``"kernel_tiled"``) at geometry ``g``. Chunk ``m`` covers cells
    ``a_1 + m·Q ..``; its first step is the far fold, which reads every
    lane ``far`` says is far (earlier chunks, final since the barrier that
    ended the last chunk). With near lanes (``near`` ≠ 0), step ``1 + p``
    of the chunk is the near warp's fold of position ``p``: it reads the
    chunk's own cells in ascending order and finishes the cell. With every
    lane far, the chunk is one step. ``far`` other than :func:`walk_far`
    models a kernel that folds lanes by another rule."""
    offsets = tuple(int(a) for a in spec.offsets)
    ring = route == "kernel_tiled"
    n, a1, k, Q, near = spec.n, offsets[0], len(offsets), g["Q"], g["near"]
    per = 1 if near == 0 else Q + 1
    finalize, consume, uncovered = [], [], []
    for c in range(n):
        if c < a1:
            finalize.append(PRESET)
            consume.append(())
            continue
        m, p = divmod(c - a1, Q)
        base = m * per
        fin = base if near == 0 else base + 1 + p
        steps = []
        for j, a in enumerate(offsets):
            if far(a, p):
                steps.append(base)
            else:
                if not _near_folds(near, j, k, a, p):
                    uncovered.append((c, j))
                steps.append(fin)
        finalize.append(fin)
        consume.append(tuple(steps))
    chunks = -(-(n - a1) // Q) if n > a1 else 0
    invariants = walk_invariants(offsets, spec.op, g, ring) + (
        _inv("every_lane_folded", not uncovered,
             f"lanes neither far nor in the near walk (cell, lane): {uncovered[:4]}"),)
    if ring:
        invariants += (_ring_reuse(offsets, n, g, far),)
    return ScheduleModel(
        route=route, kind=f"chunk_walk[near={near}, C={g['C']}]",
        steps=max(1, chunks * per), finalize=tuple(finalize),
        consume=tuple(consume), invariants=invariants,
        notes=f"chunks of Q={Q}: far fold at the chunk's first step, near "
              f"lanes by one warp in ascending order; {g}")


# ---------------------------------------------------------------------------
# Barrier-per-diagonal kernels: K2, K4, K6 spandiag
# ---------------------------------------------------------------------------
def _diagonal_steps(n: int, dropped: Iterable[int] = ()) -> list:
    """Step of each diagonal ``0 .. n-1`` of a kernel that ends its
    initialization (diagonal 0) and every diagonal with a barrier, less the
    barriers ``dropped`` (named by the diagonal they end): diagonals with no
    barrier between them share a step."""
    dropped = set(dropped)
    steps = [0]
    for d in range(1, max(n, 1)):
        steps.append(steps[-1] + (0 if d - 1 in dropped else 1))
    return steps


def _triangular(spec, route: str, kind: str, dsteps: list, ahead=None,
                invariants=(), notes="") -> ScheduleModel:
    n, cells = spec.n, num_cells(spec.n)
    finalize, consume = [PRESET] * cells, [()] * cells
    for d in range(1, n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            finalize[c] = dsteps[d]
            consume[c] = tuple(dsteps[d - 1] if ahead is not None and ahead(d, e)
                               else dsteps[d] for e in range(d))
    return ScheduleModel(route=route, kind=kind, steps=dsteps[-1] + 1,
                         finalize=tuple(finalize), consume=tuple(consume),
                         invariants=tuple(invariants), notes=notes)


def mcm_cluster_invariants(n: int, g: dict, resident: Optional[int]) -> tuple:
    """K2's geometry rules: a cluster size the kernel takes, the table's
    home as the kernel computes it, shared memory within the card's limit
    and (on the card) at least one such cluster resident."""
    out = [
        _inv("cluster_size_allowed", g["C"] in mcm_pipeline.CLUSTER_SIZES,
             f"C={g['C']}, sizes {mcm_pipeline.CLUSTER_SIZES}"),
        _inv("table_home_matches", g["home"] == mcm_pipeline.table_home(n),
             f"home={g['home']}, kernel's {mcm_pipeline.table_home(n)} at n={n}"),
        _inv("smem_within_optin",
             g["smem"] == mcm_pipeline.smem_bytes(n) <= _build.SMEM_OPTIN_BYTES,
             f"smem={g['smem']} B, layout {mcm_pipeline.smem_bytes(n)} B"),
    ]
    if resident is not None:
        out.append(_inv("cluster_resident", resident >= 1,
                        f"{resident} clusters of {g['C']} resident"))
    return tuple(out)


def mcm_cluster_schedule(spec, g: dict, resident: Optional[int] = None,
                         dropped: Iterable[int] = ()) -> ScheduleModel:
    """K2 (``csrc/mcm_pipeline.cu``): one cluster of ``g["C"]`` CTAs per
    instance, every split of diagonal ``d`` read after the cluster barrier
    that ends diagonal ``d - 1``. The kernel guards its writes by ``q <
    cd``, so no lane writes past its diagonal: the model has no clobbers
    (the reference's padded Pallas slices had them). ``dropped`` removes
    barriers."""
    return _triangular(
        spec, "kernel_wavefront", f"wavefront_cluster[{g['home']}, C={g['C']}]",
        _diagonal_steps(spec.n, dropped),
        invariants=mcm_cluster_invariants(spec.n, g, resident),
        notes="one cluster barrier per diagonal; finished cells written to "
              f"every replica; {g}")


def independent_splits(d: int, e: int) -> bool:
    """Splits of diagonal ``d`` that read no cell of diagonal ``d - 1``
    (``0 < e < d - 1``): those a kernel may fold before the barrier that
    ends diagonal ``d - 1``."""
    return 0 < e < d - 1


def mcm_grid_invariants(n: int, fused: bool, g: dict, resident: Optional[int]) -> tuple:
    """K4's geometry rules: its shared memory and the route admission's
    (``tile_plan``) within the card's limit, and (on the card) a grid the
    card keeps resident — a grid barrier over CTAs that never start hangs
    (``csrc/grid_sync.cuh``)."""
    need = mcm_tiled.spread_smem_bytes(n, fused)
    out = [
        _inv("smem_within_optin", g["smem"] == need <= _build.SMEM_OPTIN_BYTES,
             f"smem={g['smem']} B, layout {need} B"),
        _inv("tile_plan_smem_fits",
             mcm_tiled.smem_bytes(n, fused=True) <= _build.SMEM_OPTIN_BYTES,
             f"tile_plan({n}) = {mcm_tiled.tile_plan(n)}"),
    ]
    if resident is not None:
        out.append(_inv("grid_co_resident", 1 <= g["G"] <= resident,
                        f"G={g['G']}, resident {resident}"))
    return tuple(out)


def mcm_grid_schedule(spec, g: dict, fused: bool = False,
                      resident: Optional[int] = None, dropped: Iterable[int] = (),
                      ahead: Optional[Callable[[int, int], bool]] = None
                      ) -> ScheduleModel:
    """K4 (``csrc/mcm_tiled.cu``): a cooperative grid of ``g["G"]`` CTAs,
    one grid barrier after the initialization and after each diagonal.
    Every split of diagonal ``d`` reads the row- and column-major copies
    after the barrier that ends diagonal ``d - 1``; what runs before that
    barrier (``prefetch(d+1)``) loads weights only, which no cell depends
    on. ``ahead(d, e)`` marks splits folded before that barrier instead
    (:func:`independent_splits` is the legal set); ``dropped`` removes
    barriers."""
    return _triangular(
        spec, "kernel_tiled_wavefront", f"wavefront_grid[G={g['G']}]",
        _diagonal_steps(spec.n, dropped), ahead=ahead,
        invariants=mcm_grid_invariants(spec.n, fused, g, resident),
        notes="one grid barrier per diagonal; weights prefetched before it; "
              f"{g}")


def spandiag_invariants(P: int, NR: int, n: int, g: dict,
                        resident: Optional[int]) -> tuple:
    need = grid_pipeline.spandiag_smem_bytes(P, NR)
    out = [
        _inv("smem_within_optin",
             g["smem"] == need <= _build.SMEM_OPTIN_BYTES - grid_pipeline._STATIC_SMEM,
             f"smem={g['smem']} B, layout {need} B"),
        _inv("packed_args_int32", n * NR < 2 ** 31, f"n={n}, rules={NR}"),
    ]
    if resident is not None:
        out.append(_inv("grid_co_resident", 1 <= g["G"] <= resident,
                        f"G={g['G']}, resident {resident}"))
    return tuple(out)


def spandiag_schedule(spec, g: dict, resident: Optional[int] = None,
                      dropped: Iterable[int] = ()) -> ScheduleModel:
    """K6 spandiag (``grid_spandiag_kernel``): a cooperative grid, a grid
    barrier after the initialization and after each span diagonal; every
    candidate (split, rule) of a diagonal-``d`` cell of a targeted plane is
    read after the barrier that ends diagonal ``d - 1``. Planes no rule
    targets keep their initial values. ``dropped`` removes barriers."""
    n, per, P = spec.rows, num_cells(spec.rows), spec.planes
    dsteps = _diagonal_steps(n, dropped)
    rules_into = [sum(1 for r in spec.rules if int(r[0]) == p) for p in range(P)]
    finalize, consume = [PRESET] * (P * per), [()] * (P * per)
    for p in range(P):
        if not rules_into[p]:
            continue
        for d in range(1, n):
            for i in range(n - d):
                cell = p * per + lin_index(i, d, n)
                finalize[cell] = dsteps[d]
                consume[cell] = (dsteps[d],) * (d * rules_into[p])
    return ScheduleModel(
        route="kernel_grid", kind=f"spandiag_grid[G={g['G']}]", steps=dsteps[-1] + 1,
        finalize=tuple(finalize), consume=tuple(consume),
        invariants=spandiag_invariants(P, len(spec.rules), n, g, resident),
        notes=f"one grid barrier per span diagonal; {g}")


# ---------------------------------------------------------------------------
# K6 antidiag: the ticketed tile wavefront (grid_antidiag_kernel)
# ---------------------------------------------------------------------------
def antidiag_ticket(b: int, I: int, J: int) -> tuple:
    """The kernel's ticket order: tile fronts ``I + J`` ascending, then the
    instance, then ``I``."""
    return (I + J, b, I)


def antidiag_waits(t: tuple) -> list:
    """The ready flags tile ``t = (b, I, J)`` waits on: ``(I-1, J)`` and
    ``(I, J-1)``, and with them every tile up and to the left."""
    b, I, J = t
    return ([(b, I - 1, J)] if I else []) + ([(b, I, J - 1)] if J else [])


def _run_tickets(order: list, G: int, waits: Callable = antidiag_waits) -> tuple:
    """Rounds of ``G`` persistent CTAs, each taking the next ticket when it
    has none and finishing its tile in the first round after the tiles it
    ``waits`` on finished. Returns ``({tile: round it finished}, tiles
    never finished)``: a CTA that waits on a tile no running CTA holds
    waits forever."""
    done, held, nxt, rnd = {}, [], 0, 0
    while nxt < len(order) or held:
        while len(held) < G and nxt < len(order):
            held.append(order[nxt])
            nxt += 1
        rnd += 1
        ready = [t for t in held if all(q in done for q in waits(t))]
        if not ready:
            break
        for t in ready:
            done[t] = rnd
            held.remove(t)
    return done, [t for t in order if t not in done]


def antidiag_invariants(P: int, moves, R: int, C: int, B: int, with_args: bool,
                        g: dict, resident: Optional[int],
                        ticket: Callable = antidiag_ticket) -> tuple:
    """K6 antidiag's geometry rules: the tile plan's layout at its side
    (halo as the moves reach, at most ``HALO``; strides, threads, shared
    memory), the tile count, a grid the card keeps resident, and tickets
    in a topological order of the flag waits (no tile waits on a later
    ticket), and that the ``G`` CTAs finish every tile."""
    T = g["T"]
    plan = dataclasses.asdict(grid_pipeline.tile_plan_at(P, moves, with_args, T))
    nI, nJ = -(-R // T), -(-C // T)
    tiles = [(b, I, J) for b in range(B) for I in range(nI) for J in range(nJ)]
    late = [t for t in tiles for q in antidiag_waits(t) if ticket(*q) >= ticket(*t)]
    _, stuck = _run_tickets(sorted(tiles, key=lambda t: ticket(*t)), g["G"])
    out = [
        _inv("tile_layout_matches", {k: g[k] for k in plan} == plan,
             f"launch {({k: g[k] for k in plan})}, plan at T={T}: {plan}"),
        _inv("halo_within_limit", max(g["HI"], g["HJ"]) <= grid_pipeline.HALO,
             f"HI={g['HI']}, HJ={g['HJ']}, HALO={grid_pipeline.HALO}"),
        _inv("smem_within_optin",
             g["smem"] <= _build.SMEM_OPTIN_BYTES - grid_pipeline._STATIC_SMEM,
             f"smem={g['smem']} B"),
        _inv("threads_cover_tile_rows", P * T <= g["threads"] <= 1024,
             f"threads={g['threads']}, P·T={P * T}"),
        _inv("tiles_match", g["tiles"] == len(tiles),
             f"tiles={g['tiles']}, {B} x {nI} x {nJ}"),
        _inv("tickets_topological", not late,
             f"tiles waiting on a later ticket: {late[:4]}"),
        _inv("wavefront_completes", not stuck,
             f"{len(stuck)} of {len(tiles)} tiles never finish with G={g['G']} "
             f"(first {stuck[:4]})"),
    ]
    if resident is not None:
        out.append(_inv("grid_co_resident", 1 <= g["G"] <= resident,
                        f"G={g['G']}, resident {resident}"))
    return tuple(out)


def antidiag_schedule(spec, g: dict, with_args: bool = False,
                      resident: Optional[int] = None,
                      ticket: Callable = antidiag_ticket,
                      waits: Callable = antidiag_waits) -> ScheduleModel:
    """K6 antidiag (``grid_antidiag_kernel``) over one instance: ``T × T``
    tiles taken in ``ticket`` order by ``g["G"]`` persistent CTAs, a tile
    run once the ready flags of ``(I-1, J)`` and ``(I, J-1)`` are set (and
    with them every tile up and to the left). A tile finished in round
    ``D`` of :func:`_run_tickets` holds steps ``2T(D-1) ..``: step 0 loads
    the halo of ``HI`` rows and ``HJ`` columns from the finished table,
    step ``1 + s`` sweeps inner anti-diagonal ``s`` (a ``__syncthreads``
    apart). A source inside the tile is read at its cell's sweep step, one
    in the halo at the load, one past the halo from device memory at the
    sweep step. Cells of tiles that never finish are never finalized.
    ``ticket`` and ``waits`` other than the kernel's model another ticket
    order or other flag waits."""
    R, C, P, T = spec.rows, spec.cols, spec.planes, g["T"]
    HI, HJ, per = g["HI"], g["HJ"], spec.cells
    nI, nJ = -(-R // T), -(-C // T)
    order = sorted(((0, I, J) for I in range(nI) for J in range(nJ)),
                   key=lambda t: ticket(*t))
    done, _ = _run_tickets(order, g["G"], waits)
    dep = spec.schedule_model()
    targeted = {int(m[0]) for m in spec.moves}
    finalize, consume = [PRESET] * dep.cells, [()] * dep.cells
    for p in sorted(targeted):
        for i in range(R):
            for j in range(C):
                cell = p * per + i * C + j
                if cell in dep.preset:
                    continue
                D = done.get((0, i // T, j // T))
                if D is None:
                    consume[cell] = (0,) * len(dep.candidates[cell])
                    continue
                I0, J0 = i // T * T, j // T * T
                base = 2 * T * (D - 1)
                sweep = base + 1 + (i - I0) + (j - J0)
                finalize[cell] = sweep
                steps = []
                for (pt, _, di, dj) in spec.moves:
                    if int(pt) != p or i < di or j < dj:
                        continue
                    si, sj = i - di, j - dj
                    inside = si >= I0 and sj >= J0
                    halo = si >= I0 - HI and sj >= J0 - HJ
                    steps.append(base if halo and not inside else sweep)
                consume[cell] = tuple(steps)
    return ScheduleModel(
        route="kernel_grid", kind=f"tile_wavefront[T={T}, G={g['G']}]",
        steps=max(1, 2 * T * max(done.values(), default=1)),
        finalize=tuple(finalize), consume=tuple(consume),
        invariants=antidiag_invariants(P, spec.moves, R, C, 1, with_args, g,
                                       resident, ticket),
        notes=f"ticketed tile wavefront on ready flags; {g}")


# ---------------------------------------------------------------------------
# Launch geometry: what the launchers compute, for the gate to compare
# ---------------------------------------------------------------------------
def _variant(name: str) -> tuple:
    """``(with_args, fused)`` of a wrapper name."""
    return name.endswith(("_with_args", "_fused")), name.endswith("_fused")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _walk_plan(name: str, shape: tuple) -> sdp_walk.WalkPlan:
    offsets, _, weighted = shape
    return sdp_walk.plan(offsets, weighted, ring=name.startswith("sdp_chunked"))


def _tile_plan(name: str, shape: tuple) -> tuple:
    """K6 antidiag's ``(plan, tiles)`` for a launch at ``shape``."""
    _, P, moves, R, C, B = shape
    plan = grid_pipeline.tile_plan(P, moves, _variant(name)[0])
    return plan, B * -(-R // plan.T) * -(-C // plan.T)


def launch_geometry(name: str, shape: tuple, device) -> dict:
    """The geometry the launcher of wrapper ``name`` computes for a launch
    at ``shape`` (the key its ``GEOMETRY`` table records it under) on the
    CUDA ``device``, by the launchers' plan helpers."""
    with_args, fused = _variant(name)
    if name.startswith(("sdp_pipeline", "sdp_chunked")):
        offsets, op, weighted = shape
        p = _walk_plan(name, shape)
        C = sdp_walk.cluster_size(name.split("_with_args")[0], offsets, p, op, weighted,
                                  with_args, device)
        return walk_geometry(offsets, op, p, C)
    if name.startswith("mcm_pipeline"):
        n, batch = shape
        return {"C": mcm_pipeline.cluster_size(with_args, n, batch, device),
                "home": mcm_pipeline.table_home(n), "smem": mcm_pipeline.smem_bytes(n)}
    if name.startswith("mcm_tiled"):
        (n,) = shape
        return {"G": mcm_tiled.ctas(with_args, fused, n, device),
                "smem": mcm_tiled.spread_smem_bytes(n, fused)}
    if name.startswith("grid_pipeline_antidiag"):
        plan, tiles = _tile_plan(name, shape)
        return {"G": grid_pipeline.antidiag_ctas(shape[0], with_args, plan, tiles, device),
                "tiles": tiles, **dataclasses.asdict(plan)}
    if name.startswith("grid_pipeline_spandiag"):
        op, P, _, NR = shape
        return {"G": grid_pipeline.spandiag_ctas(op, with_args, P, NR, device),
                "smem": grid_pipeline.spandiag_smem_bytes(P, NR)}
    raise KeyError(f"no launch geometry for kernel wrapper {name!r}")


def launch_resident(name: str, shape: tuple, g: dict, device) -> Optional[int]:
    """What the card keeps resident for launch geometry ``g``: clusters of
    ``g["C"]`` (K2) or CTAs (the cooperative K4 and K6); None for the
    walk, which needs no residency, and on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    with_args, fused = _variant(name)
    if name.startswith("mcm_pipeline"):
        return mcm_pipeline.max_clusters(with_args, shape[0], g["C"], device)
    if name.startswith("mcm_tiled"):
        return mcm_tiled.blocks_per_sm(with_args, fused, shape[0], device) * _sms(device)
    if name.startswith("grid_pipeline_antidiag"):
        plan, _ = _tile_plan(name, shape)
        return (grid_pipeline.antidiag_blocks_per_sm(shape[0], with_args, plan, device)
                * _sms(device))
    if name.startswith("grid_pipeline_spandiag"):
        op, P, _, NR = shape
        return (grid_pipeline.spandiag_blocks_per_sm(op, with_args, P, NR, device)
                * _sms(device))
    return None


def launch_invariants(name: str, shape: tuple, g: dict,
                      resident: Optional[int] = None) -> tuple:
    """The geometry rules of a launch of wrapper ``name`` at ``shape`` — the
    check that stays cheap at path sizes, where simulating every cell
    would not."""
    with_args, fused = _variant(name)
    if name.startswith(("sdp_pipeline", "sdp_chunked")):
        offsets, op, _ = shape
        return walk_invariants(offsets, op, g, ring=name.startswith("sdp_chunked"))
    if name.startswith("mcm_pipeline"):
        return mcm_cluster_invariants(shape[0], g, resident)
    if name.startswith("mcm_tiled"):
        return mcm_grid_invariants(shape[0], fused, g, resident)
    if name.startswith("grid_pipeline_antidiag"):
        op, P, moves, R, C, B = shape
        return antidiag_invariants(P, moves, R, C, B, with_args, g, resident)
    op, P, n, NR = shape
    return spandiag_invariants(P, NR, n, g, resident)


# ---------------------------------------------------------------------------
# The routes' descriptors (Backend.schedule) and the plan sweep
# ---------------------------------------------------------------------------
def _launches(route: str, spec) -> list:
    """``(wrapper name, shape)`` of every launch the route makes for
    ``spec`` alone: without and with args (K4's fused twin too)."""
    if route in WALK_LIBRARIES:
        lib = WALK_LIBRARIES[route]
        shape = (tuple(int(a) for a in spec.offsets), spec.op, spec.weights is not None)
        names = [lib] + ([f"{lib}_with_args"] if spec.supports_args() else [])
        return [(name, shape) for name in names]
    if route == "kernel_wavefront":
        return [(name, (spec.n, 1)) for name in ("mcm_pipeline", "mcm_pipeline_with_args")]
    if route == "kernel_tiled_wavefront":
        return [(name, (spec.n,)) for name in
                ("mcm_tiled", "mcm_tiled_with_args", "mcm_tiled_fused")]
    if spec.schedule == "antidiag":
        shape = (spec.op, spec.planes, spec.moves, spec.rows, spec.cols, 1)
        return [(name, shape) for name in
                ("grid_pipeline_antidiag", "grid_pipeline_antidiag_with_args")]
    shape = (spec.op, spec.planes, spec.rows, len(spec.rules))
    return [(name, shape) for name in
            ("grid_pipeline_spandiag", "grid_pipeline_spandiag_with_args")]


def _candidates(name: str, shape: tuple) -> list:
    """Every geometry the launcher of ``name`` may take at ``shape`` on some
    card: each cluster size (K1/K3 wide plans, K2) or each of
    :data:`CPU_GRIDS` (cooperative grids, at most one CTA a tile)."""
    with_args, fused = _variant(name)
    if name.startswith(("sdp_pipeline", "sdp_chunked")):
        offsets, op, _ = shape
        p = _walk_plan(name, shape)
        return [walk_geometry(offsets, op, p, C)
                for C in (1,) + sdp_walk.cluster_candidates(p)]
    if name.startswith("mcm_pipeline"):
        n = shape[0]
        return [{"C": C, "home": mcm_pipeline.table_home(n),
                 "smem": mcm_pipeline.smem_bytes(n)} for C in mcm_pipeline.CLUSTER_SIZES]
    if name.startswith("mcm_tiled"):
        return [{"G": G, "smem": mcm_tiled.spread_smem_bytes(shape[0], fused)}
                for G in CPU_GRIDS]
    if name.startswith("grid_pipeline_antidiag"):
        plan, tiles = _tile_plan(name, shape)
        return [{"G": G, "tiles": tiles, **dataclasses.asdict(plan)}
                for G in sorted({min(tiles, G) for G in CPU_GRIDS})]
    op, P, _, NR = shape
    return [{"G": G, "smem": grid_pipeline.spandiag_smem_bytes(P, NR)} for G in CPU_GRIDS]


def _model(route: str, name: str, spec, g: dict, resident) -> ScheduleModel:
    with_args, fused = _variant(name)
    if route in WALK_LIBRARIES:
        return walk_schedule(spec, route, g)
    if route == "kernel_wavefront":
        return mcm_cluster_schedule(spec, g, resident)
    if route == "kernel_tiled_wavefront":
        return mcm_grid_schedule(spec, g, fused, resident)
    if spec.schedule == "antidiag":
        return antidiag_schedule(spec, g, with_args, resident)
    return spandiag_schedule(spec, g, resident)


def schedules(route: str, spec, device) -> tuple:
    """``Backend.schedule`` of a kernel route: a model for every launch the
    route makes for ``spec`` on ``device`` (without and with args), at the
    geometry its launcher takes there — the card's own on a CUDA device,
    every candidate of the card-dependent values elsewhere."""
    device = torch.device(device)
    out = []
    for name, shape in _launches(route, spec):
        if device.type == "cuda":
            geoms = [launch_geometry(name, shape, device)]
        else:
            geoms = _candidates(name, shape)
        for g in geoms:
            out.append(_model(route, name, spec, g,
                              launch_resident(name, shape, g, device)))
    return tuple(out)


def sweep(route: str, spec) -> tuple:
    """Models of the route at hand-made small geometries on ``spec``, where
    the launchers' own plans are degenerate: K1/K3 chunks of
    :data:`SWEEP_CHUNKS` cells (so lanes are far at some positions and
    near at others, in every near mode the offsets allow), staged weights
    or not, clusters of two where every lane is far; K6 antidiag tiles of
    :data:`SWEEP_TILES` sides taken by one, two or one CTA a tile; K2, K4
    and K6 spandiag at every candidate cluster size or grid."""
    out = []
    if route in WALK_LIBRARIES:
        offsets = tuple(int(a) for a in spec.offsets)
        ring = route == "kernel_tiled"
        for Q in SWEEP_CHUNKS:
            for stage in ((False, True) if spec.weights is not None else (False,)):
                R = -(-(offsets[0] + Q) // 32) * 32 if ring else 0
                p = sdp_walk.WalkPlan(Q=Q, R=R, near=sdp_walk.near_mode(offsets, Q),
                                      stage=stage)
                for C in ((1, 2) if p.near == 0 else (1,)):
                    out.append(walk_schedule(spec, route, walk_geometry(offsets, spec.op,
                                                                        p, C)))
        return tuple(out)
    if route == "kernel_grid" and spec.schedule == "antidiag":
        for name, shape in _launches(route, spec):
            with_args, _ = _variant(name)
            for T in SWEEP_TILES:
                plan = grid_pipeline.tile_plan_at(spec.planes, spec.moves, with_args, T)
                tiles = -(-spec.rows // T) * -(-spec.cols // T)
                for G in sorted({1, 2, tiles}):
                    g = {"G": G, "tiles": tiles, **dataclasses.asdict(plan)}
                    out.append(antidiag_schedule(spec, g, with_args))
        return tuple(out)
    for name, shape in _launches(route, spec):
        for g in _candidates(name, shape):
            out.append(_model(route, name, spec, g, None))
    return tuple(out)


# ---------------------------------------------------------------------------
# The launchers' records
# ---------------------------------------------------------------------------
def _tables() -> tuple:
    return (sdp_pipeline.GEOMETRY, sdp_chunked.GEOMETRY, mcm_pipeline.GEOMETRY,
            mcm_tiled.GEOMETRY, grid_pipeline.GEOMETRY)


def recorded_launches() -> list:
    """``(wrapper name, shape, geometry)`` of every launch shape the DP
    kernels' wrappers recorded."""
    return [(name, shape, g) for table in _tables()
            for name, shapes in sorted(table.items())
            for shape, g in shapes.items()]


def forget_launches() -> None:
    """Clear the wrappers' records (before a path whose launches are to be
    checked)."""
    for table in _tables():
        table.clear()
