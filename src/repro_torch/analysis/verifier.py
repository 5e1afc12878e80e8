"""Schedule-hazard verifier: symbolic write-before-read proofs.

Checks every registered route's :class:`~repro_torch.dp.schedule.ScheduleModel`
against its family's ground-truth :class:`~repro_torch.dp.schedule
.DependencyModel` on the family's small probe instances — no kernel
launch, no solver call. Two complementary mechanisms:

* **Distance-vector margin proof** — for every (cell, candidate, operand)
  triple, ``consume_step - finalize_step ≥ 1``. This is the family-generic
  write-before-read finalization condition; the minimum margin and its
  witness triple are reported on failure (this is what rejects the paper's
  Fig.-8 slot order: at n = 4 the first hazard has margin 0, and a kernel
  that folds a split or a lane before the barrier or the warp step that
  finishes its operand).

* **Exhaustive symbolic simulation** — a per-step state machine over cell
  states (``preset``/``empty``/``final``/``garbage``) that additionally
  covers the kernel-layout hazards the margin proof alone cannot express:
  padded-lane spill *clobbers* must be overwritten before any read sees
  them and must not survive to the end state, and preset *rewrites*
  (blended re-writes) are benign. Event order within a step: reads, then
  clobbers, then rewrites/finalize — matching the kernels, where a step's
  vector write (including its spill lanes) lands after the step's reads.

Route-specific ``invariants`` (the kernels' launch geometry — rings, halos,
cluster sizes, co-resident grids, ticket orders — and the Hall condition of
the safe order) arrive pre-evaluated on the model and are folded into the
findings here. :func:`verify_launches` holds the geometry the kernel
wrappers recorded at their launches against the descriptors' own.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.dp.schedule import PRESET, DependencyModel, ScheduleModel

__all__ = ["verify_schedule", "verify_registry", "verify_launches"]

_PRESET_STATE = "preset"
_EMPTY = "empty"
_FINAL = "final"
_GARBAGE = "garbage"


def verify_schedule(dep: DependencyModel, m: ScheduleModel,
                    route: str = "") -> List[Finding]:
    """All findings of one route's schedule against one probe's
    dependencies. Empty list = proven safe at this probe size."""
    subject = route or m.route
    out: List[Finding] = []

    def finding(check: str, message: str, **detail) -> None:
        out.append(Finding(check=check, subject=subject, message=message,
                           probe=dep.label, detail=detail))

    # --- pre-evaluated route invariants ------------------------------------
    for name, ok, detail in m.invariants:
        if not ok:
            finding("invariant_violated", f"{name}: {detail}",
                    invariant=name)

    # --- structural alignment with the dependency model --------------------
    if len(m.finalize) != dep.cells:
        finding("model_shape_mismatch",
                f"finalize covers {len(m.finalize)} cells, "
                f"family has {dep.cells}")
        return out
    if m.algebraic:
        # no table reads to schedule; only the end-state contract applies:
        # every non-preset cell must still be assigned a finalize step
        for c in range(dep.cells):
            if c not in dep.preset and m.finalize[c] == PRESET \
                    and dep.candidates[c]:
                finding("never_finalized",
                        f"cell {c} has candidates but no finalize step",
                        cell=c)
        return out
    if len(m.consume) != dep.cells:
        finding("model_shape_mismatch",
                f"consume covers {len(m.consume)} cells, "
                f"family has {dep.cells}")
        return out
    for c in range(dep.cells):
        if len(m.consume[c]) != len(dep.candidates[c]):
            finding("model_shape_mismatch",
                    f"cell {c}: {len(m.consume[c])} consume steps for "
                    f"{len(dep.candidates[c])} candidates", cell=c)
            return out

    # --- step-range and finalize sanity ------------------------------------
    for c in range(dep.cells):
        f = m.finalize[c]
        if c in dep.preset:
            if f != PRESET:
                finding("preset_refinalized",
                        f"preset cell {c} carries finalize step {f}",
                        cell=c, step=f)
            continue
        if f == PRESET:
            if dep.candidates[c]:
                finding("never_finalized",
                        f"cell {c} has candidates but no finalize step",
                        cell=c)
            continue
        if not (0 <= f < m.steps):
            finding("step_out_of_range",
                    f"cell {c} finalizes at step {f}, horizon is "
                    f"[0, {m.steps})", cell=c, step=f)
        for k, s in enumerate(m.consume[c]):
            if not (0 <= s < m.steps):
                finding("step_out_of_range",
                        f"cell {c} candidate {k} consumed at step {s}, "
                        f"horizon is [0, {m.steps})", cell=c, step=s)
            if s > f:
                finding("consume_after_finalize",
                        f"cell {c} candidate {k} consumed at step {s} but "
                        f"the cell finalizes at {f}", cell=c, step=s)
    if out:
        return out

    # --- distance-vector margin proof --------------------------------------
    min_margin: Tuple[int, tuple] = None  # (margin, witness)
    for c in range(dep.cells):
        for k, s in enumerate(m.consume[c]):
            for o in dep.candidates[c][k]:
                f = m.finalize[o]
                if f == PRESET:
                    continue                     # preset/init-final operand
                margin = s - f
                if min_margin is None or margin < min_margin[0]:
                    min_margin = (margin, (c, k, o, s, f))
                if margin < 1:
                    finding("read_before_finalize",
                            f"cell {c} candidate {k} reads operand {o} at "
                            f"step {s}, but {o} finalizes at step {f} "
                            f"(margin {margin} < 1)",
                            cell=c, candidate=k, operand=o,
                            read_step=s, finalize_step=f, margin=margin)
    if out:
        return out

    # --- exhaustive symbolic simulation ------------------------------------
    state = {}
    for c in range(dep.cells):
        if c in dep.preset or m.finalize[c] == PRESET:
            state[c] = _PRESET_STATE        # final from initialization
        else:
            state[c] = _EMPTY
    reads_at = [[] for _ in range(m.steps)]
    for c in range(dep.cells):
        for k, s in enumerate(m.consume[c]):
            reads_at[s].append((c, k))
    finals_at = [[] for _ in range(m.steps)]
    for c in range(dep.cells):
        if m.finalize[c] != PRESET:
            finals_at[m.finalize[c]].append(c)
    clobbers_at = [[] for _ in range(m.steps)]
    for s, c in m.clobbers:
        if not (0 <= s < m.steps):
            finding("step_out_of_range",
                    f"clobber of cell {c} at step {s}, horizon is "
                    f"[0, {m.steps})", cell=c, step=s)
            return out
        clobbers_at[s].append(c)
    rewrites_at = [[] for _ in range(m.steps)]
    for s, c in m.rewrites:
        if not (0 <= s < m.steps):
            finding("step_out_of_range",
                    f"rewrite of cell {c} at step {s}, horizon is "
                    f"[0, {m.steps})", cell=c, step=s)
            return out
        rewrites_at[s].append(c)

    for s in range(m.steps):
        for c, k in reads_at[s]:
            for o in dep.candidates[c][k]:
                if state[o] == _EMPTY:
                    finding("read_before_write",
                            f"step {s}: cell {c} candidate {k} reads "
                            f"operand {o}, which has not been written",
                            cell=c, candidate=k, operand=o, step=s)
                elif state[o] == _GARBAGE:
                    finding("spill_read",
                            f"step {s}: cell {c} candidate {k} reads "
                            f"operand {o}, which holds a spilled "
                            f"(clobbered) value not yet rewritten",
                            cell=c, candidate=k, operand=o, step=s)
        for c in clobbers_at[s]:
            state[c] = _GARBAGE
        for c in rewrites_at[s]:
            state[c] = _PRESET_STATE if c in dep.preset else _FINAL
        for c in finals_at[s]:
            state[c] = _FINAL

    for c in range(dep.cells):
        if state[c] == _GARBAGE:
            finding("corrupted_final",
                    f"cell {c} ends the schedule holding a spilled value "
                    "(clobbered, never rewritten)", cell=c)
        elif state[c] == _EMPTY:
            finding("never_written",
                    f"cell {c} is never written by the schedule", cell=c)
    return out


def verify_registry(device=None, sweep: bool = True) -> Tuple[List[Finding], dict]:
    """Run the hazard verifier over every registered family × probe × route
    that supports the probe on ``device`` (the card by default), as
    dispatch asks. Each route's ``schedule(spec, device)`` gives a model
    per launch geometry it may take there; with ``sweep``, the kernel
    routes add their hand-made small geometries
    (``repro_torch.kernels.schedule.sweep``). Also enforces the
    registration contract itself: every family exposes the
    ``schedule_model``/``probe_specs`` hooks, every backend a ``schedule``
    descriptor, and every route is exercised by at least one probe (a route
    whose ``supports()`` rejects every probe would otherwise pass
    vacuously)."""
    from repro_torch.dp import backends
    from repro_torch.dp.problem import FAMILIES
    from repro_torch.kernels import schedule as kernel_schedule

    device = backends.resolve_device(device)
    backends.ensure_registered()
    findings: List[Finding] = []
    verified: dict = {}
    schedules = swept = 0

    for name in backends.names():
        if backends.get(name).schedule is None:
            findings.append(Finding(
                check="missing_schedule", subject=name,
                message=f"backend {name!r} registers no schedule "
                        "descriptor"))
        else:
            verified[name] = 0

    for fam in sorted(FAMILIES):
        cls = FAMILIES[fam]
        if not (hasattr(cls, "schedule_model")
                and hasattr(cls, "probe_specs")):
            findings.append(Finding(
                check="family_missing_hooks", subject=fam,
                message=f"family {fam!r} lacks the schedule_model/"
                        "probe_specs hooks"))
            continue
        for spec in cls.probe_specs():
            spec.validate()
            dep = spec.schedule_model()
            for name in backends.names(fam):
                b = backends.get(name)
                if b.schedule is None or not b.supports(spec, device):
                    continue
                try:
                    models = tuple(b.schedule(spec, device))
                    extra = (kernel_schedule.sweep(name, spec)
                             if sweep and b.kernel else ())
                except Exception as e:  # noqa: BLE001 — report, don't crash
                    findings.append(Finding(
                        check="schedule_build_error", subject=name,
                        message=f"schedule({dep.label}) raised "
                                f"{type(e).__name__}: {e}",
                        probe=dep.label))
                    continue
                if not models:
                    findings.append(Finding(
                        check="schedule_build_error", subject=name,
                        message=f"schedule({dep.label}) gave no model",
                        probe=dep.label))
                for model in models + extra:
                    findings.extend(verify_schedule(dep, model, route=name))
                verified[name] += len(models)
                schedules += len(models)
                swept += len(extra)

    for name, count in sorted(verified.items()):
        if count == 0:
            findings.append(Finding(
                check="route_never_verified", subject=name,
                message=f"no probe instance exercises route {name!r} "
                        "(supports() rejected every family probe)"))

    stats = {"families": len(FAMILIES),
             "routes": len(verified),
             "routes_verified": dict(sorted(verified.items())),
             "schedules_verified": schedules,
             "sweep_schedules_verified": swept,
             "device": str(device)}
    return findings, stats


def verify_launches(device) -> Tuple[List[Finding], dict]:
    """Every launch shape the kernel wrappers recorded since
    ``repro_torch.kernels.schedule.forget_launches()``: the geometry that
    ran must equal the one the descriptors assume for that shape on
    ``device``, and keep the kernel's geometry rules (checked without
    simulating every cell, which path sizes make too slow)."""
    from repro_torch.kernels import schedule as kernel_schedule

    findings: List[Finding] = []
    checked = 0
    for name, shape, got in kernel_schedule.recorded_launches():
        want = kernel_schedule.launch_geometry(name, shape, device)
        label = f"{name}{shape}"
        if got != want:
            findings.append(Finding(
                check="geometry_mismatch", subject=name,
                message=f"{label}: launched with {got}, the descriptor "
                        f"assumes {want}", probe=label,
                detail={"launched": got, "descriptor": want}))
        resident = kernel_schedule.launch_resident(name, shape, got, device)
        for inv, ok, detail in kernel_schedule.launch_invariants(name, shape, got,
                                                                 resident):
            if not ok:
                findings.append(Finding(
                    check="invariant_violated", subject=name,
                    message=f"{inv}: {detail}", probe=label,
                    detail={"invariant": inv}))
        checked += 1
    return findings, {"launch_shapes_checked": checked}
