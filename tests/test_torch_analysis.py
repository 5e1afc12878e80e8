"""The port's static schedule gate (``repro_torch.analysis``) on the CPU.

Four layers, beside ``tests/test_repro_analysis.py``'s three:

  1. hazard fixtures — schedules that are known-bad by construction (the
     paper's Fig.-8 slot order, a K3 ring one slot short, a clobber after
     finalization, a grid larger than the card keeps resident), flagged
     with the same findings as ``repro.analysis`` where both apply;
  2. acceptance — every route × probe verifies clean on the CPU, with the
     kernel routes' hand-made geometries, and ``run_all`` is clean;
  3. the Hopper descriptors — clean over a sweep of small plans, and each
     kernel's mutation flagged (a near lane folded with the far fold, a
     ring one slot short, a dropped barrier, splits folded ahead of a
     barrier, reversed tickets, a dropped flag wait);
  4. the linter, the extension proofs and the CLI.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import verify_extension as ref_verify_extension  # noqa: E402
from repro.analysis import verify_extensions as ref_verify_extensions  # noqa: E402
from repro.analysis.verifier import verify_schedule as ref_verify_schedule  # noqa: E402
from repro.core import mcm as ref_mcm  # noqa: E402
from repro.dp import schedule as ref_schedule  # noqa: E402
from repro.dp.problem import TriangularSpec as RefTriangularSpec  # noqa: E402

from repro_torch.analysis import run_all  # noqa: E402
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.analysis.extension import verify_extension, verify_extensions  # noqa: E402
from repro_torch.analysis.linter import check_no_knobs, check_platform_key  # noqa: E402
from repro_torch.analysis.verifier import verify_registry, verify_schedule  # noqa: E402
from repro_torch.core.mcm import lin_index, mcm_weight_fn, num_cells, weight_table  # noqa: E402
from repro_torch.dp import backends  # noqa: E402
from repro_torch.dp import schedule as S  # noqa: E402
from repro_torch.dp.problem import FAMILIES, GridSpec, LinearSpec, TriangularSpec  # noqa: E402
from repro_torch.kernels import grid_pipeline, mcm_pipeline, mcm_tiled, sdp_walk  # noqa: E402
from repro_torch.kernels import schedule as K  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KERNEL_ROUTES = ("kernel_blocked", "kernel_tiled", "kernel_wavefront",
                 "kernel_tiled_wavefront", "kernel_grid")


def _mcm_spec(n: int) -> TriangularSpec:
    dims = np.arange(1.0, n + 2.0)
    return TriangularSpec(n=n, weights=weight_table(n, mcm_weight_fn(dims)), dims=dims)


def _ref_mcm_spec(n: int) -> RefTriangularSpec:
    dims = np.arange(1.0, n + 2.0)
    return RefTriangularSpec(
        n=n, weights=ref_mcm.weight_table(n, ref_mcm.mcm_weight_fn(dims)), dims=dims)


def _linear(offsets, n, op="min", weighted=False) -> LinearSpec:
    return LinearSpec(offsets=offsets, op=op, n=n,
                      init=np.zeros(offsets[0], np.float32),
                      weights=np.ones((n, len(offsets)), np.float32) if weighted else None)


def _antidiag(rows, cols, moves, planes=1, op="min") -> GridSpec:
    mask = np.zeros((planes, rows, cols), bool)
    mask[:, 0, :] = mask[:, :, 0] = True
    return GridSpec(rows=rows, cols=cols, op=op, schedule="antidiag", planes=planes,
                    moves=moves, weights=np.zeros((len(moves), rows, cols), np.float32),
                    init=np.zeros((planes, rows, cols), np.float32), init_mask=mask)


#: instances beyond the probes where the hand-made plans bite: offsets far
#: at some chunk positions and near at others (5, 3, 1), weighted, all-far
#: offsets for a cluster of two (8, 6), add; a 5 × 7 grid with a move that
#: reaches two rows up (a halo wider than a tile of side 1)
EXTRA_SPECS = {
    "linear": [_linear((5, 3, 1), 16), _linear((5, 3, 1), 16, weighted=True),
               _linear((8, 6), 24, op="max"), _linear((3, 1), 11, op="add")],
    "triangular": [_mcm_spec(8)],
    "grid": [_antidiag(5, 7, ((0, 0, 1, 0), (0, 0, 0, 1), (0, 0, 2, 1)))],
}


def _specs(route: str) -> list:
    family = backends.get(route).geometry
    return [s for s in list(FAMILIES[family].probe_specs()) + EXTRA_SPECS[family]
            if backends.get(route).supports(s, CPU)]


def _checks(spec, model) -> set:
    return {f.check for f in verify_schedule(spec.schedule_model(), model)}


# ---------------------------------------------------------------------------
# 1. Hazard fixtures
# ---------------------------------------------------------------------------
def _hazards(findings) -> set:
    return {(f.check, f.detail["cell"], f.detail["candidate"], f.detail["operand"],
             f.detail["read_step"], f.detail["finalize_step"]) for f in findings}


@pytest.mark.parametrize("n", [4, 5, 6])
def test_paper_slot_order_is_rejected(n):
    """The paper's declaration-order slot assignment reads splits that are
    not yet finalized: the same findings as ``repro.analysis``."""
    ours = verify_schedule(_mcm_spec(n).schedule_model(),
                           S.mcm_pipeline_schedule(_mcm_spec(n), order="paper"),
                           route="mcm_pipeline[paper]")
    theirs = ref_verify_schedule(
        _ref_mcm_spec(n).schedule_model(),
        ref_schedule.mcm_pipeline_schedule(_ref_mcm_spec(n), order="paper"),
        route="mcm_pipeline[paper]")
    assert ours, "paper-order schedule passed the verifier"
    assert {f.check for f in ours} == {"read_before_finalize"}
    assert _hazards(ours) == _hazards(theirs)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_safe_slot_order_is_accepted(n):
    spec = _mcm_spec(n)
    assert verify_schedule(spec.schedule_model(),
                           S.mcm_pipeline_schedule(spec, order="safe"),
                           route="mcm_pipeline") == []


def _k3_geometry(spec, Q: int, **override) -> dict:
    offsets = tuple(spec.offsets)
    R = -(-(offsets[0] + Q) // 32) * 32
    p = sdp_walk.WalkPlan(Q=Q, R=R, near=sdp_walk.near_mode(offsets, Q),
                          stage=spec.weights is not None)
    return dict(K.walk_geometry(offsets, spec.op, p, 1), **override)


@pytest.mark.parametrize("Q", [1, 2, 4])
def test_ring_one_slot_short_is_flagged(Q):
    """K3's ring must hold a chunk's reads (``a_1`` back) and its writes
    apart: ``R = a_1 + Q - 1`` trips the geometry rule, and where every
    lane is far (Q = 1 here) the read-by-read check finds the slot taken
    while it is read."""
    spec = _linear((5, 3, 1), 16)
    model = K.walk_schedule(spec, "kernel_tiled", _k3_geometry(spec, Q, R=5 + Q - 1))
    findings = verify_schedule(spec.schedule_model(), model, route="fixture")
    assert {f.check for f in findings} == {"invariant_violated"}
    names = {f.detail["invariant"] for f in findings}
    assert "ring_holds_window" in names
    if Q == 1:
        assert "ring_slot_not_reused" in names


@pytest.mark.parametrize("offsets,weighted", [
    (tuple(range(2048, 1024, -1)), False), ((2, 1), False), ((1,), False),
    ((3, 2, 1), True), (tuple(range(64, 0, -1)), True), ((9000, 1), False)])
def test_healthy_walk_plans_pass(offsets, weighted):
    """The launchers' own plans, at the path's offsets too, keep every walk
    rule at every cluster size they may take."""
    for ring in (False, True):
        p = sdp_walk.plan(offsets, weighted, ring=ring)
        for C in (1,) + sdp_walk.cluster_candidates(p):
            for op in ("min", "add"):
                g = K.walk_geometry(offsets, op, p, C)
                bad = [i for i in K.walk_invariants(offsets, op, g, ring) if not i[1]]
                assert not bad, (offsets, ring, C, op, bad)


def _late_clobber(spec, model):
    dep = spec.schedule_model()
    for c in range(dep.cells):
        for k, cand in enumerate(dep.candidates[c]):
            for o in cand:
                if model.finalize[o] >= 0 and model.consume[c][k] >= model.finalize[o] + 2:
                    return model.finalize[o] + 1, o
    return None


def test_spill_lane_clobbered_after_finalize_is_flagged():
    """A garbage write between an operand's finalize and its read is seen
    by the simulation. K2's descriptor itself writes no spill lanes (the
    kernel guards every write by ``q < cd``) and is clean."""
    spec = _mcm_spec(5)
    m = S.triangular_wavefront_schedule(spec)
    late = _late_clobber(spec, m)
    assert late is not None
    bad = dataclasses.replace(m, clobbers=(late,))
    assert "spill_read" in _checks(spec, bad)
    for g in K._candidates("mcm_pipeline", (5, 1)):
        k2 = K.mcm_cluster_schedule(spec, g)
        assert k2.clobbers == () and _checks(spec, k2) == set()


def test_unrewritten_spill_surviving_to_end_is_flagged():
    spec = _mcm_spec(4)
    m = S.triangular_wavefront_schedule(spec)
    c0 = next(c for c in range(num_cells(4)) if 0 <= m.finalize[c] < m.steps - 1)
    bad = dataclasses.replace(m, clobbers=((m.steps - 1, c0),))
    assert "corrupted_final" in _checks(spec, bad)


def test_co_residency_rule_fires_when_the_grid_outgrows_the_card():
    """K4 and K6's cooperative grids wait at grid barriers or ready flags:
    a CTA that never starts hangs them. The rule holds at ``G ≤
    resident`` and fires past it."""
    t, c = _mcm_spec(6), FAMILIES["grid"].probe_specs()
    g4 = {"G": 3, "smem": mcm_tiled.spread_smem_bytes(6, False)}
    gs = {"G": 3, "smem": grid_pipeline.spandiag_smem_bytes(1, 1)}
    plan = grid_pipeline.tile_plan(1, c[0].moves, False)
    ga = {"G": 1, "tiles": 1, **dataclasses.asdict(plan)}
    for spec, build in ((t, lambda r: K.mcm_grid_schedule(t, g4, resident=r)),
                        (c[2], lambda r: K.spandiag_schedule(c[2], gs, resident=r)),
                        (c[0], lambda r: K.antidiag_schedule(c[0], ga, resident=r))):
        ok, short = build(3), build(0)
        assert _checks(spec, ok) == set()
        findings = verify_schedule(spec.schedule_model(), short)
        assert [f.detail["invariant"] for f in findings] == ["grid_co_resident"]


# ---------------------------------------------------------------------------
# 2. Acceptance: the shipped registry is clean
# ---------------------------------------------------------------------------
def test_verifier_accepts_every_registered_route():
    findings, stats = verify_registry(CPU)
    assert findings == [], [f"{f.check}:{f.subject}:{f.message}" for f in findings]
    assert stats["families"] == len(FAMILIES) == 3
    assert stats["routes"] == len(backends.names()) == 14
    assert set(stats["routes_verified"]) == set(backends.names())
    assert stats["schedules_verified"] >= stats["routes"]
    assert stats["sweep_schedules_verified"] > 0


def test_run_all_gate_is_clean():
    findings, stats = run_all(CPU)
    assert findings == [], [f"{f.check}:{f.subject}:{f.message}" for f in findings]
    assert stats["extensions_verified"] > 0
    assert stats["files_scanned"] > 0


def test_every_route_registers_a_schedule_exercised_by_a_probe():
    """No route passes vacuously: each registered route has a schedule and
    is exercised by at least one probe of its family."""
    for name in backends.names():
        b = backends.get(name)
        assert b.schedule is not None, name
        probes = [s for s in FAMILIES[b.geometry].probe_specs() if b.supports(s, CPU)]
        assert probes, f"no probe exercises route {name!r}"
        for s in probes:
            models = b.schedule(s, CPU)
            assert models and all(len(m.finalize) == s.schedule_model().cells
                                  for m in models)


# ---------------------------------------------------------------------------
# 3. The Hopper descriptors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", KERNEL_ROUTES)
def test_kernel_descriptors_clean_over_the_plan_sweep(route):
    """Every kernel route's models — the launcher's geometries with each
    candidate cluster size or grid, and the hand-made small plans — verify
    clean on the probes and the extra instances; the sweep covers every
    near mode, a cluster split and grids smaller than the tile count."""
    kinds = set()
    for spec in _specs(route):
        for model in K.schedules(route, spec, CPU) + K.sweep(route, spec):
            assert _checks(spec, model) == set(), (route, model.kind, model.notes)
            kinds.add(model.kind)
    if route in K.WALK_LIBRARIES:
        assert {f"chunk_walk[near={m}, C=1]" for m in (0, 1, 2)} <= kinds
        assert "chunk_walk[near=0, C=2]" in kinds
    if route == "kernel_grid":
        assert {"tile_wavefront[T=1, G=1]", "tile_wavefront[T=2, G=2]"} <= kinds


def test_walk_folds_far_lanes_by_position():
    """Offset 3 at Q = 4 is far at chunk positions 0..2 and near at 3: the
    model reads it at the far step there and in the near walk here. The
    coarser rule (far iff ``a ≥ Q``) leaves lanes the kernel folds in
    neither place, and the gate says so."""
    spec = _linear((5, 3, 1), 16)
    g = _k3_geometry(spec, 4)
    m = K.walk_schedule(spec, "kernel_blocked", dict(g, R=0))
    base = 5 * 0                              # chunk 0 starts at step 0
    for p in range(4):
        assert m.consume[5 + p][1] == (base if p < 3 else base + 1 + p)
    coarse = K.walk_schedule(spec, "kernel_blocked", dict(g, R=0),
                             far=lambda a, p: a >= 4)
    findings = verify_schedule(spec.schedule_model(), coarse)
    assert {f.detail.get("invariant") for f in findings} == {"every_lane_folded"}


def test_k4_folds_ahead_only_the_splits_that_read_no_cell_of_the_last_diagonal():
    """Queue 2's K4 plan: fold diagonal d+1's splits that read no cell of
    diagonal d before the grid barrier. Those splits (0 < e < d) pass;
    folding all of them reads diagonal d before its barrier."""
    for n in (4, 5, 6, 8):
        spec = _mcm_spec(n)
        for g in K._candidates("mcm_tiled", (n,)):
            legal = K.mcm_grid_schedule(spec, g, ahead=K.independent_splits)
            assert _checks(spec, legal) == set()
            assert any(legal.consume[c][e] < legal.finalize[c]
                       for c in range(num_cells(n)) for e in range(len(legal.consume[c])))
            assert _checks(spec, K.mcm_grid_schedule(spec, g, ahead=lambda d, e: True)) \
                == {"read_before_finalize"}


def _walk_mutation(route):
    spec = _linear((5, 3, 1), 16)
    g = _k3_geometry(spec, 4)
    if route == "kernel_blocked":
        g = dict(g, R=0)
    return spec, K.walk_schedule(spec, route, g, far=lambda a, p: a >= p)


def _antidiag_geometry(spec, T, G, **override):
    plan = grid_pipeline.tile_plan_at(spec.planes, spec.moves, False, T)
    tiles = -(-spec.rows // T) * -(-spec.cols // T)
    return dict({"G": G, "tiles": tiles, **dataclasses.asdict(plan)}, **override)


def _reversed(b, I, J):
    return (-(I + J), b, I)


MUTATIONS = {
    "K1: a near lane folded with the far fold":
        lambda: _walk_mutation("kernel_blocked"),
    "K3: a near lane folded with the far fold":
        lambda: _walk_mutation("kernel_tiled"),
    "K3: a ring one slot short":
        lambda: (lambda s: (s, K.walk_schedule(s, "kernel_tiled",
                                               _k3_geometry(s, 1, R=5))))(
            _linear((5, 3, 1), 16)),
    "K2: a cluster barrier dropped":
        lambda: (_mcm_spec(6), K.mcm_cluster_schedule(
            _mcm_spec(6), K._candidates("mcm_pipeline", (6, 1))[1], dropped=(2,))),
    "K4: all of diagonal d+1's splits folded before the barrier":
        lambda: (_mcm_spec(6), K.mcm_grid_schedule(
            _mcm_spec(6), K._candidates("mcm_tiled", (6,))[0], ahead=lambda d, e: True)),
    "K6 antidiag: reversed tickets":
        lambda: (lambda s: (s, K.antidiag_schedule(s, _antidiag_geometry(s, 1, 2),
                                                   ticket=_reversed)))(
            FAMILIES["grid"].probe_specs()[0]),
    "K6 antidiag: reversed tickets, a CTA per tile":
        lambda: (lambda s: (s, K.antidiag_schedule(s, _antidiag_geometry(s, 1, 12),
                                                   ticket=_reversed)))(
            FAMILIES["grid"].probe_specs()[0]),
    "K6 antidiag: the wait on the left tile dropped":
        lambda: (lambda s: (s, K.antidiag_schedule(
            s, _antidiag_geometry(s, 2, 4),
            waits=lambda t: [(t[0], t[1] - 1, t[2])] if t[1] else [])))(
            FAMILIES["grid"].probe_specs()[0]),
    "K6 antidiag: a halo other than the plan's":
        lambda: (lambda s: (s, K.antidiag_schedule(s, _antidiag_geometry(s, 1, 2, HI=2))))(
            FAMILIES["grid"].probe_specs()[0]),
    "K6 spandiag: a grid barrier dropped":
        lambda: (lambda s: (s, K.spandiag_schedule(
            s, K._candidates("grid_pipeline_spandiag", (s.op, 2, 4, 3))[1],
            dropped=(1,))))(FAMILIES["grid"].probe_specs()[3]),
}
EXPECTED = {
    "K3: a ring one slot short": {"invariant_violated"},
    "K6 antidiag: reversed tickets": {"invariant_violated", "never_finalized"},
    "K6 antidiag: reversed tickets, a CTA per tile": {"invariant_violated"},
    "K6 antidiag: a halo other than the plan's": {"invariant_violated"},
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_each_kernel_mutation_is_flagged(mutation):
    spec, model = MUTATIONS[mutation]()
    assert _checks(spec, model) == EXPECTED.get(mutation, {"read_before_finalize"})


# ---------------------------------------------------------------------------
# 4. Linter, extension proofs, CLI
# ---------------------------------------------------------------------------
def test_linter_flags_a_planted_environment_read(tmp_path):
    (tmp_path / "rogue.py").write_text(
        'import os\n'
        'chunk = os.' + 'environ["REPRO' + '_X"]\n'
        'mode = os.get' + 'env("HOME")\n'
        'fine = "environment"\n')
    findings, scanned = check_no_knobs(str(tmp_path))
    assert scanned == 1
    assert [(f.check, f.detail["line"]) for f in findings] == [
        ("environment_read", 2), ("environment_read", 3)]


def test_linter_is_quiet_on_the_real_tree():
    findings, scanned = check_no_knobs(None)
    assert findings == [], [f.message for f in findings]
    assert scanned > 60


def test_platform_key_tells_the_cpu_from_the_card():
    assert check_platform_key(CPU) == []


def test_extension_proofs_are_clean_and_as_many_as_the_reference():
    findings, stats = verify_extensions()
    ref_findings, ref_stats = ref_verify_extensions()
    assert findings == [] and ref_findings == []
    assert stats == ref_stats


def test_undersized_triangular_resume_state_is_rejected_as_by_the_reference():
    """The "last two diagonals" resume state for triangular charts misses
    operands across the whole prefix: the same witnesses as the reference."""
    spec, L = _mcm_spec(6), 4
    ref_spec = _ref_mcm_spec(6)
    pmap = np.asarray(spec.prefix_cell_map(spec.split_spec(L)))
    rows = [c for d in (L - 2, L - 1)
            for c in range(lin_index(0, d, L), lin_index(0, d, L) + L - d)]
    ours = verify_extension(spec, L, saved_cells=pmap[rows])
    theirs = ref_verify_extension(ref_spec, L, saved_cells=pmap[rows])
    assert {f.check for f in ours} == {"insufficient_resume_state"}
    assert [(f.check, f.message, f.detail) for f in ours] == \
        [(f.check, f.message, f.detail) for f in theirs]
    assert verify_extension(spec, L) == []
    ext_cell = min(set(range(num_cells(6))) - set(pmap.tolist()))
    assert [f.check for f in verify_extension(spec, L, saved_cells=list(pmap) + [ext_cell])] \
        == ["saved_state_outside_prefix"]


def test_cli_exit_codes_and_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert analysis_main(["--gate", "--device", "cpu", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["version"] == 1 and rep["ok"] is True and rep["findings"] == []
    assert rep["stats"]["routes"] == 14
    assert sorted(rep["stats"]["routes_verified"]) == backends.names()
    assert rep["stats"]["schedules_verified"] >= rep["stats"]["routes"]
    assert "OK: no findings" in capsys.readouterr().out


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis_main(["--gate"])


def test_gate_module_exits_zero_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--gate",
                          "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "14 routes" in out.stdout and "OK: no findings" in out.stdout
