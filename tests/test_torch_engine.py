"""The port's ``DPEngine`` against ``repro.dp``'s on the CPU.

Mixed traffic through both engines with feedback off gives the same
buckets, drains, routes, answers (bit-equal: every zoo problem reduces by
min or max), decoded solutions and ``stats``. The online-feedback
scenarios of ``tests/test_dp_engine_feedback.py`` run on the port with the
same synthetic observations fed into both calibration tables, and route
the same way.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import dp as jdp  # noqa: E402
from repro.dp import autotune as jautotune  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.dp import backends as tbackends  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Each test starts from empty calibration tables on both sides (the
    reference's is reset by ``tests/conftest.py``)."""
    tautotune.reset()
    yield
    tautotune.reset()


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _mcm_kw(rng, n):
    return {"dims": rng.integers(1, 20, size=n + 1).astype(np.float64)}


def _traffic(tag: str, count: int):
    """``count`` requests over all thirteen problems at three small sizes,
    with repeats (dedup) and reconstruct requests where decodable."""
    rng = _rng(tag)
    names = sorted(tdp.problem_names())
    pool = []
    for i in range(count):
        if pool and i % 5 == 4:
            pool.append(pool[int(rng.integers(len(pool)))])
            continue
        name = names[int(rng.integers(len(names)))]
        prob = tdp.get_problem(name)
        kw = prob.sample(rng, int(rng.choice([4, 6, 9])))
        recon = bool(rng.integers(2)) and prob.encode(**kw).supports_args()
        pool.append((name, kw, recon))
    return pool


def _same_response(got, want, label):
    assert got.backend == want.backend, label
    assert got.batch_size == want.batch_size, label
    assert got.deduped == want.deduped, label
    assert np.array_equal(np.float32(got.answer), np.float32(want.answer)), label
    if want.solution is None:
        assert got.solution is None, label
    else:
        np.testing.assert_array_equal(got.solution.table, want.solution.table,
                                      err_msg=label)
        np.testing.assert_array_equal(got.solution.args, want.solution.args,
                                      err_msg=label)
        assert got.solution.solution == want.solution.solution, label
        assert got.solution.source == want.solution.source, label


@pytest.mark.parametrize("tag,count,max_batch", [("mix-a", 30, 4),
                                                 ("mix-b", 30, 16),
                                                 ("mix-c", 12, 1)])
def test_mixed_traffic_matches_the_reference_engine(tag, count, max_batch):
    teng = tdp.DPEngine(max_batch=max_batch, feedback=False, device="cpu")
    jeng = jdp.DPEngine(max_batch=max_batch, feedback=False)
    rids = []
    for name, kw, recon in _traffic(tag, count):
        rids.append((teng.submit(name, reconstruct=recon, **kw),
                     jeng.submit(name, reconstruct=recon, **kw)))
    assert teng.bucket_sizes() == jeng.bucket_sizes()
    drains = 0
    while jeng.pending():
        got, want = teng.step(), jeng.step()
        assert [r.rid for r in got] == [r.rid for r in want]
        for g, w in zip(got, want):
            _same_response(g, w, f"{tag} rid {w.rid} ({w.problem})")
        drains += 1
    assert not teng.pending()
    assert teng.stats == jeng.stats
    assert teng.stats["device_batches"] == drains
    assert (teng.stats["dedup_hits"] > 0) == (max_batch > 1)


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.DPEngine()
    assert tdp.DPEngine(device="cpu").device == CPU


def test_rejects_bad_instances_and_reconstruct_at_submit():
    eng = tdp.DPEngine(device="cpu")
    with pytest.raises(ValueError):
        eng.submit("sdp", init=np.zeros(3, np.float32), offsets=(1, 2),
                   op="min", n=9)
    assert eng.pending() == 0


def test_bad_override_keeps_the_bucket():
    eng = tdp.DPEngine(max_batch=4, device="cpu")
    rng = _rng("override")
    for _ in range(3):
        eng.submit("mcm", **_mcm_kw(rng, 5))
    with pytest.raises(ValueError):
        eng.step(backend="grid_wavefront")
    assert eng.pending() == 3
    out = eng.run(backend="wavefront")
    assert {r.backend for r in out.values()} == {"wavefront"}


def test_answers_are_frozen_shared_buffers():
    eng = tdp.DPEngine(max_batch=4, device="cpu")
    kw = _mcm_kw(_rng("frozen"), 6)
    a = eng.submit("mcm", reconstruct=True, **kw)
    b = eng.submit("mcm", reconstruct=True, **kw)
    out = eng.run()
    assert out[b].deduped and out[a].solution is out[b].solution
    with pytest.raises(ValueError):
        out[a].solution.table[0] = 1.0


# ---------------------------------------------------------------------------
# Online feedback (the scenarios of tests/test_dp_engine_feedback.py)
# ---------------------------------------------------------------------------
def test_measured_route_beats_analytical_pick_on_next_drain():
    rng = _rng("fb-measured")
    spec = tdp.get_problem("mcm").encode(**_mcm_kw(rng, 7))
    batch_key = spec.shape_key() + tdp.routing.BATCH_SUFFIX
    assert tdp.routing.select_batch_backend(spec, device=CPU).name == "wavefront"
    for table in (tautotune.get_table(), jautotune.get_table()):
        table.observe("mcm_pipeline", batch_key, 0.01)
        table.observe("wavefront", batch_key, 50.0)
    kws = [_mcm_kw(rng, 7) for _ in range(3)]
    teng = tdp.DPEngine(max_batch=8, device="cpu")
    jeng = jdp.DPEngine(max_batch=8)
    for kw in kws:
        teng.submit("mcm", **kw)
        jeng.submit("mcm", **kw)
    got, want = teng.step(), jeng.step()
    assert [r.backend for r in got] == [r.backend for r in want]
    assert {r.backend for r in got} == {"mcm_pipeline"}
    for g, w in zip(got, want):
        assert np.float32(g.answer) == np.float32(w.answer)


def test_override_drain_is_observed_and_flips_next_dispatch():
    rng = _rng("fb-override")
    eng = tdp.DPEngine(max_batch=8, device="cpu")
    key = (tdp.get_problem("mcm").encode(**_mcm_kw(rng, 6)).shape_key()
           + tdp.routing.BATCH_SUFFIX)
    for _ in range(4):
        eng.submit("mcm", **_mcm_kw(rng, 6))
    eng.step(backend="mcm_pipeline")
    assert eng.stats["feedback_observations"] == 0
    assert not tautotune.has_measurement("mcm_pipeline", key, device=CPU)
    for _ in range(4):
        eng.submit("mcm", **_mcm_kw(rng, 6))
    eng.step(backend="mcm_pipeline")
    assert eng.stats["feedback_observations"] == 1
    assert tautotune.has_measurement("mcm_pipeline", key, device=CPU)
    for _ in range(2):
        eng.submit("mcm", **_mcm_kw(rng, 6))
    assert eng.step()[0].backend == "mcm_pipeline"


def test_cold_drain_not_recorded_then_warm_drain_is():
    rng = _rng("fb-cold")
    key = ("triangular", 19) + tdp.routing.BATCH_SUFFIX
    eng = tdp.DPEngine(max_batch=4, device="cpu")
    for _ in range(2):
        eng.submit("mcm", **_mcm_kw(rng, 19))
    eng.step()
    assert not tautotune.has_measurement("wavefront", key, device=CPU)
    for _ in range(2):
        eng.submit("mcm", **_mcm_kw(rng, 19))
    eng.step()
    assert tautotune.has_measurement("wavefront", key, device=CPU)
    assert eng.stats["feedback_observations"] == 1


def test_build_during_a_warmed_drain_is_not_recorded(monkeypatch):
    """A (route, shape, batch) this engine already ran still goes
    unrecorded when a kernel library was built or first loaded during the
    drain (on the card, nvcc's seconds)."""
    rng = _rng("fb-build")
    eng = tdp.DPEngine(max_batch=4, device="cpu")
    for _ in range(2):
        eng.submit("mcm", **_mcm_kw(rng, 21))
    eng.step()
    builds = iter(range(100))
    monkeypatch.setattr(tbackends, "build_count", lambda: next(builds))
    for _ in range(2):
        eng.submit("mcm", **_mcm_kw(rng, 21))
    eng.step()
    assert eng.stats["feedback_observations"] == 0
    assert not tautotune.has_measurement(
        "wavefront", ("triangular", 21) + tdp.routing.BATCH_SUFFIX, device=CPU)


def test_exploration_measures_alternate_routes_and_converges():
    rng = _rng("fb-explore")
    n = 9
    key = ("triangular", n) + tdp.routing.BATCH_SUFFIX
    eng = tdp.DPEngine(max_batch=4, explore_every=2, device="cpu")
    seen = set()
    for _ in range(8):
        for _ in range(2):
            eng.submit("mcm", **_mcm_kw(rng, n))
        seen.update(r.backend for r in eng.step())
    pool = [b.name for b in tdp.routing.batch_candidates(
        tdp.get_problem("mcm").encode(**_mcm_kw(rng, n)), device=CPU)]
    assert len(pool) >= 2 and len(seen) >= 2, seen
    assert eng.stats["explore_dispatches"] >= 1
    table = tautotune.get_table()
    measured = {name: table.lookup(name, key, platform="cpu") for name in pool}
    measured = {k: v.ms for k, v in measured.items() if v is not None}
    assert measured
    for _ in range(2):
        eng.submit("mcm", **_mcm_kw(rng, n))
    assert eng.step()[0].backend == min(measured,
                                        key=lambda k: (measured[k], k))


def test_exploration_picks_the_reference_route_from_equal_tables():
    """With the same synthetic entries in both tables, an exploring drain
    picks the same unmeasured route on both sides."""
    rng = _rng("fb-explore-ref")
    key = ("triangular", 8) + tdp.routing.BATCH_SUFFIX
    for table in (tautotune.get_table(), jautotune.get_table()):
        table.observe("wavefront", key, 1.0)
    teng = tdp.DPEngine(max_batch=2, explore_every=1, device="cpu")
    jeng = jdp.DPEngine(max_batch=2, explore_every=1)
    for _ in range(2):
        kw = _mcm_kw(rng, 8)
        teng.submit("mcm", **kw)
        jeng.submit("mcm", **kw)
    got, want = teng.step(), jeng.step()
    assert got[0].backend == want[0].backend != "wavefront"
    assert teng.stats["explore_dispatches"] == jeng.stats["explore_dispatches"] == 1


def test_feedback_disabled_keeps_table_empty():
    rng = _rng("fb-off")
    for _ in range(2):
        eng = tdp.DPEngine(max_batch=4, feedback=False, device="cpu")
        for _ in range(3):
            eng.submit("mcm", **_mcm_kw(rng, 8))
        eng.run()
        assert eng.stats["feedback_observations"] == 0
    assert len(tautotune.get_table()) == 0


def test_reconstruct_bucket_keeps_arg_capability_under_calibration():
    kw = _mcm_kw(_rng("fb-args"), 6)
    spec = tdp.get_problem("mcm").encode(**kw)
    for table in (tautotune.get_table(), jautotune.get_table()):
        for suffix in ((), tdp.routing.BATCH_SUFFIX,
                       tdp.routing.RECONSTRUCT_SUFFIX):
            table.observe("mcm_pipeline", spec.shape_key() + suffix, 0.001)
            table.observe("wavefront", spec.shape_key() + suffix, 99.0)
    got = tdp.DPEngine(max_batch=4, device="cpu")
    want = jdp.DPEngine(max_batch=4)
    a, b = (got.submit("mcm", reconstruct=True, **kw),
            want.submit("mcm", reconstruct=True, **kw))
    g, w = got.run()[a], want.run()[b]
    assert g.backend == w.backend
    assert g.backend != "mcm_pipeline"
    assert g.solution.source == w.solution.source == "device"
    assert g.solution.solution == w.solution.solution


def test_reconstruct_observations_keyed_separately_from_plain():
    rng = _rng("fb-regimes")
    plain = ("triangular", 23)
    eng = tdp.DPEngine(max_batch=4, device="cpu")
    for _ in range(2):
        for _ in range(2):
            eng.submit("mcm", reconstruct=True, **_mcm_kw(rng, 23))
        eng.run()
    assert tautotune.has_measurement(
        "wavefront", plain + tdp.routing.RECONSTRUCT_SUFFIX, device=CPU)
    assert not tautotune.has_measurement("wavefront", plain, device=CPU)
    assert not tautotune.has_measurement(
        "wavefront", plain + tdp.routing.BATCH_SUFFIX, device=CPU)


def test_route_state_lru_eviction_rewarms_instead_of_recording_cold(
        monkeypatch):
    import repro_torch.dp.engine as engine_mod

    monkeypatch.setattr(engine_mod, "_ROUTE_STATE_MAX", 2)
    rng = _rng("fb-lru")
    eng = tdp.DPEngine(max_batch=4, explore_every=0, device="cpu")

    def drain(n):
        for _ in range(2):
            eng.submit("mcm", **_mcm_kw(rng, n))
        eng.step()

    drain(11)
    drain(11)
    assert eng.stats["feedback_observations"] == 1
    drain(12)
    drain(13)
    assert len(eng._warmed) <= 2 and len(eng._drains) <= 2
    drain(11)
    assert eng.stats["feedback_observations"] == 1
    drain(11)
    assert eng.stats["feedback_observations"] == 2


def test_ema_fold_tracks_latest_observations():
    key = ("triangular", 33)
    for ms in (1.0, 2.0):
        tautotune.get_table().observe("wavefront", key, ms, platform="cpu")
        jautotune.get_table().observe("wavefront", key, ms)
    got = tautotune.get_table().lookup("wavefront", key, platform="cpu")
    want = jautotune.get_table().lookup("wavefront", key)
    assert got.ms == want.ms == pytest.approx(0.7 * 1.0 + 0.3 * 2.0)
    assert (got.count, got.source) == (want.count, want.source) == (2, "online")


# ---------------------------------------------------------------------------
# The batched traceback walk (the families' traceback_program hooks)
# ---------------------------------------------------------------------------
PROBLEMS = ("sdp", "edit_distance", "lcs", "viterbi", "unbounded_knapsack",
            "mcm", "optimal_bst", "polygon_triangulation", "needleman_wunsch",
            "gotoh", "cky", "edit_distance_grid", "lcs_grid")


def _fields(path):
    return {f: np.asarray(getattr(path, f))
            for f in ("cells", "lanes", "nodes", "stop") if hasattr(path, f)}


@pytest.mark.parametrize("name", PROBLEMS)
def test_bucket_walk_equals_host_walks_and_the_reference(name):
    """One walk of a same-shape bucket on the device gives each instance's
    host walk, and ``repro``'s batched walk of the same args."""
    from repro.dp import reconstruct as jrec
    from repro_torch.dp import reconstruct as trec

    tprob, jprob = tdp.get_problem(name), jdp.get_problem(name)
    rng = _rng(f"walk/{name}")
    kw0 = tprob.sample(rng, 10)
    kws = [kw0]
    while len(kws) < 3:                 # same shape, other content
        kw = tprob.sample(rng, 10)
        if tprob.encode(**kw).shape_key() == tprob.encode(**kw0).shape_key():
            kws.append(kw)
    specs = [tprob.encode(**kw) for kw in kws]
    route = tdp.routing.resolve_backend(specs[0], reconstruct=True, device="cpu")
    tables, args = route.batch_run_with_args(specs, CPU)
    starts = ([trec.start_cell(tprob, t, s) for t, s in zip(tables, specs)]
              if specs[0].uses_start else None)
    paths = trec.traceback_batch(args, specs[0], starts)
    argss = list(args.numpy())
    jpaths = jrec.traceback_batch(argss, jprob.encode(**kw0), starts)
    for b, (spec, args) in enumerate(zip(specs, argss)):
        host = spec.traceback_host(args, starts[b] if starts else -1)
        for f, want in _fields(host).items():
            np.testing.assert_array_equal(_fields(paths[b])[f], want, err_msg=f)
            np.testing.assert_array_equal(_fields(jpaths[b])[f], want, err_msg=f)


@pytest.mark.parametrize("n,starts", [(4000, (3999, 2500, 3, 17)), (9, (8, 0, 1, 2))])
def test_long_chain_walks_equal_the_host_walks(n, starts):
    """Random lane tables: walks of up to ~n steps (many doubling rounds),
    walks that end at once, and a bucket whose walks end at different
    rounds, against the per-instance host walk."""
    from repro_torch.dp import reconstruct as trec

    rng = _rng(f"chain/{n}")
    offsets = (5, 3, 1)
    spec = tdp.LinearSpec(offsets=offsets, op="min", n=n,
                          init=np.zeros(5, np.float32))
    args = rng.integers(0, 3, (4, n)).astype(np.int32)
    paths = trec.traceback_batch(torch.from_numpy(args), spec, list(starts))
    for b, a in enumerate(args):
        host = spec.traceback_host(a, starts[b])
        for f, want in _fields(host).items():
            np.testing.assert_array_equal(_fields(paths[b])[f], want, err_msg=f)


@pytest.mark.parametrize("n", [2, 3, 47])
def test_random_split_trees_walk_in_preorder(n):
    """Random best-split tables (deep, lopsided trees among them) walk to
    the host walk's preorder."""
    from repro_torch.dp import reconstruct as trec
    from repro_torch.core.mcm import lin_index, num_cells

    rng = _rng(f"tree/{n}")
    spec = tdp.TriangularSpec(n=n, weights=np.zeros((num_cells(n), max(n - 1, 1)),
                                                    np.float32))
    args = np.zeros((3, num_cells(n)), np.int32)
    for d in range(1, n):
        c = lin_index(np.arange(n - d), d, n)
        args[0, c] = rng.integers(0, d, n - d)
        args[1, c] = 0                           # every split leftmost
        args[2, c] = d - 1                       # every split rightmost
    paths = trec.traceback_batch(torch.from_numpy(args), spec)
    for b, a in enumerate(args):
        np.testing.assert_array_equal(paths[b].nodes, spec.traceback_host(a).nodes)
