"""The port's sharding slice against the JAX reference on the CPU, in one
process: the sharding rules, the ``("shard", ndev)`` regime keys,
``ShardedDPEngine`` over meshes of ``cpu`` slots (bit-equal to
``repro.dp``'s unsharded engine for every zoo problem), ``DPService``'s
mesh, ``pipeline_apply``, ``compressed_psum``, elastic re-meshing,
``place``/``gather`` and ``shard_batch``.

The reference tests its sharded engine under a forced multi-device XLA
process; the port's stand-in is a mesh that lists the CPU several times,
whose slots solve their shards one after the other. Sharded answers are
bit-equal to the unsharded engine's by the reference's own contract
(``tests/test_dp_sharding.py``), so the port's sharded drains are held
against the reference's unsharded ``DPEngine``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import dp as jdp  # noqa: E402
from repro.core.planner import partition_stages as jpartition  # noqa: E402
from repro.optim.grad_compress import compressed_psum as jcompressed_psum  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.core.schedule import SkewedSchedule  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.dp import backends as tbackends  # noqa: E402
from repro_torch.dp import sharding as tsharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim.grad_compress import compressed_psum  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402
from repro_torch.runtime.pipeline_parallel import pipeline_apply, stage_boundaries  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_tables():
    tautotune.reset()
    yield
    tautotune.reset()


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _mesh(ndev: int, axis: str = tsharding.BATCH_AXIS) -> rt.Mesh:
    return tsharding.default_mesh(axis, devices=["cpu"] * ndev)


def _mcm_kw(rng, n):
    return {"dims": rng.integers(1, 20, size=n + 1).astype(np.float64)}


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
AXES = ["vocab", "embed", "heads", "kv", "ffn", "experts", "expert_embed",
        "expert_ffn", "ssm_inner", "act_batch", "act_seq", "act_seq_attn",
        "kv_seq", "act_heads", "act_embed", "act_ffn", "act_experts",
        "act_moe_cap", "layers", None, "unknown"]
SHAPES = [(40, 1536, 512), (1, 32768, 8, 128), (24, 5120), (16, 16), (7,),
          (151936, 5120), (8, 2048, 40, 128), (3, 1, 1)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("sizes", [(16, 16), (1, 1), (2, 8), (4, 1), (1, 40), (3, 5)])
def test_spec_for_equals_the_reference(multi_pod, sizes):
    """Every shape of the grid with logical axes drawn from the rules'
    names (and one no rule knows), on single- and multi-pod meshes: the
    port's spec equals the reference's PartitionSpec entry for entry."""
    axis_sizes = {"data": sizes[0], "model": sizes[1], "pod": 2}
    assert rt.make_rules(multi_pod) == jsharding.make_rules(multi_pod)
    rules = rt.make_rules(multi_pod)
    rng = _rng(f"spec-{multi_pod}-{sizes}")
    checked = 0
    for shape in SHAPES:
        for _ in range(12):
            axes = [AXES[int(i)] for i in rng.integers(len(AXES), size=len(shape))]
            want = jsharding.spec_for(shape, axes, jsharding.make_rules(multi_pod), axis_sizes)
            got = rt.spec_for(shape, axes, rules, axis_sizes)
            assert got == tuple(want), (shape, axes)
            checked += 1
    assert checked == 12 * len(SHAPES)


def test_spec_for_fallbacks():
    """granite-moe's 40 experts fall back to the expert FFN dim; a batch-1
    cache shards its sequence over both axes; a rank mismatch raises."""
    rules, sizes = rt.make_rules(), {"data": 16, "model": 16}
    assert rt.spec_for((40, 1536, 512), ("experts", "expert_embed", "expert_ffn"),
                       rules, sizes) == (None, "data", "model")
    assert rt.spec_for((1, 32768, 8, 128), ("act_batch", "kv_seq", "kv", None),
                       rules, sizes) == (None, ("data", "model"), None, None)
    with pytest.raises(ValueError):
        rt.spec_for((4, 4), ("embed",), rules, sizes)


# ---------------------------------------------------------------------------
# Regime plumbing and the context
# ---------------------------------------------------------------------------
def test_shard_regime_marker_recognized():
    key = ("triangular", 9)
    marked = key + (("shard", 8),)
    for b in (tbackends, jdp.backends):
        assert b.is_regime_marker(("shard", 8))
        assert b.is_regime_marker(("shard", 8, "reconstruct"))
        assert not b.is_regime_marker(("triangular", 9))
        assert b.split_shape_key(marked) == (key, ("shard", 8))
        assert b.shape_key_size(marked) == 9


@pytest.mark.parametrize("a,b,want", [
    (("triangular", 9, ("shard", 8)), ("triangular", 9, "batch"), None),
    (("triangular", 9, ("shard", 8)), ("triangular", 9), None),
    (("triangular", 9, ("shard", 8)), ("triangular", 9, ("shard", 4)), None),
    (("triangular", 9, ("shard", 8)), ("triangular", 9, ("shard", 8, "reconstruct")), None),
    (("triangular", 12, ("shard", 8)), ("triangular", 9, ("shard", 8)), 3.0),
])
def test_shard_regime_never_cross_matches(a, b, want):
    assert tbackends.shape_key_distance(a, b) == want
    assert jdp.backends.shape_key_distance(a, b) == want


def test_shard_regime_survives_json_roundtrip(tmp_path):
    t = tautotune.CalibrationTable()
    key = ("triangular", 9) + (("shard", 8),)
    t.record("wavefront", key, 1.25, platform="cpu")
    path = str(tmp_path / "calib.json")
    t.save(path)
    entry = tautotune.CalibrationTable.load(path).lookup("wavefront", key, platform="cpu")
    assert entry is not None and entry.ms == pytest.approx(1.25)


def test_shard_context_pad_math_and_keys():
    ctx = tsharding.ShardContext(mesh=_mesh(1))
    assert ctx.pad(["a", "b", "c"]) == (["a", "b", "c"], 0)
    ctx4 = tsharding.ShardContext(mesh=_mesh(4))
    assert ctx4.pad(["a", "b", "c", "d", "e"]) == (["a", "b", "c", "d", "e", "e", "e", "e"], 3)
    assert ctx4.pad(["a", "b", "c", "d"]) == (["a", "b", "c", "d"], 0)
    assert ctx4.ndev == 4 and ctx4.home == CPU
    assert ctx4.regime() == (("shard", 4),)
    assert ctx4.regime(True) == (("shard", 4, "reconstruct"),)
    with pytest.raises(ValueError):
        tsharding.ShardContext(mesh=_mesh(2), axis="nope")


def test_shard_context_places_and_gathers_in_slot_order():
    """``place`` gives each slot its contiguous slice (ragged where the
    batch does not divide); ``wrap`` runs the call a slot and
    concatenates nested outputs in slot order."""
    ctx = tsharding.ShardContext(mesh=_mesh(3))
    host = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    placed = ctx.place(host)
    assert [p.shape[0] for p in placed] == [3, 2, 2]
    seen = []

    def call(x, w):
        seen.append((x.shape[0], w))
        return x * 2, (x.sum(1), x[:, :1])

    st, (s, first) = ctx.wrap(call)(placed, None)
    assert seen == [(3, None), (2, None), (2, None)]
    assert torch.equal(st, torch.from_numpy(host) * 2)
    assert torch.equal(s, torch.from_numpy(host).sum(1))
    assert torch.equal(first, torch.from_numpy(host)[:, :1])


def test_default_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tsharding.device_count() == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsharding.default_mesh()
    m = tsharding.default_mesh(devices=["cpu"] * 3)
    assert m.axis_names == ("shard",) and m.shape == {"shard": 3} and m.size == 3


# ---------------------------------------------------------------------------
# ShardedDPEngine against the reference's unsharded engine
# ---------------------------------------------------------------------------
def _zoo_traffic():
    """Per problem and reconstruct flag, three instances at size 8 (ragged
    against 4 and 3 slots, so padding runs), as the reference's sweep."""
    rng = np.random.default_rng(42)
    out = []
    for name in sorted(tdp.problem_names()):
        prob = tdp.get_problem(name)
        for reconstruct in (False, True):
            for _ in range(3):
                out.append((name, reconstruct, prob.sample(rng, 8)))
    return out


@pytest.fixture(scope="module")
def reference_zoo():
    """The reference's unsharded engine over the sweep: {index: response}."""
    traffic = _zoo_traffic()
    eng = jdp.DPEngine(max_batch=16, feedback=False)
    rids = [eng.submit(name, reconstruct=recon, **kw) for name, recon, kw in traffic]
    out = eng.run()
    return traffic, [out[r] for r in rids]


@pytest.fixture(scope="module")
def sharded_zoo(reference_zoo):
    """The port's sharded engine over 4 and 3 ``cpu`` slots on the same
    sweep: {ndev: (responses, stats, lanes of each drain)}."""
    traffic, _ = reference_zoo
    runs = {}
    for ndev in (4, 3):
        eng = tsharding.ShardedDPEngine(mesh=_mesh(ndev), max_batch=16, feedback=False)
        rids = [eng.submit(name, reconstruct=recon, **kw) for name, recon, kw in traffic]
        out, lanes = {}, []
        while eng.pending():
            drained = eng.step()
            lanes.append(len(drained))   # no duplicates in the sweep: lanes = batch
            out.update((r.rid, r) for r in drained)
        runs[ndev] = ([out[r] for r in rids], dict(eng.stats), lanes)
    return runs


@pytest.mark.parametrize("ndev", [4, 3])
@pytest.mark.parametrize("reconstruct", [False, True])
@pytest.mark.parametrize("name", sorted(jdp.problem_names()))
def test_sharded_answers_bit_equal_to_the_reference(reference_zoo, sharded_zoo,
                                                    name, reconstruct, ndev):
    """Values, tables, args and decoded solutions of a sharded drain equal
    the reference's unsharded engine's, bit for bit."""
    traffic, want = reference_zoo
    got, _, _ = sharded_zoo[ndev]
    idx = [i for i, (n, r, _) in enumerate(traffic) if n == name and r == reconstruct]
    assert len(idx) == 3
    for i in idx:
        g, w = got[i], want[i]
        assert np.array_equal(np.float32(g.answer), np.float32(w.answer)), (name, g.answer)
        assert (g.solution is None) == (w.solution is None)
        if w.solution is not None:
            np.testing.assert_array_equal(g.solution.table, w.solution.table)
            np.testing.assert_array_equal(g.solution.args, w.solution.args)
            assert g.solution.solution == w.solution.solution
            assert np.array_equal(np.float32(g.solution.value), np.float32(w.solution.value))


@pytest.mark.parametrize("ndev", [4, 3])
def test_sharded_sweep_counts_its_drains_and_pad_lanes(sharded_zoo, ndev):
    """Every drain of the sweep ran sharded (every zoo route the engine
    picks on the CPU has a batch path), and its pad lanes were counted:
    each drain's lanes rounded up to the mesh size."""
    responses, stats, lanes = sharded_zoo[ndev]
    assert stats["sharded_drains"] == stats["device_batches"] == len(lanes) > 0
    assert stats["completed"] == len(responses) == sum(lanes)
    assert stats["padded_lanes"] == sum(-b % ndev for b in lanes) > 0


def test_ragged_bucket_pads_to_the_mesh_and_strips_pad_lanes():
    rng = _rng("ragged")
    eng = tsharding.ShardedDPEngine(mesh=_mesh(4), max_batch=16, feedback=False)
    want = {}
    for _ in range(5):
        kw = _mcm_kw(rng, 7)
        want[eng.submit("mcm", **kw)] = jdp.get_problem("mcm").solve_reference(**kw)
    out = eng.run()
    assert len(out) == 5
    for rid, ref in want.items():
        assert out[rid].answer == pytest.approx(ref, rel=1e-4)
    assert eng.stats["padded_lanes"] == 3 and eng.stats["sharded_drains"] == 1


def test_sharded_observations_only_under_the_shard_regime():
    rng = _rng("observe")
    eng = tsharding.ShardedDPEngine(mesh=_mesh(4), max_batch=8, explore_every=0)
    for _ in range(2):                    # the second drain is warm: observed
        for _ in range(3):
            eng.submit("mcm", **_mcm_kw(rng, 9))
        eng.step()
    assert eng.stats["feedback_observations"] >= 1
    regimes = {tbackends.split_shape_key(key)[1]
               for (_, _, key), _ in tautotune.get_table().items()}
    assert regimes == {("shard", 4)}
    rep = tdp.routing_report(device=CPU)
    assert [s["regime"] for s in rep["shapes"]] == [("shard", 4)]


def test_loop_only_route_runs_unsharded_under_the_batch_regime():
    rng = _rng("loop")
    eng = tsharding.ShardedDPEngine(mesh=_mesh(4), max_batch=8)
    batch_key = None
    for _ in range(2):                    # warm the loop route, then observe
        for _ in range(2):
            kw = _mcm_kw(rng, 11)
            batch_key = (tdp.get_problem("mcm").encode(**kw).shape_key()
                         + tdp.routing.BATCH_SUFFIX)
            eng.submit("mcm", **kw)
        eng.step(backend="mcm_pipeline")
    assert eng.stats["sharded_drains"] == 0
    assert tautotune.has_measurement("mcm_pipeline", batch_key, device=CPU)


def test_single_slot_mesh_falls_back_to_plain_drains():
    rng = _rng("single")
    eng = tsharding.ShardedDPEngine(mesh=_mesh(1), max_batch=8)
    assert eng.ctx.ndev == 1 and eng.device == CPU
    want = {}
    for _ in range(3):
        kw = _mcm_kw(rng, 7)
        want[eng.submit("mcm", **kw)] = jdp.get_problem("mcm").solve_reference(**kw)
    out = eng.run()
    for rid, ref in want.items():
        assert out[rid].answer == pytest.approx(ref, rel=1e-4)
    assert eng.stats["sharded_drains"] == 0 and eng.stats["padded_lanes"] == 0
    regimes = {tbackends.split_shape_key(key)[1]
               for (_, _, key), _ in tautotune.get_table().items()}
    assert regimes <= {"batch"}


def test_sharded_drain_marks_its_report_and_counts():
    tdp.telemetry.configure(mode="spans")
    tdp.telemetry.REGISTRY.reset()
    try:
        rng = _rng("telemetry")
        eng = tsharding.ShardedDPEngine(mesh=_mesh(4), max_batch=8, feedback=False)
        for _ in range(3):
            eng.submit("mcm", **_mcm_kw(rng, 6))
        eng.step()
        assert eng.last_drain is not None and eng.last_drain.sharded
        counters = tdp.telemetry.REGISTRY.counters()
        assert counters["dp_engine_sharded_drains_total"] == 1
        assert counters["dp_engine_padded_lanes_total"] == 1
    finally:
        tdp.telemetry.reset()


# ---------------------------------------------------------------------------
# DPService's mesh
# ---------------------------------------------------------------------------
def test_service_explicit_mesh_shards_and_matches_the_reference():
    rng = _rng("service")
    svc = tdp.DPService(max_batch=16, mesh=_mesh(4))
    ref = jdp.DPService(max_batch=16, mesh=None)
    assert isinstance(svc.engine, tsharding.ShardedDPEngine)
    pairs = []
    for i in range(12):
        name = ("mcm", "edit_distance", "needleman_wunsch")[i % 3]
        kw = tdp.get_problem(name).sample(rng, 8)
        pairs.append((svc.submit(name, reconstruct=i % 2 == 0, **kw),
                      ref.submit(name, reconstruct=i % 2 == 0, **kw)))
    got, want = svc.run(), ref.run()
    assert svc.engine.stats["sharded_drains"] >= 1
    for t, j in pairs:
        assert np.array_equal(np.float32(got[t].answer), np.float32(want[j].answer))
        assert (got[t].solution is None) == (want[j].solution is None)
        if want[j].solution is not None:
            assert got[t].solution.solution == want[j].solution.solution


def test_service_auto_mesh(monkeypatch):
    """``"auto"`` keeps the single engine on the CPU and on one card, and
    shards over ``default_mesh()`` when a card is asked for and more than
    one is visible; ``None`` forces the single engine."""
    svc = tdp.DPService(device="cpu")
    assert type(svc.engine) is tdp.DPEngine
    monkeypatch.setattr(tsharding, "device_count", lambda: 4)
    assert type(tdp.DPService(device="cpu").engine) is tdp.DPEngine
    monkeypatch.setattr(tdp.service._backends, "resolve_device",
                        lambda device=None, check=True: torch.device("cuda", 0))
    four = _mesh(4)
    monkeypatch.setattr(tsharding, "default_mesh", lambda *a, **k: four)
    svc = tdp.DPService()
    assert isinstance(svc.engine, tsharding.ShardedDPEngine) and svc.engine.ctx.ndev == 4
    assert type(tdp.DPService(mesh=None).engine) is tdp.DPEngine
    monkeypatch.setattr(tsharding, "device_count", lambda: 1)
    assert type(tdp.DPService().engine) is tdp.DPEngine


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------
def test_pipeline_apply_equals_the_stages_in_sequence():
    """S 4, M 6, mb 3, d 8 (the reference's case) against ``jnp.tanh(x @
    W + b)`` applied stage after stage, within 2e-5."""
    S, M, mb, d = 4, 6, 3, 8
    rng = np.random.default_rng(0)
    Ws = (rng.normal(size=(S, d, d)) * 0.3).astype(np.float32)
    bs = (rng.normal(size=(S, d)) * 0.1).astype(np.float32)
    x = rng.normal(size=(M, mb, d)).astype(np.float32)
    mesh = rt.Mesh(["cpu"] * S, ("stage",))
    params = [(torch.from_numpy(Ws[s]), torch.from_numpy(bs[s])) for s in range(S)]
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]), params,
                         torch.from_numpy(x), mesh, axis="stage")
    want = jnp.asarray(x)
    for s in range(S):
        want = jnp.tanh(want @ jnp.asarray(Ws[s]) + jnp.asarray(bs[s]))
    assert got.shape == (M, mb, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        pipeline_apply(lambda p, h: h, params[:3], torch.from_numpy(x), mesh)


def test_pipeline_walks_the_skewed_schedule():
    """Stage j serves microbatch t - j at step t, and the last stage's
    outputs come back in microbatch order."""
    S, M = 3, 5
    seen = []

    def stage_fn(j, h):
        seen.append((j, int(h[0])))
        return h + 10 ** j

    mesh = rt.Mesh(["cpu"] * S, ("stage",))
    x = torch.arange(M, dtype=torch.float64)[:, None] * 1000
    got = pipeline_apply(stage_fn, list(range(S)), x, mesh)
    assert torch.equal(got[:, 0], x[:, 0] + 111)
    sched = SkewedSchedule(M, S)
    order, t = [], 0
    for t in range(sched.num_steps):
        order += [(j, int(i)) for j, i in enumerate(sched.np_items_at(t)) if 0 <= i < M]
    assert [(j, v) for j, v in seen] == [(j, i * 1000 + sum(10 ** k for k in range(j)))
                                        for j, i in order]


def test_schedule_accounting_and_stage_boundaries():
    sched = SkewedSchedule(6, 4)
    assert sched.num_steps == 6 + 4 - 1
    assert sched.occupancy().max() == min(6, 4)
    assert 0 < sched.utilization() <= 1
    for costs, s in (([1, 1, 4, 1, 1, 4, 1, 1], 4), ([3, 1, 2, 5, 1], 2), ([1] * 8, 4),
                     ([2, 9, 1], 5)):
        bounds, bottleneck = stage_boundaries(costs, s)
        assert (bounds, bottleneck) == jpartition(costs, s)
    assert stage_boundaries([1, 1, 4, 1, 1, 4, 1, 1], 4)[1] in (4, 5)


# ---------------------------------------------------------------------------
# compressed_psum, elastic re-meshing, place / gather, shard_batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,shape,scale", [(2, (33,), 1.0), (3, (4, 17), 1e-3),
                                           (4, (1000,), 50.0), (8, (5, 5), 1.0)])
def test_compressed_psum_bit_equal_to_the_reference(k, shape, scale):
    """The reference's collective under ``jax.vmap(..., axis_name="i")``
    over k shards: every shard's sum equal bit for bit."""
    rng = np.random.default_rng(k)
    xs = (rng.standard_normal((k,) + shape) * scale
          * rng.uniform(0.5, 2, size=(k,) + (1,) * len(shape))).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a: jcompressed_psum(a, "i"), axis_name="i")(
        jnp.asarray(xs)))
    got = compressed_psum([torch.from_numpy(x) for x in xs], _mesh(k, "i"))
    assert len(got) == k
    assert len({g.data_ptr() for g in got}) == k          # each slot its own copy
    for i in range(k):
        assert got[i].dtype == torch.float32
        np.testing.assert_array_equal(got[i].numpy(), want[i])


def test_compressed_psum_runs_along_a_mesh_line_and_checks_its_count():
    """Over the ``model`` line of a (2, 3) mesh: the sum of the line's
    shards; a shard count that is not the line's raises."""
    mesh = rt.Mesh(np.array(["cpu"] * 6).reshape(2, 3), ("data", "model"))
    xs = [torch.full((4,), float(i + 1)) for i in range(3)]
    got = compressed_psum(xs, mesh.line("model"))
    assert all(torch.equal(g, torch.full((4,), 6.0)) for g in got)
    with pytest.raises(ValueError, match="3 slots"):
        compressed_psum(xs[:2], mesh.line("model"))


def test_best_mesh_after_loss():
    slots = ["cpu"] * 16
    m = elastic.best_mesh(slots, model_axis=4)
    assert m.shape == {"data": 4, "model": 4} and m.size == 16
    m2 = elastic.best_mesh(elastic.simulate_device_loss(slots, lost=4), model_axis=4)
    assert m2.size == 12 and m2.shape["model"] == 4
    m3 = elastic.best_mesh(elastic.simulate_device_loss(slots, lost=6), model_axis=4)
    assert m3.shape == {"data": 5, "model": 2}        # 10 % 4 != 0: tp halves
    assert elastic.best_mesh(["cpu"] * 7, model_axis=4).shape == {"data": 7, "model": 1}


@pytest.mark.parametrize("shape,spec", [
    ((8, 6), ("data", "model")), ((8, 6), ("data",)), ((8, 6), (None, "model")),
    ((7, 5), ("model", "data")), ((12, 3), (("data", "model"),)),
    ((4, 12), (None, ("model", "data"))), ((5,), ()), ((), ())])
def test_place_and_gather_round_trip(shape, spec):
    mesh = tmesh.make_host_mesh(2, 3, devices=["cpu"] * 6)
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    placed = rt.place(x, mesh, spec)
    assert placed.shape == (2, 3)
    back = rt.gather(placed, mesh, spec)
    assert back.shape == shape and torch.equal(back, torch.from_numpy(x))
    # the shards along an axis the spec does not name are replicas
    if "model" not in str(spec):
        assert all(torch.equal(placed[i, 0], placed[i, j]) for i in range(2) for j in range(3))


def test_reshard_places_a_tree_onto_the_new_mesh():
    mesh = elastic.best_mesh(elastic.simulate_device_loss(["cpu"] * 8, 2), model_axis=4)
    assert mesh.shape == {"data": 3, "model": 2}
    tree = {"w": torch.arange(48.0).reshape(6, 8), "opt": {"m": np.arange(6.0)}}
    out = elastic.reshard(tree, mesh, lambda path, x: ("data", "model")[: np.ndim(x)])
    assert out["w"][2, 1].shape == (2, 4)
    assert torch.equal(rt.gather(out["w"], mesh, ("data", "model")), tree["w"])
    assert torch.equal(rt.gather(out["opt"]["m"], mesh, ("data",)),
                       torch.from_numpy(tree["opt"]["m"]))


def test_shard_batch_splits_the_batch_and_replicates_scalars():
    mesh = tmesh.make_host_mesh(2, 2, devices=["cpu"] * 4)
    assert tmesh.batch_axes() == ("data",) and tmesh.batch_axes(True) == ("pod", "data")
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(4, 6),
             "step": np.float32(3.0)}
    out = shard_batch(batch, mesh, "data")
    assert torch.equal(out["tokens"][1, 0], torch.from_numpy(batch["tokens"][2:]))
    assert torch.equal(out["tokens"][1, 0], out["tokens"][1, 1])
    assert out["step"][1, 1].shape == () and float(out["step"][1, 1]) == 3.0
    assert torch.equal(rt.gather(out["tokens"], mesh, ("data",)),
                       torch.from_numpy(batch["tokens"]))


def test_mesh_rejects_mismatched_axes():
    with pytest.raises(ValueError):
        rt.Mesh(["cpu"] * 4, ("a", "b"))
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(2, 2, devices=["cpu"] * 3)
    m = rt.Mesh(np.array(["cpu"] * 6, dtype=object).reshape(2, 3), ("x", "y"))
    assert m.line("y").shape == {"y": 3} and m.line("x").size == 2
