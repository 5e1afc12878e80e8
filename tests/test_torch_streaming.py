"""The port's streaming layer against ``repro.dp``'s on the CPU: the spec
families' extension and digest-chain hooks, warm extends on every
extend-capable route, resume tokens, the prefix index and the engine's
extend buckets.

Digests must be equal across the packages (the answer cache, engine dedup
and the prefix index key on them), and a warm extend must equal the cold
solve of the full instance bit for bit, and ``repro``'s ``resume_solve``
of the same prefix.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import dp as jdp  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.dp import routing as trouting  # noqa: E402
from repro_torch.dp import streaming as tstreaming  # noqa: E402

CPU = torch.device("cpu")
PROBLEMS = ("sdp", "edit_distance", "lcs", "viterbi", "unbounded_knapsack",
            "mcm", "optimal_bst", "polygon_triangulation", "needleman_wunsch",
            "gotoh", "cky", "edit_distance_grid", "lcs_grid")


@pytest.fixture(autouse=True)
def _fresh_table():
    tautotune.reset()
    yield
    tautotune.reset()


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _pair(name: str, tag: str, size: int = 10):
    """The same sampled instance encoded by both packages."""
    kw = tdp.get_problem(name).sample(_rng(f"{tag}/{name}"), size)
    return kw, tdp.get_problem(name).encode(**kw), jdp.get_problem(name).encode(**kw)


def _split_len(spec, k: int = 3) -> int:
    n, lo = spec.extend_length(), spec.min_prefix_len()
    L = max(lo, n - k)
    assert lo <= L < n, (n, lo)
    return L


def test_all_thirteen_problems_are_covered():
    assert sorted(PROBLEMS) == sorted(tdp.problem_names())


@pytest.mark.parametrize("name", PROBLEMS)
def test_digests_and_chains_equal_the_reference(name):
    _, ts, js = _pair(name, "digest")
    assert tdp.spec_digest(ts) == jdp.spec_digest(js)
    assert ts.chain_seed() == js.chain_seed()
    assert ts.step_payloads() == js.step_payloads()
    assert ts.prefix_digest_chain() == js.prefix_digest_chain()
    n, lo = ts.extend_length(), ts.min_prefix_len()
    assert (n, lo) == (js.extend_length(), js.min_prefix_len())
    for L in sorted({lo, (lo + n) // 2, n - 1}):
        assert ts.flat_payload_digest(L) == js.flat_payload_digest(L)
        tp, jp = ts.split_spec(L), js.split_spec(L)
        assert tdp.spec_digest(tp) == jdp.spec_digest(jp)
        np.testing.assert_array_equal(ts.prefix_cell_map(tp), js.prefix_cell_map(jp))
        np.testing.assert_array_equal(ts.saved_state_cells(tp),
                                      js.saved_state_cells(jp))
        assert ts.content_extends(tp)


@pytest.mark.parametrize("name", PROBLEMS)
def test_extension_delta_round_trips_like_the_reference(name):
    _, ts, js = _pair(name, "delta")
    L = _split_len(ts)
    tp, jp = ts.split_spec(L), js.split_spec(L)
    tdelta, jdelta = ts.extension_delta(tp), js.extension_delta(jp)
    assert sorted(tdelta) == sorted(jdelta)
    grown = tp.extend_spec(tdelta)
    assert tdp.spec_digest(grown) == tdp.spec_digest(ts) == jdp.spec_digest(
        jp.extend_spec(jdelta))
    with pytest.raises(ValueError):
        tp.extension_delta(ts)


@pytest.mark.parametrize("name", PROBLEMS)
def test_warm_extend_equals_cold_solve_and_the_reference(name):
    """On the extend-capable route (the plain one a family registers), a
    prefix solve plus a warm extend is byte-identical to the cold solve of
    the full instance, and to ``repro``'s ``resume_solve`` of the same
    prefix on its route of the same name."""
    for trial in range(2):
        _, ts, js = _pair(name, f"extend{trial}", size=8 + 3 * trial)
        routes = trouting.extend_candidates(ts, CPU)
        assert routes, name
        route = routes[0]
        assert route.name == jdp.routing.extend_candidates(js)[0].name
        L = _split_len(ts)
        cold = tdp.solve_spec(ts, backend=route.name, device="cpu")
        prefix = ts.split_spec(L)
        ptab = tdp.solve_spec(prefix, backend=route.name, device="cpu")
        token = tdp.ResumeToken(prefix_spec=prefix, prefix_table=ptab)
        warm = tdp.resume_solve(ts, token, backend=route, device="cpu")
        assert warm.dtype == cold.dtype and warm.tobytes() == cold.tobytes(), name
        jprefix = js.split_spec(L)
        jtok = jdp.ResumeToken(prefix_spec=jprefix, prefix_table=np.asarray(
            jdp.solve_spec(jprefix, backend=route.name)))
        ref = np.asarray(jdp.resume_solve(js, jtok, backend=route.name))
        assert warm.tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("name", ["sdp", "mcm", "needleman_wunsch", "cky"])
def test_extend_off_a_kernel_route_prefix_equals_the_kernel_cold(name):
    """A prefix solved on the family's kernel route (its plain version on
    the CPU) extends through the plain route to the kernel route's own cold
    table."""
    kernel = {"sdp": "kernel_blocked", "mcm": "kernel_wavefront",
              "needleman_wunsch": "kernel_grid", "cky": "kernel_grid"}[name]
    _, ts, _ = _pair(name, "extend-kernel")
    prefix = ts.split_spec(_split_len(ts, 2))
    token = tdp.ResumeToken(prefix_spec=prefix, prefix_table=tdp.solve_spec(
        prefix, backend=kernel, device="cpu"))
    warm = tdp.resume_solve(ts, token, device="cpu")
    assert warm.tobytes() == tdp.solve_spec(ts, backend=kernel,
                                            device="cpu").tobytes()


def _viterbi_pair(tag, t_prefix=8, t_full=12):
    prob = tdp.get_problem("viterbi")
    rng = _rng(tag)
    kw = prob.sample(rng, t_prefix)
    n_sym = np.asarray(kw["log_b"]).shape[1]
    extra = rng.integers(0, n_sym, size=t_full - len(kw["obs"]))
    return prob, kw, dict(kw, obs=np.concatenate([np.asarray(kw["obs"]), extra]))


def test_resume_token_validation_errors():
    prob, kw, kw_full = _viterbi_pair("validate")
    spec_prefix, spec_full = prob.encode(**kw), prob.encode(**kw_full)
    tok = tdp.ResumeToken(prefix_spec=spec_prefix,
                          prefix_table=tdp.solve_spec(spec_prefix, device="cpu"))
    with pytest.raises(ValueError, match="cannot extend"):
        tstreaming.check_extends(spec_prefix, tok)
    kw_bad = dict(kw_full, obs=np.asarray(kw_full["obs"]).copy())
    kw_bad["obs"][0] = (kw_bad["obs"][0] + 1) % np.asarray(kw["log_b"]).shape[1]
    with pytest.raises(ValueError, match="chain-digest mismatch"):
        tdp.resume_solve(prob.encode(**kw_bad), tok, device="cpu")
    warm = tdp.resume_solve(spec_full, tok, device="cpu")
    assert warm[-1] == tdp.solve_spec(spec_full, backend="sequential",
                                      device="cpu")[-1]


def test_prefix_index_longest_prefix_full_hit_and_lru():
    prob, kw, kw_full = _viterbi_pair("index")
    spec_prefix, spec_full = prob.encode(**kw), prob.encode(**kw_full)
    idx = tdp.PrefixIndex(capacity=2)
    assert idx.lookup(prob.name, spec_full) is None
    idx.put(prob.name, spec_prefix, tdp.solve_spec(spec_prefix, device="cpu"),
            backend="sequential")
    ent = idx.lookup(prob.name, spec_full)
    assert ent is not None and ent.length == spec_prefix.extend_length()
    assert not ent.table.flags.writeable
    warm = tdp.resume_solve(spec_full, ent.token(), validate=False, device="cpu")
    idx.put(prob.name, spec_full, warm, backend="sequential")
    assert idx.lookup(prob.name, spec_full).length == spec_full.extend_length()
    snap = idx.snapshot()
    assert (snap["full_hits"], snap["hits"], snap["misses"]) == (1, 2, 1)
    other = prob.encode(**prob.sample(_rng("index-other"), 7))
    idx.put(prob.name, other, tdp.solve_spec(other, device="cpu"), backend="x")
    assert len(idx) == 2 and idx.lookup(prob.name, spec_prefix) is None
    with pytest.raises(ValueError):
        tdp.PrefixIndex(capacity=0)


def test_chain_cursor_advances_by_the_appended_steps_only():
    prob = tdp.get_problem("needleman_wunsch")
    kw = prob.sample(_rng("cursor"), 8)
    y = np.asarray(kw["y"])
    short, grown = prob.encode(**kw), prob.encode(**dict(kw, y=np.concatenate([y, y])))
    cur = tstreaming.ChainCursor(short)
    assert cur.advance(grown) == grown.prefix_digest_chain()
    assert cur.advance(short) is None            # shrinking is no extension


def test_engine_extend_bucket_isolation_and_response():
    prob, kw, kw_full = _viterbi_pair("engine")
    spec_prefix = prob.encode(**kw)
    route = trouting.extend_candidates(prob.encode(**kw_full), CPU)[0]
    tok = tdp.ResumeToken(prefix_spec=spec_prefix, affinity=route.name,
                          prefix_table=tdp.solve_spec(spec_prefix, backend=route.name,
                                                      device="cpu"))
    eng = tdp.DPEngine(max_batch=8, device="cpu")
    rid_warm = eng.submit("viterbi", resume=tok, keep_table=True, **kw_full)
    rid_cold = eng.submit("viterbi", **kw_full)
    assert sum(eng.is_extend_bucket(k) for k in eng.bucket_sizes()) == 1
    assert len(eng.bucket_sizes()) == 2
    out = eng.run()
    warm, cold = out[rid_warm], out[rid_cold]
    assert warm.extended and warm.affine and not cold.extended
    assert warm.table is not None and cold.table is None
    # the cold lane ran the dispatched route, which may round differently
    # in the last place than the extend route (bit-identity is per route)
    np.testing.assert_allclose(warm.answer, cold.answer, rtol=1e-6)
    assert (eng.stats["extend_drains"], eng.stats["extend_requests"],
            eng.stats["affine_lanes"]) == (1, 1, 1)
