"""The port's ``DPService`` against ``repro.dp``'s on the CPU.

The same submissions in the same order, with one fake monotonic clock
driving both services' deadlines, give the same ticket statuses, answers
(bit-equal), cache hits, expiries, routes and counters. Streaming sessions
follow ``tests/test_dp_streaming.py``, with the session TTL and count
passed as arguments instead of environment knobs.
"""
import time
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import dp as jdp  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_table():
    tautotune.reset()
    yield
    tautotune.reset()


class FakeClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def advance(self, ms: float) -> None:
        self.t += ms / 1e3


@pytest.fixture
def clock(monkeypatch):
    """The fake clock in place of ``time.monotonic`` inside both services'
    modules only (the rest of the process keeps the real clock)."""
    import repro.dp.service as jservice
    import repro_torch.dp.service as tservice

    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c, perf_counter=time.perf_counter)
    for mod in (tservice, jservice):
        monkeypatch.setattr(mod, "time", fake)
    return c


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _pair(**kw):
    return (tdp.DPService(device="cpu", **kw), jdp.DPService(mesh=None, **kw))


def _same_results(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for tid, w in want.items():
        g = got[tid]
        label = f"tid {tid} ({w.problem})"
        assert (g.status, g.cached, g.backend, g.extended, g.sid) == \
            (w.status, w.cached, w.backend, w.extended, w.sid), label
        if w.answer is None:
            assert g.answer is None, label
        else:
            assert np.float32(g.answer) == np.float32(w.answer), label
        if w.solution is None:
            assert g.solution is None, label
        else:
            assert g.solution.solution == w.solution.solution, label


def _traffic(tag: str, count: int):
    rng = _rng(tag)
    names = ("mcm", "lcs", "edit_distance", "unbounded_knapsack",
             "needleman_wunsch", "cky", "viterbi", "optimal_bst")
    pool = []
    for name in names:
        prob = tdp.get_problem(name)
        pool += [(name, prob.sample(rng, int(rng.choice([5, 8])))) for _ in range(2)]
    out = []
    for i in range(count):
        name, kw = pool[int(rng.integers(len(pool)))]
        deadline = (None, 60_000.0, 5.0)[int(rng.integers(3))]
        out.append((name, kw, dict(priority=int(rng.integers(3)),
                                   deadline_ms=deadline,
                                   reconstruct=(i % 4 == 0))))
    return out


@pytest.mark.parametrize("tag,max_batch,max_inflight", [("svc-a", 4, 8),
                                                        ("svc-b", 8, None)])
def test_mixed_traffic_matches_the_reference_service(clock, tag, max_batch,
                                                     max_inflight):
    tsvc, jsvc = _pair(max_batch=max_batch, max_inflight=max_inflight,
                       cache_size=64)
    got, want = {}, {}
    for i, (name, kw, opts) in enumerate(_traffic(tag, 48)):
        assert tsvc.submit(name, **kw, **opts) == jsvc.submit(name, **kw, **opts)
        if i % 6 == 5:                  # arrivals interleave with steps
            assert tsvc.step() == jsvc.step()
            clock.advance(10.0)         # 5 ms deadlines lapse in the backlog
    got.update(tsvc.run())
    want.update(jsvc.run())
    _same_results(got, want)
    assert tsvc.stats == jsvc.stats
    assert tsvc.routes == jsvc.routes
    assert tsvc.engine.stats == jsvc.engine.stats
    assert tsvc.cache_stats() == jsvc.cache_stats()
    assert tsvc.stats["cache_hits"] > 0 and tsvc.stats["expired"] > 0


def test_priority_deadline_and_inflight_order_match_the_reference(clock):
    rng = _rng("svc-order")
    tsvc, jsvc = _pair(max_batch=4, max_inflight=32)
    mcm = [{"dims": rng.integers(1, 20, size=8).astype(np.float64)}
           for _ in range(4)]
    bst = [{"freq": rng.random(6) + 0.01} for _ in range(2)]
    lcs = [{"x": rng.integers(0, 3, size=5), "y": rng.integers(0, 3, size=5)}
           for _ in range(2)]
    for svc in (tsvc, jsvc):
        for kw in mcm:
            svc.submit("mcm", priority=0, **kw)
        for kw in bst:
            svc.submit("optimal_bst", priority=1, deadline_ms=5_000.0, **kw)
    assert tsvc.step() == jsvc.step()
    for svc in (tsvc, jsvc):
        svc.submit("mcm", priority=9, **mcm[0])
        for kw in lcs:
            svc.submit("lcs", priority=5, **kw)
    steps = []
    while jsvc.pending():
        steps.append((tsvc.step(), jsvc.step()))
    assert all(a == b for a, b in steps)
    _same_results(tsvc.run(), jsvc.run())


def test_admission_overload_and_cache_hits_are_never_shed():
    svc = tdp.DPService(max_batch=4, max_pending=2, device="cpu")
    kw = {"dims": np.array([3.0, 4, 5, 6])}
    first = svc.submit("mcm", **kw)
    svc.run()
    svc.submit("mcm", dims=np.array([2.0, 9, 4]))
    svc.submit("mcm", dims=np.array([7.0, 9, 4]))
    with pytest.raises(tdp.AdmissionError):
        svc.submit("mcm", dims=np.array([5.0, 9, 4]))
    hit = svc.poll(svc.submit("mcm", **kw))       # full backlog, cache hit
    assert hit.cached and hit.status == "done"
    assert svc.stats["shed"] == svc.stats["rejected"] == 1
    del first
    svc.run()
    s = svc.stats
    assert s["submitted"] == s["completed"] + s["expired"] + s["shed"]


def test_mesh_argument_of_another_kind_raises_type_error():
    """A mesh argument other than "auto", None or a port ``Mesh`` of slots
    (here a reference-style tuple of axis names) raises."""
    with pytest.raises(TypeError, match="Mesh"):
        tdp.DPService(mesh=("data",), device="cpu")


def test_explicit_mesh_builds_the_sharded_engine():
    """An explicit mesh of slots builds the sharded engine on its first
    slot's device; mesh=None keeps the single engine."""
    from repro_torch.dp.sharding import ShardedDPEngine, default_mesh

    svc = tdp.DPService(mesh=default_mesh(devices=["cpu"] * 2))
    assert isinstance(svc.engine, ShardedDPEngine) and svc.engine.device.type == "cpu"
    assert tdp.DPService(mesh=None, device="cpu").engine.device.type == "cpu"


def test_session_lifecycle_matches_the_reference():
    prob = tdp.get_problem("unbounded_knapsack")
    kw = prob.sample(_rng("session"), 8)

    def grow(c):
        return dict(kw, capacity=int(kw["capacity"]) + c)

    tsvc, jsvc = _pair(max_batch=8)
    results = []
    for svc in (tsvc, jsvc):
        sid = svc.open_session("unbounded_knapsack")
        t1 = svc.append(sid, **kw)
        r1 = svc.run()[t1]
        t2 = svc.append(sid, **grow(4))
        r2 = svc.run()[t2]
        r3 = svc.poll(svc.append(sid, **grow(4)))       # resolved at admission
        results.append((r1, r2, r3, svc.close_session(sid), dict(svc.stats)))
    (t1, t2, t3, tsum, tstats), (j1, j2, j3, jsum, jstats) = results
    _same_results({1: t1, 2: t2, 3: t3}, {1: j1, 2: j2, 3: j3})
    assert not t1.extended and t2.extended and t3.cached and t3.extended
    assert tsum == jsum and tstats == jstats
    assert tstats["prefix_hits"] == 2 and tstats["prefix_full_hits"] == 1
    np.testing.assert_allclose(
        t2.answer, tdp.solve("unbounded_knapsack", device="cpu", **grow(4)),
        rtol=1e-6)
    with pytest.raises(KeyError):
        tsvc.append(0, **grow(8))


def test_cross_session_warm_start():
    prob = tdp.get_problem("needleman_wunsch")
    kw = prob.sample(_rng("cross"), 8)
    y = np.asarray(kw["y"])
    kw_full = dict(kw, y=np.concatenate([y, y[:2]]))
    svc = tdp.DPService(max_batch=8, device="cpu")
    sid1 = svc.open_session("needleman_wunsch")
    t1 = svc.append(sid1, **kw)
    assert not svc.run()[t1].extended
    svc.close_session(sid1)
    sid2 = svc.open_session("needleman_wunsch")
    t2 = svc.append(sid2, **kw_full)
    r2 = svc.run()[t2]
    assert r2.extended
    assert r2.answer == tdp.solve_spec(prob.encode(**kw_full),
                                       backend="grid_wavefront", device="cpu")[-1]


def test_session_capacity_and_ttl_are_arguments(clock):
    svc = tdp.DPService(max_batch=4, device="cpu", session_max=2,
                        session_ttl_ms=1)
    assert svc.session_max == 2 and svc.session_ttl_ms == 1
    a = svc.open_session("mcm")
    b = svc.open_session("mcm")
    c = svc.open_session("mcm")              # evicts the LRU session (a)
    assert svc.stats["sessions_evicted"] == 1
    with pytest.raises(KeyError):
        svc.close_session(a)
    clock.advance(10.0)                      # both survivors idle past TTL
    svc.step()
    assert svc.stats["sessions_expired"] == 2
    for sid in (b, c):
        with pytest.raises(KeyError):
            svc.close_session(sid)
    assert svc.session_stats()["open"] == 0
    with pytest.raises(ValueError):
        tdp.DPService(device="cpu", session_max=0)
