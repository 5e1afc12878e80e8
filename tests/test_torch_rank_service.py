"""The port's ``DPService`` one process a rank (``DPService(comm=...)``):
four ``cpu`` slots of ``runtime.sharding.run`` and four ``gloo`` processes
of ``runtime.distributed.launch``, each rank serving the same traffic over
its own ``ShardedDPEngine(comm=comm)``, against the threaded
``DPService(mesh=...)`` and the reference's single-process ``DPService``.

The traffic is the zoo sweep of ``tests/test_torch_sharding.py`` (13
problems with and without reconstruct, three instances each at size 8)
with repeats, priorities 0–2, start-by deadlines that do not lapse, and
one streaming session, driven by ``launch/ranks.py::serve_dp`` (two steps
every 32 submits, as the smoke's service path). Every check against the
threads is bit for bit (the answers' dtype and bytes, the decoded
solutions, routes, statuses, counters); the reference is compared as
``tests/test_torch_service.py`` compares it.

A rank whose own clock disagrees with its peers' by more than a deadline
(it sleeps before every step) must still expire the same tickets and drain
the same buckets: the service reads one clock agreed by every rank.

The ranks are spawned once for the module (:func:`launching`, started in a
thread while the threads and the reference run).
"""
import functools
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharding import _zoo_traffic  # noqa: E402

from repro import dp as jdp  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.runtime import distributed  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402

SLOTS = 4
#: the service's bucket width and engine-slot budget (ragged against four
#: ranks, so pad lanes run)
MAX_BATCH, MAX_INFLIGHT = 6, 12
#: a start-by deadline that never lapses in these runs (its EDF order is
#: the submit order, on every clock)
FAR_MS = 600_000.0
#: the disagreeing clock: the sleeping slot, its sleep before each step
#: and the deadline of half the tickets (ms)
SLEEPER, SLEEP_MS, TIGHT_MS = 3, 30.0, 10.0


@pytest.fixture(autouse=True)
def _fresh_table():
    tautotune.reset()
    yield
    tautotune.reset()


def _traffic() -> tuple:
    """(requests as ``serve_dp`` takes them, sessions): the zoo sweep
    shuffled, then 18 repeats of its requests (answered by the cache, or
    deduplicated where the first is still in flight), each with a seeded
    priority and no deadline or :data:`FAR_MS`; one unbounded_knapsack
    session of three appends (the last a full prefix hit)."""
    rng = np.random.default_rng(31)
    sweep = [(name, kw, recon) for name, recon, kw in _zoo_traffic()]
    base = [sweep[i] for i in rng.permutation(len(sweep))]
    base += [sweep[int(i)] for i in rng.integers(len(sweep), size=18)]
    requests = [(*req, int(rng.integers(3)), (None, FAR_MS)[int(rng.integers(2))])
                for req in base]
    knap = tdp.get_problem("unbounded_knapsack").sample(np.random.default_rng(5), 8)
    steps = [dict(knap, capacity=int(knap["capacity"]) + c) for c in (0, 4, 4)]
    return requests, [("unbounded_knapsack", steps)]


def _service_kw() -> dict:
    return {"max_batch": MAX_BATCH, "max_inflight": MAX_INFLIGHT, "cache_size": 64}


def _cpu_mesh():
    return tdp.default_mesh(devices=["cpu"] * SLOTS)


@pytest.fixture(scope="module")
def launching(tmp_path_factory):
    """:func:`ranks.dp_service` in four ``gloo`` rank processes of a
    ``(4,)`` mesh on the CPU, started in a thread of its own."""
    requests, sessions = _traffic()
    path = tmp_path_factory.mktemp("ranks-service")
    pool = ThreadPoolExecutor(1)
    future = pool.submit(
        distributed.launch, functools.partial(ranks.dp_service, **_service_kw()), (SLOTS,),
        (tdp.sharding.BATCH_AXIS,), ["cpu"] * SLOTS, args=(requests, sessions),
        init_method=f"file://{path / 'rendezvous'}")
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def threaded_ranks(launching):
    """:func:`ranks.dp_service` in every slot of ``runtime.sharding.run``
    over four ``cpu`` slots: each slot's result, in slot order."""
    requests, sessions = _traffic()
    tautotune.reset()
    got = rt.run(_cpu_mesh(), lambda comm: ranks.dp_service(
        comm, requests, sessions, **_service_kw()))
    return list(got)


@pytest.fixture(scope="module")
def threaded_mesh(launching):
    """The same traffic through one ``DPService(mesh=...)`` over four ``cpu``
    slots (the threaded sharded engine)."""
    requests, sessions = _traffic()
    tautotune.reset()
    svc = tdp.DPService(mesh=_cpu_mesh(), feedback=False, **_service_kw())
    return ranks.serve_dp(svc, requests, sessions)


@pytest.fixture(scope="module")
def reference(launching):
    """The same traffic through the reference's ``DPService(mesh=None)``,
    driven by the same loop (its engine given the device attribute the
    loop synchronises)."""
    requests, sessions = _traffic()
    svc = jdp.DPService(mesh=None, feedback=False, **_service_kw())
    svc.engine.device = torch.device("cpu")
    return ranks.serve_dp(svc, requests, sessions)


def _same_value(got, want) -> bool:
    if want is None or got is None:
        return got is None and want is None
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


def _same_records(got: list, want: list, what: str) -> None:
    """Two runs' ticket records equal bit for bit."""
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        label = f"{what}: tid {w['tid']} ({w['problem']})"
        assert {k: v for k, v in g.items() if k != "answer"} == \
            {k: v for k, v in w.items() if k != "answer"}, label
        assert _same_value(g["answer"], w["answer"]), label


def test_every_slot_serves_the_same_tickets_as_the_threaded_mesh(threaded_ranks, threaded_mesh):
    """``DPService(comm=comm)`` in each of four threaded slots: every slot's
    records, session summaries, routes and counters equal every other
    slot's and the threaded ``DPService(mesh=...)``'s, bit for bit; drains
    ran sharded, with pad lanes, and the traffic hit the cache, the
    engine's dedup and the session's prefix index."""
    want = threaded_mesh
    for r, got in enumerate(threaded_ranks):
        _same_records(got["records"], want["records"], f"slot {r}")
        for key in ("sessions", "stats", "engine", "routes"):
            assert got[key] == want[key], (r, key)
    eng, stats = want["engine"], want["stats"]
    assert eng["sharded_drains"] > 0 and eng["padded_lanes"] > 0
    assert stats["cache_hits"] > 0 and stats["prefix_full_hits"] == 1
    assert stats["expired"] == 0 and stats["completed"] == len(want["records"])
    assert {r["status"] for r in want["records"]} == {"done"}


def test_slots_bit_equal_to_the_reference_service(threaded_ranks, reference):
    """Slot 0's records equal the reference's single-process ``DPService``
    on the same calls: statuses, cache hits, routes, extends, sessions,
    answers (as float32) and decoded solutions; and the service's counters
    and routes."""
    got, want = threaded_ranks[0], reference
    assert len(got["records"]) == len(want["records"])
    for g, w in zip(got["records"], want["records"]):
        label = f"tid {w['tid']} ({w['problem']})"
        for key in ("tid", "problem", "status", "cached", "backend", "extended", "sid"):
            assert g[key] == w[key], (label, key)
        assert np.array_equal(np.float32(g["answer"]), np.float32(w["answer"])), label
        assert g["solution"] == w["solution"], label
    assert got["stats"] == want["stats"]
    assert got["routes"] == want["routes"]
    assert got["sessions"] == want["sessions"]


def test_rank_processes_bit_equal_to_the_threaded_slots(launching, threaded_ranks):
    """The same program in four ``gloo`` rank processes: every rank's
    records, sessions, routes and counters equal the threaded slots', bit
    for bit, and no rank loads jax or ``repro``."""
    done = launching.result(timeout=600)
    assert done.backend == "gloo"
    want = threaded_ranks[0]
    for r, rep in enumerate(done.reports):
        assert rep.foreign == [], rep.foreign
        got = rep.result
        _same_records(got["records"], want["records"], f"rank {r}")
        for key in ("sessions", "stats", "engine", "routes"):
            assert got[key] == want[key], (r, key)
        assert got["seconds"] > 0 and got["host"] is None


# ---------------------------------------------------------------------------
# clocks that disagree
# ---------------------------------------------------------------------------
def _sleepy_service(comm, requests) -> dict:
    """``requests`` through ``DPService(comm=comm, max_batch=2,
    max_inflight=2)``, two submits between steps; slot :data:`SLEEPER`
    sleeps :data:`SLEEP_MS` before every step, so its own clock runs ahead
    of its peers' by more than :data:`TIGHT_MS` at each step. Returns
    {"records", "stats", "engine"}."""
    svc = tdp.DPService(comm=comm, max_batch=2, max_inflight=2, feedback=False)
    step = svc.step

    def sleepy_step(backend=None):
        if comm.rank == SLEEPER:
            time.sleep(SLEEP_MS / 1e3)
        return step(backend)

    svc.step = sleepy_step
    got = {}
    for i, (name, kw, recon, priority, deadline_ms) in enumerate(requests):
        svc.submit(name, reconstruct=recon, priority=priority, deadline_ms=deadline_ms, **kw)
        if i % 2 == 1:
            svc.step()
    while svc.pending():
        svc.step()
    got.update(svc.run())
    return {"records": [ranks.ticket_record(got[t]) for t in sorted(got)],
            "stats": dict(svc.stats), "engine": dict(svc.engine.stats)}


def test_disagreeing_clocks_expire_the_same_tickets_on_every_slot():
    """One slot sleeps 30 ms before every step, past the 10 ms start-by
    deadline of half the tickets: every slot still expires the same
    tickets, drains the same buckets and returns the same records, and at
    least one ticket expired."""
    rng = np.random.default_rng(3)
    requests = []
    for name in ("mcm", "lcs", "edit_distance", "optimal_bst"):
        prob = tdp.get_problem(name)
        for k in range(6):
            requests.append((name, prob.sample(rng, 6), False, int(rng.integers(3)),
                             TIGHT_MS if k % 2 else None))
    got = rt.run(_cpu_mesh(), lambda comm: _sleepy_service(comm, requests))
    first = got[0]
    assert first["stats"]["expired"] > 0
    assert first["stats"]["completed"] + first["stats"]["expired"] == len(requests)
    for r, other in enumerate(got[1:], 1):
        assert [x["status"] for x in other["records"]] == \
            [x["status"] for x in first["records"]], r
        _same_records(other["records"], first["records"], f"slot {r}")
        assert other["stats"] == first["stats"] and other["engine"] == first["engine"], r


# ---------------------------------------------------------------------------
# the comm argument
# ---------------------------------------------------------------------------
def test_comm_with_a_mesh_or_another_engines_comm_raises():
    """``comm=`` with an explicit ``mesh=`` (or ``mesh=None``) raises; an
    injected rank engine brings its comm; an injected engine whose comm is
    not the ``comm=`` given, or a single engine with a ``comm=``, raises."""
    mesh = _cpu_mesh()
    comm, other = rt.RecordingComm(mesh, (0,)), rt.RecordingComm(mesh, (1,))
    for bad in (mesh, None):
        with pytest.raises(ValueError, match="comm"):
            tdp.DPService(comm=comm, mesh=bad)
    svc = tdp.DPService(comm=comm, feedback=False)
    assert isinstance(svc.engine, tdp.ShardedDPEngine) and svc.engine.ctx.comm is comm
    assert svc.comm is comm and svc.engine.device.type == "cpu"
    engine = tdp.ShardedDPEngine(comm=other, feedback=False)
    assert tdp.DPService(engine=engine).comm is other
    with pytest.raises(ValueError, match="comm"):
        tdp.DPService(engine=engine, comm=comm)
    with pytest.raises(ValueError, match="comm"):
        tdp.DPService(engine=tdp.DPEngine(device="cpu"), comm=comm)
    assert tdp.DPService(mesh=None, device="cpu").comm is None


class _Ticking:
    """A fake ``time.monotonic`` that moves one second at every reading."""

    def __init__(self):
        self.reads = 0

    def __call__(self) -> float:
        self.reads += 1
        return 100.0 + self.reads


def _ticking(monkeypatch, mod) -> _Ticking:
    clock = _Ticking()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock,
                                                           perf_counter=time.perf_counter))
    return clock


def test_alone_the_clock_is_the_monotonic_clock(monkeypatch):
    """Without a comm the service's clock is ``time.monotonic()``: a
    submit reads it once, a step reads it once as it begins and again for
    each ticket it resolves after the drain, so ``latency_ms`` is
    submit→resolve and equals the reference's on a clock that ticks at
    every reading."""
    import repro.dp.service as jservice
    import repro_torch.dp.service as tservice

    lat = {}
    for mod, svc_of in ((tservice, lambda: tdp.DPService(mesh=None, device="cpu", max_batch=4)),
                        (jservice, lambda: jdp.DPService(mesh=None, max_batch=4))):
        clock = _ticking(monkeypatch, mod)
        svc = svc_of()
        tids = [svc.submit("mcm", deadline_ms=5_000.0, dims=np.array(d))
                for d in ([3.0, 4, 5], [2.0, 6, 3])]
        assert clock.reads == 2
        svc.step()
        assert clock.reads == 5
        lat[mod.__name__] = [svc.poll(t).latency_ms for t in tids]
    # submits at 101, 102; the step at 103; resolved at 104, 105
    assert lat["repro_torch.dp.service"] == lat["repro.dp.service"] == [3e3, 3e3]


def test_a_rank_measures_its_drain_on_its_own_clock(monkeypatch):
    """With a comm a ticket's latency runs from the agreed submit reading
    to the agreed step reading plus the rank's own time from then to the
    ticket's resolve, and a session's ``last_seen`` (which decides sweeps)
    is the agreed step reading that every rank shares."""
    import repro_torch.dp.service as tservice

    clock = _ticking(monkeypatch, tservice)

    def serve(comm):
        svc = tdp.DPService(comm=comm, max_batch=4, feedback=False)
        sid = svc.open_session("mcm")                                   # 101
        tid = svc.append(sid, dims=np.array([3.0, 4, 5]))               # 102
        svc.step()                  # agreed 103, local 104, resolved at 105 - 1
        return svc.poll(tid).latency_ms, svc._sessions[sid].last_seen

    (latency, last_seen), = rt.run(tdp.default_mesh(devices=["cpu"]), serve)
    assert clock.reads == 5
    assert latency == 2e3 and last_seen == 103.0


# ---------------------------------------------------------------------------
# the row-at-a-time plain check of a large S-DP grid (rank 0's K3 timing)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["edit_distance", "lcs"])
@pytest.mark.parametrize("m,n", [(5, 4), (17, 23), (40, 1), (1, 30)])
def test_grid_rows_plain_equals_the_plain_versions(name, m, n):
    """``sdp_pipeline.grid_rows_plain`` (a grid row at a time) gives K1's
    and K3's plain versions' tables and args bit for bit on batches of
    edit_distance and lcs specs, and its last cell is ``dp.solve``'s
    answer."""
    from repro_torch.kernels import sdp_chunked as k3
    from repro_torch.kernels import sdp_pipeline as k1

    rng = np.random.default_rng(m * 100 + n)
    kws = [{"x": rng.integers(0, 4, m), "y": rng.integers(0, 4, n)} for _ in range(3)]
    specs = [tdp.get_problem(name).encode(**kw) for kw in kws]
    s0 = specs[0]
    init = torch.from_numpy(np.stack([s.init for s in specs]).astype(np.float32))
    w = torch.from_numpy(np.stack([s.weights for s in specs]).astype(np.float32))
    got, args = k1.grid_rows_plain(init, s0.offsets, s0.op, s0.n, w, with_args=True)
    assert got.dtype == torch.float32 and args.dtype == torch.int32
    assert torch.equal(k1.grid_rows_plain(init, s0.offsets, s0.op, s0.n, w), got)
    for plain in (k1.sdp_pipeline_plain, k3.sdp_chunked_plain):
        want, want_args = plain(init, s0.offsets, s0.op, s0.n, weights=w, with_args=True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(args, want_args)
    for row, kw in zip(got, kws):
        assert float(row[-1]) == float(tdp.solve(name, device="cpu", **kw))
    one, one_args = k1.grid_rows_plain(init[1], s0.offsets, s0.op, s0.n, w[1], with_args=True)
    assert torch.equal(one, got[1]) and torch.equal(one_args, args[1])


@pytest.mark.parametrize("name", ["edit_distance", "lcs"])
def test_grid_rows_plain_at_a_full_row_width(name):
    """At the smoke's row width (513 cells, 64 rows) ``grid_rows_plain``
    gives K1's plain version's table and args bit for bit."""
    from repro_torch.kernels import sdp_pipeline as k1

    rng = np.random.default_rng(513)
    specs = [tdp.get_problem(name).encode(x=rng.integers(0, 4, 63), y=rng.integers(0, 4, 512))
             for _ in range(2)]
    s0 = specs[0]
    assert s0.offsets == (514, 513, 1)
    init = torch.from_numpy(np.stack([s.init for s in specs]).astype(np.float32))
    w = torch.from_numpy(np.stack([s.weights for s in specs]).astype(np.float32))
    got, args = k1.grid_rows_plain(init, s0.offsets, s0.op, s0.n, w, with_args=True)
    want, want_args = k1.sdp_pipeline_plain(init, s0.offsets, s0.op, s0.n, weights=w,
                                            with_args=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(args, want_args)


def test_grid_rows_plain_refuses_what_it_cannot_hold_exactly():
    """Offsets that are not an alignment grid's, weights that are not
    small integers, or a finite in-row weight at a row's first cell
    (another layout), raise."""
    spec = tdp.get_problem("edit_distance").encode(x=np.array([0, 1, 2]), y=np.array([1, 2]))
    init = torch.from_numpy(spec.init[None].astype(np.float32))
    w = torch.from_numpy(spec.weights[None].astype(np.float32))
    from repro_torch.kernels.sdp_pipeline import grid_rows_plain

    with pytest.raises(ValueError, match="not small integers"):
        grid_rows_plain(init, spec.offsets, spec.op, spec.n, w * 0.5)
    with pytest.raises(ValueError, match="offsets"):
        grid_rows_plain(init, (4, 2, 1), spec.op, spec.n, w)
    col0 = w.clone()
    col0[0, 2 * (spec.offsets[1]), 2] = 1.0      # row 2's first cell
    with pytest.raises(ValueError, match="first cell"):
        grid_rows_plain(init, spec.offsets, spec.op, spec.n, col0)


def test_pack_puts_every_tensor_on_the_rank_device():
    """``ProcessComm`` packs a collective's tensors into one buffer on the
    rank's device, whatever device a tensor was on: a rank over NCCL agrees
    its clock and its drain times from host scalars, and NCCL refuses a
    buffer on the CPU (``meta`` stands in for the card here)."""
    meta = torch.device("meta")
    buf, metas = distributed._pack([torch.tensor(1.5, dtype=torch.float64),
                                    torch.arange(3, dtype=torch.int32)], meta)
    assert buf.device == meta and buf.dtype == torch.uint8
    assert [m[:2] for m in metas] == [((), torch.float64), ((3,), torch.int32)]
    assert buf.numel() == distributed._packed_size(metas)
