"""The port's telemetry against ``repro.dp``'s on the CPU: modes and log
levels as arguments (no environment), the registry, spans, drain phases,
the routing audit, exporters, ``torch.profiler`` ranges in ``profile``
mode, and — for the same traffic through both services — the same span
events and the same metric names.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import dp as jdp  # noqa: E402
from repro.dp import telemetry as jtel  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.dp import telemetry as ttel  # noqa: E402

#: metrics only the reference has: its jit trace counter and its per-entry
#: kernel counters (the port's kernel counters are the LAUNCHES dicts)
REFERENCE_ONLY = ("dp_backend_traces_total", "dp_kernel_")


@pytest.fixture(autouse=True)
def _telemetry_isolated(monkeypatch):
    monkeypatch.delenv(jtel.ENV_MODE, raising=False)
    monkeypatch.delenv(jtel.ENV_LOG, raising=False)

    def clean():
        for tel in (ttel, jtel):
            tel.reset()
            tel.REGISTRY.reset()
            tel.clear_spans()
            tel.clear_audit()
        tautotune.reset()

    clean()
    yield
    clean()


def _mcm_payloads(n, seed=0, size=6):
    rng = np.random.default_rng(seed)
    return [tdp.get_problem("mcm").sample(rng, size) for _ in range(n)]


def test_modes_and_log_levels_are_arguments(monkeypatch):
    monkeypatch.setenv("REPRO_TELEMETRY", "spans")       # not read
    assert ttel.mode() == "off" and not ttel.enabled("basic")
    assert ttel.configure(mode="basic") == "off"
    assert ttel.enabled("basic") and not ttel.enabled("spans")
    assert ttel.configure(mode="profile", log="debug") == "basic"
    assert ttel.enabled("spans") and ttel.log_level() == "debug"
    for bad in ({"mode": "span"}, {"log": "loud"}):
        with pytest.raises(ValueError):
            ttel.configure(**bad)
    assert ttel.mode() == "profile"
    ttel.reset()
    assert (ttel.mode(), ttel.log_level()) == ("off", "off")


def test_logger_hierarchy():
    log = ttel.get_logger("engine")
    assert log.name == "repro_torch.dp.engine"
    assert ttel.get_logger("repro_torch.dp.x").name == "repro_torch.dp.x"


def test_registry_kinds_quantiles_and_noop_when_off():
    ttel.count("t_total")
    assert "t_total" not in ttel.REGISTRY.counters()      # off: no-op
    ttel.configure(mode="basic")
    ttel.count("t_total", 2)
    with pytest.raises(ValueError):
        ttel.REGISTRY.counter("t_total").inc(-1)
    with pytest.raises(ValueError):
        ttel.REGISTRY.gauge("t_total")
    for v in (1.0, 2.0, 3.0, 40.0):
        ttel.observe_ms("t_ms", v)
    h = ttel.REGISTRY.histograms()["t_ms"]
    assert h.count == 4 and 1.0 <= h.quantile(0.5) <= 40.0
    assert h.quantile(1.0) == 40.0


def _service_traffic(tel, make, seed):
    tel.configure("spans")
    svc = make()
    payloads = _mcm_payloads(5, seed)
    tids = [svc.submit("mcm", reconstruct=(i % 2 == 0), **kw)
            for i, kw in enumerate(payloads)]
    tids.append(svc.submit("mcm", **payloads[1]))          # engine dedup
    tids.append(svc.submit("mcm", deadline_ms=0.0, **payloads[3]))
    time.sleep(0.002)
    out = svc.run()
    tids.append(svc.submit("mcm", **payloads[0]))          # cache hit
    out.update(svc.run())
    return [out[t] for t in tids], tel.snapshot()


def test_spans_and_metric_names_equal_the_reference():
    got, tsnap = _service_traffic(ttel, lambda: tdp.DPService(max_batch=4,
                                                             device="cpu"), 3)
    want, jsnap = _service_traffic(jtel, lambda: jdp.DPService(max_batch=4,
                                                              mesh=None), 3)
    for g, w in zip(got, want):
        assert g.status == w.status and g.cached == w.cached
        assert g.span.event_names() == w.span.event_names(), w.tid
        assert set(g.span.phases()) == set(w.span.phases())
        assert g.span.meta.keys() == w.span.meta.keys()
    for kind in ("counters", "gauges", "histograms"):
        ours = set(tsnap[kind])
        theirs = {n for n in jsnap[kind] if not n.startswith(REFERENCE_ONLY)}
        assert ours == theirs, kind
    for name in ("dp_service_submitted_total", "dp_service_completed_total",
                 "dp_service_cache_hits_total", "dp_service_expired_total",
                 "dp_engine_drains_total", "dp_engine_requests_total",
                 "dp_engine_dedup_fanout_total"):
        assert tsnap["counters"][name] == jsnap["counters"][name], name
    assert [d["kind"] for d in tsnap["routing_audit"]] == \
        [d["kind"] for d in jsnap["routing_audit"]]


def test_drain_report_phases():
    ttel.configure(mode="basic")
    eng = tdp.DPEngine(max_batch=8, device="cpu")
    eng.submit("mcm", reconstruct=True, dims=[4, 5, 6, 7, 8])
    eng.run()
    rep = eng.last_drain
    assert rep is not None and {"solve", "traceback", "decode"} <= set(rep.phases)
    assert ttel.REGISTRY.histograms()["dp_engine_solve_ms"].count == 1


def test_audit_silent_below_spans_and_routing_unchanged_by_telemetry():
    def leg(mode):
        ttel.configure(mode=mode)
        tautotune.reset()
        eng = tdp.DPEngine(max_batch=8, feedback=False, device="cpu")
        rids = [eng.submit("mcm", **kw) for kw in _mcm_payloads(4)]
        out = eng.run()
        return [(out[r].backend, out[r].answer) for r in rids]

    off = leg("basic")
    assert ttel.routing_audit() == []
    assert leg("spans") == off
    decisions = tdp.routing_report(device="cpu")["decisions"]
    assert {"drain", "rank_batch"} <= {d["kind"] for d in decisions}


def test_profile_mode_names_drains_in_a_torch_profiler_trace():
    ttel.configure(mode="profile")
    eng = tdp.DPEngine(max_batch=4, device="cpu")
    for kw in _mcm_payloads(2):
        eng.submit("mcm", **kw)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run()
    keys = {e.key for e in prof.key_averages()}
    assert any(k.startswith("dp_drain:mcm:") for k in keys), sorted(keys)[:20]


def test_snapshot_prometheus_and_kernel_counters(tmp_path):
    ttel.configure(mode="spans")
    svc = tdp.DPService(max_batch=8, device="cpu")
    tid = svc.submit("mcm", dims=[4, 5, 6, 7])
    svc.run()[tid]
    snap = ttel.snapshot()
    assert snap["mode"] == "spans"
    assert snap["counters"]["dp_service_completed_total"] == 1
    assert any(s["tid"] == tid for s in snap["spans"])
    assert snap["kernel_launches"]["mcm_pipeline"] == 0      # CPU: no launch
    assert set(snap["kernel_launches"]) >= {
        "sdp_pipeline", "sdp_chunked", "mcm_tiled_fused", "grid_pipeline_spandiag"}
    assert isinstance(snap["build_count"], int)
    path = ttel.save_snapshot(str(tmp_path / "snap.json"))
    assert json.load(open(path))["mode"] == "spans"
    text = ttel.to_prometheus()
    assert "# TYPE dp_kernel_mcm_pipeline_launches_total counter" in text
    assert "dp_service_completed_total 1" in text
