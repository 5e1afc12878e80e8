"""DPService tour on the port: the cache-fronted serving tier on the card.

Mixed-problem traffic through submit/poll handles — priorities, deadlines,
the content-digest answer cache and intra-drain dedup. Runs with telemetry
in ``spans`` mode: a request's timestamped span, the per-phase latency
breakdown, the routing audit and a Prometheus excerpt.

The tour ends with a streaming session: one alignment grown a few columns
at a time through ``open_session/append``, where every append after the
first warm-starts off the longest solved prefix in the chain-digest index —
recomputing only the extension, sticky to the session's route — and
re-sending an already-solved length is answered at admission with no
solve at all.

Run: ``PYTHONPATH=src python examples/torch_dp_service.py [--device cpu]``
"""
import argparse
import time

import numpy as np

from repro_torch import dp
from repro_torch.dp import telemetry


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = dp.backends.resolve_device(ap.parse_args().device)

    # telemetry is off unless configured; the tour opts in so the
    # walkthrough below always has data
    telemetry.configure(mode="spans")

    svc = dp.DPService(max_batch=16, device=dev)
    print(f"device: {dev} -> engine: {type(svc.engine).__name__}")

    rng = np.random.default_rng(0)
    # a small pool of unique instances, drawn with repeats — the shape of
    # real traffic, and what the digest cache + dedup are for
    pool = []
    for name, size in [("mcm", 9), ("mcm", 13), ("lcs", 8),
                       ("edit_distance", 8), ("unbounded_knapsack", 10)]:
        prob = dp.get_problem(name)
        pool += [(name, prob.sample(rng, size)) for _ in range(3)]

    tids = []
    t0 = time.perf_counter()
    for i in range(120):
        name, kw = pool[int(rng.integers(len(pool)))]
        tids.append(svc.submit(
            name, reconstruct=(i % 5 == 0), priority=int(rng.integers(3)),
            deadline_ms=60_000.0, **kw))
        if (i + 1) % 10 == 0:       # arrivals interleave with service steps
            svc.step()
    out = svc.run()
    wall = time.perf_counter() - t0

    done = [r for r in out.values() if r.status == "done"]
    recon = [r for r in done if r.solution is not None]
    lat = sorted(r.latency_ms for r in done)
    print(f"\n{len(done)} requests in {wall:.2f}s "
          f"({len(done) / wall:.0f} req/s), "
          f"p50 latency {lat[len(lat) // 2]:.1f} ms")
    cs = svc.cache_stats()
    print(f"cache: {cs['hits']} hits / {cs['misses']} misses "
          f"({100 * cs['hit_rate']:.0f}% hit rate, {cs['size']} entries); "
          f"intra-drain dedup: {svc.engine.stats['dedup_hits']} requests "
          f"shared a solve lane")
    eng = svc.engine.stats
    print(f"engine: {eng['device_batches']} batched solves, "
          f"{eng['feedback_observations']} latencies fed back to routing")
    sample = next(r for r in recon if r.problem == "mcm")
    print(f"sample reconstructed {sample.problem}: "
          f"{sample.solution.solution['string']} via {sample.backend}")

    print("\nroutes served (problem, backend -> requests):")
    for (name, backend), count in sorted(svc.routes.items()):
        print(f"  {name:20s} {backend:14s} {count}")

    rep = dp.routing_report(device=dev)
    print(f"\nrouting_report on {rep['platform']}: observations by "
          f"measurement regime")
    by_regime = {}
    for row in rep["shapes"]:
        key = str(row["regime"])
        by_regime.setdefault(key, []).append(row)
    for regime, rows in sorted(by_regime.items()):
        picks = {r["measured_choice"] for r in rows}
        print(f"  {regime:24s} {len(rows)} shape(s), measured picks: "
              f"{', '.join(sorted(picks))}")

    # -- telemetry walkthrough ----------------------------------------------
    # 1. every non-cached result carries its span: the request's
    #    timestamped lifecycle and the per-phase attribution derived from it
    spanned = next(r for r in done if r.span is not None
                   and "solved" in r.span.event_names())
    print(f"\nspan of tid {spanned.tid} ({spanned.problem} via "
          f"{spanned.span.meta.get('backend')}):")
    t0 = spanned.span.events[0][1]
    for name, t in spanned.span.events:
        print(f"  {(t - t0) * 1e3:9.3f} ms  {name}")
    print("  phases: " + ", ".join(
        f"{k}={v:.3f}ms" for k, v in spanned.span.phases().items()))

    # 2. the registry aggregates the same attribution across ALL requests
    print("\nper-phase latency quantiles (registry histograms):")
    for name, h in sorted(telemetry.REGISTRY.histograms().items()):
        if name.startswith("dp_service_") and h.count:
            print(f"  {name:28s} n={h.count:4d} p50={h.quantile(0.5):8.3f} "
                  f"p99={h.quantile(0.99):8.3f} ms")

    # 3. the routing audit records what every decision saw; 4. exporters
    decisions = rep["decisions"]
    print(f"\nrouting audit: {len(decisions)} decisions recorded "
          f"(last: {decisions[-1]['kind']} -> {decisions[-1]['chosen']})")
    prom = telemetry.to_prometheus().splitlines()
    print(f"prometheus export: {len(prom)} lines, e.g.")
    for line in prom[:4]:
        print(f"  {line}")
    # telemetry.save_snapshot("telemetry.json") dumps all of the above

    # -- streaming session ----------------------------------------------
    # one growing alignment: y gains 24 columns per append; the service
    # finds the longest already-solved prefix through the chain-digest
    # index and recomputes only the extension — bit-identical to a cold
    # solve of the full instance
    x = rng.integers(0, 4, size=96)
    y = rng.integers(0, 4, size=240)
    sid = svc.open_session("needleman_wunsch")
    print(f"\nstreaming session {sid}: needleman_wunsch, "
          f"{len(x)} rows, y growing 120 -> {len(y)}")
    for length in range(120, len(y) + 1, 24):
        t0 = time.perf_counter()
        tid = svc.append(sid, x=x, y=y[:length])
        res = svc.run()[tid]
        kind = "extend" if res.extended else "cold"
        print(f"  len={length:3d} {kind:6s} via {res.backend:14s} "
              f"answer={float(np.float64(res.answer)):8.1f}  "
              f"({(time.perf_counter() - t0) * 1e3:6.2f} ms)")
    # an already-solved length resolves at admission: full prefix-index hit
    rep = svc.poll(svc.append(sid, x=x, y=y))
    print(f"  len={len(y):3d} replay: cached={rep.cached} "
          f"(no backlog slot, no solve)")
    pidx = svc.session_stats()["prefix_index"]
    summary = svc.close_session(sid)
    print(f"  closed: {summary['appends']} appends, "
          f"{summary['extends']} extends, affinity {summary['affinity']}; "
          f"prefix index {pidx['hits']} hits / {pidx['misses']} misses "
          f"({100 * pidx['hit_rate']:.0f}% hit rate)")


if __name__ == "__main__":
    main()
