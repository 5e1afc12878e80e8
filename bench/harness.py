"""One run of one cell: set-up, the measured window, the check, the result.

The window drives ``repro_torch.dp.DPService`` in a closed loop: each of
the traffic's clients submits a request, and submits its next one only
once the ``poll`` that returns its answer has come back. A request's
latency runs from its ``submit`` to that ``poll``, on this module's clock.
After the window the requests still open are answered (a minute at most),
a sample of every answer drawn from the seed is held against the plain
reference, and the metrics the cell names are read by their own modules.
"""
from __future__ import annotations

import gc
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bench import manifest as _manifest
from bench import trace as _trace

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: requests drawn from one generator
BLOCK = 256
#: seconds past the window's close that an open request may take
LATE_S = 60.0
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 96
#: generator streams of one seed
WINDOW_STREAM, WARM_STREAM, SAMPLE_STREAM = 0, 1, 2
#: the arrival processes a traffic mix may name under ``loop``
LOOPS = ("closed",)


class Requests:
    """The payloads of one stream of requests: request ``i`` comes from
    block ``i // BLOCK``, drawn by a generator seeded with (seed, stream,
    block), so the same seed gives the same requests in the same order."""

    def __init__(self, problem, config: dict, seed: int, stream: int):
        self.problem, self.config = problem, config
        self.key = [seed % 2 ** 64, stream]
        self.block, self.rows = -1, []

    def __call__(self, i: int) -> dict:
        b = i // BLOCK
        if b != self.block:
            rng = np.random.default_rng(self.key + [b])
            self.block, self.rows = b, self.problem.draw(self.config, rng, BLOCK)
        return self.rows[i % BLOCK]


class Reservoir:
    """A uniform sample of ``size`` answers from a stream of them, drawn by
    a generator seeded from the run's seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.kept = size, 0, []
        self.rng = np.random.default_rng([seed % 2 ** 64, SAMPLE_STREAM])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.kept[j] = item


@dataclass
class Observation:
    """What one run saw, for the metric readers (``bench/metrics``)."""

    seconds: float
    setup_s: float
    peak_bytes: int
    #: latencies (ms) of the requests answered within the window
    latencies_ms: list
    #: (bytes, operations) of one request's solve
    work: tuple
    #: span name -> durations (s) of the benchmark's calls in the window
    spans: dict
    #: the engine's counters moved over the window's steps
    engine: dict
    #: route -> requests its drains answered in the window's steps
    lanes_by_route: Counter
    #: the routes that are one hand-written kernel launch
    kernel_routes: set
    trace: Optional[_trace.TraceSummary] = None
    devices: list = field(default_factory=list)


def build_service(config: dict, chips: int, device: torch.device):
    """The service as the configuration deploys it: ``max_batch`` lanes a
    card times the cards, sharded over every card by ``mesh="auto"`` (on
    the CPU, over ``chips`` CPU slots)."""
    from repro_torch import dp

    svc = config["service"]
    kw = dict(max_batch=int(config["lanes_per_chip"]) * chips,
              feedback=bool(svc["feedback"]), cache_size=int(svc["cache_size"]),
              device=device)
    if device.type == "cuda" and torch.cuda.device_count() == chips:
        mesh = svc["mesh"]
    elif chips > 1:
        mesh = dp.default_mesh(devices=[torch.device(device.type, i) if device.type == "cuda"
                                        else device for i in range(chips)])
    else:
        mesh = None
    return dp.DPService(mesh=mesh, **kw)


class ClosedLoop:
    """The traffic's clients over one service."""

    def __init__(self, svc, problem_name: str, requests: Requests, traced: bool,
                 reservoir: Optional[Reservoir] = None):
        self.svc, self.name, self.requests = svc, problem_name, requests
        self.traced, self.reservoir = traced, reservoir
        self.next = 0
        #: tid -> (client, payload, submit time)
        self.open: dict = {}
        self.spans = {"submit": [], "step": [], "poll": []}
        self.latencies_ms: list = []
        self.routes: Counter = Counter()
        self.failed = 0

    def submit(self, client: int) -> None:
        payload = self.requests(self.next)
        self.next += 1
        t0 = time.perf_counter()
        with _trace.span("submit", self.traced):
            tid = self.svc.submit(self.name, reconstruct=True, **payload)
        self.spans["submit"].append(time.perf_counter() - t0)
        self.open[tid] = (client, payload, t0)

    def step(self, t_end: float, resubmit: bool) -> None:
        """One service step, then a poll for each ticket it resolved: an
        answer polled by ``t_end`` counts in the window."""
        t0 = time.perf_counter()
        with _trace.span("step", self.traced):
            tids = self.svc.step()
        self.spans["step"].append(time.perf_counter() - t0)
        for tid in tids:
            t1 = time.perf_counter()
            with _trace.span("poll", self.traced):
                res = self.svc.poll(tid)
            t2 = time.perf_counter()
            self.spans["poll"].append(t2 - t1)
            client, payload, t_sub = self.open.pop(tid)
            if res is None or res.status != "done":
                self.failed += 1
            else:
                self.routes[res.backend] += 1
                if t2 <= t_end:
                    self.latencies_ms.append((t2 - t_sub) * 1e3)
                if self.reservoir is not None:
                    self.reservoir.offer((payload, res.answer, res.solution.solution))
            if resubmit and t2 < t_end:
                self.submit(client)

    def window(self, clients: int, seconds: float) -> float:
        """The measured window; returns its start on this module's clock."""
        t0 = time.perf_counter()
        t_end = t0 + seconds
        with _trace.span("window", self.traced):
            for c in range(clients):
                self.submit(c)
            while time.perf_counter() < t_end:
                self.step(t_end, resubmit=True)
        return t0

    def finish(self) -> None:
        """Answer the requests still open after the window (no new ones)."""
        t_end = time.perf_counter() + LATE_S
        while self.open and time.perf_counter() < t_end:
            self.step(0.0, resubmit=False)
        self.failed += len(self.open)


def warm_up(svc, problem_name: str, requests: Requests, batch: int, drains: int) -> None:
    """``drains`` drains of ``batch`` requests: the window's shape, its
    kernels loaded and its walk captured (the walk's graph is captured at a
    shape's second walk)."""
    i = 0
    for _ in range(drains):
        for _ in range(batch):
            svc.submit(problem_name, reconstruct=True, **requests(i))
            i += 1
        for res in svc.run().values():
            if res.status != "done":
                raise RuntimeError(f"warm-up request {res.tid} ended {res.status}")


def peak_bytes(chips: int, device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: Optional[torch.device] = None,
             root: Path = ROOT, bench: Path = _manifest.BENCH) -> tuple:
    """Run ``workload`` once; returns ``(result, check lines)``. ``device``
    None runs on the cards the cell asks for; a CPU device runs the same
    path on the CPU (the tests)."""
    man = _manifest.Manifest(root, bench)
    cell = man.cell(workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"traffic {cell['traffic']!r} asks for loop {traffic.get('loop')!r}; "
                         f"the harness runs {', '.join(LOOPS)}")
    problem = man.problem(config["problem"])
    chips = int(cell["chips"])
    device = device or torch.device("cuda", 0)
    devices = list(range(chips)) if device.type == "cuda" else [-1]

    from repro_torch.dp import backends as _backends

    t_imports = time.perf_counter()
    svc = build_service(config, chips, device)
    t_service = time.perf_counter()
    clients = int(traffic["clients"])
    batch = min(clients, svc.engine.max_batch)
    warm_up(svc, config["problem"], Requests(problem, config, seed, WARM_STREAM),
            batch, drains=2)
    if trace:
        # the process's first profiler start is slow: pay it here
        with _trace.profiler():
            warm_up(svc, config["problem"], Requests(problem, config, seed + 1, WARM_STREAM),
                    batch, drains=1)
    t_warm = time.perf_counter()
    loop = ClosedLoop(svc, config["problem"], Requests(problem, config, seed, WINDOW_STREAM),
                      trace, Reservoir(int(traffic["sample"]), seed))
    before = dict(svc.engine.stats)
    summary = None
    if trace:
        with _trace.profiler() as prof:
            t0 = loop.window(clients, seconds)
        after = dict(svc.engine.stats)
        summary = _trace.summarize(_trace.events(prof), devices)
        del prof
    else:
        t0 = loop.window(clients, seconds)
        after = dict(svc.engine.stats)
    setup_s = t0 - t_start
    window_routes = Counter(loop.routes)
    attempted = loop.next
    loop.finish()
    peak = peak_bytes(chips, device)
    kernel_routes = {n for n in _backends.names() if _backends.get(n).kernel}
    samples = loop.reservoir.kept
    del svc, loop.svc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = config["check"]
    t_check = time.perf_counter()
    numbers = problem.compare(samples, config, device, limits)
    t_check = time.perf_counter() - t_check
    wrong = numbers.pop("wrong")
    numbers["missing"] = loop.failed
    correct = all(numbers[k] <= limits[k] for k in limits) and len(samples) > 0
    obs = Observation(
        seconds=seconds,
        setup_s=setup_s, peak_bytes=peak, latencies_ms=loop.latencies_ms,
        work=problem.work(config), spans=loop.spans,
        engine={k: after[k] - before.get(k, 0) for k in after},
        lanes_by_route=window_routes, kernel_routes=kernel_routes,
        trace=summary, devices=devices)
    metrics = {}
    for m, module in man.metrics(workload, trace):
        value = module.read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": loop.failed + wrong, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s(devices)
        dev["window_s"] = summary.window_s
        result["breakdown"] = breakdown(summary, len(devices))
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    lines = [f"set-up {setup_s:.3f} s: start and imports {t_imports - t_start:.3f}, "
             f"service {t_service - t_imports:.3f}, warm-up {t_warm - t_service:.3f}",
             f"compared {len(samples)} answers of {loop.reservoir.seen} "
             f"with the reference in {t_check:.3f} s"]
    lines += [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    return result, lines


def breakdown(summary: _trace.TraceSummary, chips: int) -> dict:
    """The ten device operations that took most time (seconds summed over
    the cards) and the device's idle time by what the host was doing
    (seconds a card, averaged over the cards)."""
    by_name: Counter = Counter()
    for name, _, s in summary.ops:
        by_name[name] += s
    idle = sorted(summary.idle_by_span.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[f"idle in {n}" if n in _trace.SPANS else f"idle {n}", s / chips]
                          for n, s in idle[:10]]}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one no run may hold."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
