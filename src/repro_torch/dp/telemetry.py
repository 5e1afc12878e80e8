"""Telemetry of the serving stack: request spans, the metrics registry,
the routing audit, latency attribution and exporters.

  * **Request spans.** In ``spans`` mode every ``DPService.submit()``
    opens a :class:`Span` that collects timestamped events (``admitted``,
    ``enqueued``, ``dispatched``, ``batched``, ``retraced``, ``solved``,
    ``extended``, ``traceback``, ``decoded``, ``dedup_fanout``,
    ``cache_hit``, ``prefix_hit``, ``expired``, ``shed``, ``resolved``)
    and rides back on the ``ServiceResult``. Finished spans also land in a
    bounded ring for export.
  * **Metrics registry.** Named monotonic counters, gauges and
    fixed-bucket histograms (:data:`REGISTRY`), thread-safe, with
    weakly referenced *stat sources* that absorb the engine's and the
    service's ``stats`` dicts into one snapshot.
  * **Routing audit.** Each ``autotune.rank`` / ``rank_batch`` decision and
    each engine drain's route goes into a bounded ring with its candidates'
    measured and analytical scores, the regime and the chosen route,
    surfaced through ``dp.routing_report()["decisions"]``.
  * **Exporters.** :func:`snapshot` (a JSON-able dict, with the kernels'
    launch counters), :func:`save_snapshot`, :func:`to_prometheus`, and in
    ``profile`` mode a ``torch.profiler.record_function`` range around
    every engine drain, so drains show as named ranges in a
    ``torch.profiler`` trace.

Telemetry is off by default and free when off: every helper is a guarded
no-op below its level, all timestamps come from the monotonic
:func:`clock`, buffers are bounded rings, and nothing on the solve path
adds a device synchronisation. The mode (``off``, ``basic``, ``spans``,
``profile``) and the log level (``off``, ``error``, ``warning``, ``info``,
``debug``) are arguments of :func:`configure`; nothing is read from the
environment.

The per-kernel counters are the kernel modules' own ``LAUNCHES`` dicts
(:func:`kernel_launches`), which move only where a kernel launches.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "REGISTRY", "Counter", "DrainReport", "Gauge", "Histogram",
    "MetricsRegistry", "Span", "add_phase", "clock", "configure", "count",
    "drain_scope", "enabled", "get_logger", "kernel_launches", "log_level",
    "mode",
    "new_span", "observe_ms", "record_route_decision", "reset",
    "routing_audit", "save_snapshot", "set_gauge", "snapshot",
    "spans_snapshot", "to_prometheus",
]

#: the one clock every span event and phase timing uses — monotonic,
#: high-resolution, never wall time (wall clocks jump; attribution math
#: must not)
clock = time.perf_counter

# ---------------------------------------------------------------------------
# Mode and log level
# ---------------------------------------------------------------------------
MODES = ("off", "basic", "spans", "profile")
_LEVEL_OF = {m: i for i, m in enumerate(MODES)}
LEVEL_OFF, LEVEL_BASIC, LEVEL_SPANS, LEVEL_PROFILE = 0, 1, 2, 3
LOG_LEVELS = ("off", "error", "warning", "info", "debug")
_LOG_LEVEL_NO = {"off": logging.CRITICAL + 10, "error": logging.ERROR,
                 "warning": logging.WARNING, "info": logging.INFO,
                 "debug": logging.DEBUG}
#: root of the port's logger hierarchy
LOGGER_ROOT = "repro_torch.dp"

_mode_lock = threading.Lock()
_mode: str = "off"
_level: int = LEVEL_OFF              # cached int level for hot-path checks
_log: str = "off"


def mode() -> str:
    """The active telemetry mode."""
    return _mode


def log_level() -> str:
    """The active log level of the ``repro_torch.dp`` loggers."""
    return _log


def configure(mode: Optional[str] = None, log: Optional[str] = None) -> str:
    """Set the telemetry mode and/or the log level; returns the previous
    mode. An unknown value raises (a typo never silently disables
    telemetry)."""
    global _mode, _level, _log
    if mode is not None and mode not in MODES:
        raise ValueError(f"invalid telemetry mode {mode!r}; "
                         f"expected one of {', '.join(MODES)}")
    if log is not None and log not in LOG_LEVELS:
        raise ValueError(f"invalid log level {log!r}; "
                         f"expected one of {', '.join(LOG_LEVELS)}")
    with _mode_lock:
        prev = _mode
        if mode is not None:
            _mode, _level = mode, _LEVEL_OF[mode]
        if log is not None:
            _log = log
    if log is not None:
        _configure_logging()
    return prev


def reset() -> None:
    """Back to ``off`` with silent logging. Does not clear the registry."""
    configure(mode="off", log="off")


def enabled(at: str = "basic") -> bool:
    """Whether telemetry at level ``at`` is active."""
    return _level >= _LEVEL_OF[at]


# ---------------------------------------------------------------------------
# Logging hierarchy: repro_torch.dp.<module>
# ---------------------------------------------------------------------------
def _configure_logging() -> None:
    root = logging.getLogger(LOGGER_ROOT)
    if not any(isinstance(h, logging.NullHandler) for h in root.handlers):
        root.addHandler(logging.NullHandler())
    root.setLevel(_LOG_LEVEL_NO[_log])
    if _log != "off" and not any(isinstance(h, logging.StreamHandler)
                                 and not isinstance(h, logging.NullHandler)
                                 for h in root.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)


def get_logger(module: str) -> logging.Logger:
    """``logging.getLogger("repro_torch.dp.<module>")``; the hierarchy's
    level is :func:`configure`'s ``log`` (silent by default)."""
    _configure_logging()
    name = module if module.startswith(LOGGER_ROOT) else f"{LOGGER_ROOT}.{module}"
    return logging.getLogger(name)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------
#: default latency buckets (ms): wide geometric coverage from sub-50µs
#: host-side hops to 10s tail drains; fixed so two runs' histograms are
#: directly comparable (the bench's reproducible-tail requirement)
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0)
#: buckets for small integer distributions (batch sizes, lane counts)
DEFAULT_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0, 512.0)


class Counter:
    """Monotonic counter: ``inc()`` only ever moves it up."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> float:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {amount})")
        with self._lock:
            self._value += amount
            return self._value


class Gauge:
    """Point-in-time value (backlog depth, cache size, …)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    @property
    def value(self) -> float:
        return self._value

    def set(self, value: float) -> float:
        with self._lock:
            self._value = float(value)
            return self._value


class Histogram:
    """Fixed-bucket histogram with quantile estimation.

    Buckets are upper bounds (an implicit ``+inf`` overflow bucket is
    always present). Quantiles interpolate linearly inside the winning
    bucket, clamped to the observed min/max — tail figures are thus a
    deterministic function of the (bounded, mergeable) bucket counts, not
    of an unbounded sample list."""

    __slots__ = ("name", "buckets", "counts", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, name: str, buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name!r} needs ascending buckets")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            i = 0
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 ≤ q ≤ 1) from the bucket counts."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = (self.buckets[i] if i < len(self.buckets)
                      else max(self.max, lo))
                if cum + c >= target:
                    frac = (target - cum) / c
                    est = lo + frac * (hi - lo)
                    return min(max(est, self.min), self.max)
                cum += c
            return self.max

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": round(self.sum, 6),
                "min": round(self.min, 6) if self.count else None,
                "max": round(self.max, 6) if self.count else None,
                "buckets": [[ub, c] for ub, c
                            in zip(self.buckets, self.counts)]
                           + [["+inf", self.counts[-1]]],
            }


class MetricsRegistry:
    """Process-wide named metrics plus weak-referenced stat sources.

    Metric creation is get-or-create by name (a name can hold exactly one
    metric kind — mixing kinds raises). ``register_source`` absorbs a
    component's legacy ``stats`` dict (engine, service) by weak reference:
    the snapshot exports every live source's dict without the component
    paying any per-event cost, and dead components fall out of the
    snapshot automatically."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "OrderedDict[str, Any]" = OrderedDict()
        self._sources: "OrderedDict[str, tuple]" = OrderedDict()
        self._source_seq = 0

    def _named(self, name: str, kind, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, *args)
            elif not isinstance(m, kind):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._named(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._named(name, Gauge)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS) -> Histogram:
        return self._named(name, Histogram, buckets)

    def register_source(self, kind: str, obj: Any,
                        attr: str = "stats") -> str:
        """Absorb ``obj.<attr>`` (a plain dict — the compatibility view)
        into future snapshots. Weakly referenced; returns the source name.
        Dead references are pruned on registration so short-lived engines
        (tests, bench warmups) never accumulate."""
        with self._lock:
            for stale in [n for n, (ref, _) in self._sources.items()
                          if ref() is None]:
                del self._sources[stale]
            name = f"{kind}/{self._source_seq}"
            self._source_seq += 1
            self._sources[name] = (weakref.ref(obj), attr)
            return name

    def sources(self) -> Dict[str, dict]:
        out = {}
        with self._lock:
            dead = []
            for name, (ref, attr) in self._sources.items():
                obj = ref()
                if obj is None:
                    dead.append(name)
                    continue
                try:
                    out[name] = dict(getattr(obj, attr))
                except Exception:
                    continue
            for name in dead:
                del self._sources[name]
        return out

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {n: m.value for n, m in self._metrics.items()
                    if isinstance(m, Counter)}

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return {n: m.value for n, m in self._metrics.items()
                    if isinstance(m, Gauge)}

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return {n: m for n, m in self._metrics.items()
                    if isinstance(m, Histogram)}

    def reset(self) -> None:
        """Drop every metric and source (tests, bench leg isolation)."""
        with self._lock:
            self._metrics.clear()
            self._sources.clear()
            self._source_seq = 0


#: the process-global registry every helper below reports into
REGISTRY = MetricsRegistry()


def count(name: str, amount: float = 1.0) -> None:
    """Increment a registry counter — no-op below ``basic``."""
    if _level >= LEVEL_BASIC:
        REGISTRY.counter(name).inc(amount)


def set_gauge(name: str, value: float) -> None:
    """Set a registry gauge — no-op below ``basic``."""
    if _level >= LEVEL_BASIC:
        REGISTRY.gauge(name).set(value)


def observe_ms(name: str, ms: float,
               buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS) -> None:
    """Observe a latency into a registry histogram — no-op below
    ``basic``."""
    if _level >= LEVEL_BASIC:
        REGISTRY.histogram(name, buckets).observe(ms)


# ---------------------------------------------------------------------------
# Request spans
# ---------------------------------------------------------------------------
#: completed spans kept for snapshot export (ring; oldest dropped)
SPAN_RING_MAX = 2048
_SPANS: "deque" = deque(maxlen=SPAN_RING_MAX)
_spans_lock = threading.Lock()

#: event-pair → phase attribution (ms) derived by :meth:`Span.phases`
_PHASE_EDGES = (
    ("queue", "enqueued", "dispatched"),      # backlog wait
    ("dispatch", "dispatched", "batched"),    # engine bucket wait
    ("solve", "batched", "solved"),           # the batched device call
    ("extend", "batched", "extended"),        # warm-start extension solve
    ("traceback", "solved", "traceback"),     # batched path walk
    ("decode", "traceback", "decoded"),       # problem-level decode
)


@dataclasses.dataclass
class Span:
    """One request's timestamped lifecycle. ``events`` is an append-only
    list of ``(name, t)`` pairs on the :func:`clock` timebase; ``meta``
    carries decision facts (backend, batch size, cached, cold-trace …)."""

    tid: int
    problem: str
    events: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def add(self, name: str, t: Optional[float] = None) -> "Span":
        self.events.append((name, clock() if t is None else t))
        return self

    def event_names(self) -> List[str]:
        return [name for name, _ in self.events]

    def _t(self, name: str) -> Optional[float]:
        for n, t in self.events:
            if n == name:
                return t
        return None

    def phases(self) -> Dict[str, float]:
        """Per-phase attribution in ms — the queue/dispatch/solve/
        traceback/decode breakdown, plus ``total`` (first→last event).
        Phases whose events are absent (no reconstruct, cache hit) are
        omitted; a missing ``traceback`` chains ``decode`` off ``solved``."""
        out: Dict[str, float] = {}
        for phase, start, end in _PHASE_EDGES:
            t1 = self._t(end)
            if t1 is None:
                continue
            t0 = self._t(start)
            if t0 is None and phase == "decode":
                t0 = self._t("solved")
            if t0 is not None:
                out[phase] = (t1 - t0) * 1e3
        if self.events:
            out["total"] = (self.events[-1][1] - self.events[0][1]) * 1e3
        return out

    def to_dict(self) -> dict:
        t0 = self.events[0][1] if self.events else 0.0
        return {
            "tid": self.tid,
            "problem": self.problem,
            "events": [[n, round((t - t0) * 1e3, 6)] for n, t in self.events],
            "phases_ms": {k: round(v, 6) for k, v in self.phases().items()},
            "meta": dict(self.meta),
        }


def new_span(tid: int, problem: str) -> Optional[Span]:
    """Open a span for one request — ``None`` below ``spans`` mode (the
    caller's per-event code is then skipped entirely)."""
    if not enabled("spans"):
        return None
    return Span(tid=tid, problem=problem)


def finish_span(span: Optional[Span]) -> Optional[Span]:
    """File a completed span into the export ring; returns it."""
    if span is not None:
        with _spans_lock:
            _SPANS.append(span)
    return span


def spans_snapshot(limit: Optional[int] = None) -> List[dict]:
    with _spans_lock:
        items = list(_SPANS)
    if limit is not None:
        items = items[-limit:]
    return [s.to_dict() for s in items]


def clear_spans() -> None:
    with _spans_lock:
        _SPANS.clear()


# ---------------------------------------------------------------------------
# Drain scope: per-drain phase attribution shared engine ↔ reconstruct
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DrainReport:
    """Phase timings and decision facts of ONE engine bucket drain. The
    engine publishes the last one (``engine.last_drain``); the service
    reads it to attribute span events and per-phase histograms to every
    request the drain resolved."""

    bucket: tuple
    backend: str
    batch_size: int
    unique: int
    t_start: float
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    cold: bool = False
    explored: bool = False
    sharded: bool = False

    def to_dict(self) -> dict:
        return {
            "bucket": repr(self.bucket), "backend": self.backend,
            "batch_size": self.batch_size, "unique": self.unique,
            "cold": self.cold, "explored": self.explored,
            "sharded": self.sharded,
            "phases_ms": {k: round(v, 6) for k, v in self.phases.items()},
        }


_TLS = threading.local()


@contextmanager
def drain_scope(bucket: tuple, backend: str, batch_size: int, unique: int):
    """Open the per-drain attribution context (``None`` in ``off`` mode).
    While active, :func:`add_phase` calls — including from
    ``reconstruct.reconstruct_batch`` deep below the engine — land on this
    drain's report. In ``profile`` mode the body also runs inside a
    ``torch.profiler.record_function`` range named
    ``dp_drain:<problem>:<route>:b<batch>``, so drains show in a
    ``torch.profiler`` trace."""
    if not enabled("basic"):
        yield None
        return
    report = DrainReport(bucket=bucket, backend=backend,
                         batch_size=batch_size, unique=unique,
                         t_start=clock())
    prev = getattr(_TLS, "drain", None)
    _TLS.drain = report
    annotation = None
    if enabled("profile"):
        try:
            import torch

            annotation = torch.profiler.record_function(
                f"dp_drain:{bucket[0]}:{backend}:b{batch_size}")
            annotation.__enter__()
        except Exception:           # profiling must never break a drain
            annotation = None
    try:
        yield report
    finally:
        if annotation is not None:
            try:
                annotation.__exit__(None, None, None)
            except Exception:
                pass
        _TLS.drain = prev


def current_drain() -> Optional[DrainReport]:
    return getattr(_TLS, "drain", None)


def add_phase(phase: str, ms: float) -> None:
    """Record one phase duration: onto the active drain report (if any)
    and into the ``dp_engine_<phase>_ms`` histogram. No-op below
    ``basic``."""
    if not enabled("basic"):
        return
    report = current_drain()
    if report is not None:
        report.phases[phase] = report.phases.get(phase, 0.0) + ms
    REGISTRY.histogram(f"dp_engine_{phase}_ms").observe(ms)


# ---------------------------------------------------------------------------
# Routing audit
# ---------------------------------------------------------------------------
AUDIT_RING_MAX = 2048
_AUDIT: "deque" = deque(maxlen=AUDIT_RING_MAX)
_audit_lock = threading.Lock()


def audit_enabled() -> bool:
    return enabled("spans")


def record_route_decision(kind: str, shape_key: tuple, regime,
                          candidates: List[dict], chosen: str,
                          **extra) -> None:
    """File one routing decision. ``candidates`` rows carry per-backend
    ``measured_ms`` (None = unmeasured in this regime) and
    ``analytical_cost`` — the measured-vs-analytical evidence the decision
    was made on. Bounded ring; no-op unless ``spans`` mode."""
    if not audit_enabled():
        return
    entry = {
        "t": clock(),
        "kind": kind,
        "shape_key": repr(tuple(shape_key)),
        "regime": repr(regime) if regime else "single",
        "candidates": candidates,
        "chosen": chosen,
    }
    entry.update(extra)
    with _audit_lock:
        _AUDIT.append(entry)
    count("dp_routing_decisions_total")


def routing_audit(limit: Optional[int] = None) -> List[dict]:
    """Most recent routing decisions (oldest first)."""
    with _audit_lock:
        items = list(_AUDIT)
    return items[-limit:] if limit is not None else items


def clear_audit() -> None:
    with _audit_lock:
        _AUDIT.clear()


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------
def kernel_launches() -> Dict[str, int]:
    """Launch counts of every kernel wrapper (the kernel modules' own
    ``LAUNCHES`` dicts), by wrapper name."""
    from repro_torch.kernels import (chunked_scan, flash_attention,
                                     grid_pipeline, mcm_pipeline, mcm_tiled,
                                     sdp_chunked, sdp_pipeline,
                                     semiring_matmul)

    out: Dict[str, int] = {}
    for mod in (sdp_pipeline, sdp_chunked, mcm_pipeline, mcm_tiled,
                grid_pipeline, semiring_matmul, flash_attention, chunked_scan):
        out.update(mod.LAUNCHES)
    return out


def snapshot(spans_limit: int = 256, audit_limit: int = 256) -> dict:
    """One JSON-able dict of everything: mode, metrics, absorbed stat
    sources, recent spans, recent routing decisions, the kernels' launch
    counters and the count of kernel libraries built or loaded."""
    from repro_torch.dp import backends as _backends

    return {
        "mode": mode(),
        "counters": REGISTRY.counters(),
        "gauges": REGISTRY.gauges(),
        "histograms": {
            name: {**h.to_dict(),
                   "p50": round(h.quantile(0.5), 6),
                   "p99": round(h.quantile(0.99), 6)}
            for name, h in sorted(REGISTRY.histograms().items())},
        "sources": REGISTRY.sources(),
        "spans": spans_snapshot(limit=spans_limit),
        "routing_audit": routing_audit(limit=audit_limit),
        "kernel_launches": kernel_launches(),
        "build_count": _backends.build_count(),
    }


def save_snapshot(path: str, **kw) -> str:
    """Dump :func:`snapshot` as JSON; returns the absolute path."""
    with open(path, "w") as f:
        json.dump(snapshot(**kw), f, indent=1, default=str)
    return os.path.abspath(path)


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def to_prometheus() -> str:
    """Prometheus text exposition format of the registry metrics (counters
    as ``_total``-suffixed counters, histograms with cumulative
    ``le``-labelled buckets plus ``_sum``/``_count``), and each kernel
    wrapper's launches as ``dp_kernel_<wrapper>_launches_total``."""
    lines: List[str] = []
    for name, value in sorted(kernel_launches().items()):
        n = _prom_name(f"dp_kernel_{name}_launches_total")
        lines += [f"# TYPE {n} counter", f"{n} {value:g}"]
    for name, value in sorted(REGISTRY.counters().items()):
        n = _prom_name(name)
        lines += [f"# TYPE {n} counter", f"{n} {value:g}"]
    for name, value in sorted(REGISTRY.gauges().items()):
        n = _prom_name(name)
        lines += [f"# TYPE {n} gauge", f"{n} {value:g}"]
    for name, h in sorted(REGISTRY.histograms().items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} histogram")
        d = h.to_dict()
        cum = 0
        for ub, c in d["buckets"]:
            cum += c
            le = "+Inf" if ub == "+inf" else f"{ub:g}"
            lines.append(f'{n}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{n}_sum {d['sum']:g}")
        lines.append(f"{n}_count {d['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
