"""Measured-cost calibration for the dispatcher.

The analytical step-count model (``Spec.route_costs``) cannot see constant
factors, launch overheads or host↔device copies. Dispatch therefore
consults *measured* latencies wherever they exist and keeps the analytical
model as prior and tiebreak.

Three sources feed one :class:`CalibrationTable`, keyed
``(platform, route_name, shape_key)``, where the platform is the device's
name (``torch.cuda.get_device_name``) on a CUDA device and ``"cpu"`` on the
CPU:

  * :func:`calibrate` — an offline sweep over zoo problems × sizes; each
    supporting route timed warm, min of N, with the device synchronised
    around every run;
  * :func:`calibrate_spec` — the same for one spec;
  * :func:`observe` — online: ``DPEngine`` folds the latency of every warm
    drain in by exponential moving average.

Measurement *regimes* never share entries: plain keys hold single-instance
offline timings, while the engine observes under regime-suffixed keys —
``… + ("batch",)`` for amortized per-instance bucket drains, ``… +
("reconstruct",)`` for arg-emitting solves, ``… + ("extend",)`` for warm
starts (``backends.shape_key_distance`` refuses to interpolate across
regimes too).

Ranking (:func:`rank`) is two-tier: routes with a measured cost (an exact
entry or a nearest-shape interpolation scaled by the analytical cost
ratio) sort by measured ms; unmeasured routes follow in their given
(analytical) order. Only routes that ``supports(spec, device)`` admitted
reach the ranking, so a measurement can reorder admitted routes and never
admit another. Batch pools use :func:`rank_batch`, where a route without a
batch path needs an amortized drain observation to overrule the batching
prior. An empty table returns the given order unchanged.

Tables persist as JSON (:meth:`CalibrationTable.save` / :func:`load`); a
corrupt or unreadable file degrades to the analytical model with a
warning, never an error. A table is loaded by an explicit :func:`load` or
passed as an argument; nothing is read from the environment.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dp import backends as _backends
from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.problem import Spec

_log = _telemetry.get_logger("autotune")

#: EMA weight of one online observation folded into an existing entry.
EMA_ALPHA = 0.3
#: Nearest-shape interpolation gives up past this table-length ratio.
MAX_INTERP_RATIO = 4.0
#: LRU bound on the per-table measured_ms memo.
MEMO_MAX = 4096

Key = Tuple[str, str, tuple]  # (platform, route_name, shape_key)


def platform(device=None) -> str:
    """The platform axis of every measurement key: the CUDA device's name,
    or ``"cpu"``. ``device`` defaults to the card."""
    dev = _backends.resolve_device(device, check=False)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


@dataclasses.dataclass
class Entry:
    """One measured latency: per-instance milliseconds, how many
    measurements folded in, and where they came from (``calibrate`` /
    ``online`` / ``mixed``)."""

    ms: float
    count: int = 1
    source: str = "calibrate"


def _key_to_json(x):
    return [_key_to_json(v) for v in x] if isinstance(x, (tuple, list)) else x


def _key_from_json(x):
    return tuple(_key_from_json(v) for v in x) if isinstance(x, list) else x


class CalibrationTable:
    """Per-(platform, route, shape_key) latency table with JSON
    persistence. All latencies are per-instance milliseconds. Methods that
    take ``platform=`` key on it; None means :func:`platform` of the
    card."""

    VERSION = 1

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[Key, Entry] = {}
        #: (platform, route) -> {shape_key: Entry}, so cost resolution
        #: scans only one backend's entries instead of the whole table
        self._by_backend: Dict[tuple, Dict[tuple, Entry]] = {}
        #: memoized measured_ms resolutions (incl. interpolation misses);
        #: any write invalidates it, and it is LRU-bounded — dispatching
        #: endless fresh shapes against a read-only table must not grow
        #: process memory (same invariant as every other per-shape cache)
        self._memo: "OrderedDict[tuple, Optional[float]]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def items(self):
        return self._entries.items()

    def entries_for(self, backend: str,
                    platform: Optional[str] = None) -> Dict[tuple, Entry]:
        return self._by_backend.get((platform or _default_platform(), backend),
                                    {})

    def _key(self, backend: str, shape_key: tuple,
             platform: Optional[str]) -> Key:
        return (platform or _default_platform(), backend, tuple(shape_key))

    def _put(self, key: Key, entry: Entry) -> Entry:
        self._entries[key] = entry
        self._by_backend.setdefault(key[:2], {})[key[2]] = entry
        self._memo.clear()
        return entry

    def lookup(self, backend: str, shape_key: tuple,
               platform: Optional[str] = None) -> Optional[Entry]:
        return self._entries.get(self._key(backend, shape_key, platform))

    def record(self, backend: str, shape_key: tuple, ms: float,
               platform: Optional[str] = None,
               source: str = "calibrate") -> Entry:
        """Overwrite-style write (offline calibration: min-of-N already
        summarized the samples)."""
        key = self._key(backend, shape_key, platform)
        prev = self._entries.get(key)
        return self._put(key, Entry(ms=float(ms),
                                    count=(prev.count + 1 if prev else 1),
                                    source=source))

    def observe(self, backend: str, shape_key: tuple, ms: float,
                alpha: float = EMA_ALPHA,
                platform: Optional[str] = None) -> Entry:
        """EMA fold of one realized latency (the engine's online feedback)."""
        key = self._key(backend, shape_key, platform)
        prev = self._entries.get(key)
        if prev is None:
            entry = Entry(ms=float(ms), source="online")
        else:
            entry = Entry(ms=(1.0 - alpha) * prev.ms + alpha * float(ms),
                          count=prev.count + 1,
                          source="online" if prev.source == "online" else "mixed")
        return self._put(key, entry)

    # -- persistence -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": self.VERSION,
            "entries": [
                {"platform": pf, "backend": name,
                 "shape_key": _key_to_json(shape_key),
                 "ms": round(e.ms, 6), "count": e.count, "source": e.source}
                for (pf, name, shape_key), e in sorted(
                    self._entries.items(), key=lambda kv: repr(kv[0]))
            ],
        }

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no path configured for this calibration table")
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        self.path = path
        return os.path.abspath(path)

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        """Load a persisted table; anything unreadable (missing file,
        corrupt JSON, wrong schema) degrades to an EMPTY table — dispatch
        then falls back to the analytical model, it never errors."""
        table = cls(path=path)
        if not os.path.exists(path):
            return table
        try:
            with open(path) as f:
                raw = json.load(f)
            if raw.get("version") != cls.VERSION:
                raise ValueError(f"unsupported version {raw.get('version')!r}")
            for row in raw["entries"]:
                key = (str(row["platform"]), str(row["backend"]),
                       _key_from_json(row["shape_key"]))
                table._put(key, Entry(
                    ms=float(row["ms"]), count=int(row.get("count", 1)),
                    source=str(row.get("source", "calibrate"))))
        except Exception as exc:  # corrupt cache must never break dispatch
            _log.warning("ignoring corrupt calibration table %r: %s "
                         "(falling back to the analytical model)", path, exc)
            table._entries.clear()
            table._by_backend.clear()
            table._memo.clear()
        return table


# ---------------------------------------------------------------------------
# Process-global table
# ---------------------------------------------------------------------------
_TABLE: Optional[CalibrationTable] = None


def _default_platform() -> str:
    """Platform of the device entry points default to: the card when one is
    present, else the CPU (the table keys on it)."""
    return platform(None) if torch.cuda.is_available() else "cpu"


def get_table() -> CalibrationTable:
    """The process-global table (empty until :func:`load`,
    :func:`set_table`, :func:`calibrate` or online feedback fills it)."""
    global _TABLE
    if _TABLE is None:
        _TABLE = CalibrationTable()
    return _TABLE


def set_table(table: CalibrationTable) -> CalibrationTable:
    global _TABLE
    _TABLE = table
    return table


def reset() -> None:
    """Drop all calibration state."""
    global _TABLE
    _TABLE = None


def load(path: str) -> CalibrationTable:
    """Load a persisted table and make it the process-global one."""
    return set_table(CalibrationTable.load(path))


def observe(backend_name: str, shape_key: tuple, ms: float,
            alpha: float = EMA_ALPHA, device=None) -> Entry:
    return get_table().observe(backend_name, shape_key, ms, alpha=alpha,
                               platform=platform(device))


def has_measurement(backend_name: str, shape_key: tuple,
                    device=None) -> bool:
    """Exact-entry check (the engine's exploration criterion, on the
    regime-suffixed key): interpolated estimates and other regimes don't
    count; a route stays explorable until timed in this regime."""
    return get_table().lookup(backend_name, shape_key,
                              platform=platform(device)) is not None


# ---------------------------------------------------------------------------
# Cost resolution: exact entry > nearest-shape interpolation > None
# ---------------------------------------------------------------------------
def measured_ms(backend, spec: Spec,
                table: Optional[CalibrationTable] = None,
                suffix: tuple = (), device=None) -> Optional[float]:
    """Measured latency of ``backend`` on ``spec``'s shape on ``device``'s
    platform. Exact entries win; otherwise the nearest compatible shape
    (``backends.shape_key_distance``) within a :data:`MAX_INTERP_RATIO` size
    ratio is scaled by the analytical cost ratio — the step-count model as
    interpolation prior. ``None`` when nothing transfers. ``suffix``
    selects a measurement regime — e.g. ``("reconstruct",)`` keys the
    arg-emitting solve observations separately from plain ones, whose cost
    profiles differ (distance rules keep the regimes from cross-matching)."""
    t = table if table is not None else get_table()
    if not len(t):
        return None
    dev = _backends.resolve_device(device, check=False)
    pf = platform(dev)
    key = spec.shape_key() + tuple(suffix)
    memo_key = (pf, backend.name, key)
    if memo_key in t._memo:
        t._memo.move_to_end(memo_key)
        return t._memo[memo_key]
    return _backends.lru_put(t._memo, memo_key,
                             _resolve_ms(t, pf, backend, spec, key, dev),
                             MEMO_MAX)


def _resolve_ms(t: CalibrationTable, pf: str, backend, spec: Spec,
                key: tuple, device) -> Optional[float]:
    by_shape = t.entries_for(backend.name, platform=pf)
    exact = by_shape.get(key)
    if exact is not None:
        return exact.ms
    best = None
    for ekey, entry in by_shape.items():
        d = _backends.shape_key_distance(key, ekey)
        if d is None:
            continue
        n0, n1 = _backends.shape_key_size(key), _backends.shape_key_size(ekey)
        if max(n0, n1) > MAX_INTERP_RATIO * max(1, min(n0, n1)):
            continue
        if best is None or d < best[0]:
            best = (d, ekey, entry)
    if best is None:
        return None
    _, ekey, entry = best
    try:
        ref = _backends.spec_from_shape_key(ekey)
        scale = (backend.cost(spec, device)
                 / max(backend.cost(ref, device), 1e-9))
    except Exception:  # cost models only read shapes, but stay defensive
        scale = 1.0
    return entry.ms * max(scale, 1e-9)


def _rank_by(pool: list, resolve) -> list:
    """Shared two-tier sort: tier 0 = resolved measured ms (ascending),
    tier 1 = unresolved, input order preserved (the structural/analytical
    prior); input order also breaks measured ties. With no resolved entry
    the input order is returned unchanged — an empty table is bit-identical
    to the analytical dispatcher."""
    decorated = []
    any_measured = False
    for i, b in enumerate(pool):
        ms = resolve(i, b)
        if ms is None:
            decorated.append((1, 0.0, i, b))
        else:
            any_measured = True
            decorated.append((0, ms, i, b))
    if not any_measured:
        return pool
    decorated.sort(key=lambda d: d[:3])
    return [d[3] for d in decorated]


def _audit_decision(kind: str, spec: Spec, regime, pool: list,
                    scores: dict, ranked: list, device) -> None:
    """File one rank decision into the telemetry routing audit: every
    candidate with its measured ms (None = unmeasured in this regime) and
    analytical cost, plus the winner. No-op unless audit is enabled, so
    routing pays nothing by default."""
    if not _telemetry.audit_enabled() or not ranked:
        return
    rows = []
    for b in pool:
        try:
            analytic = float(b.cost(spec, device))
        except Exception:
            analytic = float("inf")
        ms = scores.get(b.name)
        rows.append({"backend": b.name,
                     "measured_ms": None if ms is None else round(ms, 6),
                     "analytical_cost": round(analytic, 3)})
    _telemetry.record_route_decision(
        kind, spec.shape_key(), regime, rows, ranked[0].name)


def rank(spec: Spec, cands: Sequence, suffix: tuple = (),
         device=None) -> list:
    """Two-tier ordering of candidate routes on ``device``: tier 0 =
    measured cost, tier 1 = unmeasured in the given (analytical) order.
    ``suffix`` selects the measurement regime (see :func:`measured_ms`).
    Each call files a routing-audit entry in ``spans`` mode."""
    dev = _backends.resolve_device(device, check=False)
    t = get_table()
    scores: dict = {}
    if not len(t):
        ranked = list(cands)
        _audit_decision("rank", spec, suffix, ranked, scores, ranked, dev)
        return ranked

    def resolve(i, b):
        ms = measured_ms(b, spec, table=t, suffix=suffix, device=dev)
        scores[b.name] = ms
        return ms

    ranked = _rank_by(list(cands), resolve)
    _audit_decision("rank", spec, suffix, ranked, scores, ranked, dev)
    return ranked


def rank_batch(spec: Spec, batchable: Sequence, loop_only: Sequence,
               batch_suffix: tuple = ("batch",),
               loop_suffix: Optional[tuple] = None, device=None) -> list:
    """:func:`rank` for a batch pool. A batchable route solves a whole
    bucket in one call, a loop-only route (no ``batch_run``) one instance
    at a time, so single-instance entries do not compare them: routes
    resolve against batch-regime measurements first; a batchable route may
    fall back to its single-instance entry as a prior, a loop-only route
    may not (tier 1 keeps batchable-first order); a loop-only route ranks
    on the ``loop_suffix`` regime alone (default: ``batch_suffix``; the
    sharded engine ranks batchable routes on its ``("shard", ndev)``
    regime and loop-only ones, which it runs unsharded, on the
    single-device batch regime)."""
    dev = _backends.resolve_device(device, check=False)
    t = get_table()
    pool = list(batchable) + list(loop_only)
    scores: dict = {}
    if not len(t):
        _audit_decision("rank_batch", spec, batch_suffix, pool, scores, pool,
                        dev)
        return pool
    loop_suffix = batch_suffix if loop_suffix is None else loop_suffix

    def resolve(i, b):
        if i < len(batchable):
            ms = measured_ms(b, spec, table=t, suffix=batch_suffix, device=dev)
            if ms is None:
                ms = measured_ms(b, spec, table=t, device=dev)
        else:
            ms = measured_ms(b, spec, table=t, suffix=loop_suffix, device=dev)
        scores[b.name] = ms
        return ms

    ranked = _rank_by(pool, resolve)
    _audit_decision("rank_batch", spec, batch_suffix, ranked, scores, ranked,
                    dev)
    return ranked


# ---------------------------------------------------------------------------
# Offline calibration
# ---------------------------------------------------------------------------
def _time_ms(fn, repeats: int, device) -> float:
    """Warm once (build, caches), then min of N, the device synchronised
    before and after each run (the routes' numpy conversion already waits
    for their results)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    best = float("inf")
    for _ in range(max(1, repeats)):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def calibrate_spec(spec: Spec, repeats: int = 3,
                   table: Optional[CalibrationTable] = None,
                   device=None) -> dict:
    """Time every route that supports ``spec`` on ``device`` and record the
    results. Returns ``{route_name: ms}``. Entries are single-instance
    latencies under the plain (regime-less) keys."""
    dev = _backends.resolve_device(device)
    t = table if table is not None else get_table()
    pf = platform(dev)
    out = {}
    for b in _backends.candidates(spec, dev):
        ms = _time_ms(lambda b=b: b.run(spec, dev), repeats, dev)
        t.record(b.name, spec.shape_key(), ms, platform=pf)
        out[b.name] = ms
    return out


def calibrate(problems: Optional[Sequence[str]] = None,
              sizes: Sequence[int] = (8, 16, 32), repeats: int = 3,
              seed: int = 0, path: Optional[str] = None,
              device=None) -> CalibrationTable:
    """Offline calibration sweep on ``device``: a sampled instance of each
    problem (all registered ones by default) at each size, every supporting
    route timed warm, min of N. Persists to ``path`` (or the table's own
    path) when given; the populated table drives dispatch at once."""
    from repro_torch.dp import registry as _registry

    dev = _backends.resolve_device(device)
    t = get_table()
    rng = np.random.default_rng(seed)
    names = list(problems) if problems is not None else _registry.names()
    for name in names:
        prob = _registry.get(name)
        for size in sizes:
            kw = prob.sample(rng, int(size))
            calibrate_spec(prob.encode(**kw), repeats=repeats, table=t,
                           device=dev)
    if path is not None:
        t.save(path)
    elif t.path:
        t.save()
    return t


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------
def routing_report(table: Optional[CalibrationTable] = None,
                   decisions_limit: int = 256, device=None) -> dict:
    """Measured-vs-analytical dispatch audit over every calibrated shape on
    ``device``'s platform: which route each policy picks, whether they
    agree, and the *analytical regret* — measured ms of the analytical pick
    over measured ms of the true fastest (1.0 = the model was right).
    Rows are grouped per (shape, measurement regime); only rows where at
    least two routes were measured enter the agree/regret statistics —
    a single-backend row can't disagree with anything.

    ``decisions`` holds the most recent per-decision telemetry audit
    entries (``spans`` mode) — each live ``rank``/``rank_batch``/drain
    resolution with its candidates' measured-vs-analytical scores, regime
    key, and chosen backend; empty below ``spans`` mode."""
    t = table if table is not None else get_table()
    dev = _backends.resolve_device(device, check=False)
    pf = platform(dev)
    by_shape: Dict[tuple, Dict[str, Entry]] = {}
    for (epf, name, shape_key), e in t.items():
        if epf == pf:
            by_shape.setdefault(shape_key, {})[name] = e
    shapes, regrets = [], []
    for shape_key, measured in sorted(by_shape.items(),
                                      key=lambda kv: repr(kv[0])):
        spec = _backends.spec_from_shape_key(shape_key)
        _, regime = _backends.split_shape_key(shape_key)
        analytic = {}
        for name in measured:
            try:
                analytic[name] = float(_backends.get(name).cost(spec, dev))
            except Exception:
                analytic[name] = float("inf")
        measured_choice = min(measured, key=lambda n: (measured[n].ms, n))
        analytic_choice = _analytic_choice(analytic, dev)
        regret = (measured[analytic_choice].ms
                  / max(measured[measured_choice].ms, 1e-9))
        comparable = len(measured) >= 2
        if comparable:
            regrets.append(regret)
        shapes.append({
            "shape_key": shape_key,
            "regime": regime or "single",
            "comparable": comparable,
            "measured_choice": measured_choice,
            "analytical_choice": analytic_choice,
            "agree": measured_choice == analytic_choice,
            "analytical_regret": round(regret, 3),
            "measured_ms": {n: round(e.ms, 4)
                            for n, e in sorted(measured.items())},
        })
    return {
        "platform": pf,
        "shapes": shapes,
        "disagreements": sum(1 for s in shapes
                             if s["comparable"] and not s["agree"]),
        "median_analytical_regret":
            float(np.median(regrets)) if regrets else 1.0,
        "max_analytical_regret": float(max(regrets)) if regrets else 1.0,
        "decisions": _telemetry.routing_audit(limit=decisions_limit),
    }


def _analytic_choice(analytic: dict, device) -> str:
    """The route the analytical order puts first among ``analytic``'s
    (``backends.candidates``' key: kernel routes first on a CUDA device,
    then cost, then name)."""
    plain_last = device.type == "cuda"

    def key(n):
        return (plain_last and not _backends.get(n).kernel, analytic[n], n)

    return min(analytic, key=key)
