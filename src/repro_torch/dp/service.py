"""DPService: the continuous-batching, cache-fronted serving layer over
:class:`repro_torch.dp.engine.DPEngine`.

  * **Handles.** ``submit()`` returns a ticket id at once; ``poll(tid)``
    returns None while the request is queued and a :class:`ServiceResult`
    once it resolved. The loop (``step`` / ``run``) advances work between
    polls with a fixed in-flight budget of engine slots: finished buckets
    recycle their slots to the backlog without draining the world.
  * **Admission control.** A bounded backlog (:class:`AdmissionError` past
    it), an integer ``priority`` per request (higher first) and a
    ``deadline_ms`` (a start-by deadline: a request that ages out in the
    backlog resolves to ``status="expired"`` without a solve; once admitted
    to the engine, a request is never abandoned).
  * **Answer cache.** A content-digest LRU (``problem.spec_digest``) serves
    repeat instances without touching the engine — duplicates within one
    drain are the engine's dedup, repeats across drains are cache hits
    here.
  * **Streaming sessions.** ``open_session()`` / ``append()`` /
    ``close_session()`` serve growing instances: each append's longest
    solved prefix is found through the chain-digest
    :class:`repro_torch.dp.streaming.PrefixIndex` and only the extension is
    recomputed (an engine extend bucket), sticky to the session's route;
    results equal cold solves bit for bit. The session TTL, the session
    count and the index capacity are arguments.

The engine runs on ``device`` (default: the card). ``mesh="auto"`` shards
each drain over every visible card where there is more than one (a
:class:`repro_torch.dp.sharding.ShardedDPEngine` over
:func:`repro_torch.dp.sharding.default_mesh`) and runs one engine
otherwise; ``mesh=None`` forces the one engine; an explicit
:class:`repro_torch.runtime.sharding.Mesh` of slots (one card may be listed
several times) builds the sharded engine over it.

One process a rank: ``DPService(comm=comm)`` in every rank of
``runtime.sharding.run`` or ``runtime.distributed.launch`` serves over that
rank's ``ShardedDPEngine(comm=comm)``. Every rank makes the same calls in
the same order, solves its share of each sharded drain and resolves the
same tickets with the same answers, because every decision that reads a
clock reads one clock agreed by the ranks (:meth:`DPService._now`).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.dp import backends as _backends
from repro_torch.dp import reconstruct as _reconstruct
from repro_torch.dp import registry as _registry
from repro_torch.dp import sharding as _sharding
from repro_torch.dp import streaming as _streaming
from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.engine import DPEngine
from repro_torch.dp.problem import Answer, Spec, spec_digest

_log = _telemetry.get_logger("service")

#: default idle time (ms) after which a streaming session is reclaimed
SESSION_TTL_MS = 600_000
#: default number of streaming sessions kept (LRU past it)
SESSION_MAX = 256


class AdmissionError(RuntimeError):
    """Backlog is full — the request was refused at the door."""


@dataclasses.dataclass
class Ticket:
    """One admitted request, waiting in the service backlog."""

    tid: int
    problem: str
    spec: Spec
    digest: str
    reconstruct: bool
    priority: int
    deadline: Optional[float]      # absolute start-by bound on the service's clock
    submitted_at: float
    #: telemetry timestamps on the ``telemetry.clock`` timebase (set in
    #: ``basic`` mode and above; 0.0 when telemetry is off)
    t_enqueued: float = 0.0
    t_dispatched: float = 0.0
    #: warm-start handle (streaming sessions) — routes into an engine
    #: extend bucket
    resume: Optional[_streaming.ResumeToken] = None
    #: owning streaming session, when any
    sid: Optional[int] = None
    #: retain the solved table on the response (prefix-index it)
    keep_table: bool = False
    #: digest chain value at the instance's full length (computed once at
    #: append time; the prefix-index put reuses it)
    chain_full: Optional[bytes] = None


@dataclasses.dataclass
class ServiceResult:
    """Resolution of one ticket. ``status`` is ``"done"`` or ``"expired"``;
    ``cached`` marks answers served from the digest cache without a
    solve; ``latency_ms`` is submit→resolve wall time (a drained ticket
    resolves after its drain; one rank of a per-rank service measures
    from the agreed submit reading, its drain on its own clock). In ``spans``
    telemetry mode ``span`` carries the request's full timestamped
    lifecycle (:class:`repro_torch.dp.telemetry.Span`)."""

    tid: int
    problem: str
    status: str
    answer: Any = None
    solution: Optional[Answer] = None
    backend: Optional[str] = None
    cached: bool = False
    latency_ms: float = 0.0
    span: Optional[_telemetry.Span] = None
    #: resolved by a warm-start extend drain (or a full prefix-index hit)
    #: instead of a cold solve
    extended: bool = False
    #: owning streaming session, when submitted through one
    sid: Optional[int] = None


@dataclasses.dataclass
class _CacheEntry:
    answer: Any
    solution: Optional[Answer]
    backend: str


@dataclasses.dataclass
class Session:
    """One streaming session: a lineage of growing instances served with
    warm starts and session-affine sticky routing."""

    sid: int
    problem: str
    opened_at: float
    last_seen: float
    #: sticky backend: the route that served this session's first solved
    #: instance; later extends prefer it so the session keeps hitting
    #: programs it already traced
    affinity: Optional[str] = None
    appends: int = 0
    #: appends that warm-started off a stored prefix
    extends: int = 0
    #: length of the session's latest solved instance (0 until one lands)
    length: int = 0
    #: incremental digest-chain state — appends chain only their new
    #: steps instead of re-walking the whole instance
    cursor: Optional[_streaming.ChainCursor] = None


class DPService:
    """Front end over a (possibly sharded) :class:`DPEngine`.

    ``mesh="auto"`` shards over every visible card when ``device`` is a
    card and there is more than one; ``mesh=None`` forces the single engine
    on ``device``; an explicit ``repro_torch.runtime.sharding.Mesh`` builds
    a :class:`repro_torch.dp.sharding.ShardedDPEngine` over exactly that
    mesh (on its first slot's device; ``device`` then configures nothing).
    ``max_inflight`` is the engine-slot budget: admission tops the engine
    up to it each step, so buckets refill while earlier ones drain.
    ``engine=`` injects a ready-made (empty) engine and takes precedence:
    ``max_batch``, ``mesh``, ``feedback``, ``explore_every`` and ``device``
    then configure nothing. ``session_ttl_ms``, ``session_max`` and
    ``prefix_index_capacity`` bound the streaming sessions.

    ``comm=`` (a rank's ``runtime.sharding.Comm``) makes this service one
    rank of a per-rank program: it builds ``ShardedDPEngine(comm=comm)``
    (on the comm's slot; ``device`` configures nothing) and agrees its
    clock with the other ranks along the engine's axis. ``comm`` with a
    ``mesh`` other than "auto" raises ``ValueError``. An injected rank
    engine (``ShardedDPEngine(comm=...)``, along any axis) brings its comm;
    one whose comm is not ``comm`` raises ``ValueError``."""

    def __init__(self, max_batch: int = 64, max_pending: int = 4096,
                 max_inflight: Optional[int] = None, cache_size: int = 1024,
                 mesh: Any = "auto", feedback: bool = True,
                 explore_every: int = 8, results_max: int = 8192,
                 engine: Optional[DPEngine] = None, device=None,
                 session_ttl_ms: int = SESSION_TTL_MS,
                 session_max: int = SESSION_MAX,
                 prefix_index_capacity: int = _streaming.PREFIX_INDEX_CAPACITY,
                 comm: Optional[_sharding.Comm] = None):
        if comm is not None and not (isinstance(mesh, str) and mesh == "auto"):
            raise ValueError("pass comm= or mesh=, not both: a rank's service "
                             "shards over its comm's mesh")
        if engine is not None:
            ctx = getattr(engine, "ctx", None)
            own = None if ctx is None else ctx.comm
            if comm is not None and own is not comm:
                raise ValueError("the injected engine's comm is not the comm= given")
            comm = own
            if engine.pending():
                # the service owns its engine's request lifecycle: rids
                # submitted behind its back would drain into responses no
                # ticket maps to
                raise ValueError("injected engine must start empty "
                                 f"({engine.pending()} requests pending)")
            self.engine = engine
        else:
            knobs = dict(max_batch=max_batch, feedback=feedback,
                         explore_every=explore_every)
            if comm is not None:
                mesh = comm.mesh
            elif mesh == "auto":
                shard = (_backends.resolve_device(device).type == "cuda"
                         and _sharding.device_count() > 1)
                mesh = _sharding.default_mesh() if shard else None
            if comm is not None:
                self.engine = _sharding.ShardedDPEngine(comm=comm, **knobs)
            elif mesh is None:
                self.engine = DPEngine(device=device, **knobs)
            elif isinstance(mesh, _sharding.Mesh):
                self.engine = _sharding.ShardedDPEngine(mesh=mesh, **knobs)
            else:
                raise TypeError(f"mesh must be 'auto', None or a "
                                f"repro_torch.runtime.sharding.Mesh, not {mesh!r}")
        #: the rank's communicator (None: one process serves alone)
        self.comm = comm
        if session_ttl_ms < 1 or session_max < 1:
            raise ValueError("session_ttl_ms and session_max must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if cache_size < 0:
            raise ValueError("cache_size must be >= 0")
        self.max_pending = max_pending
        self.max_inflight = max_inflight or 2 * self.engine.max_batch
        self.cache_size = cache_size
        self._next_tid = 0
        #: tids admitted but not yet resolved — O(1) poll() membership
        self._unresolved: set = set()
        #: bucket key -> [Ticket] awaiting engine admission
        self._backlog: "OrderedDict[tuple, list]" = OrderedDict()
        #: engine rid -> Ticket (admitted, in flight)
        self._inflight: dict = {}
        if results_max < 1:
            raise ValueError("results_max must be >= 1")
        self.results_max = results_max
        #: tid -> ServiceResult, consumed (popped) by poll(); LRU-bounded —
        #: fire-and-forget clients that never poll must not grow process
        #: memory (abandoned results evict oldest-first; polling an evicted
        #: tid raises KeyError like an unknown one)
        self._results: "OrderedDict[int, ServiceResult]" = OrderedDict()
        #: (problem, digest, reconstruct) -> _CacheEntry, LRU
        self._cache: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        #: (problem, backend) -> drained request count (the demo's
        #: per-route view; per-regime detail lives in routing_report())
        self.routes: dict = {}
        #: ``shed`` and ``rejected`` are the same count (``shed`` is the
        #: telemetry-conventional name; ``rejected`` the original); the
        #: service invariant is
        #: ``submitted == completed + pending() + expired + shed``
        self.stats = {"submitted": 0, "completed": 0, "cache_hits": 0,
                      "cache_misses": 0, "expired": 0, "rejected": 0,
                      "shed": 0, "admitted": 0, "service_steps": 0,
                      "sessions_opened": 0, "sessions_closed": 0,
                      "sessions_expired": 0, "sessions_evicted": 0,
                      "session_appends": 0,
                      "prefix_hits": 0, "prefix_full_hits": 0,
                      "prefix_misses": 0}
        #: tid -> live telemetry Span (``spans`` mode only)
        self._spans: dict = {}
        # -- streaming sessions: a bounded session map plus the
        # cross-session longest-prefix answer cache
        self._next_sid = 0
        self._sessions: "OrderedDict[int, Session]" = OrderedDict()
        self.session_ttl_ms = session_ttl_ms
        self.session_max = session_max
        self.prefix_index = _streaming.PrefixIndex(prefix_index_capacity)
        _telemetry.REGISTRY.register_source("dp_service", self)

    def _now(self) -> float:
        """The service's clock, read once a public call (``submit``,
        ``append``, ``open_session``, ``step``; ``close_session`` and
        ``poll`` decide nothing by it): deadlines, expiry, the EDF order
        and so the drain target, and session sweeps all come from these
        readings, as does the submit end of ``latency_ms`` (its resolve
        end is read after the drain, see :meth:`step`). Alone,
        ``time.monotonic()``. Given a
        comm, the largest of the ranks' readings along the engine's axis
        (``comm.all_max``, one collective a call): every rank gets the
        same value, so every rank expires the same tickets and drains the
        same bucket (ranks that disagreed would enter different gathers),
        and that value is the moment the last rank reached the call, when
        the decision is taken on every rank. Telemetry's clock stays per
        rank: it decides nothing."""
        if self.comm is None:
            return time.monotonic()
        reading = torch.tensor(time.monotonic(), dtype=torch.float64)
        return float(self.comm.all_max(reading, self.engine.ctx.axis))

    # -- admission ---------------------------------------------------------
    def backlog(self) -> int:
        return sum(len(v) for v in self._backlog.values())

    def pending(self) -> int:
        """Requests not yet resolved (backlog + in flight)."""
        return self.backlog() + len(self._inflight)

    def submit(self, problem: str, priority: int = 0,
               deadline_ms: Optional[float] = None,
               reconstruct: bool = False, **payload) -> int:
        """Admit one request; returns its ticket id immediately.

        Encodes eagerly (validation errors surface here, not at drain
        time), then: digest cache hit → the ticket resolves on the spot —
        even during overload, a cache hit costs no backlog slot and no
        device work, so it is never shed; otherwise it joins the backlog
        subject to ``max_pending`` (:class:`AdmissionError` past it).
        ``deadline_ms`` is relative to now and bounds *start* time — a
        ticket still in the backlog past it resolves to
        ``status="expired"``."""
        prob = _registry.get(problem)
        spec = prob.encode(**payload)
        return self._submit(prob, spec, priority, deadline_ms, reconstruct, self._now())

    def _submit(self, prob, spec: Spec, priority: int,
                deadline_ms: Optional[float], reconstruct: bool, now: float,
                resume: Optional[_streaming.ResumeToken] = None,
                sid: Optional[int] = None, keep_table: bool = False,
                chain_full: Optional[bytes] = None,
                serve: Optional[tuple] = None) -> int:
        """Shared admission path for ``submit`` and session ``append``, at
        the call's clock reading ``now``. ``serve`` is a precomputed
        ``(answer, solution, backend, extended)`` resolution (a full
        prefix-index hit) that bypasses the cache and the backlog;
        ``resume`` routes the ticket into an engine extend bucket."""
        if reconstruct:
            _reconstruct.check_reconstructable(prob, spec)
        # A session append already carries its chain digest at full
        # length, which commits to the seed (non-step parameters) plus
        # every step payload — the same content commitment spec_digest
        # makes, minus an O(n) hash pass over the instance.
        digest = chain_full if chain_full is not None else spec_digest(spec)
        hit = strip_solution = None
        if serve is None:
            ckey = (prob.name, digest, reconstruct)
            hit = self._cache.get(ckey)
            if hit is not None:
                self._cache.move_to_end(ckey)
            elif not reconstruct:
                # a reconstruct=True entry is strictly richer: its digest
                # covers the same canonical payload and its answer is the
                # same extract — serve plain hits from it rather than
                # re-solving (the solution is withheld so the result keeps
                # the non-reconstruct contract)
                rich = self._cache.get((prob.name, digest, True))
                if rich is not None:
                    self._cache.move_to_end((prob.name, digest, True))
                    hit, strip_solution = rich, True
        # submitted counts every request that reached admission — including
        # shed ones — so the §8 invariant
        # submitted == completed + pending() + expired + shed always balances
        self.stats["submitted"] += 1
        span = _telemetry.new_span(self._next_tid, prob.name)
        if span is not None:
            span.add("admitted")
        if (hit is None and serve is None
                and self.backlog() >= self.max_pending):
            self.stats["rejected"] += 1
            self.stats["shed"] += 1
            _telemetry.count("dp_service_shed_total")
            if span is not None:
                span.meta["status"] = "shed"
                _telemetry.finish_span(span.add("shed"))
            raise AdmissionError(
                f"backlog full ({self.max_pending} pending); retry later")
        tid = self._next_tid
        self._next_tid += 1
        _telemetry.count("dp_service_submitted_total")
        if hit is not None or serve is not None:
            if hit is not None:
                answer = hit.answer
                solution = None if strip_solution else hit.solution
                backend_name, extended = hit.backend, False
                self.stats["cache_hits"] += 1
                _telemetry.count("dp_service_cache_hits_total")
                if span is not None:
                    span.add("cache_hit")
            else:
                answer, solution, backend_name, extended = serve
                if span is not None:
                    span.add("prefix_hit")
            self.stats["completed"] += 1
            _telemetry.observe_ms("dp_service_latency_ms", 0.0)
            if span is not None:
                span.meta.update(status="done", cached=True,
                                 backend=backend_name)
                _telemetry.finish_span(span.add("resolved"))
            _backends.lru_put(self._results, tid, ServiceResult(
                tid=tid, problem=prob.name, status="done", answer=answer,
                solution=solution, backend=backend_name, cached=True,
                latency_ms=0.0, span=span, extended=extended, sid=sid),
                self.results_max)
            return tid
        self.stats["cache_misses"] += 1
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        key = (prob.name, spec.shape_key(), reconstruct)
        if resume is not None:
            key += (("extend", resume.old_len),)
        self._unresolved.add(tid)
        ticket = Ticket(
            tid=tid, problem=prob.name, spec=spec, digest=digest,
            reconstruct=reconstruct, priority=priority, deadline=deadline,
            submitted_at=now,
            t_enqueued=_telemetry.clock() if _telemetry.enabled() else 0.0,
            resume=resume, sid=sid, keep_table=keep_table,
            chain_full=chain_full)
        self._backlog.setdefault(key, []).append(ticket)
        if span is not None:
            span.add("enqueued", ticket.t_enqueued)
            self._spans[tid] = span
        return tid

    # -- streaming sessions ------------------------------------------------
    def open_session(self, problem: str) -> int:
        """Open a streaming session for ``problem``; returns its sid.
        Sessions hold no device state — they carry sticky routing affinity
        and bookkeeping; the solved tables live in the (cross-session)
        prefix index. Idle sessions are reclaimed past ``session_ttl_ms``;
        the LRU session evicts past ``session_max``."""
        prob = _registry.get(problem)       # validates the name
        now = self._now()
        self._sweep_sessions(now)
        sid = self._next_sid
        self._next_sid += 1
        self._sessions[sid] = Session(sid=sid, problem=prob.name,
                                      opened_at=now, last_seen=now)
        while len(self._sessions) > self.session_max:
            self._sessions.popitem(last=False)
            self.stats["sessions_evicted"] += 1
            _telemetry.count("dp_service_sessions_evicted_total")
        self.stats["sessions_opened"] += 1
        _telemetry.count("dp_service_sessions_opened_total")
        return sid

    def _session(self, sid: int) -> Session:
        s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"unknown or expired session {sid}")
        self._sessions.move_to_end(sid)
        return s

    def _sweep_sessions(self, now: float) -> None:
        if not self._sessions:
            return
        cutoff = now - self.session_ttl_ms / 1e3
        for sid in [k for k, s in self._sessions.items()
                    if s.last_seen < cutoff]:
            del self._sessions[sid]
            self.stats["sessions_expired"] += 1
            _telemetry.count("dp_service_sessions_expired_total")

    def append(self, sid: int, priority: int = 0,
               deadline_ms: Optional[float] = None,
               reconstruct: bool = False, **payload) -> int:
        """Grow the session's instance; returns a ticket id like
        ``submit``. ``payload`` is the FULL new instance (prefix plus the
        appended steps) — the service finds the longest already-solved
        prefix through the chain-digest index and decides how to serve:

          * full-length index hit → the stored table answers outright, no
            device work;
          * proper-prefix hit → a warm-start ticket (engine extend bucket)
            recomputing only the extension, sticky to the session's
            affine backend;
          * miss → a cold ticket.

        Either ticket retains its solved table in the prefix index, so
        the *next* append — from this session or any other — warm-starts
        off it."""
        s = self._session(sid)
        now = self._now()
        s.last_seen = now
        s.appends += 1
        self.stats["session_appends"] += 1
        _telemetry.count("dp_service_session_appends_total")
        prob = _registry.get(s.problem)
        spec = prob.encode(**payload)
        chain = s.cursor.advance(spec) if s.cursor is not None else None
        if chain is None:          # first append, or not a pure extension
            s.cursor = _streaming.ChainCursor(spec)
            chain = s.cursor.chain
        n = spec.extend_length()
        streamable = chain.get(n) is not None
        ent = (self.prefix_index.lookup(prob.name, spec, chain)
               if streamable else None)
        resume = serve = None
        if ent is not None and ent.length == n:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_full_hits"] += 1
            _telemetry.count("dp_service_prefix_hits_total")
            solution = None
            if reconstruct:
                _reconstruct.check_reconstructable(prob, spec)
                args = _reconstruct.args_from_table(ent.table, spec)
                solution = _reconstruct.reconstruct_one(
                    prob, spec, ent.table, args, "host")
            if s.affinity is None:
                s.affinity = ent.backend
            s.length = max(s.length, n)
            serve = (prob.extract(ent.table, spec), solution,
                     ent.backend, True)
        elif ent is not None:
            self.stats["prefix_hits"] += 1
            _telemetry.count("dp_service_prefix_hits_total")
            s.extends += 1
            resume = ent.token(affinity=s.affinity)
        else:
            self.stats["prefix_misses"] += 1
            _telemetry.count("dp_service_prefix_misses_total")
        return self._submit(prob, spec, priority, deadline_ms, reconstruct, now,
                            resume=resume, sid=sid,
                            keep_table=serve is None and streamable,
                            chain_full=chain.get(n), serve=serve)

    def close_session(self, sid: int) -> dict:
        """Close a session; returns its summary. Its prefix-index entries
        stay — other sessions (or a reopened one) still warm-start off
        them until LRU eviction."""
        s = self._sessions.pop(sid, None)
        if s is None:
            raise KeyError(f"unknown or expired session {sid}")
        self.stats["sessions_closed"] += 1
        _telemetry.count("dp_service_sessions_closed_total")
        return {"sid": s.sid, "problem": s.problem, "appends": s.appends,
                "extends": s.extends, "affinity": s.affinity,
                "length": s.length}

    def session_stats(self) -> dict:
        return {"open": len(self._sessions), "capacity": self.session_max,
                "ttl_ms": self.session_ttl_ms,
                "prefix_index": self.prefix_index.snapshot()}

    def poll(self, tid: int):
        """``None`` while the ticket is queued/in flight; its
        :class:`ServiceResult` once resolved (consumed — a second poll of
        the same tid raises KeyError, like reading a future twice; so does
        a result abandoned long enough to be LRU-evicted past
        ``results_max``)."""
        if tid in self._results:
            return self._results.pop(tid)
        if tid in self._unresolved:
            return None
        raise KeyError(f"unknown ticket {tid}")

    # -- scheduling loop ---------------------------------------------------
    def _expire(self, now: float) -> list:
        """Resolve backlog tickets past their start-by deadline at ``now``;
        returns the expired tids."""
        expired = []
        for key in list(self._backlog):
            queue = self._backlog[key]
            live = []
            for t in queue:
                if t.deadline is not None and now > t.deadline:
                    self.stats["expired"] += 1
                    expired.append(t.tid)
                    self._unresolved.discard(t.tid)
                    _telemetry.count("dp_service_expired_total")
                    span = self._spans.pop(t.tid, None)
                    if span is not None:
                        span.meta["status"] = "expired"
                        _telemetry.finish_span(span.add("expired"))
                    _backends.lru_put(self._results, t.tid, ServiceResult(
                        tid=t.tid, problem=t.problem, status="expired",
                        latency_ms=(now - t.submitted_at) * 1e3, span=span),
                        self.results_max)
                else:
                    live.append(t)
            if live:
                self._backlog[key] = live
            else:
                del self._backlog[key]
        return expired

    @staticmethod
    def _urgency(tickets: list) -> tuple:
        """Sort key of a ticket group, most urgent first: highest priority,
        then earliest deadline (EDF — deadline-less tickets sort last),
        then fullest (drain amortization)."""
        prio = max(t.priority for t in tickets)
        deadlines = [t.deadline for t in tickets if t.deadline is not None]
        edf = min(deadlines) if deadlines else float("inf")
        return (-prio, edf, -len(tickets))

    def _bucket_order(self) -> list:
        return sorted(self._backlog,
                      key=lambda k: self._urgency(self._backlog[k]))

    @staticmethod
    def _engine_key(t: Ticket) -> tuple:
        """The engine bucket a ticket lands in."""
        return DPEngine.bucket_key(
            t.problem, t.spec, t.reconstruct,
            resume_len=None if t.resume is None else t.resume.old_len)

    def _drain_target(self) -> Optional[tuple]:
        """Most urgent engine bucket among in-flight tickets — the
        service schedules drains by priority/deadline, not by the engine's
        default fullest-first policy. Urgency is computed over the prefix
        the engine would actually drain (its queue is admission order, up
        to ``max_batch``): an urgent ticket queued *behind* a full batch of
        non-urgent same-shape work must not let that work preempt genuinely
        urgent buckets — priority is bucket-granular at admission, FIFO
        within an engine bucket."""
        groups: dict = {}
        for t in self._inflight.values():   # insertion order == queue order
            groups.setdefault(self._engine_key(t), []).append(t)
        if not groups:
            return None
        cap = self.engine.max_batch
        return min(groups, key=lambda k: self._urgency(groups[k][:cap]))

    def _admit(self) -> int:
        """Top the engine up to ``max_inflight`` from the backlog, most
        urgent bucket first (within a bucket: priority desc, deadline asc,
        FIFO). Finished buckets having recycled their slots, the pipeline
        refills without waiting for the backlog to drain — the continuous-
        batching loop."""
        admitted = 0
        budget = self.max_inflight - len(self._inflight)
        for key in self._bucket_order():
            if budget <= 0:
                break
            queue = self._backlog[key]
            queue.sort(key=lambda t: (-t.priority,
                                      t.deadline if t.deadline is not None
                                      else float("inf"), t.tid))
            take, rest = queue[:budget], queue[budget:]
            t_dispatch = _telemetry.clock() if _telemetry.enabled() else 0.0
            for t in take:
                rid = self.engine.submit_spec(t.problem, t.spec,
                                              reconstruct=t.reconstruct,
                                              digest=t.digest,
                                              resume=t.resume,
                                              keep_table=t.keep_table)
                self._inflight[rid] = t
                t.t_dispatched = t_dispatch
                span = self._spans.get(t.tid)
                if span is not None:
                    span.add("dispatched", t_dispatch)
            admitted += len(take)
            budget -= len(take)
            if rest:
                self._backlog[key] = rest
            else:
                del self._backlog[key]
        self.stats["admitted"] += admitted
        return admitted

    def step(self, backend: Optional[str] = None) -> list:
        """One service step: expire stale tickets, refill the engine, drain
        one bucket. Returns the tids resolved this step (drained + newly
        expired)."""
        now = self._now()
        # A drained ticket resolves after its drain, as ``latency_ms`` says.
        # Alone the clock is read again then. A rank adds its own drain
        # time to the agreed reading (latency decides nothing, so it need
        # not agree); its sessions' ``last_seen`` decides sweeps, so it
        # stays at the agreed reading every rank shares.
        skew = 0.0 if self.comm is None else now - time.monotonic()
        resolved = self._expire(now)
        self._sweep_sessions(now)
        self._admit()
        responses = self.engine.step(backend=backend,
                                     bucket=self._drain_target())
        drain = self.engine.last_drain if _telemetry.enabled() else None
        t_done = _telemetry.clock() if _telemetry.enabled() else 0.0
        for resp in responses:
            t = self._inflight.pop(resp.rid)
            self._unresolved.discard(t.tid)
            span = self._spans.pop(t.tid, None)
            res = ServiceResult(
                tid=t.tid, problem=t.problem, status="done",
                answer=resp.answer, solution=resp.solution,
                backend=resp.backend,
                latency_ms=(time.monotonic() + skew - t.submitted_at) * 1e3,
                span=span, extended=resp.extended, sid=t.sid)
            if drain is not None:
                self._observe_phases(t, resp, drain, span, t_done)
            if t.keep_table and resp.table is not None:
                # index the solved table (cold or stitched) so the next
                # append — this session's or any other's — warm-starts here
                self.prefix_index.put(t.problem, t.spec, resp.table,
                                      resp.backend, chain=t.chain_full)
            if t.sid is not None:
                s = self._sessions.get(t.sid)
                if s is not None:
                    # sticky to the route serving the session's steady
                    # state: extends re-pin, so later appends keep hitting
                    # the extend route's already-traced programs
                    if s.affinity is None or resp.extended:
                        s.affinity = resp.backend
                    s.length = max(s.length, t.spec.extend_length())
                    s.last_seen = time.monotonic() if self.comm is None else now
            _backends.lru_put(self._results, t.tid, res, self.results_max)
            resolved.append(t.tid)
            self.stats["completed"] += 1
            _telemetry.count("dp_service_completed_total")
            _telemetry.observe_ms("dp_service_latency_ms", res.latency_ms)
            rkey = (t.problem, resp.backend)
            self.routes[rkey] = self.routes.get(rkey, 0) + 1
            ckey = (t.problem, t.digest, t.reconstruct)
            _backends.lru_put(self._cache, ckey,
                              _CacheEntry(answer=resp.answer,
                                          solution=resp.solution,
                                          backend=resp.backend),
                              self.cache_size)
        self.stats["service_steps"] += 1
        _telemetry.set_gauge("dp_service_backlog", self.backlog())
        _telemetry.set_gauge("dp_service_inflight", len(self._inflight))
        _telemetry.set_gauge("dp_service_cache_size", len(self._cache))
        return resolved

    def _observe_phases(self, t: Ticket, resp, drain, span, t_done: float):
        """Per-request latency attribution from the drain report: feed the
        queue/dispatch/solve/traceback/decode histograms, and (``spans``
        mode) replay the drain's timeline into the request's span. Solve/
        traceback/decode are drain-level durations — each request in the
        batch waited for the whole batched call, so the drain's duration IS
        its latency contribution."""
        phases = {
            "queue": (t.t_dispatched - t.t_enqueued) * 1e3,
            "dispatch": (drain.t_start - t.t_dispatched) * 1e3,
        }
        if not resp.extended:
            phases["solve"] = drain.phases.get("solve", 0.0)
        for ph in ("extend", "traceback", "decode"):
            if ph in drain.phases:
                phases[ph] = drain.phases[ph]
        for ph, ms in phases.items():
            _telemetry.observe_ms(f"dp_service_{ph}_ms", max(ms, 0.0))
        if span is None:
            return
        span.meta.update(status="done", backend=resp.backend,
                         batch_size=resp.batch_size, bucket=repr(drain.bucket),
                         cold=drain.cold, sharded=drain.sharded)
        if resp.extended:
            span.meta.update(extended=True, affine=resp.affine)
        tt = drain.t_start
        span.add("batched", tt)
        if drain.cold:
            span.add("retraced", tt)
        if resp.extended:
            tt += drain.phases.get("extend", 0.0) / 1e3
            span.add("extended", tt)
        else:
            tt += drain.phases.get("solve", 0.0) / 1e3
            span.add("solved", tt)
        if "traceback" in drain.phases:
            tt += drain.phases["traceback"] / 1e3
            span.add("traceback", tt)
        if "decode" in drain.phases:
            tt += drain.phases["decode"] / 1e3
            span.add("decoded", tt)
        if resp.deduped:
            span.add("dedup_fanout", tt)
        _telemetry.finish_span(span.add("resolved", t_done))

    def run(self, backend: Optional[str] = None) -> dict:
        """Drive the loop until backlog and engine are empty; returns
        ``{tid: ServiceResult}`` for every result available at the end —
        everything resolved during the call plus any earlier resolutions
        (cache-hit submits, prior expiries) not yet polled."""
        while self.pending():
            self.step(backend=backend)
        out = dict(self._results)
        self._results = OrderedDict()
        return out

    # -- introspection -----------------------------------------------------
    def cache_stats(self) -> dict:
        total = self.stats["cache_hits"] + self.stats["cache_misses"]
        return {"size": len(self._cache), "capacity": self.cache_size,
                "hits": self.stats["cache_hits"],
                "misses": self.stats["cache_misses"],
                "hit_rate": (self.stats["cache_hits"] / total) if total
                            else 0.0}
