"""DPEngine: a request/response front end over the zoo and the dispatcher.

Requests are *admitted* into shape buckets (instances that share one
solver call), and every engine step drains one bucket — the fullest by
default — with ONE batched solve: one kernel launch on a kernel route.
Heterogeneous traffic (many problems, many sizes) thus turns into a few
large calls instead of a stream of single launches. Identical instances in
a drain (equal ``spec_digest``) solve once and share the answer.

Reconstruction: ``submit(..., reconstruct=True)`` lands in its own bucket
(same shape, arg-tracking treatment) whose drain runs the arg-emitting
batched solve and one batched traceback walk on the engine's device
(none on a fused route, which walks inside its launch); responses carry the
decoded :class:`Answer` in ``solution``. ``stats`` counts walks on the
device and on the host (deduplicated lanes, not fan-out).

Warm starts: ``submit(..., resume=token)`` lands in an extend bucket whose
drain recomputes only the extension of the token's solved prefix
(``repro_torch.dp.streaming``); the stitched table equals a cold solve's
bit for bit.

Online routing feedback: the latency of every warm drain, taken with the
device synchronised on both sides, is folded into the calibration table
(``repro_torch.dp.autotune``) by EMA, so dispatch converges to the
measured-fastest route under live traffic. Cold drains are left out — a
build is not a routing signal — where cold means the engine has not yet run
this exact (route, shape, batch size), or a kernel library was built or
first loaded during the call (``backends.build_count``). Every
``explore_every``-th drain of a bucket routes to the analytically cheapest
candidate not yet measured in the drain's regime (on the card, the
cheapest such kernel route: a plain route there loops on the host and can
take seconds a drain); an explicit ``backend=``
bypasses both (its warm latency is still recorded). Observations are keyed
by regime — ``("batch",)`` for bucket drains, ``("reconstruct",)`` for
arg-emitting solves, ``("extend",)`` for warm starts — and never share
entries with single-instance offline calibration.

The engine runs on ``device`` (default: the card); without a card it
raises unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.dp import autotune as _autotune
from repro_torch.dp import backends as _backends
from repro_torch.dp import reconstruct as _reconstruct
from repro_torch.dp import registry as _registry
from repro_torch.dp import routing as _routing
from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.problem import Answer, Spec, spec_digest

_log = _telemetry.get_logger("engine")

#: LRU bound on the engine's per-route bookkeeping (_drains / _warmed) —
#: endless fresh shapes must not grow process memory. Evicting a _warmed triple just costs
#: one skipped observation when that route next drains; evicting a _drains
#: count resets that bucket's exploration cadence.
_ROUTE_STATE_MAX = 4096


@dataclasses.dataclass
class DPRequest:
    rid: int
    problem: str
    payload: dict
    spec: Spec = None
    reconstruct: bool = False
    #: content digest of the encoded spec (``problem.spec_digest``) — the
    #: intra-drain dedup key: equal digests imply bit-equal Answers
    digest: str = ""
    #: warm-start handle (``repro_torch.dp.streaming.ResumeToken``) — routes
    #: the request into an extend bucket whose drain recomputes only the
    #: extension region
    resume: Optional[Any] = None
    #: return the solved table on the response (streaming sessions index
    #: it for future warm starts); plain callers skip the extra reference
    keep_table: bool = False


@dataclasses.dataclass
class DPResponse:
    rid: int
    problem: str
    answer: Any
    backend: str
    batch_size: int
    solution: Optional[Answer] = None
    #: this rid shared another request's solve lane (intra-drain dedup
    #: fan-out) — telemetry marks its span instead of re-counting work
    deduped: bool = False
    #: full solved table (read-only), only when the request asked for it
    table: Optional[Any] = None
    #: resolved by a warm-start extend drain rather than a cold solve
    extended: bool = False
    #: the extend drain honored the resume token's sticky backend affinity
    affine: bool = False


class DPEngine:
    """Queue heterogeneous solve requests, bucket by (problem, shape_key),
    dispatch batched solves bucket-at-a-time."""

    def __init__(self, max_batch: int = 64, feedback: bool = True,
                 explore_every: int = 8, device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = _backends.resolve_device(device)
        self.max_batch = max_batch
        #: fold realized drain latencies into the calibration table and run
        #: periodic exploration; off = no writes and no exploration (routing
        #: still honors whatever the global calibration table already holds)
        self.feedback = feedback
        #: every Nth drain of a bucket tries a route that still wants an
        #: online sample (0 = never)
        self.explore_every = explore_every
        self._next_rid = 0
        self._buckets: "OrderedDict[tuple, list]" = OrderedDict()
        #: bucket key -> completed drain count (LRU, _ROUTE_STATE_MAX)
        self._drains: "OrderedDict[tuple, int]" = OrderedDict()
        #: (backend, shape_key, batch_size) triples this engine has already
        #: executed once — only repeat runs are observed, so first-use costs
        #: (kernel builds, occupancy queries, per-shape tables) never become
        #: a routing signal (LRU, _ROUTE_STATE_MAX)
        self._warmed: "OrderedDict[tuple, bool]" = OrderedDict()
        self.stats = {"submitted": 0, "completed": 0, "device_batches": 0,
                      "batched_requests": 0, "dedup_hits": 0,
                      "device_tracebacks": 0, "host_tracebacks": 0,
                      "explore_dispatches": 0, "feedback_observations": 0,
                      "extend_drains": 0, "extend_requests": 0,
                      "affine_lanes": 0}
        #: :class:`repro_torch.dp.telemetry.DrainReport` of the most recent
        #: drain (None below ``basic`` telemetry) — the service reads it to
        #: attribute span events and per-phase histograms per request
        self.last_drain = None
        _telemetry.REGISTRY.register_source("dp_engine", self)

    # -- admission ---------------------------------------------------------
    def submit(self, problem: str, reconstruct: bool = False,
               resume: Optional[Any] = None, keep_table: bool = False,
               **payload) -> int:
        """Encode eagerly (validates the instance) and enqueue. Returns rid.
        ``reconstruct=True`` requests land in their own (problem, shape)
        bucket and resolve to responses carrying a decoded solution.
        ``resume`` (a :class:`repro_torch.dp.streaming.ResumeToken`) routes the
        request into an extend bucket — the drain recomputes only the
        extension region and stitches onto the token's solved prefix."""
        prob = _registry.get(problem)
        spec = prob.encode(**payload)
        return self.submit_spec(prob, spec, reconstruct=reconstruct,
                                payload=payload, resume=resume,
                                keep_table=keep_table)

    def submit_spec(self, problem, spec: Spec, reconstruct: bool = False,
                    payload: Optional[dict] = None,
                    digest: Optional[str] = None,
                    resume: Optional[Any] = None,
                    keep_table: bool = False) -> int:
        """Admit an already-encoded spec (the :class:`repro_torch.dp.service.
        DPService` path — the service encoded it for cache keying and must
        not pay a second encode, nor a second content hash: pass its
        ``digest`` through). Returns rid."""
        prob = (_registry.get(problem) if isinstance(problem, str)
                else problem)
        if reconstruct:
            # reject at admission: drain-time failure would poison the
            # bucket forever (solve-before-dequeue keeps it enqueued)
            _reconstruct.check_reconstructable(prob, spec)
        if resume is not None and not _routing.extend_candidates(spec,
                                                                 self.device):
            raise ValueError(
                f"no extend-capable backend for spec {spec.shape_key()}; "
                "submit without resume=")
        rid = self._next_rid
        self._next_rid += 1
        key = self.bucket_key(prob.name, spec, reconstruct,
                              resume_len=None if resume is None
                              else resume.old_len)
        self._buckets.setdefault(key, []).append(
            DPRequest(rid=rid, problem=prob.name, payload=payload or {},
                      spec=spec, reconstruct=reconstruct,
                      digest=digest or spec_digest(spec), resume=resume,
                      keep_table=keep_table))
        self.stats["submitted"] += 1
        return rid

    @staticmethod
    def bucket_key(problem_name: str, spec: Spec, reconstruct: bool,
                   resume_len: Optional[int] = None) -> tuple:
        """The bucket a request lands in. The single source of truth for
        bucket keying — admission uses it, and the DPService drain
        targeting (``step(bucket=…)``) builds its keys through it too.
        Warm-start requests get their own ``("extend", old_len)``-marked
        buckets: an extend drain runs a different program (and is observed
        under a different calibration regime) than a cold batched solve of
        the same shape."""
        key = (problem_name, spec.shape_key())
        if resume_len is not None:
            key += (("extend", resume_len),)
        return key + ("reconstruct",) if reconstruct else key

    @staticmethod
    def is_extend_bucket(key: tuple) -> bool:
        return any(isinstance(m, tuple) and m and m[0] == "extend"
                   for m in key[2:])

    def pending(self) -> int:
        return sum(len(v) for v in self._buckets.values())

    def bucket_sizes(self) -> dict:
        return {k: len(v) for k, v in self._buckets.items()}

    # -- routing -----------------------------------------------------------
    def _route(self, key: tuple, spec0: Spec, reconstruct: bool,
               backend) -> tuple:
        """Resolve the bucket's route: explicit override > periodic
        exploration of an unmeasured candidate > measured-cost dispatch.
        Returns ``(backend, explored)``."""
        if backend is not None or not self.feedback:
            return _routing.resolve_backend(spec0, backend, batch=True,
                                            reconstruct=reconstruct,
                                            device=self.device), False
        pool = _routing.batch_candidates(
            spec0, reconstruct=reconstruct, device=self.device,
            batch_suffix=self._batch_regime(reconstruct),
            loop_suffix=self._loop_regime(reconstruct))
        count = self._drains.get(key, 0)
        if (self.explore_every
                and count % self.explore_every == self.explore_every - 1):
            # on the card a plain route loops on the host, step by step:
            # a drain explored onto it can take seconds where the kernel
            # routes take milliseconds, so only kernel routes are explored
            # there (the plain ones still rank by their measurements)
            explorable = (pool if self.device.type != "cuda"
                          or not any(b.kernel for b in pool)
                          else [b for b in pool if b.kernel])
            wanting = [
                b for b in explorable
                if not _autotune.has_measurement(
                    b.name,
                    spec0.shape_key() + self._obs_suffix(b, spec0, reconstruct),
                    device=self.device)]
            if wanting:
                return wanting[0], True
        return pool[0], False

    # -- drain internals (regime + execution hooks) ------------------------
    # ``ShardedDPEngine`` (repro_torch.dp.sharding) overrides these to run
    # batchable drains over a mesh of slots and key their observations
    # under the ("shard", ndev) regime; everything else in step() is shared.
    def _batch_regime(self, reconstruct: bool) -> tuple:
        """Measurement-regime suffix batchable routes rank/observe under:
        amortized bucket drains and arg-emitting (reconstruct) solves cost
        differently from plain single-instance runs, so each regime keys
        its own entries — offline calibration (plain keys) is never
        conflated with either."""
        return (_routing.RECONSTRUCT_SUFFIX if reconstruct
                else _routing.BATCH_SUFFIX)

    def _loop_regime(self, reconstruct: bool) -> tuple:
        """Regime suffix loop-only routes rank/observe under (the same as
        batchable ones on a single device)."""
        return self._batch_regime(reconstruct)

    def _obs_suffix(self, backend, spec0: Spec, reconstruct: bool) -> tuple:
        """Regime suffix a drain on ``backend`` is observed under."""
        if backend.batch_run is None:
            return self._loop_regime(reconstruct)
        return self._batch_regime(reconstruct)

    def _run_bucket(self, backend, specs, reconstruct: bool):
        """Execute one routed bucket; returns
        ``(tables, argss, source, paths)`` (``argss``/``source``/``paths``
        are None for plain solves; ``paths`` is non-None only on fused
        solve+traceback routes)."""
        if reconstruct:
            return _routing.run_batch_with_args(backend, specs, self.device)
        return _routing.run_batch(backend, specs, self.device), None, None, None

    def _sync(self) -> None:
        """Wait for the device, so a drain's clock brackets its own work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _agreed_ms(self, ms: float) -> float:
        """The time a drain (or a lane) is observed and reported at, from
        its measured ``ms``; the sharded engine's ranks agree on one."""
        return ms

    # -- warm-start extend drain -------------------------------------------
    def _extend_route(self, request, backend):
        """Route one extend lane: explicit override > the token's sticky
        session affinity > the ranked extend pool. Returns
        ``(backend, affine)``."""
        if backend is not None:
            b = (backend if isinstance(backend, _backends.Backend)
                 else _backends.get(backend))
            if b.run_extend is None or not b.supports(request.spec,
                                                      self.device):
                raise ValueError(
                    f"backend {b.name!r} cannot extend this spec")
            return b, False
        cands = _routing.extend_candidates(request.spec, self.device)
        if not cands:                    # admission already checked this
            raise RuntimeError("no extend-capable backend for "
                               f"{request.spec.shape_key()}")
        affinity = request.resume.affinity
        if affinity is not None:
            for b in cands:
                if b.name == affinity:
                    return b, True
        return cands[0], False

    def _step_extend(self, key: tuple,
                     backend: Optional[str] = None) -> list:
        """Drain one extend bucket: every lane recomputes only its
        extension region from the resume token's solved prefix and
        stitches a full table bit-identical to the cold solve. Lanes run
        one solve each (warm starts are latency-bound singletons — there is
        no cross-instance batching axis once prefixes differ),
        but dedup still applies: equal spec digests imply bit-equal
        extended tables *regardless of which prefix each token carries*,
        so duplicates fan out from one lane. Reconstruction decodes from
        host-side args on the stitched table. Realized per-lane latency
        feeds calibration under the ``("extend",)`` regime."""
        queue = self._buckets[key]
        batch, rest = queue[: self.max_batch], queue[self.max_batch:]
        prob = _registry.get(key[0])
        reconstruct = batch[0].reconstruct
        uniq_idx: "OrderedDict[str, int]" = OrderedDict()
        for i, r in enumerate(batch):
            uniq_idx.setdefault(r.digest, i)
        lane_of = {d: j for j, d in enumerate(uniq_idx)}
        uniq = [batch[i] for i in uniq_idx.values()]
        obs_key = uniq[0].spec.shape_key() + _routing.EXTEND_SUFFIX
        routes = [self._extend_route(r, backend) for r in uniq]
        if _telemetry.audit_enabled():
            _telemetry.record_route_decision(
                "extend_drain", uniq[0].spec.shape_key(),
                _routing.EXTEND_SUFFIX, [], routes[0][0].name,
                bucket=repr(key), batch_size=len(batch), unique=len(uniq),
                affine=any(a for _, a in routes),
                override=backend is not None)
        tables, answers, lane_cold = [], [], []
        with _telemetry.drain_scope(key, routes[0][0].name, len(batch),
                                    len(uniq)) as drain_rep:
            extend_ms = 0.0
            for r, (chosen, affine) in zip(uniq, routes):
                tok = r.resume
                builds_before = _backends.build_count()
                self._sync()
                t0 = time.perf_counter()
                ext = chosen.run_extend(r.spec, tok.old_len, tok.state(),
                                        self.device)
                table = r.spec.stitch_extension(tok.prefix_spec,
                                                tok.prefix_table, ext)
                self._sync()
                lane_ms = self._agreed_ms((time.perf_counter() - t0) * 1e3)
                extend_ms += lane_ms
                # same freezing rule as batched drains: dedup fan-out and
                # the caches share this exact array
                table.setflags(write=False)
                warm_key = (chosen.name, obs_key, 1)
                cold = (warm_key not in self._warmed
                        or _backends.build_count() != builds_before)
                _backends.lru_put(self._warmed, warm_key, True,
                                  _ROUTE_STATE_MAX)
                lane_cold.append(cold)
                if self.feedback and not cold:
                    _autotune.observe(chosen.name, obs_key, lane_ms,
                                      device=self.device)
                    self.stats["feedback_observations"] += 1
                if affine:
                    self.stats["affine_lanes"] += 1
                tables.append(table)
                if reconstruct:
                    args = _reconstruct.args_from_table(table, r.spec)
                    answers.append(_reconstruct.reconstruct_one(
                        prob, r.spec, table, args, "host"))
                else:
                    answers.append(None)
            _telemetry.add_phase("extend", extend_ms)
            if drain_rep is not None:
                drain_rep.cold = any(lane_cold)
        self.last_drain = drain_rep
        responses = []
        for i, r in enumerate(batch):
            j = lane_of[r.digest]
            responses.append(DPResponse(
                rid=r.rid, problem=r.problem,
                answer=prob.extract(tables[j], r.spec),
                backend=routes[j][0].name, batch_size=len(batch),
                solution=answers[j], deduped=uniq_idx[r.digest] != i,
                table=tables[j] if r.keep_table else None,
                extended=True, affine=routes[j][1]))
        if rest:
            self._buckets[key] = rest
        else:
            del self._buckets[key]
        _backends.lru_put(self._drains, key, self._drains.get(key, 0) + 1,
                          _ROUTE_STATE_MAX)
        self.stats["extend_drains"] += 1
        self.stats["extend_requests"] += len(batch)
        self.stats["completed"] += len(batch)
        self.stats["dedup_hits"] += len(batch) - len(uniq)
        if reconstruct:
            self.stats["host_tracebacks"] += len(uniq)
        if _telemetry.enabled("basic"):
            _telemetry.count("dp_engine_extend_drains_total")
            _telemetry.count("dp_engine_extend_requests_total", len(batch))
            _telemetry.set_gauge("dp_engine_pending", self.pending())
            _log.debug("extend drain %r: %d req (%d lanes) in %.3f ms",
                       key, len(batch), len(uniq), extend_ms)
        return responses

    # -- one batched device call ------------------------------------------
    def step(self, backend: Optional[str] = None,
             bucket: Optional[tuple] = None) -> list:
        """Drain up to ``max_batch`` requests from one bucket with a single
        batched solve — the fullest bucket by default, or exactly
        ``bucket`` when given (the DPService scheduler picks by
        priority/deadline instead of size). Identical instances in the
        bucket (equal spec digests) solve once and fan the result out to
        every rid (``stats["dedup_hits"]``). Returns the finished
        DPResponses."""
        if not self._buckets:
            return []
        if bucket is not None:
            if bucket not in self._buckets:
                raise KeyError(f"no such bucket {bucket!r}; "
                               f"pending: {list(self._buckets)}")
            key = bucket
        else:
            key = max(self._buckets, key=lambda k: len(self._buckets[k]))
        if self.is_extend_bucket(key):
            return self._step_extend(key, backend=backend)
        queue = self._buckets[key]
        batch, rest = queue[: self.max_batch], queue[self.max_batch:]

        prob = _registry.get(key[0])
        reconstruct = batch[0].reconstruct
        specs = [r.spec for r in batch]
        # solve, traceback and decode all run BEFORE dequeuing: a failed
        # batch (bad backend override, transient device error, a decode bug)
        # must not lose requests
        chosen, explored = self._route(key, specs[0], reconstruct, backend)
        # intra-drain dedup: one solve lane per distinct digest — equal
        # digests imply bit-equal answers (problem.spec_digest), so the
        # extract/decode of the shared lane serves every duplicate rid
        uniq_idx: "OrderedDict[str, int]" = OrderedDict()
        for i, r in enumerate(batch):
            uniq_idx.setdefault(r.digest, i)
        lane_of = {d: j for j, d in enumerate(uniq_idx)}
        uniq_specs = [specs[i] for i in uniq_idx.values()]

        suffix = self._obs_suffix(chosen, specs[0], reconstruct)
        obs_key = specs[0].shape_key() + suffix
        if _telemetry.audit_enabled():
            _telemetry.record_route_decision(
                "drain", specs[0].shape_key(), suffix, [],
                chosen.name, bucket=repr(key), batch_size=len(batch),
                unique=len(uniq_specs), explored=explored,
                override=backend is not None)
        warm_key = (chosen.name, obs_key, len(uniq_specs))
        with _telemetry.drain_scope(key, chosen.name, len(batch),
                                    len(uniq_specs)) as drain_rep:
            builds_before = _backends.build_count()
            self._sync()
            t0 = time.perf_counter()
            tables, argss, source, paths = self._run_bucket(
                chosen, uniq_specs, reconstruct)
            self._sync()
            solve_ms = self._agreed_ms((time.perf_counter() - t0) * 1e3)
            _telemetry.add_phase("solve", solve_ms)
            # dedup fan-out (and the service answer cache) hand the SAME
            # arrays to multiple consumers — freeze them so a caller's
            # in-place edit raises instead of silently corrupting the
            # duplicates' and future cache hits' answers
            for arr in tables:
                arr.setflags(write=False)
            # a drain is warm only if this engine already ran this exact
            # (route, shape, batch size) AND no kernel library was built or
            # first loaded during the call
            cold = (warm_key not in self._warmed
                    or _backends.build_count() != builds_before)
            _backends.lru_put(self._warmed, warm_key, True, _ROUTE_STATE_MAX)
            if drain_rep is not None:
                drain_rep.cold = cold
                drain_rep.explored = explored
            if reconstruct:
                answers = _reconstruct.reconstruct_batch(
                    prob, uniq_specs, tables, argss, source, paths=paths)
                for a in answers:
                    a.args.setflags(write=False)
            else:
                answers = [None] * len(uniq_specs)
        self.last_drain = drain_rep
        responses = []
        for i, r in enumerate(batch):
            j = lane_of[r.digest]
            responses.append(
                DPResponse(rid=r.rid, problem=r.problem,
                           answer=prob.extract(tables[j], r.spec),
                           backend=chosen.name, batch_size=len(batch),
                           solution=answers[j],
                           deduped=uniq_idx[r.digest] != i,
                           table=tables[j] if r.keep_table else None))

        if rest:
            self._buckets[key] = rest
        else:
            del self._buckets[key]
        _backends.lru_put(self._drains, key, self._drains.get(key, 0) + 1,
                          _ROUTE_STATE_MAX)
        self.stats["device_batches"] += 1
        self.stats["completed"] += len(batch)
        self.stats["batched_requests"] += len(batch) if len(batch) > 1 else 0
        self.stats["dedup_hits"] += len(batch) - len(uniq_specs)
        if explored:
            self.stats["explore_dispatches"] += 1
        if self.feedback and not cold:
            # per-instance cost of what the device actually solved — the
            # deduped lane count, not the fan-out count
            _autotune.observe(chosen.name, obs_key,
                              solve_ms / len(uniq_specs), device=self.device)
            self.stats["feedback_observations"] += 1
        if reconstruct:
            # count walks actually executed (the deduped lanes), matching
            # the feedback accounting — duplicate traffic must not inflate
            # the device-vs-host traceback picture
            counter = ("device_tracebacks" if source == "device"
                       else "host_tracebacks")
            self.stats[counter] += len(uniq_specs)
        if _telemetry.enabled("basic"):
            _telemetry.count("dp_engine_drains_total")
            _telemetry.count("dp_engine_requests_total", len(batch))
            _telemetry.count("dp_engine_dedup_fanout_total",
                             len(batch) - len(uniq_specs))
            if cold:
                _telemetry.count("dp_engine_cold_drains_total")
            _telemetry.observe_ms("dp_engine_batch_size", len(batch),
                                  buckets=_telemetry.DEFAULT_SIZE_BUCKETS)
            _telemetry.set_gauge("dp_engine_pending", self.pending())
            _log.debug("drain %r: %d req (%d unique) via %s in %.3f ms "
                       "(cold=%s explored=%s)", key, len(batch),
                       len(uniq_specs), chosen.name, solve_ms, cold,
                       explored)
        return responses

    def run(self, backend: Optional[str] = None) -> dict:
        """Drain every bucket; returns {rid: DPResponse}."""
        out = {}
        while self.pending():
            for resp in self.step(backend=backend):
                out[resp.rid] = resp
        return out
