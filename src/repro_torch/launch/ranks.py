"""Rank programs for ``runtime.distributed.launch`` (and
``runtime.sharding.run``): each is ``fn(comm, ...)``, runs in every rank on
that rank's share of the work, and returns what its caller compares
(tensors come back on the CPU; with ``digest_out=True`` the large ones
come back as :func:`digest`\\ s).

* :func:`serve`: requests through the serving engine on the rank's share of
  the model (``ShardedLM.of_rank``; :func:`serve_requests`, which the
  threaded model runs too);
* :func:`train`: one train step with its gradients (:func:`train_record`,
  which the threaded model runs too);
* :func:`dp_drains`: buckets of DP instances through a ``ShardedDPEngine``
  rank, each rank solving its share (:func:`response_record` of each
  response, which the threaded engine's responses give too);
* :func:`dp_service`: DP traffic, with priorities, deadlines and streaming
  sessions, through a ``DPService(comm=comm)`` rank (:func:`serve_dp`, which
  the threaded and the single-engine service run too);
* :func:`pipeline`: ``pipeline_apply_rank`` over a model's blocks, each rank
  one stage (``stage_params``);
* :func:`compressed`: ``compressed_psum_rank`` of each rank's shard;
* :func:`attention_ms` and :func:`dp_kernel_ms`: K7 or K7b, or a DP route's
  kernel (K1–K4, K6 by either schedule), timed in rank 0 at a rank's shapes
  beside its plain version;
* :func:`sequence`: several programs in one launch, each timed, with the
  kernel launches and the peak memory it took in the rank.

A program given ``mesh`` (a shape) runs over the launch's processes
arranged as that mesh (``ProcessComm.remesh``), so one launch serves
several meshes.
"""
from __future__ import annotations

import gc
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import CausalLM, ShardedLM, embed_tokens, stage_params
from repro_torch.optim.grad_compress import compressed_psum_rank
from repro_torch.runtime import distributed, pipeline_parallel, sharding


def _on(comm, mesh: Optional[Sequence[int]]):
    """``comm``, or its processes arranged as a ``mesh``-shaped mesh."""
    if mesh is None or tuple(mesh) == tuple(comm.mesh.slots.shape):
        return comm
    return comm.remesh(mesh, comm.mesh.axis_names)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sha256(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().data)
    return h.hexdigest()


def digest(obj):
    """``obj`` with each tensor replaced by the sha256 of its dtype, shape
    and bytes (equal digests: equal bits), hashed on a pool of threads
    (hashlib lets go of the interpreter lock). The caller's current streams
    are waited for first: a pool thread copies a tensor to the host on its
    device's default stream, which is not ordered after them."""
    ts = list(sharding.tensors(obj))
    for dev in {t.device for t in ts if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    with ThreadPoolExecutor(8) as pool:
        return sharding.refill(obj, iter(list(pool.map(_sha256, ts))))


class Recording:
    """A model whose ``prefill`` and ``decode_step`` keep their logits and
    their ms (each call synchronised); every other attribute is the
    model's."""

    def __init__(self, model):
        self.model, self.logits = model, []
        self.ms = {"prefill": [], "decode": []}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _timed(self, kind: str, fn, *args, **kw):
        dev = self.model.device
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = fn(*args, **kw)
        _sync(dev)
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.logits.append(logits)
        return logits, cache

    def prefill(self, *args, **kw):
        return self._timed("prefill", self.model.prefill, *args, **kw)

    def decode_step(self, *args, **kw):
        return self._timed("decode", self.model.decode_step, *args, **kw)


def serve_requests(model, prompts: Sequence, max_new: int, max_len: int) -> tuple:
    """``prompts`` through a serving engine over ``model`` (one request a
    slot, each admitted, then decode steps until every one is done).
    Returns (the engine, {"tokens": each request's, "logits": each call's,
    "ms": each call's by kind})."""
    from repro_torch.serving import Engine, Request

    rec = Recording(model)
    eng = Engine(rec, max_batch=len(prompts), max_len=max_len, cache_dtype=torch.float32)
    reqs = [Request(rid=i, prompt=np.asarray(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(r)
    while eng.active().any():
        eng.step()
    return eng, {"tokens": [list(r.out) for r in reqs], "logits": rec.logits, "ms": rec.ms}


def serve(comm, cfg, prompts: Sequence, max_new: int, max_len: int, *, mesh=None,
          seed: int = 0, digest_out: bool = False) -> dict:
    """:func:`serve_requests` on this rank's share of
    ``CausalLM.from_seed(cfg, seed)``; the record with "cache": the rank's
    shards of the engine's cache."""
    comm = _on(comm, mesh)
    model = ShardedLM.of_rank(cfg, comm, seed=seed)
    eng, rec = serve_requests(model, prompts, max_new, max_len)
    shards = eng.cache.shards[comm.index]
    rec["cache"] = digest(shards) if digest_out else shards
    if digest_out and comm.rank:   # every rank's logits are rank 0's: its own come back
        rec["logits"] = digest(rec["logits"])
    return rec


def opt_config(lr: float, warmup: int, total: int):
    """AdamW with the warmup-cosine schedule (a config crosses processes as
    these numbers: its schedule is a closure)."""
    from repro_torch.optim import adamw, schedules

    return adamw.AdamWConfig(lr=schedules.warmup_cosine(lr, warmup, total))


def train_record(model: ShardedLM, batch: dict, opt_cfg) -> dict:
    """One ``model.train_step`` on ``batch``: {"metrics", "grads": the
    slots' gradient shards of the step, "params": their parameter shards
    after it, both by index}."""
    grads: dict = {}
    metrics = model.train_step(opt_cfg, model.init_opt(opt_cfg), batch, grads_out=grads)
    return {"metrics": metrics, "grads": grads,
            "params": {idx: {n: p.detach() for n, p in model.params[idx].items()}
                       for idx in model._indices()}}


def train(comm, cfg, batch: dict, *, mesh=None, seed: int = 0, lr: float = 3e-4,
          warmup: int = 10, total: int = 20, digest_out: bool = False) -> dict:
    """:func:`train_record` on this rank's share of
    ``CausalLM.from_seed(cfg, seed)`` and of ``batch`` (numpy arrays or CPU
    tensors, the whole batch): "grads" and "params" are the rank's."""
    comm = _on(comm, mesh)
    model = ShardedLM.of_rank(cfg, comm, seed=seed)
    rec = train_record(model, batch, opt_config(lr, warmup, total))
    rec["grads"], rec["params"] = rec["grads"][comm.index], rec["params"][comm.index]
    if digest_out:
        rec["grads"], rec["params"] = digest(rec["grads"]), digest(rec["params"])
    return rec


def _events_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    by CUDA events on the current stream."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _largest_gap(got, want) -> tuple:
    """(largest |got - want| over the tensors, as a share of max |want|)."""
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    return err, err / max(max(float(b.double().abs().max()) for b in want), 1e-30)


def attention_ms(comm, q_shape: tuple, kv_shape: tuple, backward: bool = False,
                 reps: int = 5, seed: int = 0):
    """K7 (``backward``: K7b, on K7's output and log-sum-exp and a drawn dO)
    at causal q (B, Hq, S, D) and k, v (B, Hkv, S, D) drawn from ``seed``
    on this rank's card, timed by CUDA events in rank 0 while the others
    wait at a barrier, beside its plain version (one call) and PyTorch's
    ``scaled_dot_product_attention`` (its backward for K7b). Returns
    {"ms", "plain_ms", "library_ms", "max_abs_err", "share"} in rank 0,
    None in the others."""
    import torch.distributed as dist
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as k7

    dist.barrier()
    if comm.rank:
        dist.barrier()
        return None
    dev = comm.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=gen, device=dev)
                   for s in (q_shape, kv_shape, kv_shape, q_shape))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if backward:
        o, lse = k7._launch(q, k, v, True, k7.body_for(q, k, v), with_lse=True)
        run = lambda: k7._launch_backward(q, k, v, o, lse, do, True)   # noqa: E731
        start.record()
        want = k7.flash_attention_backward_plain(q, k, v, o, lse, do)
        end.record()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves, is_causal=True, enable_gqa=True)
        lib = _events_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps)
        got = run()
    else:
        run = lambda: k7.flash_attention(q, k, v)   # noqa: E731
        start.record()
        want = (k7.flash_attention_plain(q, k, v),)
        end.record()
        lib = _events_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), reps)
        got = (run(),)
    end.synchronize()
    plain = start.elapsed_time(end)
    err, share = _largest_gap(got, want)
    ms = _events_ms(run, reps)
    dist.barrier()
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "max_abs_err": err,
            "share": share}


# ---------------------------------------------------------------------------
# The DP engine, the pipeline and the compressed all-reduce
# ---------------------------------------------------------------------------
def _np_digest(a) -> str:
    return _sha256(torch.from_numpy(np.ascontiguousarray(a)))


def response_record(r, digest_out: bool = False) -> dict:
    """A ``DPResponse`` as plain data: its rid, route, answer and, under
    reconstruct, its solution's value, table, args and decoded path (with
    ``digest_out`` the answer, value, table and args as digests of their
    float32 or own bytes)."""
    keep = _np_digest if digest_out else (lambda a: a)
    rec = {"rid": r.rid, "backend": r.backend, "answer": keep(np.float32(r.answer)),
           "solution": None}
    if r.solution is not None:
        sol = r.solution
        rec["solution"] = {"value": keep(np.float32(sol.value)), "table": keep(sol.table),
                           "args": keep(sol.args), "path": sol.solution}
    return rec


def drain_rounds(engine, prob, specs: Sequence, route: Optional[str], reconstruct: bool,
                 rounds: int, digest_out: bool = False) -> tuple:
    """``specs`` (of problem ``prob``, each with its ``spec_digest``:
    ``(spec, digest)`` pairs) submitted to ``engine`` and drained,
    ``rounds`` times, with ``route`` forced (None: the engine's choice):
    (each round's :func:`response_record`\\ s, each round's seconds on the
    host clock with the engine's device synchronised)."""
    records, seconds = [], []
    for _ in range(rounds):
        for spec, key in specs:
            engine.submit_spec(prob, spec, reconstruct=reconstruct, digest=key)
        got = []
        _sync(engine.device)
        t0 = time.perf_counter()
        while engine.pending():
            got += engine.step(backend=route)
        _sync(engine.device)
        seconds.append(time.perf_counter() - t0)
        records.append([response_record(r, digest_out) for r in got])
    return records, seconds


def encoded(prob, instances: Sequence) -> list:
    """``(spec, spec_digest)`` of each instance (keyword dicts) of ``prob``."""
    from repro_torch.dp.problem import spec_digest

    specs = [prob.encode(**kw) for kw in instances]
    return [(spec, spec_digest(spec)) for spec in specs]


def dp_drains(comm, buckets: Sequence, *, rounds: int = 1, max_batch: int = 8,
              axis: Optional[str] = None, digest_out: bool = False) -> list:
    """Each bucket of ``buckets``, ``(problem, route, instances,
    reconstruct)`` with the instances as numpy keyword dicts (buckets that
    share one list of instances share its encoding), through a fresh
    ``ShardedDPEngine(comm=comm)`` (no feedback; :func:`drain_rounds`).
    For each bucket {"responses": each round's records, "seconds": each
    round's, "stats": the engine's}."""
    from repro_torch import dp

    out, specs = [], {}
    for problem, route, instances, reconstruct in buckets:
        prob = dp.get_problem(problem)
        if id(instances) not in specs:
            specs[id(instances)] = encoded(prob, instances)
        eng = dp.ShardedDPEngine(comm=comm, axis=axis, max_batch=max_batch, feedback=False)
        records, seconds = drain_rounds(eng, prob, specs[id(instances)], route, reconstruct,
                                        rounds, digest_out)
        out.append({"responses": records, "seconds": seconds, "stats": dict(eng.stats)})
    return out


def ticket_record(res, digest_out: bool = False) -> dict:
    """A ``ServiceResult`` as plain data: its tid, problem, status, answer
    (its numpy value, or with ``digest_out`` the digest of its dtype and
    bytes), decoded solution, route, ``cached``, ``extended`` and session."""
    answer = None if res.answer is None else np.asarray(res.answer)
    if digest_out and answer is not None:
        answer = _np_digest(answer)
    return {"tid": res.tid, "problem": res.problem, "status": res.status, "answer": answer,
            "solution": None if res.solution is None else res.solution.solution,
            "backend": res.backend, "cached": res.cached, "extended": res.extended,
            "sid": res.sid}


def host_seconds(requests: Sequence, sessions: Sequence = ()) -> dict:
    """{"encode", "digest"}: the host seconds of encoding and digesting
    each distinct instance of ``requests`` and ``sessions`` (as
    :func:`serve_dp` takes them) once, the work every rank of a
    ``DPService(comm=...)`` repeats for every request it admits."""
    from repro_torch import dp
    from repro_torch.dp.problem import spec_digest

    seen, out = set(), {"encode": 0.0, "digest": 0.0}
    items = [(r[0], r[1]) for r in requests] + [(name, kw) for name, steps in sessions
                                                for kw in steps]
    for name, kw in items:
        if id(kw) in seen:
            continue
        seen.add(id(kw))
        t0 = time.perf_counter()
        spec = dp.get_problem(name).encode(**kw)
        t1 = time.perf_counter()
        spec_digest(spec)
        out["encode"] += t1 - t0
        out["digest"] += time.perf_counter() - t1
    return out


def serve_dp(svc, requests: Sequence, sessions: Sequence = (), *, step_every: int = 32,
             steps: int = 2, digest_out: bool = False) -> dict:
    """``requests`` through the service ``svc``: each ``(problem, payload,
    reconstruct, priority, deadline_ms)`` submitted in order, ``steps``
    ``svc.step()`` calls after every ``step_every`` submits, then steps
    until nothing is pending; then each ``(problem, payloads)`` of
    ``sessions`` as a streaming session, one ``append`` and ``run`` a
    payload. Returns {"records": each ticket's :func:`ticket_record` in tid
    order, "sessions": each session's summary, "stats", "engine": the
    engine's stats, "routes", "seconds": on the host clock with the
    engine's device synchronised, "sessions_seconds" of that}."""
    dev = svc.engine.device
    got, summaries = {}, []
    _sync(dev)
    t0 = time.perf_counter()
    for i, (name, kw, recon, priority, deadline_ms) in enumerate(requests):
        svc.submit(name, reconstruct=recon, priority=priority, deadline_ms=deadline_ms, **kw)
        if i % step_every == step_every - 1:
            for _ in range(steps):
                svc.step()
    got.update(svc.run())
    _sync(dev)
    t1 = time.perf_counter()
    for name, payloads in sessions:
        sid = svc.open_session(name)
        for kw in payloads:
            svc.append(sid, **kw)
            got.update(svc.run())
        summaries.append(svc.close_session(sid))
    _sync(dev)
    t2 = time.perf_counter()
    return {"records": [ticket_record(got[t], digest_out) for t in sorted(got)],
            "sessions": summaries, "stats": dict(svc.stats), "engine": dict(svc.engine.stats),
            "routes": dict(svc.routes), "seconds": t2 - t0, "sessions_seconds": t2 - t1}


def dp_service(comm, requests: Sequence, sessions: Sequence = (), *, max_batch: int = 32,
               timing: bool = False, digest_out: bool = False, **service) -> dict:
    """:func:`serve_dp` through a ``DPService(comm=comm, max_batch=...,
    feedback=False, **service)`` rank (requests and sessions as numpy
    payloads); with ``timing``, {"host": :func:`host_seconds`} of the same
    traffic beside, measured first."""
    from repro_torch import dp

    host = host_seconds(requests, sessions) if timing else None
    svc = dp.DPService(comm=comm, max_batch=max_batch, **{"feedback": False, **service})
    out = serve_dp(svc, requests, sessions, digest_out=digest_out)
    out["host"] = host
    return out


#: plain steps past which an S-DP kernel of a grid-shaped spec is held
#: against ``sdp_pipeline.grid_rows_plain`` instead (its plain version takes
#: a step of ``min(offsets)`` cells: one a cell on an alignment grid)
PLAIN_STEPS_MAX = 1 << 16


def _dp_calls(route: str, specs: list, reconstruct: bool, device) -> tuple:
    """(the route's kernel, its plain version), each a call with no
    arguments on ``specs`` stacked on ``device``, returning the table first
    (and, under ``reconstruct``, the args, and K4's fused nodes). An S-DP
    table whose plain version would take more than
    :data:`PLAIN_STEPS_MAX` steps is held against
    ``sdp_pipeline.grid_rows_plain``."""
    from repro_torch.dp.backends import _stack
    from repro_torch.kernels import grid_pipeline as k6
    from repro_torch.kernels import mcm_pipeline as k2
    from repro_torch.kernels import mcm_tiled as k4
    from repro_torch.kernels import ops
    from repro_torch.kernels import sdp_chunked as k3
    from repro_torch.kernels import sdp_pipeline as k1

    s0 = specs[0]
    if route in ("kernel_blocked", "kernel_tiled"):
        init = _stack([s.init for s in specs], device)
        w = None if s0.weights is None else _stack([s.weights for s in specs], device)
        if route == "kernel_blocked":
            kern = ops.sdp_blocked_with_args if reconstruct else ops.sdp_blocked
            plain = k1.sdp_pipeline_plain
        else:
            kern = ops.sdp_chunked_with_args if reconstruct else ops.sdp_chunked
            plain = k3.sdp_chunked_plain
        run = lambda: kern(init, s0.offsets, s0.op, s0.n, weights=w)   # noqa: E731
        if (s0.n - s0.offsets[0]) // min(s0.offsets) > PLAIN_STEPS_MAX:
            return run, lambda: k1.grid_rows_plain(init, s0.offsets, s0.op, s0.n, w,
                                                   with_args=reconstruct)
        return run, lambda: plain(init, s0.offsets, s0.op, s0.n, weights=w,
                                  with_args=reconstruct)
    if route == "kernel_grid":
        arrs = tuple(_stack(a, device) for a in zip(*(s.device_arrays() for s in specs)))
        meta = s0.static_meta()
        kern = ops.grid_blocked_with_args if reconstruct else ops.grid_blocked
        return (lambda: kern(arrs, meta),
                lambda: k6.grid_pipeline_plain(arrs, meta, with_args=reconstruct))
    wtab = _stack([s.weights for s in specs], device)
    if route == "kernel_wavefront":
        kern = ops.mcm_blocked_with_args if reconstruct else ops.mcm_blocked
        return (lambda: kern(wtab, s0.n),
                lambda: k2.mcm_pipeline_plain(wtab, s0.n, with_args=reconstruct))
    if route == "kernel_tiled_wavefront":
        kern = ops.mcm_tiled_fused if reconstruct else ops.mcm_tiled
        return (lambda: kern(wtab, s0.n),
                lambda: k4.mcm_tiled_plain(wtab, s0.n, fused=reconstruct))
    raise ValueError(f"no kernel to time for route {route!r}")


def dp_kernel_ms(comm, problem: str, route: str, instances: Sequence,
                 reconstruct: bool = False, reps: int = 5, axis: Optional[str] = None):
    """The kernel of ``route`` at rank 0's share of the bucket of
    ``instances`` (padded to the ranks along ``axis`` as the sharded engine
    pads it), timed by CUDA events in rank 0 while the others wait at a
    barrier, beside its plain version (one call): {"ms", "plain_ms",
    "max_abs_err" of the table, "equal": every output bit-equal, "lanes"}
    in rank 0, None in the others."""
    import torch.distributed as dist

    from repro_torch import dp

    dist.barrier()
    if comm.rank:
        dist.barrier()
        return None
    prob = dp.get_problem(problem)
    ctx = dp.ShardContext(comm.mesh, axis or comm.mesh.axis_names[0], comm)
    padded, _ = ctx.pad([prob.encode(**kw) for kw in instances])
    k, n = comm.share(ctx.axis)
    mine = [padded[i] for i in np.array_split(np.arange(len(padded)), n)[k]]
    run, plain = _dp_calls(route, mine, reconstruct, comm.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    got = run()
    end.synchronize()
    flat = lambda o: list(sharding.tensors(o))   # noqa: E731
    equal = all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    err = _largest_gap(flat(got)[:1], flat(want)[:1])[0]
    result = {"ms": _events_ms(run, reps), "plain_ms": start.elapsed_time(end),
              "max_abs_err": err, "equal": equal, "lanes": len(mine)}
    dist.barrier()
    return result


def pipeline_input(embed, cfg, tokens) -> torch.Tensor:
    """(M, 1, S, d) microbatches: the embeddings of ``tokens`` (M, S), one
    sequence a microbatch, in the compute dtype."""
    tok = torch.as_tensor(np.asarray(tokens), device=embed.device).long()
    return embed_tokens(embed, cfg, tok)[:, None]


def block_stage(blocks: Sequence, x: torch.Tensor) -> torch.Tensor:
    """``blocks`` applied in order to a microbatch (1, S, d): each block's
    causal full-sequence forward at positions 0..S-1."""
    positions = torch.arange(x.shape[-2], device=x.device).expand(1, x.shape[-2])
    for blk in blocks:
        x, _ = blk(x, positions, "train")
    return x


def pipeline_stages(cfg, stages: int) -> tuple:
    """(the stages' first layers after the first, as
    ``pipeline_parallel.stage_boundaries`` balances the layers' parameter
    counts, and its bottleneck)."""
    model = CausalLM(cfg, device="meta")
    return pipeline_parallel.stage_boundaries(
        [sum(p.numel() for p in b.parameters()) for b in model.layers], stages)


def pipeline(comm, cfg, tokens, *, seed: int = 0, axis: Optional[str] = None,
             digest_out: bool = False) -> torch.Tensor:
    """``pipeline_apply_rank`` of ``CausalLM.from_seed(cfg, seed)``'s blocks
    over the ranks along ``axis`` (the mesh's first by default), each rank
    one stage of :func:`pipeline_stages`: it draws its stage's blocks and
    the embedding table alone on its device (``stage_params``), embeds
    ``tokens`` (M, S) as M microbatches (:func:`pipeline_input`) and runs
    :func:`block_stage`, without gradients. Returns the (M, 1, S, d)
    outputs (every rank's copy), or their digest."""
    axis = axis or comm.mesh.axis_names[0]
    group = comm.group(axis)
    bounds, _ = pipeline_stages(cfg, len(group))
    edges = (0, *bounds, cfg.n_layers)
    j = group.index(comm.rank)
    embed, blocks = stage_params(cfg, seed, comm.device, range(edges[j], edges[j + 1]))
    with torch.no_grad():
        x = pipeline_input(embed, cfg, tokens)
        del embed
        out = pipeline_parallel.pipeline_apply_rank(block_stage, blocks, x, comm, axis)
    return digest(out) if digest_out else out


def compressed(comm, shards: Sequence, axis: Optional[str] = None, *, mesh=None,
               digest_out: bool = False):
    """``compressed_psum_rank`` of this rank's ``shards[comm.rank]`` (numpy)
    over ``axis`` (the mesh's first by default; over the processes arranged
    as ``mesh``), or its digest."""
    comm = _on(comm, mesh)
    x = torch.as_tensor(np.asarray(shards[comm.rank])).to(comm.device)
    out = compressed_psum_rank(x, comm, axis or comm.mesh.axis_names[0])
    return digest(out) if digest_out else out


def sequence(comm, jobs: Sequence) -> list:
    """Each ``(fn, kwargs)`` of ``jobs`` in order as ``fn(comm, **kwargs)``;
    for each, {"result", "seconds", "launches": the kernel launches it made
    in this rank, "peak_bytes": the card's peak allocated bytes in it (None
    on the CPU)}. Each job's objects are freed before the next."""
    dev = comm.device
    out = []
    for fn, kw in jobs:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        before = distributed.launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        result = fn(comm, **kw)
        _sync(dev)
        seconds = time.perf_counter() - t0
        after = distributed.launch_counts()
        launches = {k: v - before.get(mod, {}).get(k, 0)
                    for mod, table in after.items() for k, v in table.items()}
        out.append({"result": result, "seconds": seconds, "launches": launches,
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None})
    return out
