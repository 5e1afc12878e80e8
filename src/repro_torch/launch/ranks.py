"""Rank programs of the sharded LM for ``runtime.distributed.launch``: each
is ``fn(comm, ...)``, runs in every rank's process on that rank's share of
the model (``ShardedLM.of_rank``), and returns what its caller compares
(tensors come back on the CPU; with ``digest_out=True`` the large ones
come back as :func:`digest`\\ s).

* :func:`serve`: requests through the serving engine (:func:`serve_requests`,
  which the threaded model runs too);
* :func:`train`: one train step with its gradients (:func:`train_record`,
  which the threaded model runs too);
* :func:`attention_ms`: K7 or K7b timed in rank 0 at a rank's shapes,
  beside its plain version and PyTorch's attention;
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

from repro_torch.models.model import ShardedLM
from repro_torch.runtime import distributed, sharding


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
    (hashlib lets go of the interpreter lock)."""
    ts = list(sharding.tensors(obj))
    with ThreadPoolExecutor(8) as pool:
        return distributed.refill(obj, iter(list(pool.map(_sha256, ts))))


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
