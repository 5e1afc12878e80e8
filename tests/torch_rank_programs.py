"""Rank programs that only the tests run under
``repro_torch.runtime.distributed.launch``: each is ``fn(comm, ...)`` in
every rank's process, on that rank's share of the model where it has one.

A rank's process imports this module by name (``spawn`` hands the
caller's ``sys.path`` on), so it imports ``torch`` and ``repro_torch``
only: no ``jax``, no ``repro``, nothing of a test file.

* :func:`forward`: a batch's prefill, then decode steps fed the argmax of
  the last logits or given tokens (:func:`prefill_and_decode`, which the
  threaded model runs too);
* :func:`step_log`: the collectives' log of one train or decode step;
* :func:`collectives`: every collective of the communicator on given
  inputs, a gradient through them included (a ``Comm`` of
  ``runtime.sharding.run`` runs it too);
* :func:`dp_sweep`: DP traffic through one ``ShardedDPEngine`` rank, with
  the rank's calibration table;
* :func:`permutes`: ``permute`` over every set of the mesh's axes;
* :func:`skipped_permute`: a pipeline's permutes with one rank skipping
  one (the call must fail);
* :func:`pipeline_tanh`: ``pipeline_apply_rank`` of the reference's
  ``tanh(x @ W + b)`` stages;
* :func:`pipeline_negzero`: ``pipeline_apply_rank`` of stages whose every
  output is -0.0 (:func:`negzero_stage`).
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import ranks
from repro_torch.models.model import ShardedLM
from repro_torch.runtime import sharding
from repro_torch.runtime.pipeline_parallel import pipeline_apply_rank


def prefill_and_decode(model, tokens, steps: int, forced=None, max_len: Optional[int] = None,
                       frontend=None) -> tuple:
    """``model``'s prefill of ``tokens`` (B, T) into a float32 cache, then
    ``steps`` decode steps at positions T, T + 1, … fed ``forced[i]``
    (B, 1) where given, else the argmax of the last logits. Returns (each
    call's logits, the cache)."""
    dev = model.device
    tok = torch.as_tensor(np.asarray(tokens), device=dev).long()
    fr = None if frontend is None else torch.as_tensor(np.asarray(frontend), device=dev)
    logits, cache = model.prefill(tok, max_len=max_len, cache_dtype=torch.float32, frontend=fr)
    out = [logits]
    for step in range(steps):
        nxt = (logits.argmax(dim=-1, keepdim=True) if forced is None
               else torch.as_tensor(np.asarray(forced[step]), device=dev).long())
        logits, cache = model.decode_step(nxt, cache, tok.shape[1] + step)
        out.append(logits)
    return out, cache


def forward(comm, cfg, tokens, steps: int, *, seed: int = 0, **kw) -> dict:
    """:func:`prefill_and_decode` (``kw`` its options) on this rank's share
    of ``CausalLM.from_seed(cfg, seed)``: {"logits": each call's, "cache":
    the rank's cache shards}."""
    model = ShardedLM.of_rank(cfg, comm, seed=seed)
    logits, cache = prefill_and_decode(model, tokens, steps, **kw)
    return {"logits": logits, "cache": cache.shards[comm.index]}


def step_log(comm, cfg, batch: dict, kind: str, *, seed: int = 0, cache_len: int = 0,
             pos: int = 0) -> list:
    """This rank's (kind, bytes) log of the collectives of one step of its
    share of ``CausalLM.from_seed(cfg, seed)``, which the dry run's
    ``RecordingComm`` predicts: "train", the gradient pass on ``batch``
    (``model.grads``); "decode", a decode step of ``batch["tokens"][:, :1]``
    at ``pos`` into an empty float32 cache of ``cache_len`` positions."""
    model = ShardedLM.of_rank(cfg, comm, seed=seed)
    comm.log = []
    if kind == "train":
        model.grads(batch)
    else:
        tokens = torch.as_tensor(np.asarray(batch["tokens"]))
        cache = model.empty_cache(tokens.shape[0], cache_len, dtype=torch.float32)
        tok = tokens[:, :1].to(model.device)
        at = torch.full((tokens.shape[0],), pos, dtype=torch.int64, device=model.device)
        with torch.no_grad():
            model._each(lambda c: model._forward_rank(c, tok, "decode", cache, at, None))
    log, comm.log = comm.log, None
    return log


def collectives(comm, inputs: Sequence) -> dict:
    """Every collective of ``comm`` on this rank's ``inputs[comm.rank]``
    (numpy arrays: ``x`` (4, 6, 5) float32, ``y`` (7,) int64, ``b`` (4, 6,
    5) bf16 as int16 bits, ``w`` (24, 3) float32), over every set of the
    mesh's axes in mesh order and over all axes in reverse order; then a
    gradient through an all-gather, an all-reduce and an all-to-all under
    a ``Tape``. Returns {"out": {name: result}, "grad": w's gradient,
    "log": ``comm.log``}."""
    dev = comm.device
    mine = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in inputs[comm.rank].items()}
    x, y, w = mine["x"], mine["y"], mine["w"]
    b = mine["b"].view(torch.bfloat16)
    names = comm.mesh.axis_names
    sets = [a for k in range(1, len(names) + 1) for a in itertools.combinations(names, k)]
    sets.append(tuple(reversed(names)))
    comm.log = []
    out = {}
    for axes in sets:
        key = "+".join(axes)
        n, me = len(comm.group(axes)), comm.group(axes).index(comm.rank)
        out[f"sum {key}"] = comm.all_reduce(x, axes)
        out[f"sum tuple {key}"] = comm.all_reduce((x.transpose(0, 2), y, x[0, 0, 0]), axes)
        out[f"max {key}"] = comm.all_max(x, axes)
        out[f"gather {key}"] = comm.all_gather(x, axes, 1)
        out[f"gather parts {key}"] = comm.all_gather(x, axes, 1, parts=2)
        out[f"gather tuple {key}"] = comm.all_gather((x, b), axes, (0, 2))
        out[f"scatter {key}"] = comm.reduce_scatter((w, x), axes, (0, 0), parts=2 if n < 4 else 1)
        spans = [(me + k) % 3 for k in range(n)]   # ragged: 0, 1 or 2 rows to each
        out[f"to_all {key}"] = comm.all_to_all([x[:s] for s in spans], axes, 0)
        out[f"exchange {key}"] = comm.exchange((x[:, 0], {"y": y, "b": b}), axes)
    wl = w.clone().requires_grad_()
    tape = sharding.Tape(comm)
    comm.tape = tape
    with tape:
        h = comm.all_gather(wl * wl, names[-1], 0)
        s = comm.all_reduce(h.sin(), names)
        n = len(comm.group(names[0]))
        t = comm.all_to_all(list(torch.tensor_split(s, n, dim=0)), names[0], 0)
        loss = (t * t).sum() + s.sum()
    tape.backward((loss,), (torch.ones((), dtype=loss.dtype, device=dev),))
    comm.tape = None
    return {"out": out, "grad": tape.grad(wl), "log": list(comm.log)}


def dp_sweep(comm, traffic: Sequence, *, mesh=None, axis: str = "model", max_batch: int = 16,
             rounds: int = 1, **engine) -> dict:
    """Every ``(problem, reconstruct, instance)`` of ``traffic`` through one
    ``ShardedDPEngine(comm=comm, **engine)`` along ``axis`` (over the
    processes arranged as ``mesh``; no feedback unless ``engine`` asks),
    submitted and stepped until empty ``rounds`` times: {"responses": the
    ``ranks.response_record`` of each of the last round's, in submission
    order, "stats", "lanes": each drain's responses, "table": the rank's
    calibration table}."""
    from repro_torch import dp
    from repro_torch.dp import autotune

    comm = ranks._on(comm, mesh)
    eng = dp.ShardedDPEngine(comm=comm, axis=axis, max_batch=max_batch,
                             **{"feedback": False, **engine})
    out, lanes = {}, []
    for _ in range(rounds):
        rids = [eng.submit(name, reconstruct=recon, **kw) for name, recon, kw in traffic]
        while eng.pending():
            drained = eng.step()
            lanes.append(len(drained))
            out.update((r.rid, r) for r in drained)
    return {"responses": [ranks.response_record(out[r]) for r in rids],
            "stats": dict(eng.stats), "lanes": lanes,
            "table": {k: (e.ms, e.count, e.source) for k, e in autotune.get_table().items()}}


def permutes(comm, inputs: Sequence, *, mesh=None, ragged: bool = True) -> dict:
    """``comm.permute`` of this rank's ``inputs[comm.rank]`` (as
    :func:`collectives` takes them) over every set of the mesh's axes in
    mesh order and over all axes in reverse order, by shifts 1, 2 and -1:
    a float32 tensor, a tuple with an int64 and a bf16 member and, with
    ``ragged``, rows that differ by rank. Returns {"out": {name: result},
    "log": ``comm.log``}."""
    comm = ranks._on(comm, mesh)
    dev = comm.device
    mine = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in inputs[comm.rank].items()}
    x, y, b = mine["x"], mine["y"], mine["b"].view(torch.bfloat16)
    names = comm.mesh.axis_names
    sets = [a for k in range(1, len(names) + 1) for a in itertools.combinations(names, k)]
    sets.append(tuple(reversed(names)))
    comm.log = []
    out = {}
    for axes in sets:
        for shift in (1, 2, -1):
            key = f"{'+'.join(axes)} by {shift}"
            out[f"x {key}"] = comm.permute(x, axes, shift)
            out[f"tuple {key}"] = comm.permute((y, b), axes, shift)
            if ragged:
                out[f"ragged {key}"] = comm.permute(x[:comm.rank % 3], axes, shift)
    log, comm.log = comm.log, None
    return {"out": out, "log": log}


def skipped_permute(comm, steps: int = 3, skipper: int = 2) -> list:
    """``steps`` permutes of a small tensor along the mesh's last axis, with
    rank ``skipper`` calling one fewer, as a pipeline stage that skipped an
    idle step would: its peers wait at the last one until the collective
    fails."""
    axis = comm.mesh.axis_names[-1]
    x = torch.full((4,), float(comm.rank), device=comm.device)
    got = []
    for step in range(steps - (comm.rank == skipper)):
        got.append(comm.permute(x + step, axis))
    return got


def tanh_stage(params, h):
    """The reference pipeline test's stage: ``tanh(h @ W + b)``."""
    return torch.tanh(h @ params[0] + params[1])


def pipeline_tanh(comm, Ws, bs, x, *, axis: str = "model") -> torch.Tensor:
    """``pipeline_apply_rank`` of :func:`tanh_stage` over the ranks along
    ``axis``: rank j's stage holds ``Ws[j]``, ``bs[j]``; ``x`` (M, mb, d)
    numpy microbatches."""
    j = comm.group(axis).index(comm.rank)
    dev = comm.device
    params = (torch.as_tensor(Ws[j]).to(dev), torch.as_tensor(bs[j]).to(dev))
    return pipeline_apply_rank(tanh_stage, params, torch.as_tensor(x).to(dev), comm, axis)


def negzero_stage(p, h):
    """``-|h| * 0 * p``: -0.0 in every element for a positive ``p``."""
    return -h.abs() * 0.0 * p


def pipeline_negzero(comm, ps, x, *, axis: str = "model") -> torch.Tensor:
    """``pipeline_apply_rank`` of :func:`negzero_stage` over the ranks along
    ``axis``: rank j's stage holds ``ps[j]`` (numpy, positive); ``x``
    (M, mb, d) numpy microbatches."""
    j = comm.group(axis).index(comm.rank)
    dev = comm.device
    return pipeline_apply_rank(negzero_stage, torch.as_tensor(ps[j]).to(dev),
                               torch.as_tensor(x).to(dev), comm, axis)
