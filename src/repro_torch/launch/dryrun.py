"""The dry run (port of ``repro/launch/dryrun.py``): every (arch × shape ×
mesh) cell on the production meshes, one rank traced on ``meta``, with its
memory, FLOPs, HBM traffic and collective bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod --all

The reference lowers and compiles one SPMD program over 256 or 512 host
devices and reads XLA's memory analysis and HLO. The port's program is the
per-rank program of ``models/model.py::ShardedLM``, so :func:`run_cell`
traces rank 0 alone: its shards of the parameters, optimizer state, batch
and cache on ``meta`` (nothing allocated), a
:class:`~repro_torch.runtime.sharding.RecordingComm` that records each
collective's kind and bytes instead of sending, and ``launch/op_analysis``
over the ops it runs. No card is needed.

Memory per device is the step's argument bytes (parameters, moments, the
batch or cache shard) plus the peak of the bytes its ops hold live (the
reference: argument + temp + output − alias). The budget is an H100's:
``torch.cuda.get_device_properties(0).total_memory`` of the card the smoke
ran on, less 1 GiB (:data:`HBM_BUDGET`). Train cells escalate the
gradient-accumulation microbatches until the step fits; decode cells
escalate the KV cache from bf16 to int8.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import SHAPES, ShapeCell, cells, get_config, list_archs
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import model
from repro_torch.optim import adamw, schedules
from repro_torch.runtime import sharding as shd

DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
               torch.int64: 8, torch.int8: 1, torch.uint8: 1, torch.bool: 1}


# ---------------------------------------------------------------------------
# Abstract inputs: rank 0's shards on meta
# ---------------------------------------------------------------------------
def _rank0(mesh) -> tuple:
    return (0,) * len(mesh.axis_names)


def abstract_params(cfg, mesh, rules) -> dict:
    """Rank 0's shard of every parameter, on ``meta``."""
    named = dict(model.CausalLM(cfg, device="meta").named_parameters())
    return model.place_params(named, cfg, mesh, rules, _rank0(mesh))


def abstract_cache(cfg, batch: int, seq: int, mesh, rules, cache_dtype=torch.bfloat16) -> list:
    """Rank 0's shard of an empty cache of ``batch`` × ``seq``, on ``meta``."""
    return model.place_cache(cfg, batch, seq, cache_dtype, mesh, rules, _rank0(mesh))


def _batch_spec(b: int, mesh, multi_pod: bool):
    """The reference's batch placement: every batch axis where the batch
    divides them all, else the last one where it divides that, else none."""
    ba = batch_axes(multi_pod)
    if b % int(np.prod([mesh.shape[a] for a in ba])) == 0:
        return ba if len(ba) > 1 else ba[0]
    return ba[-1] if b % mesh.shape[ba[-1]] == 0 else None


def _arr(shape, dtype, spec, mesh) -> torch.Tensor:
    """Rank 0's shard of a ``shape`` tensor placed by ``spec``, on meta."""
    whole = torch.empty(shape, dtype=dtype, device="meta")
    return shd.piece(whole, spec, dict(zip(mesh.axis_names, _rank0(mesh))), mesh.shape)


def _cell(cell_name) -> ShapeCell:
    return SHAPES[cell_name] if isinstance(cell_name, str) else cell_name


def input_specs(cfg, cell_name, mesh, rules, multi_pod: bool,
                cache_dtype=torch.bfloat16) -> dict:
    """Rank 0's shard of every model input of this cell (a name of
    ``SHAPES`` or a ``ShapeCell``), on ``meta``, as the reference's
    ``input_specs`` places them."""
    cell = _cell(cell_name)
    b, t = cell.global_batch, cell.seq_len
    bspec = _batch_spec(b, mesh, multi_pod)
    if cell.kind == "train":
        batch = {"tokens": _arr((b, t), torch.int32, (bspec, None), mesh),
                 "labels": _arr((b, t), torch.int32, (bspec, None), mesh)}
        if cfg.frontend != "none":
            batch["frontend"] = _arr((b, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16,
                                     (bspec, None, None), mesh)
        return {"batch": batch}
    if cell.kind == "prefill":
        out = {"tokens": _arr((b, t), torch.int32, (bspec, None), mesh)}
        if cfg.frontend != "none":
            out["frontend"] = _arr((b, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16,
                                   (bspec, None, None), mesh)
        return out
    return {"token": _arr((b, 1), torch.int32, (bspec, None), mesh),
            "cache": abstract_cache(cfg, b, t, mesh, rules, cache_dtype),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def arg_bytes(tree) -> int:
    """The bytes of a tree of tensors."""
    return sum(t.numel() * DTYPE_BYTES[t.dtype] for t in shd.tensors(tree))


# ---------------------------------------------------------------------------
# Step functions: one rank's, under activate(mesh, rules) and acting_as(comm)
# ---------------------------------------------------------------------------
def _rank_model(cfg, params: dict) -> tuple:
    """(the sharded model over rank ``comm``'s shards ``params``, comm)."""
    mesh, rules = shd.current_state()
    comm = shd.current_comm()
    return model.ShardedLM.of_shards(cfg, mesh, rules, {comm.index: params}), comm


def _cache_layout(sharded, comm, batch: int, seq: int, dtype) -> tuple:
    """(the rank's cache shard as ``{name: (shape, dtype)}`` per layer, the
    per-layer specs), worked out outside any trace: the whole cache it is
    cut from exists only to be cut, on no device."""
    with torch.utils._python_dispatch._disable_current_modes():
        whole, specs = model.cache_specs(sharded.cfg, batch, seq, dtype, sharded.mesh,
                                         sharded.rules)
        shapes = [{name: (tuple(shd.piece(buf, spec[name], comm.coord, sharded.mesh.shape).shape),
                          buf.dtype) for name, buf in layer.items()}
                  for layer, spec in zip(whole, specs)]
    return shapes, specs


def make_train_step(cfg, microbatches: int = 1, moment_dtype=torch.float32,
                    accum_dtype=torch.float32):
    """Gradient-accumulating train step, one rank's: ``train_step(params,
    opt_state, batch)`` on the rank's shards (activation memory scales
    1/microbatches; the dry run escalates them until the cell fits). The
    rank's batch rows split into ``microbatches`` equal parts, its share of
    each microbatch."""
    opt_cfg = adamw.AdamWConfig(lr=schedules.warmup_cosine(3e-4, 100, 10_000),
                                moment_dtype=moment_dtype)

    def train_step(params, opt_state, batch):
        sharded, comm = _rank_model(cfg, params)
        rows = batch["tokens"].shape[0]
        if rows % microbatches:
            raise ValueError(f"{rows} rows of the batch on a rank do not split into "
                             f"{microbatches} microbatches")
        m = rows // microbatches
        batches = [{k: v[j * m:(j + 1) * m] for k, v in batch.items()}
                   for j in range(microbatches)]
        fsdp = sharded.rules["act_batch"][0]
        ways = int(np.prod([sharded.mesh.shape[a] for a in shd.axes_of(fsdp)]))
        split = sharded._batch_spec(m * ways) == fsdp
        metrics = sharded.rank_train_step(comm, opt_cfg, opt_state, batches,
                                          m * ways if split else m, accum_dtype)
        return params, opt_state, metrics

    return train_step


def make_step(cfg, cell_name, microbatches: int = 1, moment_dtype=torch.float32,
              accum_dtype=torch.float32):
    """One rank's step of the cell: the train step, or ``prefill_step(params,
    tokens, frontend=None)``, or ``serve_step(params, cache, token, pos)``.
    The serving steps take the whole batch's tokens on ``meta`` (the
    per-rank program keeps its share of them by a view) and the rank's
    cache shard."""
    cell = _cell(cell_name)
    if cell.kind == "train":
        return make_train_step(cfg, microbatches, moment_dtype, accum_dtype)
    if cell.kind == "prefill":
        def prefill_step(params, tokens, frontend=None):
            sharded, comm = _rank_model(cfg, params)
            shapes, specs = _cache_layout(sharded, comm, tokens.shape[0], cell.seq_len,
                                          torch.bfloat16)
            cache = np.empty(sharded.mesh.slots.shape, dtype=object)
            cache[comm.index] = [{name: torch.zeros(shape, dtype=dtype, device=comm.device)
                                  for name, (shape, dtype) in layer.items()} for layer in shapes]
            cache = model.ShardedCache(cache, specs)
            with torch.no_grad():
                return sharded._forward_rank(comm, tokens, "prefill", cache, None, frontend)

        return prefill_step

    def serve_step(params, cache, token, pos):
        sharded, comm = _rank_model(cfg, params)
        shards = np.empty(sharded.mesh.slots.shape, dtype=object)
        shards[comm.index] = cache
        _, specs = _cache_layout(sharded, comm, token.shape[0], cell.seq_len,
                                 next(iter(cache[0].values())).dtype)
        pos = pos.to(torch.int64).expand(token.shape[0]).contiguous()
        with torch.no_grad():
            return sharded._forward_rank(comm, token, "decode", model.ShardedCache(shards, specs),
                                         pos, None)

    return serve_step


# ---------------------------------------------------------------------------
#: torch.cuda.get_device_properties(0).total_memory of the smoke's card
#: (NVIDIA H100 80GB HBM3, 700.00 W), less 1 GiB of headroom
H100_TOTAL_MEMORY = 85_017_493_504
HBM_BUDGET = H100_TOTAL_MEMORY - 2 ** 30
#: bf16 optimizer moments for the ≥100B archs (the reference's rule)
BF16_MOMENT_THRESHOLD = 1e11
#: the reference's crude activation bound (10 GiB of its 15 GiB budget)
#: scaled to the H100's budget: microbatch counts whose activations it
#: puts past this are not traced
ACT_GIB_LIMIT = 10.0 / 15.0 * HBM_BUDGET / 2 ** 30


def _global_inputs(cfg, cell: ShapeCell) -> tuple:
    """The serving steps' whole-batch token (and frontend) inputs on
    meta."""
    t = 1 if cell.kind == "decode" else cell.seq_len
    tokens = torch.empty((cell.global_batch, t), dtype=torch.int32, device="meta")
    frontend = None
    if cell.kind == "prefill" and cfg.frontend != "none":
        frontend = torch.empty((cell.global_batch, cfg.n_frontend_tokens, cfg.d_model),
                               dtype=torch.bfloat16, device="meta")
    return tokens, frontend


def run_cell(arch: str, cell_name: str, multi_pod: bool, microbatches: int = 0,
             extra_tag: str = "", cfg_overrides: dict = None, rule_overrides: dict = None,
             mesh=None, shape: ShapeCell = None) -> dict:
    """microbatches=0 → escalate 1, 2, 4, … until the cell fits the budget.

    cfg_overrides: ``dataclasses.replace`` kwargs on the config (xent_chunk,
    remat, ssm=..., moe=...). rule_overrides: sharding-rule entries merged
    over ``make_rules()``. The reference's ``donate`` has no counterpart:
    the port's step updates the parameters, moments and cache in place,
    which is what donation buys. ``mesh`` (a
    mesh of ``meta`` slots) and ``shape`` replace the production mesh and
    the cell's shape (the smoke traces its own step this way)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = shape or SHAPES[cell_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    multi_pod = "pod" in mesh.axis_names
    rules = shd.make_rules(multi_pod=multi_pod)
    if rule_overrides:
        rules.update(rule_overrides)
    rec = {"arch": arch, "cell": cell_name, "mesh": "x".join(map(str, mesh.shape.values())),
           "devices": mesh.size, "tag": extra_tag, "kind": cell.kind,
           "global_batch": cell.global_batch, "seq_len": cell.seq_len}
    kind = cell.kind
    big = cfg.param_count() > BF16_MOMENT_THRESHOLD
    moment_dtype = torch.bfloat16 if big else torch.float32
    accum_dtype = torch.bfloat16 if big else torch.float32
    rec["moment_dtype"] = str(moment_dtype).split(".")[-1]

    data_ways = int(np.prod([s for a, s in mesh.shape.items() if a != "model"]))
    gb = cell.global_batch
    cands = [m for m in (1, 2, 4, 8, 16, 32, 64) if gb % m == 0 and (gb // m) % data_ways == 0]
    if kind == "train" and not microbatches and cands:
        seq = cell.seq_len

        def act_gib(m):
            per_dev_tokens = gb // m // data_ways * seq
            return cfg.n_layers * per_dev_tokens * cfg.d_model * 2 * 4 / 2 ** 30

        cands = [m for m in cands if act_gib(m) <= ACT_GIB_LIMIT] or [cands[-1]]
    mb_candidates = [microbatches] if microbatches else (cands or [1])
    if kind != "train":
        mb_candidates = [1]
    variants = [(mb, torch.bfloat16) for mb in mb_candidates]
    if kind == "decode":
        variants = [(1, torch.bfloat16), (1, torch.int8)]

    for mb, cache_dtype in variants:
        t0 = time.time()
        comm = shd.RecordingComm(mesh, _rank0(mesh))
        with shd.activate(mesh, rules), shd.acting_as(comm):
            params = abstract_params(cfg, mesh, rules)
            specs = input_specs(cfg, cell, mesh, rules, multi_pod, cache_dtype=cache_dtype)
            step = make_step(cfg, cell, microbatches=mb, moment_dtype=moment_dtype,
                             accum_dtype=accum_dtype)
            if kind == "train":
                opt_state = adamw.abstract_state(params, moment_dtype)
                args = (params, opt_state, specs["batch"])
            elif kind == "prefill":
                tokens, frontend = _global_inputs(cfg, cell)
                args = (params, tokens, frontend)
            else:
                token, _ = _global_inputs(cfg, cell)
                args = (params, specs["cache"], token, specs["pos"])
            _, ops, flops = op_analysis.trace(step, *args)
            # the rank's shards (the serving steps read the whole batch's
            # tokens, of which the rank keeps its share)
            arguments = arg_bytes((params, opt_state) if kind == "train" else params) \
                + arg_bytes(specs)
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["compile_s"] = 0.0
        rec["microbatches"] = mb
        rec["cache_dtype"] = str(cache_dtype).split(".")[-1] if kind == "decode" else ""
        rec["argument_size_in_bytes"] = int(arguments)
        rec["temp_size_in_bytes"] = int(ops.peak)
        rec["hbm_per_device"] = int(arguments + ops.peak)
        if rec["hbm_per_device"] <= HBM_BUDGET or (mb, cache_dtype) == variants[-1]:
            break
        print(f"  ... mb={mb}/{str(cache_dtype).split('.')[-1]}: "
              f"{rec['hbm_per_device'] / 2 ** 30:.1f} GiB > budget, escalating", flush=True)
    rec["fits_hbm"] = rec["hbm_per_device"] <= HBM_BUDGET
    found = op_analysis.analyze(ops, flops, comm.log)
    rec["flops"] = found["flops"]
    rec["hbm_traffic_bytes"] = found["hbm_traffic_bytes"]
    rec["collectives"] = found["collective_bytes"]
    rec["collective_bytes_total"] = found["collective_bytes_total"]
    rec["collective_counts"] = found["collective_counts"]
    rec["unknown_trip_counts"] = found["unknown_trip_counts"]
    rec["n_ops"] = found["n_ops"]
    rec["param_count"] = cfg.param_count()
    rec["active_param_count"] = cfg.active_param_count()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done.add((r["arch"], r["cell"], r["mesh"]))

    n_ok, failures = 0, []
    for arch in archs:
        for cell_name in (cells(arch) if args.cell is None else [args.cell]):
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch}/{cell_name}/{mesh_name}"
                if (arch, cell_name, mesh_name) in done:
                    print(f"[skip] {tag} (already recorded)", flush=True)
                    continue
                try:
                    rec = run_cell(arch, cell_name, mp)
                except Exception as e:  # noqa: BLE001 - every cell is tried; failures listed
                    failures.append({"tag": tag, "error": repr(e)})
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
                    continue
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                n_ok += 1
                print(f"[ok] {tag}: flops={rec['flops']:.3e} hbm/device="
                      f"{rec['hbm_per_device'] / 2 ** 30:.2f} GiB mb={rec['microbatches']} "
                      f"traced in {rec['lower_s']}s", flush=True)
    print(f"\n{n_ok} ok, {len(failures)} failed")
    for f_ in failures:
        print("  FAIL:", f_["tag"], f_["error"])
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
