"""Pipeline parallelism (port of ``repro/runtime/pipeline_parallel.py``):
the paper's skewed schedule as a per-rank program over a mesh axis.

``SkewedSchedule`` (``core/schedule.py``) is shared with the S-DP and MCM
solvers: stage ``j`` serves microbatch ``t - j`` at step ``t``; the
pipeline fills for S-1 steps, streams one microbatch a step, and drains.
:func:`pipeline_apply_rank` is the reference's ``shard_map`` body: each
rank is one stage, and its activation moves to the next stage by
``comm.permute`` (the reference's ``lax.ppermute``), in a thread a slot
(:func:`pipeline_apply`, over ``runtime.sharding.run``) or in a process a
rank (``runtime.distributed.launch``); stage assignment is balanced by the
DP planner (``core.planner.partition_stages``).

Forward pipeline (inference / the serving path), as in the reference.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.schedule import SkewedSchedule
from repro_torch.runtime.sharding import Mesh, join, run


def pipeline_apply_rank(stage_fn: Callable, params_j, x_micro: torch.Tensor, comm,
                        axis: str = "stage") -> torch.Tensor:
    """This rank's stage of ``stage_fn(params_j, x)`` as an S-stage pipeline
    over microbatches, S the size of ``comm``'s group along ``axis`` and j
    this rank's place in it.

    ``x_micro``: (M, rows, ...) microbatches (every rank's copy; stage 0
    reads it); ``stage_fn`` keeps a microbatch's shape and dtype. Each of
    the schedule's steps runs the stage where it is active and then calls
    ``comm.permute`` on every rank, idle or not (a rank that skipped it
    would hold its peers at the collective until they time out); an idle
    stage, and the last one, whose output no stage reads, send a
    microbatch of no rows. Returns the (M, rows, ...) outputs on this
    rank's device, equal on every rank: the last stage's, summed over the
    stages as integers of their width (zeros elsewhere, so each element's
    bits are the last stage's; a float sum would turn -0.0 into +0.0)."""
    group = comm.group(axis)
    s, j, m = len(group), group.index(comm.rank), x_micro.shape[0]
    dev = comm.device
    empty = x_micro.new_empty((0,) + tuple(x_micro.shape[2:]), device=dev)   # no rows
    inbox, outs = None, None
    for t in range(SkewedSchedule(num_items=m, num_stages=s).num_steps):
        item = t - j
        y = empty
        if 0 <= item < m:
            x = x_micro[item].to(dev) if j == 0 else inbox
            y = stage_fn(params_j, x)
            if j == s - 1:
                if outs is None:
                    outs = torch.zeros((m,) + tuple(y.shape), dtype=y.dtype, device=dev)
                outs[item] = y
                y = empty
        inbox = comm.permute(y, axis)
    if outs is None:
        outs = torch.zeros(tuple(x_micro.shape), dtype=x_micro.dtype, device=dev)
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[outs.element_size()]
    return comm.all_reduce(outs.view(width), axis).view(outs.dtype)


def pipeline_apply(stage_fn: Callable, stage_params: Sequence, x_micro: torch.Tensor,
                   mesh: Mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_j, x)`` as an S-stage pipeline over microbatches,
    one thread a slot of ``mesh`` along ``axis`` (:func:`pipeline_apply_rank`
    in each).

    ``stage_params``: one entry a stage, on that stage's slot (the slots
    along ``axis``, in order). ``x_micro``: (M, ...) microbatches. Returns
    (M, ...) outputs on ``x_micro``'s device in microbatch order, equal to
    applying the S stages in sequence to every microbatch."""
    line = mesh.line(axis)
    if len(stage_params) != line.size:
        raise ValueError(f"{len(stage_params)} stage params for {line.size} stages")
    for slot in line.slots:
        slot.follow(x_micro)
    outs = run(line, lambda comm: pipeline_apply_rank(stage_fn, stage_params[comm.rank],
                                                      x_micro, comm, axis))
    return join(outs[0], line.slots[0]).to(x_micro.device)


def stage_boundaries(layer_costs, num_stages: int) -> tuple:
    """DP-balanced contiguous layer → stage assignment (planner
    integration): ``(boundaries, bottleneck)``."""
    from repro_torch.core.planner import partition_stages

    return partition_stages(layer_costs, num_stages)
