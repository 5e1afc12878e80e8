"""Pipeline parallelism (port of ``repro/runtime/pipeline_parallel.py``):
the paper's skewed schedule as a runtime over a mesh of slots.

``SkewedSchedule`` (``core/schedule.py``) is shared with the S-DP and MCM
solvers: stage ``j`` serves microbatch ``t - j`` at step ``t``; the
pipeline fills for S-1 steps, streams one microbatch a step, and drains.
Each stage runs on its own slot — a card, or one of a card's concurrent
streams — and hands its activation to the next stage's slot with an event
wait and a ``.to()``; stage assignment is balanced by the DP planner
(``core.planner.partition_stages``).

Forward pipeline (inference / the serving path), as in the reference.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.schedule import SkewedSchedule
from repro_torch.runtime.sharding import Mesh, Slot, join


def _handoff(y: torch.Tensor, src: Slot, dst: Slot) -> torch.Tensor:
    """``y``, made on ``src``'s stream, as ``dst``'s input: ``dst``'s stream
    waits for an event recorded after ``y`` on ``src``'s, then ``y`` moves
    to ``dst``'s device on ``dst``'s stream (the allocator keeps ``y`` until
    that stream has read it)."""
    if src.stream is not None:
        done = torch.cuda.Event()
        done.record(src.stream)
        if dst.stream is not None:
            dst.stream.wait_event(done)
        else:
            done.synchronize()
    if dst.stream is not None and y.is_cuda:
        y.record_stream(dst.stream)
    with dst.scope():
        return y.to(dst.device)


def pipeline_apply(stage_fn: Callable, stage_params: Sequence, x_micro: torch.Tensor,
                   mesh: Mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_j, x)`` as an S-stage pipeline over microbatches.

    ``stage_params``: one entry a stage, on that stage's slot (the slots
    along ``axis``, in order). ``x_micro``: (M, ...) microbatches. Returns
    (M, ...) outputs on ``x_micro``'s device in microbatch order, equal to
    applying the S stages in sequence to every microbatch."""
    slots = list(mesh.line(axis).slots)
    s, m = len(slots), x_micro.shape[0]
    if len(stage_params) != s:
        raise ValueError(f"{len(stage_params)} stage params for {s} stages")
    sched = SkewedSchedule(num_items=m, num_stages=s)
    home = x_micro.device
    slots[0].follow(x_micro)
    inbox: list = [None] * s
    outs: list = [None] * m
    for t in range(sched.num_steps):
        ran = []
        for j, item in enumerate(sched.np_items_at(t)):
            if not 0 <= item < m:
                continue
            x = inbox[j]
            if j == 0:
                with slots[0].scope():
                    x = x_micro[item].to(slots[0].device)
            with slots[j].scope():
                ran.append((j, item, stage_fn(stage_params[j], x)))
        # every stage of step t launched before any hand-off: stage j + 1
        # takes at step t + 1 what stage j made at step t
        for j, item, y in ran:
            if j == s - 1:
                outs[item] = join(y, slots[j]).to(home)
            else:
                inbox[j + 1] = _handoff(y, slots[j], slots[j + 1])
    return torch.stack(outs)


def stage_boundaries(layer_costs, num_stages: int) -> tuple:
    """DP-balanced contiguous layer → stage assignment (planner
    integration): ``(boundaries, bottleneck)``."""
    from repro_torch.core.planner import partition_stages

    return partition_stages(layer_costs, num_stages)
