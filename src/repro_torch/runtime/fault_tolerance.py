"""Fault tolerance (port of ``repro/runtime/fault_tolerance.py``):
supervised training with checkpoint/restart, failure injection and
straggler detection.

Failures are injected (an exception from ``failure_hook(step)``), so the
recovery path itself is what runs: restore from the latest checkpoint and
replay the deterministic data stream from there. A forced checkpoint at
the start makes every failure recoverable; ``max_restarts`` bounds the
retries. A step whose time exceeds ``straggler_factor`` times the median of
the last ``straggler_window`` steps counts as a straggler. Step times end
in ``torch.cuda.synchronize`` when the state lies on the card (the
reference's ``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.utils.tree import leaves


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 10
    max_restarts: int = 5
    straggler_factor: float = 3.0    # step time > factor × median → straggler
    straggler_window: int = 16


@dataclasses.dataclass
class FTStats:
    restarts: int = 0
    stragglers: int = 0
    checkpoints: int = 0
    steps_replayed: int = 0


@dataclasses.dataclass(frozen=True)
class TensorLike:
    """What a restore needs of a tensor: its shape, dtype and device."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v) for v in tree)
    return TensorLike(tuple(tree.shape), tree.dtype, tree.device)


def _sync(state) -> None:
    first = leaves(state)[0]
    if first.is_cuda:
        torch.cuda.synchronize(first.device)


class Supervisor:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with recovery.

    ``state`` is a tree of tensors (params and optimizer state).
    ``failure_hook(step)`` may raise :class:`InjectedFailure` to simulate a
    node loss; recovery restores the latest checkpoint and replays the
    (deterministic) data stream.
    """

    def __init__(self, step_fn: Callable, checkpointer: Checkpointer,
                 cfg: FTConfig = FTConfig(),
                 failure_hook: Optional[Callable] = None):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.cfg = cfg
        self.failure_hook = failure_hook or (lambda step: None)
        self.stats = FTStats()
        self._durations: list = []

    def _maybe_checkpoint(self, step: int, state, force: bool = False):
        if force or step % self.cfg.checkpoint_every == 0:
            self.ckpt.save(step, state)
            self.stats.checkpoints += 1

    def _recover(self, like):
        latest = self.ckpt.latest_step()
        if latest is None:
            raise RuntimeError("failure before first checkpoint; cannot recover")
        state = self.ckpt.restore(latest, like)
        self.stats.restarts += 1
        return latest, state

    def run(self, state, batches: Callable, start_step: int, num_steps: int):
        """batches(i) -> batch (deterministic!). Returns (state, metrics_list)."""
        like = _like(state)
        self._maybe_checkpoint(start_step, state, force=True)
        step = start_step
        metrics_log = []
        restarts_left = self.cfg.max_restarts
        while step < start_step + num_steps:
            try:
                self.failure_hook(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batches(step))
                _sync(state)
                dt = time.perf_counter() - t0
                self._watch_straggler(dt)
                metrics_log.append({"step": step, **{k: float(v) for k, v in metrics.items()},
                                    "dt": dt})
                step += 1
                self._maybe_checkpoint(step, state)
            except InjectedFailure:
                if restarts_left == 0:
                    raise
                restarts_left -= 1
                resume, state = self._recover(like)
                self.stats.steps_replayed += step - resume
                step = resume
        self.ckpt.wait()
        return state, metrics_log

    def _watch_straggler(self, dt: float):
        self._durations.append(dt)
        w = self._durations[-self.cfg.straggler_window:]
        if len(w) >= 4 and dt > self.cfg.straggler_factor * float(np.median(w)):
            self.stats.stragglers += 1
