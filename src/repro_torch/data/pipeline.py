"""Data pipeline (port of ``repro/data/pipeline.py``): a deterministic
synthetic token stream, a background prefetcher, and the placement of a
host batch on a device.

Batch ``i`` depends only on ``(seed, i)`` (numpy's generator, the
reference's own draws), so a restart replays the stream exactly, which the
fault-tolerance supervisor relies on. ``shard_batch`` places a global batch
over a mesh of slots.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.runtime.sharding import Mesh, place


class SyntheticLM:
    """Zipf-ish token stream: batch i is a pure function of (seed, i)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 frontend_tokens: int = 0, d_model: int = 0):
        self.vocab, self.seq, self.gb = vocab, seq_len, global_batch
        self.seed = seed
        self.frontend_tokens, self.d_model = frontend_tokens, d_model

    def batch(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, i))
        raw = rng.zipf(1.3, size=(self.gb, self.seq + 1))
        tokens = (raw % self.vocab).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (self.gb, self.frontend_tokens, self.d_model)).astype(np.float32) * 0.1
        return out

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class Prefetcher:
    """Double-buffered background prefetch (overlaps host generation with
    the step)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: dict, device) -> dict:
    """A host batch as tensors on ``device``: integer arrays as int64 (the
    embedding's and the loss's indices), float arrays as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def shard_batch(batch: dict, mesh: Mesh, batch_axes) -> dict:
    """A host batch over ``mesh``: each array's batch dim split over
    ``batch_axes`` (an axis name or a tuple of them), scalars replicated.
    Returns, per key, the mesh-shaped array of each slot's shard."""
    out = {}
    for k, v in batch.items():
        spec = (batch_axes,) if np.ndim(v) >= 1 else ()
        out[k] = place(np.asarray(v), mesh, spec)
    return out
