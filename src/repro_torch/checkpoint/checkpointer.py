"""Checkpointing (port of ``repro/checkpoint/checkpointer.py``): one ``.npy``
a tensor and a JSON manifest, asynchronous writes, restore onto a target's
shapes, dtypes and devices.

Layout:  <dir>/step_<N>/manifest.json
         <dir>/step_<N>/<leaf-id>.npy          (bf16 stored as uint16 views)

The reference writes its manifest with msgpack, which the machine with the
card lacks, so the port's is JSON (ROADMAP queue 3). A save snapshots every
tensor to the host before it returns, so training may update them in place
right after; the files are written on a thread pool into a temporary
directory that is renamed into place, and the oldest steps past ``keep``
are removed.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

_BF16 = "bfloat16"
_MANIFEST = "manifest.json"


def _with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _with_paths(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves replaced, in order, from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _leaf_id(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)[:180]


def _to_numpy(t: torch.Tensor) -> tuple:
    t = t.detach().to("cpu", copy=True)   # a copy even on the CPU: training goes on
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=4)
        self._pending: Optional[cf.Future] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot ``tree`` to the host now, write it asynchronously
        (unless ``blocking``); returns a Future (or the step's directory)."""
        host = [(_leaf_id(p), *_to_numpy(x)) for p, x in _with_paths(tree)]

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = []
            for lid, arr, dtype in host:
                np.save(os.path.join(tmp, lid + ".npy"), arr, allow_pickle=False)
                manifest.append({"id": lid, "dtype": dtype, "shape": list(arr.shape)})
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            return final

        self.wait()
        self._pending = self._pool.submit(write)
        if blocking:
            return self._pending.result()
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest complete step, after this checkpointer's write in
        flight (if any) has finished: a step it saved counts, so recovery
        does not race the async write."""
        self.wait()
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like):
        """Step ``step`` as new tensors in ``like``'s structure, each with
        its counterpart's shape, dtype and device (``like``'s leaves are
        tensors or anything with ``shape``, ``dtype`` and ``device``)."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        by_id = {m["id"]: m for m in manifest["leaves"]}
        out = []
        for path, proto in _with_paths(like):
            lid = _leaf_id(path)
            if lid not in by_id:
                raise KeyError(f"checkpoint step {step} missing leaf {lid}")
            raw = np.load(os.path.join(d, lid + ".npy"), allow_pickle=False)
            t = _from_numpy(raw, by_id[lid]["dtype"])
            if tuple(t.shape) != tuple(proto.shape):
                raise ValueError(f"checkpoint step {step}, {lid}: shape {tuple(t.shape)} "
                                 f"!= {tuple(proto.shape)}")
            out.append(t.to(device=proto.device, dtype=proto.dtype))
        return _rebuild(like, iter(out))
