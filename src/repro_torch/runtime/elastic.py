"""Elastic scaling (port of ``repro/runtime/elastic.py``): rebuild the mesh
after device loss and reshard state.

When a slice of devices drops, the job restarts on the surviving N'.
``best_mesh`` picks the largest (data, model) grid, keeping the model axis
where it can (the tensor-parallel degree is baked into the per-layer
weights' divisibility, so it is kept unless N' forces otherwise), and
``reshard`` places the old state onto the new mesh with
``runtime.sharding.place``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.runtime.sharding import Mesh, place


def best_mesh(devices: Sequence, model_axis: int,
              axis_names: tuple = ("data", "model")) -> Mesh:
    """Largest usable (data, model) mesh from the surviving devices."""
    n = len(devices)
    tp = model_axis
    while tp > 1 and n % tp:
        tp //= 2
    dp = n // tp
    grid = np.empty(dp * tp, dtype=object)
    grid[:] = list(devices)[: dp * tp]
    return Mesh(grid.reshape(dp, tp), axis_names)


def reshard(tree: dict, mesh: Mesh, spec_fn: Callable) -> dict:
    """Place every leaf of ``tree`` (a dict of tensors or arrays, nested
    dicts allowed) onto ``mesh``; ``spec_fn(path, leaf)`` gives its spec,
    ``path`` the tuple of keys down to it. Returns the same tree of
    mesh-shaped shard arrays."""
    def go(path, x):
        if isinstance(x, dict):
            return {k: go(path + (k,), v) for k, v in x.items()}
        return place(x, mesh, spec_fn(path, x))

    return go((), tree)


def simulate_device_loss(devices: Sequence, lost: int) -> list:
    """Drop ``lost`` devices (the tail — stand-in for a failed slice)."""
    return list(devices)[: len(devices) - lost]
