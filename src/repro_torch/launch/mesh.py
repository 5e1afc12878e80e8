"""Meshes for tests and examples (port of ``repro/launch/mesh.py``).

``make_host_mesh`` builds a (data, model) mesh of slots over the visible
cards, or over given slots (``["cpu"] * 4``, or one card listed several
times). ``make_production_mesh`` builds the reference's 16 × 16 and
2 × 16 × 16 meshes over ``meta`` slots (placements computed, nothing
allocated).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) data × model = 256 slots (a v5e pod).
    Multi-pod: (2, 16, 16) pod × data × model = 512 slots; the ``pod`` axis
    joins ``data`` for batch and FSDP sharding (compound axes in
    ``runtime/sharding.py``). Every slot on ``meta``: placements are
    computed, nothing is allocated."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(shape, dtype=object)
    grid[...] = torch.device("meta")
    return Mesh(grid, axes)


def batch_axes(multi_pod: bool = False) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)


def make_host_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first ``data * model`` of ``devices``
    (default: the visible cards)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(devices) < data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} devices, "
                         f"{len(devices)} given")
    grid = np.empty(data * model, dtype=object)
    grid[:] = list(devices)[: data * model]
    return Mesh(grid.reshape(data, model), ("data", "model"))
