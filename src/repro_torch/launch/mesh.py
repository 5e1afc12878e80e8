"""Meshes for tests and examples (port of ``repro/launch/mesh.py``).

``make_host_mesh`` builds a (data, model) mesh of slots over the visible
cards, or over given slots (``["cpu"] * 4``, or one card listed several
times). The reference's ``make_production_mesh`` (16 × 16 and 2 × 16 × 16
chips) serves only its dry run, which the port does not have yet
(ROADMAP queue 1); it comes with that port.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.sharding import Mesh


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
