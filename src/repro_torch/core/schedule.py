"""Skewed pipeline schedule — the paper's core scheduling abstraction.

The paper's pipeline (Fig. 2 / Fig. 8) assigns, at outer step ``i``, stage
(thread) ``j`` to item ``i - j`` (0-based). The same skew shows up in the
S-DP pipeline solver (stages = offset terms) and the MCM pipeline solver
(stages = split candidates); this module keeps the index arithmetic in one
place so both use the same schedule.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SkewedSchedule:
    """num_steps = num_items + num_stages - 1; stage j serves item t - j."""

    num_items: int
    num_stages: int

    @property
    def num_steps(self) -> int:
        return self.num_items + self.num_stages - 1

    def items_at(self, step, device=None) -> torch.Tensor:
        """Item index handled by each stage at ``step`` (int64 tensor of
        ``num_stages``)."""
        return step - torch.arange(self.num_stages, device=device)

    def active_at(self, step, device=None) -> torch.Tensor:
        items = self.items_at(step, device)
        return (items >= 0) & (items < self.num_items)

    # -- numpy variants for host-side planning / tests ----------------------
    def np_items_at(self, step: int) -> np.ndarray:
        return step - np.arange(self.num_stages)

    def np_active_at(self, step: int) -> np.ndarray:
        items = self.np_items_at(step)
        return (items >= 0) & (items < self.num_items)

    def occupancy(self) -> np.ndarray:
        """Active-stage count per step (the fill/drain trapezoid of Fig. 3)."""
        return np.array([self.np_active_at(t).sum() for t in range(self.num_steps)])

    def utilization(self) -> float:
        """Fraction of stage-steps doing useful work (1 as items >> stages)."""
        total = self.num_steps * self.num_stages
        return float(self.num_items * self.num_stages) / total
