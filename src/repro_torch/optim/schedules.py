"""Learning-rate schedules (port of ``repro/optim/schedules.py``): functions
of the step that return a float32 scalar tensor on the step's device, in
the reference's float32 arithmetic."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return lr
