"""Optimizer substrate (port of ``repro/optim``): AdamW, schedules and
gradient compression."""
from repro_torch.optim import adamw, grad_compress, schedules  # noqa: F401
