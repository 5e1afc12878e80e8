"""Checkpointing (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
