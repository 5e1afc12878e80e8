"""Architecture registry (port of ``repro/configs/__init__.py``):
``get_config("<arch-id>")`` for every architecture of the reference.

Shape cells (identical across LM archs):
  train_4k     seq 4096   global_batch 256   (train_step)
  prefill_32k  seq 32768  global_batch 32    (serve: prefill)
  decode_32k   seq 32768  global_batch 128   (serve: one decode step w/ cache)
  long_500k    seq 524288 global_batch 1     (decode; sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig  # noqa: F401

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "arctic-480b": "arctic_480b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "internvl2-76b": "internvl2_76b",
    "musicgen-large": "musicgen_large",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "granite-20b": "granite_20b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen3-14b": "qwen3_14b",
    "stablelm-12b": "stablelm_12b",
}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def list_archs() -> list:
    return sorted(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cells(arch: str) -> list:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
