"""Model/config system (port of ``repro/configs/base.py``): one frozen
dataclass drives model init, forward and the smoke tests.

Every architecture gets a module in this package defining ``CONFIG`` (the
published hyper-parameters) and relies on :meth:`ModelConfig.reduced` for
its CPU test variant. The dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    every: int = 1                 # MoE on layers where i % every == offset
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                      # "mamba" | "rwkv6"
    n_heads: int
    d_head: int                    # value width per head (V)
    d_state: int                   # key/state width per head (K)
    chunk: int = 64                # pipeline chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1            # hybrid: attention on i % attn_every == attn_offset
    attn_offset: int = 0
    frontend: str = "none"         # none | patch (vlm) | frame (audio) — STUBS
    n_frontend_tokens: int = 0
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    xent_chunk: int = 512          # token-chunked cross-entropy (memory bound)
    remat: bool = True             # checkpoint each layer group in training
    source: str = ""               # provenance note ([arXiv/hf; tier])

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid/linear-attn)."""
        return self.ssm is not None

    def mixer_of(self, i: int) -> str:
        if self.ssm is None:
            return "attn"
        if self.attn_every and i % self.attn_every == self.attn_offset:
            return "attn"
        return self.ssm.kind

    def mlp_of(self, i: int) -> str:
        if self.moe is not None and i % self.moe.every == self.moe.offset:
            return "moe"
        if self.ssm is not None and self.ssm.kind == "rwkv6":
            return "rwkv_cm"
        return "dense"

    @property
    def scan_period(self) -> int:
        """Layer-pattern period: the reference stacks its parameters as
        n_layers/period groups of `period` heterogeneous layers; the port's
        weight conversion unstacks them with it."""
        p = 1
        if self.ssm is not None and self.attn_every:
            p = math.lcm(p, self.attn_every)
        if self.moe is not None:
            p = math.lcm(p, self.moe.every)
        if self.n_layers % p:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible by period={p}")
        return p

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.scan_period

    # ------------------------------------------------------------------
    def reduced(self, n_layers: int = 2, d_model: int = 64, d_ff: int = 128,
                vocab: int = 256) -> "ModelConfig":
        """Small same-family variant for CPU tests (the reference's rule)."""
        period = self.scan_period
        nl = max(n_layers, period) if self.n_layers % period == 0 else n_layers
        nl = period * max(1, nl // period)
        hd = 16
        n_heads = max(2, d_model // hd // 2) * 2
        n_kv = max(1, min(self.n_kv_heads, n_heads // 2)) if self.n_kv_heads > 1 else 1
        while n_heads % n_kv:
            n_kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=min(8, self.moe.n_experts),
                                      top_k=min(2, self.moe.top_k), d_ff=d_ff)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, n_heads=4, d_head=hd,
                                      d_state=min(16, self.ssm.d_state), chunk=8)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=nl, d_model=d_model,
            n_heads=n_heads, n_kv_heads=n_kv, d_ff=d_ff, vocab_size=vocab,
            head_dim=hd, moe=moe, ssm=ssm, param_dtype=torch.float32,
            compute_dtype=torch.float32, xent_chunk=64,
            n_frontend_tokens=8 if self.frontend != "none" else 0)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the port's model, built on the meta
        device (no memory). Raises NotImplementedError for the block kinds
        the port does not have yet (MoE, SSM)."""
        from repro_torch.models.model import CausalLM

        m = CausalLM(self, device="meta")
        return sum(p.numel() for p in m.parameters())
