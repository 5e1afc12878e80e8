"""Blocks and the layer stack (port of ``repro/models/transformer.py``).

The reference stacks its parameters ``(n_groups, …)`` and runs one
``lax.scan`` whose body unrolls a period of layers; the port keeps an
``nn.ModuleList`` of ``n_layers`` blocks and ``CausalLM`` loops over it (one
layer's weights live in one block; ``models/convert.py`` unstacks the
reference's tree). Only dense blocks (attention + SwiGLU) are ported: the
``moe``, ``mamba``, ``rwkv6`` and ``rwkv_cm`` kinds raise
``NotImplementedError`` (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import (attn_decode, attn_defs, attn_forward,
                                          write_kv)
from repro_torch.models.layers import ParamDef, rmsnorm, swiglu

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 15: MoE and SSM blocks)"


def block_defs(cfg, i: int) -> dict:
    """ParamDefs of layer ``i``, named as the reference's block tree."""
    if cfg.mixer_of(i) != "attn":
        raise NotImplementedError(f"{cfg.name}: mixer {cfg.mixer_of(i)!r} {_NOT_PORTED}")
    if cfg.mlp_of(i) != "dense":
        raise NotImplementedError(f"{cfg.name}: mlp {cfg.mlp_of(i)!r} {_NOT_PORTED}")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln1": ParamDef((d,), "ones"),
        "mixer": attn_defs(cfg),
        "ln2": ParamDef((d,), "ones"),
        "mlp": {"w_gate": ParamDef((d, f)), "w_up": ParamDef((d, f)),
                "w_down": ParamDef((f, d))},
    }


def _empty(d: ParamDef, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(d.shape, dtype=cfg.param_dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One dense layer: ``x + attn(rmsnorm(x))``, then ``x + swiglu(rmsnorm(x))``.
    Parameters are allocated uninitialised; ``CausalLM`` fills them."""

    def __init__(self, cfg, i: int, device=None):
        super().__init__()
        self.cfg = cfg
        defs = block_defs(cfg, i)
        self.ln1 = _empty(defs["ln1"], cfg, device)
        self.ln2 = _empty(defs["ln2"], cfg, device)
        self.mixer = nn.ParameterDict({k: _empty(d, cfg, device)
                                       for k, d in defs["mixer"].items()})
        self.mlp = nn.ParameterDict({k: _empty(d, cfg, device)
                                     for k, d in defs["mlp"].items()})

    def forward(self, x, positions, mode: str, cache: dict, pos=None):
        """mode "prefill" fills ``cache`` (in place) over the whole prompt;
        "decode" runs T = 1 against it at ``pos``."""
        cfg = self.cfg
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        if mode == "decode":
            mix, _ = attn_decode(self.mixer, cfg, h, cache, pos)
        elif mode == "prefill":
            mix, (k, v) = attn_forward(self.mixer, cfg, h, positions)
            write_kv(cache, k, v, slice(None), slice(0, k.shape[1]))
        else:
            raise NotImplementedError(f"mode {mode!r} is not ported yet (the "
                                      "training slice, ROADMAP queue 1 item 15)")
        x = x + mix
        h2 = rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + swiglu(h2, self.mlp["w_gate"], self.mlp["w_up"],
                          self.mlp["w_down"], cfg.compute_dtype)


def empty_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None) -> list:
    """One dict per layer: k, v (batch, max_len, Hkv, hd); ``dtype=torch.int8``
    quantizes the cache with per-vector bf16 scales (k_scale, v_scale)."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    out = []
    for i in range(cfg.n_layers):
        if cfg.mixer_of(i) != "attn":
            raise NotImplementedError(f"{cfg.name}: mixer {cfg.mixer_of(i)!r} {_NOT_PORTED}")
        c = {"k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
             "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device)}
        if dtype == torch.int8:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros((batch, max_len, hkv, 1), dtype=torch.bfloat16,
                                      device=device)
        out.append(c)
    return out
