"""Blocks and the layer stack (port of ``repro/models/transformer.py``).

The reference stacks its parameters ``(n_groups, …)`` and runs one
``lax.scan`` whose body unrolls a period of layers; the port keeps an
``nn.ModuleList`` of ``n_layers`` blocks and ``CausalLM`` loops over it (one
layer's weights live in one block; ``models/convert.py`` unstacks the
reference's tree). A block's mixer is attention, Mamba or RWKV6 and its MLP
dense SwiGLU, MoE or the RWKV channel mix, by the config's layer pattern.
Training (mode ``"train"``) is not ported yet (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import moe, ssm
from repro_torch.models.attention import (attn_decode, attn_defs, attn_forward,
                                          write_kv)
from repro_torch.models.layers import ParamDef, rmsnorm, swiglu

#: state entries an SSM mixer reads in decode and writes in prefill and decode
_STATE = {"mamba": ("h",), "rwkv6": ("h", "x_prev")}
_MIXER_DEFS = {"attn": attn_defs, "mamba": ssm.mamba_defs, "rwkv6": ssm.rwkv_defs}
_SSM_FORWARD = {"mamba": ssm.mamba_forward, "rwkv6": ssm.rwkv_forward}


def _mlp_defs(cfg, kind: str) -> dict:
    if kind == "moe":
        return moe.moe_defs(cfg)
    if kind == "rwkv_cm":
        return ssm.rwkv_cm_defs(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": ParamDef((d, f)), "w_up": ParamDef((d, f)),
            "w_down": ParamDef((f, d))}


def block_defs(cfg, i: int) -> dict:
    """ParamDefs of layer ``i``, named as the reference's block tree."""
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), "ones"),
        "mixer": _MIXER_DEFS[cfg.mixer_of(i)](cfg),
        "ln2": ParamDef((d,), "ones"),
        "mlp": _mlp_defs(cfg, cfg.mlp_of(i)),
    }


def _empty(d: ParamDef, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(d.shape, dtype=cfg.param_dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One layer: ``x + mixer(rmsnorm(x))``, then ``x + mlp(rmsnorm(x))``.
    Parameters are allocated uninitialised; ``CausalLM`` fills them.

    ``moe_stats``, None by default, may be set to a dict: an MoE block then
    counts its (token, k) assignments and capacity drops there by mode
    (``moe_stats[mode]``, see ``moe.moe_forward``)."""

    def __init__(self, cfg, i: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.mixer_kind, self.mlp_kind = cfg.mixer_of(i), cfg.mlp_of(i)
        self.moe_stats = None
        defs = block_defs(cfg, i)
        self.ln1 = _empty(defs["ln1"], cfg, device)
        self.ln2 = _empty(defs["ln2"], cfg, device)
        self.mixer = nn.ParameterDict({k: _empty(d, cfg, device)
                                       for k, d in defs["mixer"].items()})
        self.mlp = nn.ParameterDict({k: _empty(d, cfg, device)
                                     for k, d in defs["mlp"].items()})

    def forward(self, x, positions, mode: str, cache: dict, pos=None):
        """mode "prefill" fills ``cache`` (in place) over the whole prompt;
        "decode" runs T = 1 against it at ``pos``, advancing the SSM states
        of every row of the batch."""
        if mode not in ("prefill", "decode"):
            raise NotImplementedError(f"mode {mode!r} is not ported yet (the "
                                      "training slice, ROADMAP queue 1 item 6)")
        cfg = self.cfg
        decode = mode == "decode"
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        if self.mixer_kind == "attn":
            if decode:
                mix, _ = attn_decode(self.mixer, cfg, h, cache, pos)
            else:
                mix, (k, v) = attn_forward(self.mixer, cfg, h, positions)
                write_kv(cache, k, v, slice(None), slice(0, k.shape[1]))
        else:
            names = _STATE[self.mixer_kind]
            state = {n: cache[n] for n in names} if decode else None
            mix, new = _SSM_FORWARD[self.mixer_kind](self.mixer, cfg, h, state)
            for n in names:
                cache[n].copy_(new[n])
        x = x + mix
        h2 = rmsnorm(x, self.ln2, cfg.norm_eps)
        if self.mlp_kind == "moe":
            stats = None if self.moe_stats is None else self.moe_stats.setdefault(mode, {})
            out, _ = moe.moe_forward(self.mlp, cfg, h2, stats=stats)
        elif self.mlp_kind == "rwkv_cm":
            out, x_cm = ssm.rwkv_cm_forward(self.mlp, cfg, h2,
                                            cache["x_cm"] if decode else None)
            cache["x_cm"].copy_(x_cm)
        else:
            out = swiglu(h2, self.mlp["w_gate"], self.mlp["w_up"],
                         self.mlp["w_down"], cfg.compute_dtype)
        return x + out


def empty_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None) -> list:
    """One dict per layer. Attention: k, v (batch, max_len, Hkv, hd);
    ``dtype=torch.int8`` quantizes them with per-vector bf16 scales
    (k_scale, v_scale). Mamba: h (batch, H, K, V) float32; RWKV6: h and
    x_prev (batch, 1, d), the latter in the compute dtype; an RWKV channel
    mix adds x_cm (batch, 1, d), in the compute dtype too. The states
    ignore ``dtype``, as the reference's do."""
    hkv, hd = cfg.n_kv_heads, cfg.hd
    out = []
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        if kind == "attn":
            c = {"k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
                 "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device)}
            if dtype == torch.int8:
                for name in ("k_scale", "v_scale"):
                    c[name] = torch.zeros((batch, max_len, hkv, 1), dtype=torch.bfloat16,
                                          device=device)
        elif kind == "mamba":
            c = ssm.mamba_empty_state(cfg, batch, device=device)
        else:
            c = ssm.rwkv_empty_state(cfg, batch, device=device)
        if cfg.mlp_of(i) == "rwkv_cm":
            c["x_cm"] = torch.zeros((batch, 1, cfg.d_model), dtype=cfg.compute_dtype,
                                    device=device)
        out.append(c)
    return out
