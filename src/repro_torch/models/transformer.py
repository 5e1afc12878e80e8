"""Blocks and the layer stack (port of ``repro/models/transformer.py``).

The reference stacks its parameters ``(n_groups, …)`` and runs one
``lax.scan`` whose body unrolls a period of layers; the port keeps an
``nn.ModuleList`` of ``n_layers`` blocks and ``CausalLM`` loops over it (one
layer's weights live in one block; ``models/convert.py`` unstacks the
reference's tree). A block's mixer is attention, Mamba or RWKV6 and its MLP
dense SwiGLU, MoE or the RWKV channel mix, by the config's layer pattern.
Mode ``"train"`` runs a block with no cache (``CausalLM.forward`` groups
the blocks by ``cfg.scan_period`` and checkpoints each group, as the
reference remats its scan body).

:func:`block_forward` is one layer's code for both: a ``Block`` runs it
on its own parameters with the one-slot communicator, and under a mesh
each slot runs it on its shard (``models/model.py::ShardedLM``) with the
slot's communicator: the mixers and MLPs of ``attention``, ``moe`` and
``ssm`` over the mesh, the SwiGLU with ``ffn`` on ``model``, and the
caches placed by :func:`cache_axes`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import moe, ssm
from repro_torch.models.attention import attn_decode, attn_defs, attn_forward, write_prefill
from repro_torch.models.layers import ParamDef, rmsnorm, swiglu
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import LOCAL, hint

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
    return {"w_gate": ParamDef((d, f), ("embed", "ffn")),
            "w_up": ParamDef((d, f), ("embed", "ffn")),
            "w_down": ParamDef((f, d), ("ffn", "embed"))}


def block_defs(cfg, i: int) -> dict:
    """ParamDefs of layer ``i``, named as the reference's block tree."""
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), (None,), "ones"),
        "mixer": _MIXER_DEFS[cfg.mixer_of(i)](cfg),
        "ln2": ParamDef((d,), (None,), "ones"),
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
        self.cfg, self.i = cfg, i
        self.moe_stats = None
        defs = block_defs(cfg, i)
        self.ln1 = _empty(defs["ln1"], cfg, device)
        self.ln2 = _empty(defs["ln2"], cfg, device)
        self.mixer = nn.ParameterDict({k: _empty(d, cfg, device)
                                       for k, d in defs["mixer"].items()})
        self.mlp = nn.ParameterDict({k: _empty(d, cfg, device)
                                     for k, d in defs["mlp"].items()})

    def forward(self, x, positions, mode: str, cache: dict = None, pos=None):
        """:func:`block_forward` on this block's parameters."""
        stats = None
        if self.moe_stats is not None and self.cfg.mlp_of(self.i) == "moe":
            stats = self.moe_stats.setdefault(mode, {})
        p = {"ln1": self.ln1, "mixer": self.mixer, "ln2": self.ln2, "mlp": self.mlp}
        return block_forward(p, self.cfg, self.i, x, positions, mode, cache, pos, stats=stats)


def block_forward(p: dict, cfg, i: int, x, positions, mode: str, cache: dict = None,
                  pos=None, *, stats=None, comm=LOCAL, specs=None, cache_specs=None,
                  batch_spec=None):
    """Layer ``i`` on its weights ``p`` (nested as :func:`block_defs`).
    mode "train" runs the block with no cache; "prefill" fills ``cache``
    (in place) over the whole prompt; "decode" runs T = 1 against it at
    ``pos``, advancing the SSM states of every row of the batch. ``stats``
    goes to an MoE block (see ``moe.moe_forward``). Returns (x, aux): aux
    the MoE block's load-balance loss, 0.0 for the other MLPs.

    Over a mesh ``comm`` is the slot's communicator, ``p`` its weights with
    their FSDP dims gathered and ``specs`` their specs; ``x`` is the slot's
    share of the batch along ``batch_spec``, and ``cache`` its shard of
    the layer's cache (placed by ``cache_specs``). The output is
    replicated over ``model``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    decode, train = mode == "decode", mode == "train"
    kind, mlp_kind = cfg.mixer_of(i), cfg.mlp_of(i)
    sm, sl = (specs["mixer"], specs["mlp"]) if specs else (None, None)
    kv_spec = cache_specs["k"] if cache_specs and kind == "attn" else None
    x = whole_rows(x, positions, comm, batch_spec)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        if decode:
            mix, _ = attn_decode(p["mixer"], cfg, h, cache, pos, comm, sm, kv_spec)
        else:
            mix, (k, v) = attn_forward(p["mixer"], cfg, h, positions, comm, sm)
            if not train:
                write_prefill(cache, k, v, comm, kv_spec)
    else:
        names = _STATE[kind]
        state = {n: cache[n] for n in names} if decode else None
        mix, new = _SSM_FORWARD[kind](p["mixer"], cfg, h, state, comm, sm)
        if not train:
            for n in names:
                cache[n].copy_(new[n])
    x = x + mix
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    aux = 0.0
    if mlp_kind == "moe":
        out, aux = moe.moe_forward(p["mlp"], cfg, h2, stats, comm, sl, batch_spec,
                                   whole_aux=train)
    elif mlp_kind == "rwkv_cm":
        out, x_cm = ssm.rwkv_cm_forward(p["mlp"], cfg, h2, cache["x_cm"] if decode else None,
                                        comm, sl)
        if not train:
            cache["x_cm"].copy_(x_cm)
    else:
        out = swiglu(h2, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"],
                     cfg.compute_dtype)
        if sharding.sharded(sl, "w_down", 0):
            out = comm.all_reduce(out, "model")
    return hint(x + out, RESIDUAL, src=(batch_spec, None, None)), aux


RESIDUAL = ("act_batch", "act_seq", "act_embed")


def whole_rows(x, positions, comm=LOCAL, batch_spec=None):
    """The residual stream ``x`` with every position of its rows: where the
    rules shard the stream's sequence between layers (``act_seq``, the
    sequence-parallel residual), an all-gather of ``x`` over those axes;
    else ``x``. ``positions`` (B, T) gives the whole length T."""
    if comm is LOCAL or sharding.current_state() is None:
        return x
    full = (x.shape[0] * comm.share(batch_spec)[1], positions.shape[1], x.shape[2])
    spec = sharding.active_spec(full, RESIDUAL)
    return sharding.reshard(x, spec, (batch_spec, None, None), comm) if spec[1] else x


def train_group(blocks, x, aux, positions) -> tuple:
    """Blocks in mode "train" (one scan body of the reference): returns
    (x, aux + the blocks' aux losses, added in layer order)."""
    for block in blocks:
        x, a = block(x, positions, "train")
        aux = aux + a
    return x, aux


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


def cache_axes(cfg) -> list:
    """Logical sharding axes mirroring :func:`empty_cache`, one dict per
    layer: the reference's per-period-position dicts without their leading
    ``layers`` axis (k_scale and v_scale listed whatever the dtype)."""
    out = []
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        if kind == "attn":
            kv = ("act_batch", "kv_seq", None, None)
            c = {"k": kv, "v": kv, "k_scale": kv, "v_scale": kv}
        elif kind == "mamba":
            c = {"h": ("act_batch", "act_heads", None, None)}
        else:
            c = {"h": ("act_batch", "act_heads", None, None),
                 "x_prev": ("act_batch", None, None)}
        if cfg.mlp_of(i) == "rwkv_cm":
            c["x_cm"] = ("act_batch", None, None)
        out.append(c)
    return out
