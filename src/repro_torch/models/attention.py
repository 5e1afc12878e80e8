"""Attention (port of ``repro/models/attention.py``): GQA with optional
qk-norm and RoPE; the prefill goes through the flash-attention kernel K7
(``ops.flash_attention``), the decode step through plain matmuls over the
KV cache, as the reference computes it outside any Pallas kernel.

The reference's sharding hints are no-ops without a mesh and are dropped.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, rmsnorm, rope


def attn_defs(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, hq * hd)),
        "wk": ParamDef((d, hkv * hd)),
        "wv": ParamDef((d, hkv * hd)),
        "wo": ParamDef((hq * hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "ones")
        defs["k_norm"] = ParamDef((hd,), "ones")
    return defs


def _project_qkv(p, cfg, x, positions):
    b, t, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, t, hq, hd)
    k = (x @ p["wk"].to(cd)).reshape(b, t, hkv, hd)
    v = (x @ p["wv"].to(cd)).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, cfg, x, positions):
    """Prefill attention. x: (B, T, d). Returns (out, (k, v)), k and v
    (B, T, Hkv, hd). The heads-major views go to the kernel as strides."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)   # (B, Hq, T, hd)
    o = o.transpose(1, 2).reshape(b, t, -1)
    out = o @ p["wo"].to(cfg.compute_dtype)
    return out, (k, v)


def quantize_kv(x):
    """x: (..., hd) -> (int8 values, per-vector bf16 scale (..., 1))."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / s.clamp_min(1e-8)).to(torch.int8)
    return q, s.to(torch.bfloat16)


def write_kv(cache: dict, k, v, rows, cols) -> None:
    """Store k, v at ``cache[..][rows, cols]`` in place, quantized when the
    cache is int8 (per-vector bf16 scales beside it)."""
    if cache["k"].dtype == torch.int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            cache[name][rows, cols] = val
    else:
        cache["k"][rows, cols] = k.to(cache["k"].dtype)
        cache["v"][rows, cols] = v.to(cache["v"].dtype)


def attn_decode(p, cfg, x, cache: dict, pos):
    """One decode step. x: (B, 1, d); cache dict with k, v (B, S, Hkv, hd)
    (+ k_scale/v_scale (B, S, Hkv, 1) when int8-quantized), updated in
    place at ``pos``: an int or (B,) per-slot positions (continuous
    batching). int8 caches dequantize by factoring the per-(b, s, h) scale
    out of the score and value products; the cache is never materialized
    dequantized. Returns (out, cache)."""
    b, _, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    quant = cache["k"].dtype == torch.int8
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    q, k, v = _project_qkv(p, cfg, x, positions=pos_vec[:, None])
    bi = torch.arange(b, device=x.device)
    write_kv(cache, k[:, 0], v[:, 0], bi, pos_vec)

    s = cache["k"].shape[1]
    qh = q.reshape(b, hkv, g, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qh, cache["k"].float())
    if quant:
        logits = logits * cache["k_scale"].float()[:, :, :, 0].permute(0, 2, 1)[:, :, None, :]
    logits = logits / (hd ** 0.5)
    mask = torch.arange(s, device=x.device)[None, None, None, :] <= pos_vec[:, None, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    if quant:
        w = w * cache["v_scale"].float()[:, :, :, 0].permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", w, cache["v"].float())
    o = o.reshape(b, 1, hq * hd).to(cfg.compute_dtype)
    out = o @ p["wo"].to(cfg.compute_dtype)
    return out, cache
