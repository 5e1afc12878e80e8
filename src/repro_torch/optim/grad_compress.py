"""Gradient compression with error feedback (port of
``repro/optim/grad_compress.py``): per-tensor int8 quantization and top-k
sparsification. ``compressed_psum``, the collective, waits for the sharding
slice (ROADMAP queue 1)."""
from __future__ import annotations

import torch


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_decompress(x):
    q, s = quantize_int8(x)
    return dequantize_int8(q, s).to(x.dtype)


def topk_sparsify(x, frac: float):
    """Keep the top ``frac`` fraction of entries by magnitude (rest zeroed)."""
    xf = x.float()
    flat = xf.abs().reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(xf.abs() >= thresh, xf, 0.0).to(x.dtype)


def ef_compress_grads(grads: dict, residual: dict, mode: str = "int8",
                      topk_frac: float = 0.05):
    """Error-feedback compression: g' = C(g + r); r' = (g + r) - g'.

    Returns (compressed_grads, new_residual)."""
    out, res = {}, {}
    for name, g in grads.items():
        gf = g.float() + residual[name]
        c = (compress_decompress(gf) if mode == "int8"
             else topk_sparsify(gf, topk_frac)).float()
        out[name], res[name] = c.to(g.dtype), gf - c
    return out, res
