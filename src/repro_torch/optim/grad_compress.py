"""Gradient compression with error feedback (port of
``repro/optim/grad_compress.py``): per-tensor int8 quantization and top-k
sparsification, and ``compressed_psum``, the int8-compressed all-reduce
over the shards of a mesh axis."""
from __future__ import annotations

import torch

from repro_torch.runtime.sharding import join


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


def compressed_psum(shards: list, mesh) -> list:
    """Int8-compressed all-reduce with a shared scale over ``shards``, one
    tensor a slot of the 1-D ``mesh`` (a :class:`repro_torch.runtime.
    sharding.Mesh`, e.g. ``mesh.line(axis)``), each on its slot's device
    and made on its slot's stream; returns every slot's copy of the sum, on
    its device and made on its stream, in ``x``'s dtype.

    1. the max of |x| over the shards fixes one scale for all of them (one
       scalar exchange),
    2. each shard ships its int8-range payload, summed in int32 (as a real
       ring-reduce accumulator would, without overflow),
    3. one dequantize at the end.
    Wire bytes: 1/2 of bf16, 1/4 of float32."""
    slots = list(mesh.slots.flat)
    if len(slots) != len(shards):
        raise ValueError(f"{len(shards)} shards over a mesh of {len(slots)} slots")
    shards = [join(x, slot) for x, slot in zip(shards, slots)]
    home = shards[0].device
    gmax = torch.stack([x.float().abs().max().to(home) for x in shards]).max()
    scale = torch.clamp_min(gmax, 1e-12) / 127.0
    total = None
    for x in shards:
        q = torch.clamp(torch.round(x.float() / scale.to(x.device)), -127, 127)
        q = q.to(torch.int32).to(home)
        total = q if total is None else total + q
    out = total.float() * scale
    copies = []
    for x, slot in zip(shards, slots):
        slot.follow(out)
        with slot.scope():
            copies.append(out.to(device=slot.device, dtype=x.dtype, copy=True))
    return copies
