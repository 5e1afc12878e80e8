"""Gradient compression with error feedback (port of
``repro/optim/grad_compress.py``): per-tensor int8 quantization and top-k
sparsification, and ``compressed_psum_rank``, the int8-compressed
all-reduce of the members of a mesh axis (``compressed_psum``: the same in
a thread a slot)."""
from __future__ import annotations

import torch

from repro_torch.runtime.sharding import run


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


def compressed_psum_rank(x, comm, axes):
    """The reference's ``compressed_psum(x, axis_name)`` as a per-rank
    program: the int8-compressed all-reduce with a shared scale of every
    member's ``x`` over ``comm``'s ``axes``, in ``x``'s dtype.

    1. ``all_max`` of |x| fixes one scale for all members (one scalar
       exchange),
    2. each member ships its int8-range payload, summed in int32 (as a real
       ring-reduce accumulator would, without overflow),
    3. one dequantize at the end.
    Wire bytes: 1/2 of bf16, 1/4 of float32."""
    xf = x.float()
    gmax = comm.all_max(xf.abs().max(), axes)
    scale = torch.clamp_min(gmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    total = comm.all_reduce(q, axes)
    return (total.float() * scale).to(x.dtype)


def compressed_psum(shards: list, mesh) -> list:
    """:func:`compressed_psum_rank` over ``shards``, one tensor a slot of
    the 1-D ``mesh`` (a :class:`repro_torch.runtime.sharding.Mesh`, e.g.
    ``mesh.line(axis)``), each on its slot's device and made on its slot's
    stream, one thread a slot; returns every slot's copy of the sum, on its
    device and made on its stream."""
    slots = list(mesh.slots.flat)
    if len(slots) != len(shards):
        raise ValueError(f"{len(shards)} shards over a mesh of {len(slots)} slots")
    axis = mesh.axis_names[0]
    return list(run(mesh, lambda comm: compressed_psum_rank(shards[comm.rank], comm, axis)))
