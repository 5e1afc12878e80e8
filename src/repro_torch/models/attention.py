"""Attention (port of ``repro/models/attention.py``): GQA with optional
qk-norm and RoPE; the prefill goes through the flash-attention kernel K7
(``ops.flash_attention``), the decode step through plain matmuls over the
KV cache, as the reference computes it outside any Pallas kernel.

Each function takes a communicator (``runtime.sharding``; by default
``LOCAL``, one slot) and its weights' specs (None: not sharded). Under a
mesh (``models.model.ShardedLM``) each slot runs them as GSPMD partitions
the reference's by the rules: column-parallel ``wq``/``wk``/``wv`` and
row-parallel ``wo`` on ``model``, then a sum over ``model``; K7 on the
slot's share of whole heads, or, where the heads do not divide the axis,
on the slot's query rows (``act_seq_attn``) against the causal key
prefix. The cache's sequence shards over ``kv_seq``, and decode is
flash-decode over it: each slot's partial over its own positions (its
log Σexp and its softmax-weighted values), merged across the shards.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, rmsnorm, rope
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import LOCAL


def attn_defs(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, hq * hd), ("embed", "heads")),
        "wk": ParamDef((d, hkv * hd), ("embed", "kv")),
        "wv": ParamDef((d, hkv * hd), ("embed", "kv")),
        "wo": ParamDef((hq * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones")
        defs["k_norm"] = ParamDef((hd,), (None,), "ones")
    return defs


_QKV = ("wq", "wk", "wv")


def _project_qkv(p, cfg, x, positions, comm=LOCAL, gather=()):
    """q, k, v (B, T, heads, hd) after the optional qk-norm and RoPE. The
    columns of the weights named in ``gather`` are gathered over ``model``
    (one collective): every head of those."""
    b, t, _ = x.shape
    cd = cfg.compute_dtype
    qkv = [x @ p[w].to(cd) for w in _QKV]
    cut = [i for i, w in enumerate(_QKV) if w in gather]
    if cut:
        for i, full in zip(cut, comm.all_gather(tuple(qkv[i] for i in cut), "model", 2)):
            qkv[i] = full
    q, k, v = (a.reshape(b, t, -1, cfg.hd) for a in qkv)
    q, k = _norm_rope(p, cfg, q, k, positions)
    return q, k, v


def _norm_rope(p, cfg, q, k, positions):
    """The optional qk-norm, then RoPE, on (…, T, H, hd) q and k."""
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)


def _row_parallel(o, p, specs, comm):
    """``o @ wo`` for ``o`` holding every head: each slot multiplies its
    share of o's columns by its rows of ``wo`` and the slots sum over
    ``model``; a replicated ``wo`` takes the whole product."""
    wo = p["wo"].to(o.dtype)
    if not sharding.sharded(specs, "wo", 0):
        return o @ wo
    j, m = comm.share("model")
    c = o.shape[-1] // m
    return comm.all_reduce(o[..., j * c:(j + 1) * c] @ wo, "model")


def _kv_for(k, v, h0: int, h1: int, g: int, local: bool):
    """The kv heads that q heads [h0, h1) read: the slot's own where its
    kv share matches, a slice of whole GQA groups, else one kv head per q
    head."""
    if local:
        return k, v
    if h0 % g == 0 and h1 % g == 0:
        return k[:, h0 // g:h1 // g], v[:, h0 // g:h1 // g]
    idx = torch.arange(h0, h1, device=k.device) // g
    return k[:, idx], v[:, idx]


def attn_forward(p, cfg, x, positions, comm=LOCAL, specs=None):
    """Prefill attention. x: (B, T, d). Returns (out, (k, v)), k and v
    (B, T, heads, hd): every kv head, or the slot's own where it holds
    whole kv heads (:func:`write_prefill` stores either). The heads-major
    views go to the kernel as strides.

    Over a mesh ``x`` is the slot's batch share, replicated over
    ``model``, and ``p`` its weights (FSDP dims gathered). Where the heads
    divide ``model``, q's columns are the slot's whole heads and K7 runs on
    them (k and v gathered over ``model`` where the slot's kv share is not
    whole heads of its GQA groups); else q, k and v are gathered and K7
    runs on the slot's query rows by ``act_seq_attn`` against the causal
    key prefix (all rows where T does not divide). The output is
    replicated over ``model``."""
    b, t, _ = x.shape
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    j, m = comm.share("model")
    heads_local = m == 1 or (sharding.sharded(specs, "wq", 1) and hq % m == 0)
    kv_local = m == 1 or (heads_local and sharding.sharded(specs, "wk", 1) and hkv % m == 0)
    gather = [w for w, local in zip(_QKV, (heads_local, kv_local, kv_local))
              if not local and sharding.sharded(specs, w, 1)]
    q, k, v = _project_qkv(p, cfg, x, positions, comm, gather)
    if heads_local:
        h0, h1 = j * hq // m, (j + 1) * hq // m
        kk, vv = _kv_for(k.transpose(1, 2), v.transpose(1, 2), h0, h1, hq // hkv, kv_local)
        o = ops.flash_attention(q.transpose(1, 2), kk, vv, causal=True)   # (B, Hq, T, hd)
        o = o.transpose(1, 2).reshape(b, t, -1)
        return comm.all_reduce(o @ p["wo"].to(cfg.compute_dtype), "model"), (k, v)
    rows = sharding.active_spec((t,), ("act_seq_attn",))[0]
    kq, nq = comm.share(rows)
    lo, hi = kq * t // nq, (kq + 1) * t // nq
    o = ops.flash_attention(q[:, lo:hi].transpose(1, 2), k[:, :hi].transpose(1, 2),
                            v[:, :hi].transpose(1, 2), causal=True)
    o = o.transpose(1, 2).reshape(b, hi - lo, -1)
    if rows is not None:
        o = comm.all_gather(o, rows, 1)
    return _row_parallel(o, p, specs, comm), (k, v)


def quantize_kv(x):
    """x: (..., hd) -> (int8 values, per-vector bf16 scale (..., 1))."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / s.clamp_min(1e-8)).to(torch.int8)
    return q, s.to(torch.bfloat16)


def write_kv(cache: dict, k, v, rows, cols, keep=None) -> None:
    """Store k, v at ``cache[..][rows, cols]`` in place, quantized when the
    cache is int8 (per-vector bf16 scales beside it); where ``keep`` (a
    mask that broadcasts against the values) is False the cache keeps what
    it held."""
    if cache["k"].dtype == torch.int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        new = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        new = (("k", k.to(cache["k"].dtype)), ("v", v.to(cache["v"].dtype)))
    for name, val in new:
        if keep is not None:
            val = torch.where(keep, val, cache[name][rows, cols])
        cache[name][rows, cols] = val


def write_prefill(cache: dict, k, v, comm=LOCAL, spec=None) -> None:
    """Store the prompt's k, v (B, T, heads, hd) at positions 0..T-1 of
    the cache, or, over a mesh, at the slot's ``kv_seq`` positions of its
    shard (placed by ``spec``; every kv head): an all-to-all over
    ``model`` where the slot holds only its own kv heads (each peer gets
    the positions its shard holds), else a slice."""
    t = k.shape[1]
    s_local = cache["k"].shape[1]
    seq = None if spec is None else spec[1]

    def span(**at) -> tuple:
        kq = comm.share(seq, **at)[0]
        return min(t, kq * s_local), min(t, (kq + 1) * s_local)

    if k.shape[2] < cache["k"].shape[2]:
        spans = [span(model=jj) for jj in range(comm.share("model")[1])]
        k = comm.all_to_all([k[:, a:b] for a, b in spans], "model", 2)
        v = comm.all_to_all([v[:, a:b] for a, b in spans], "model", 2)
    else:
        a, b = span()
        k, v = k[:, a:b], v[:, a:b]
    if k.shape[1]:
        write_kv(cache, k, v, slice(None), slice(0, k.shape[1]))


def attn_decode(p, cfg, x, cache: dict, pos, comm=LOCAL, specs=None, cache_spec=None):
    """One decode step. x: (B, 1, d); cache dict with k, v (B, S, Hkv, hd)
    (+ k_scale/v_scale (B, S, Hkv, 1) when int8-quantized), updated in
    place at ``pos``: an int or (B,) per-slot positions (continuous
    batching). int8 caches dequantize by factoring the per-(b, s, h) scale
    out of the score and value products; the cache is never materialized
    dequantized. Returns (out, cache).

    Over a mesh this is flash-decode over the sequence-sharded cache
    (placed by ``cache_spec``): ``x`` and ``pos`` are the slot's batch
    share, q, k and v are gathered over ``model`` (every head), the slot
    owning a row's position writes its k and v, each slot takes its
    partial over its positions (log Σexp, and the values weighted by the
    softmax over its positions), and the partials merge across the cache's
    sequence axes (stacked in slot order, one reduction each). A shard
    wholly past ``pos`` has log Σexp = -inf and weighs 0; its own softmax
    is never formed. The output is replicated over ``model``."""
    b, _, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = hq // hkv
    quant = cache["k"].dtype == torch.int8
    pos_vec = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(b)
    q, k, v = _project_qkv(p, cfg, x, pos_vec[:, None], comm,
                           [w for w in _QKV if sharding.sharded(specs, w, 1)])
    s = cache["k"].shape[1]
    seq = None if cache_spec is None else cache_spec[1]
    s0 = comm.share(seq)[0] * s
    rel = pos_vec - s0
    bi = torch.arange(b, device=x.device)
    write_kv(cache, k[:, 0], v[:, 0], bi, rel.clamp(0, s - 1),
             keep=((rel >= 0) & (rel < s))[:, None, None])

    qh = q.reshape(b, hkv, g, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qh, cache["k"].float())
    if quant:
        logits = logits * cache["k_scale"].float()[:, :, :, 0].permute(0, 2, 1)[:, :, None, :]
    logits = logits / (hd ** 0.5)
    mask = (s0 + torch.arange(s, device=x.device))[None, None, None, :] \
        <= pos_vec[:, None, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)                              # (b, hkv, g)
    empty = torch.isinf(lse)[..., None]      # a shard wholly past pos
    w = torch.softmax(logits.masked_fill(empty, 0.0), dim=-1)
    if quant:
        w = w * cache["v_scale"].float()[:, :, :, 0].permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", w, cache["v"].float())
    parts = comm.exchange((lse, o), seq)
    if len(parts) > 1:
        lses = torch.stack([a.to(x.device) for a, _ in parts])
        ws = torch.exp(lses - torch.logsumexp(lses, dim=0))            # 0 where -inf
        o = (ws[..., None] * torch.stack([o_.to(x.device) for _, o_ in parts])).sum(dim=0)
    o = o.reshape(b, 1, hq * hd).to(cfg.compute_dtype)
    return _row_parallel(o, p, specs, comm), cache
