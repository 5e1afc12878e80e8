"""Mixture-of-Experts (port of ``repro/models/moe.py``): top-k routing with
capacity, dispatch by a slot map and a gather, batched expert SwiGLU,
weighted combine, and the load-balancing auxiliary loss.

Three rules are kept exactly as the reference has them, since they decide
which (token, k) assignments an expert serves:

  * the top k: ``jax.lax.top_k`` puts the lower expert first among equal
    probabilities, ``torch.topk`` does not, so the experts are picked by a
    stable descending sort (:func:`top_k`);
  * the slot of an assignment in its expert is a cumsum in (token, k)-major
    order, and assignments past :func:`capacity` are dropped (their weight
    is 0). ``n`` counts every token of the batch: in decode, every slot
    of the engine, active or not;
  * the combine adds a token's k contributions in order, starting from
    zeros and rounding in the compute dtype, as the reference's
    ``.at[tok_id].add`` does. A sum over k (not ``index_add_``, whose
    atomics change the order from run to run) keeps it deterministic.

The expert products are ``torch.bmm`` over the (E, C, d) buffer, as the
reference's einsums are outside any Pallas kernel.

:func:`moe_forward` takes a communicator (``runtime.sharding``; by
default ``LOCAL``, one slot) and its weights' specs (None: not sharded).
Under a mesh the experts shard over ``model`` where they divide it, else
(granite-moe's 40 on 16) each expert's FFN dim does (``expert_ffn``), as
do ``dense_residual``'s; the router, the stable top-k and the capacity
stay global (every token of the batch), and the slots sum their
contributions over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, silu, swiglu
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import LOCAL


def moe_defs(cfg) -> dict:
    m, d = cfg.moe, cfg.d_model
    defs = {
        "router": ParamDef((d, m.n_experts), ("embed", None)),
        "w_gate": ParamDef((m.n_experts, d, m.d_ff), ("experts", "expert_embed", "expert_ffn")),
        "w_up": ParamDef((m.n_experts, d, m.d_ff), ("experts", "expert_embed", "expert_ffn")),
        "w_down": ParamDef((m.n_experts, m.d_ff, d), ("experts", "expert_ffn", "expert_embed")),
    }
    if m.dense_residual:
        defs["res_gate"] = ParamDef((d, cfg.d_ff), ("embed", "ffn"))
        defs["res_up"] = ParamDef((d, cfg.d_ff), ("embed", "ffn"))
        defs["res_down"] = ParamDef((cfg.d_ff, d), ("ffn", "embed"))
    return defs


def capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(probs, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(p, cfg, x, stats=None, comm=LOCAL, specs=None, batch_spec=None,
                whole_aux: bool = False):
    """x: (B, T, d). Returns (out, aux_loss).

    ``stats``, where given, is a dict whose ``"assigned"`` entry grows by
    this call's (token, k) assignments and whose ``"dropped"`` entry by
    those past capacity (a tensor on x's device: no host sync).

    Over a mesh ``x`` is the slot's share of the batch along ``batch_spec``
    (the ``act_batch`` entry), replicated over ``model``, and ``p`` the
    slot's weights with their FSDP dims gathered. The routing is the
    global one: the capacity counts every token of the batch, and a slot's
    position in an expert starts after the assignments of the data ranks
    before it (an all-gather of the per-expert counts, in rank order). The
    slot serves the (token, k) assignments of its experts (all of them, on
    its FFN share, where the experts do not divide ``model``), and the
    slots' outputs are summed over ``model`` in slot order. ``stats``
    counts the whole batch (the drops summed over ``batch_spec``); the aux
    loss covers the slot's tokens, or, with ``whole_aux`` (training), the
    whole batch's, as the reference's: each expert's share of the primary
    assignments and its mean probability summed over ``batch_spec``."""
    m = cfg.moe
    b, t, d = x.shape
    cd = cfg.compute_dtype
    n = b * t
    tokens = x.reshape(n, d)
    e, k = m.n_experts, m.top_k
    kb, nb = comm.share(batch_spec)
    cap = capacity(n * nb, cfg)
    dev = x.device

    logits = (tokens @ p["router"].to(cd)).float()                    # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)                                     # (N, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch-style): E * Σ_e f_e · p̄_e
    assign = F.one_hot(top_e[:, 0], e).float()                        # primary
    if whole_aux and nb > 1:
        share, mean_p = comm.all_reduce((assign.sum(0), probs.sum(0)), batch_spec)
        aux = e * torch.sum((share / (n * nb)) * (mean_p / (n * nb)))
    else:
        aux = e * torch.sum(assign.mean(0) * probs.mean(0))

    # positions within each expert: cumsum over the one-hot of the (N·k)
    # assignments in (token, k)-major order, held expert-major (E, N·k) so
    # that the scan runs along the contiguous axis (a scan along the outer
    # axis of (N·k, E) is a serial loop per expert on the card)
    e_flat = top_e.reshape(-1)
    oh = (torch.arange(e, device=dev)[:, None] == e_flat[None, :]).to(torch.int64)
    pos = (torch.cumsum(oh, dim=1) * oh - 1).amax(dim=0)              # (N·k,)
    if nb > 1:
        counts = comm.all_gather(oh.sum(dim=1)[None], batch_spec, 0)     # (nb, E)
        pos = pos + counts[:kb].sum(dim=0)[e_flat]
    keep = pos < cap
    if stats is not None:
        stats["assigned"] = stats.get("assigned", 0) + n * nb * k
        stats["dropped"] = stats.get("dropped", 0) + comm.all_reduce((~keep).sum(), batch_spec)

    # the experts [e0, e1) this slot serves
    by_expert = sharding.sharded(specs, "w_gate", 0)
    jm, mm = comm.share("model")
    e0, e1 = (jm * e // mm, (jm + 1) * e // mm) if by_expert else (0, e)
    mine = keep & (e_flat >= e0) & (e_flat < e1)
    w_flat = torch.where(mine, top_w.reshape(-1), 0.0)
    e_loc = torch.where(mine, e_flat - e0, 0)

    tok_id = torch.arange(n, device=dev).repeat_interleave(k)
    safe_pos = torch.where(mine, pos, cap)                             # drop column
    slot_tok = torch.full((e1 - e0, cap + 1), n, dtype=torch.int64, device=dev)  # n → zero row
    slot_tok[e_loc, safe_pos] = tok_id
    tok_pad = torch.cat([tokens, torch.zeros((1, d), dtype=tokens.dtype, device=dev)])
    buf = tok_pad[slot_tok[:, :cap]]                                   # (E, C, d)

    g = torch.bmm(buf, p["w_gate"].to(cd))
    u = torch.bmm(buf, p["w_up"].to(cd))
    out_buf = torch.bmm(silu(g) * u, p["w_down"].to(cd))              # (E, C, d)

    gathered = out_buf[e_loc, torch.clamp(safe_pos, 0, cap - 1)]       # (N·k, d)
    gathered = (gathered * w_flat[:, None].to(cd)).reshape(n, k, d)
    out = torch.zeros((n, d), dtype=cd, device=dev)
    for j in range(k):
        out = out + gathered[:, j]

    partial = by_expert or sharding.sharded(specs, "w_gate", 2)   # else every slot has it all
    res = None
    if m.dense_residual:
        res = swiglu(tokens, p["res_gate"], p["res_up"], p["res_down"], cd)
        if sharding.sharded(specs, "res_gate", 1) == partial:   # summed with the experts'
            out, res = out + res, None
    if partial:
        out = comm.all_reduce(out, "model")
    if res is not None:
        out = out + (res if partial else comm.all_reduce(res, "model"))
    return out.reshape(b, t, d), aux
