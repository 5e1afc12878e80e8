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
reference's einsums are outside any Pallas kernel. The reference's sharding
hints are no-ops without a mesh and are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, silu


def moe_defs(cfg) -> dict:
    m, d = cfg.moe, cfg.d_model
    defs = {
        "router": ParamDef((d, m.n_experts)),
        "w_gate": ParamDef((m.n_experts, d, m.d_ff)),
        "w_up": ParamDef((m.n_experts, d, m.d_ff)),
        "w_down": ParamDef((m.n_experts, m.d_ff, d)),
    }
    if m.dense_residual:
        defs["res_gate"] = ParamDef((d, cfg.d_ff))
        defs["res_up"] = ParamDef((d, cfg.d_ff))
        defs["res_down"] = ParamDef((cfg.d_ff, d))
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


def moe_forward(p, cfg, x, stats=None):
    """x: (B, T, d). Returns (out, aux_loss).

    ``stats``, where given, is a dict whose ``"assigned"`` entry grows by
    this call's (token, k) assignments and whose ``"dropped"`` entry by
    those past capacity (a tensor on x's device: no host sync)."""
    m = cfg.moe
    b, t, d = x.shape
    cd = cfg.compute_dtype
    n = b * t
    tokens = x.reshape(n, d)
    e, k = m.n_experts, m.top_k
    cap = capacity(n, cfg)
    dev = x.device

    logits = (tokens @ p["router"].to(cd)).float()                    # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)                                     # (N, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch-style): E * Σ_e f_e · p̄_e
    assign = F.one_hot(top_e[:, 0], e).float()                        # primary
    aux = e * torch.sum(assign.mean(0) * probs.mean(0))

    # positions within each expert: cumsum over the one-hot of the (N·k)
    # assignments in (token, k)-major order, held expert-major (E, N·k) so
    # that the scan runs along the contiguous axis (a scan along the outer
    # axis of (N·k, E) is a serial loop per expert on the card)
    e_flat = top_e.reshape(-1)
    oh = (torch.arange(e, device=dev)[:, None] == e_flat[None, :]).to(torch.int64)
    pos = (torch.cumsum(oh, dim=1) * oh - 1).amax(dim=0)              # (N·k,)
    keep = pos < cap
    w_flat = torch.where(keep, top_w.reshape(-1), 0.0)
    if stats is not None:
        stats["assigned"] = stats.get("assigned", 0) + n * k
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()

    tok_id = torch.arange(n, device=dev).repeat_interleave(k)
    safe_pos = torch.where(keep, pos, cap)                             # drop column
    slot_tok = torch.full((e, cap + 1), n, dtype=torch.int64, device=dev)  # n → zero row
    slot_tok[e_flat, safe_pos] = tok_id
    tok_pad = torch.cat([tokens, torch.zeros((1, d), dtype=tokens.dtype, device=dev)])
    buf = tok_pad[slot_tok[:, :cap]]                                   # (E, C, d)

    g = torch.bmm(buf, p["w_gate"].to(cd))
    u = torch.bmm(buf, p["w_up"].to(cd))
    out_buf = torch.bmm(silu(g) * u, p["w_down"].to(cd))              # (E, C, d)

    gathered = out_buf[e_flat, torch.clamp(safe_pos, 0, cap - 1)]      # (N·k, d)
    gathered = (gathered * w_flat[:, None].to(cd)).reshape(n, k, d)
    out = torch.zeros((n, d), dtype=cd, device=dev)
    for j in range(k):
        out = out + gathered[:, j]

    if m.dense_residual:
        gg = tokens @ p["res_gate"].to(cd)
        uu = tokens @ p["res_up"].to(cd)
        out = out + (silu(gg) * uu) @ p["res_down"].to(cd)
    return out.reshape(b, t, d), aux
