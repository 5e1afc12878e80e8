"""SSM mixers: Mamba (SSD chunked form) and RWKV6 (port of
``repro/models/ssm.py``).

Both mixers share :func:`chunked_gla`, a chunked gated-linear-attention
evaluation of ``S_t = diag(decay_t) S_{t-1} + k_t v_tᵀ``:

  * the work inside a chunk is dense products (``torch.einsum``), computed
    for every chunk at once, since none of it reads the carried state;
  * the state crosses chunks in a Python loop, one chunk after another
    (the reference's ``lax.scan``), and each chunk then reads the state it
    was handed in one batched product.

The reference computes these products outside any Pallas kernel (its carry
is a ``lax.scan``, not the chunked-scan kernel K8), and so does the port.
:func:`gla_reference` is the step-by-step oracle and the plain version.

One difference on purpose: the reference splits the in-chunk decay
``e^{L_t - L_s}`` into ``e^{L_t} · e^{-L_s}`` and clamps ``-L_s`` at 30 so
that the k-side factor cannot overflow. Where a chunk's cumulative log decay
passes -30 (rwkv6-1.6b at init, ~-1 a step over chunks of 32) that clamp
changes the last positions of each chunk by up to ~30 % of max|y| against
the reference's own oracle. The port takes the pairwise differences
``L_t - L_s`` (never positive under the causal mask) and exponentiates
them, which cannot overflow and needs no clamp: it equals the reference
wherever the clamp is idle and the oracle everywhere.

The reference's simplifications hold here too: Jamba's Mamba-1 mixer in the
Mamba-2/SSD scalar-decay-per-head form without the depthwise conv, and
RWKV6's token-shift mixers as learned static coefficients with the decay
``w = exp(-exp(ŵ))``, ŵ clipped for float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, rmsnorm, silu


# ---------------------------------------------------------------------------
# Shared chunked GLA
# ---------------------------------------------------------------------------
def chunked_gla(q, k, v, log_decay, h0, *, chunk: int, mode: str, u=None):
    """q, k: (B, T, H, K); v: (B, T, H, V); h0: (B, H, K, V) carried state.

    log_decay: (B, T, H) scalar-per-head (mamba/SSD) or (B, T, H, K) vector
    (rwkv6) — log of diag(decay_t); must be ≤ 0.

    mode="inclusive": y_t = q_t·S_t        (current token in state; mamba)
    mode="bonus":     y_t = q_t·S_{t-1} + (q_t ⊙ u ⊙ k_t)·v_t   (rwkv6)

    Returns (y (B, T, H, V) in v's dtype, h_last (B, H, K, V) float32).
    Decode is the T = 1 case. Sums in float32.
    """
    b, t, h, _ = q.shape
    vv = v.shape[-1]
    c = min(chunk, t)
    t_pad = -(-t // c) * c
    if t_pad != t:
        # pad with identity steps: decay 1 (log 0), k = v = 0 → state unchanged
        def pad(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, t_pad - t))
        y, h_last = chunked_gla(pad(q), pad(k), pad(v), pad(log_decay), h0,
                                chunk=chunk, mode=mode, u=u)
        return y[:, :t], h_last
    nc = t // c
    scalar = log_decay.dim() == 3

    def to_chunks(a):      # (B, T, …) -> (B, nc, C, …) in float32
        return a.reshape((b, nc, c) + tuple(a.shape[2:])).float()

    def expand(a):         # scalar decay broadcasts over K
        return a[..., None] if scalar else a

    qq, kk, vv_, ld = (to_chunks(a) for a in (q, k, v, log_decay))
    L = torch.cumsum(ld, dim=2)                        # inclusive within-chunk
    if mode == "inclusive":
        Lq = L
    else:                                              # exclusive: L_{t-1}, L_0 = 0
        Lq = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril(
        0 if mode == "inclusive" else -1)
    # in-chunk decay e^{Lq_t - L_s} for s under the mask (exponent ≤ 0), 0 above
    heads_first = (0, 1, 3, 2) if scalar else (0, 1, 3, 2, 4)  # (B, nc, H, C[, K])
    lq_h, l_h = Lq.permute(heads_first), L.permute(heads_first)
    if scalar:
        gap = lq_h[..., :, None] - l_h[..., None, :]               # (B, nc, H, C, C)
        dec = torch.exp(gap.masked_fill(~tri, float("-inf")))
        A = torch.einsum("bnthk,bnshk->bnhts", qq, kk) * dec
    else:
        gap = lq_h[..., :, None, :] - l_h[..., None, :, :]         # (B, nc, H, C, C, K)
        dec = torch.exp(gap.masked_fill(~tri[..., None], float("-inf")))
        q_h, k_h = qq.permute(heads_first), kk.permute(heads_first)
        A = torch.einsum("bnhtsk,bnhsk->bnhts", dec * q_h[..., :, None, :], k_h)
    y = torch.einsum("bnhts,bnshv->bnthv", A, vv_)
    qf = qq * torch.exp(expand(Lq))
    # state: h = e^{L_end} ⊙ h_prev + Σ_s (k_s ⊙ e^{L_end - L_s}) v_sᵀ
    l_end = L[:, :, -1]                                # (B, nc, H[, K])
    kdec = kk * torch.exp(expand(l_end[:, :, None] - L))
    inject = torch.einsum("bnshk,bnshv->bnhkv", kdec, vv_)
    carry = torch.exp(l_end)[..., None, None] if scalar else torch.exp(l_end)[..., None]
    h_cur, h_in = h0.float(), []
    for n in range(nc):
        h_in.append(h_cur)
        h_cur = carry[:, n] * h_cur + inject[:, n]
    y = y + torch.einsum("bnthk,bnhkv->bnthv", qf, torch.stack(h_in, dim=1))
    if mode == "bonus":
        coef = torch.sum(qq * u.float() * kk, dim=-1)  # (B, nc, C, H)
        y = y + coef[..., None] * vv_
    return y.reshape(b, t, h, vv).to(v.dtype), h_cur


def gla_reference(q, k, v, log_decay, h0, *, mode: str, u=None):
    """Step-by-step oracle for :func:`chunked_gla`, one token a step in
    float32; the plain version."""
    scalar = log_decay.dim() == 3
    q, k, vf, ld = (a.float() for a in (q, k, v, log_decay))
    hh, ys = h0.float(), []
    for t in range(q.shape[1]):
        qt, kt, vt, lt = q[:, t], k[:, t], vf[:, t], ld[:, t]    # (B, H, K/V[, K])
        dec = torch.exp(lt)[..., None, None] if scalar else torch.exp(lt)[..., None]
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        if mode == "inclusive":
            hh = dec * hh + kv
            yt = torch.einsum("bhk,bhkv->bhv", qt, hh)
        else:
            yt = torch.einsum("bhk,bhkv->bhv", qt, hh)
            yt = yt + torch.sum(qt * u[None].float() * kt, -1)[..., None] * vt
            hh = dec * hh + kv
        ys.append(yt)
    return torch.stack(ys, dim=1).to(v.dtype), hh


# ---------------------------------------------------------------------------
# Mamba (SSD form)
# ---------------------------------------------------------------------------
def mamba_defs(cfg) -> dict:
    s, d = cfg.ssm, cfg.d_model
    hv, hk = s.n_heads * s.d_head, s.n_heads * s.d_state
    return {
        "w_in": ParamDef((d, 2 * hv)),
        "w_bc": ParamDef((d, 2 * hk)),
        "w_dt": ParamDef((d, s.n_heads)),
        "dt_bias": ParamDef((s.n_heads,), "zeros"),
        "a_log": ParamDef((s.n_heads,), "zeros"),
        "dskip": ParamDef((s.n_heads,), "ones"),
        "norm": ParamDef((hv,), "ones"),
        "w_out": ParamDef((hv, d)),
    }


def mamba_empty_state(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    s = cfg.ssm
    return {"h": torch.zeros((batch, s.n_heads, s.d_state, s.d_head), dtype=dtype,
                             device=device)}


def mamba_forward(p, cfg, x, state=None):
    """x: (B, T, d). Returns (out, new_state). T = 1 with a state is decode."""
    s = cfg.ssm
    b, t, _ = x.shape
    H, K, V = s.n_heads, s.d_state, s.d_head
    cd = cfg.compute_dtype
    if state is None:
        state = mamba_empty_state(cfg, b, device=x.device)
    xg, z = torch.chunk(x @ p["w_in"].to(cd), 2, dim=-1)
    xg = xg.reshape(b, t, H, V)
    bb, cc = torch.chunk(x @ p["w_bc"].to(cd), 2, dim=-1)
    bb, cc = bb.reshape(b, t, H, K), cc.reshape(b, t, H, K)
    dt = F.softplus((x @ p["w_dt"].to(cd)).float() + p["dt_bias"].float())   # (B,T,H)
    a = -torch.exp(p["a_log"].float())
    ld = dt * a[None, None]
    v = (xg.float() * dt[..., None]).to(cd)
    y, h_last = chunked_gla(cc, bb, v, ld, state["h"], chunk=s.chunk, mode="inclusive")
    y = y + p["dskip"].to(cd)[None, None, :, None] * xg
    y = rmsnorm(y.reshape(b, t, H * V), p["norm"], cfg.norm_eps)
    y = y * silu(z)
    return y @ p["w_out"].to(cd), {"h": h_last}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
def rwkv_defs(cfg) -> dict:
    s, d = cfg.ssm, cfg.d_model
    hk, hv = s.n_heads * s.d_state, s.n_heads * s.d_head
    return {
        "mix": ParamDef((5, d), "zeros"),   # r, k, v, g, w shifts
        "w_r": ParamDef((d, hk)),
        "w_k": ParamDef((d, hk)),
        "w_v": ParamDef((d, hv)),
        "w_g": ParamDef((d, hv)),
        "w_w": ParamDef((d, hk), "normal", 0.002),
        "w_bias": ParamDef((hk,), "zeros"),
        "u": ParamDef((s.n_heads, s.d_state), "normal", 0.5),
        "gn": ParamDef((hv,), "ones"),
        "w_out": ParamDef((hv, d)),
    }


def rwkv_empty_state(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    s = cfg.ssm
    return {
        "h": torch.zeros((batch, s.n_heads, s.d_state, s.d_head), dtype=dtype,
                         device=device),
        "x_prev": torch.zeros((batch, 1, cfg.d_model), dtype=cfg.compute_dtype,
                              device=device),
    }


def _token_shift(x, x_prev):
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_projections(p, cfg, x, x_prev) -> tuple:
    """The token-shifted projections of :func:`rwkv_forward`: r, k (B, T, H,
    K), v (B, T, H, V), the gate g (B, T, H·V) and the log decay ld (B, T,
    H, K), float32 and ≤ 0: the inputs of its ``chunked_gla``."""
    s = cfg.ssm
    b, t, _ = x.shape
    H, K, V = s.n_heads, s.d_state, s.d_head
    cd = cfg.compute_dtype
    xs = _token_shift(x, x_prev)
    mix = torch.sigmoid(p["mix"].float()).to(cd)                     # (5, d)
    xm = [x + mix[i][None, None] * (xs - x) for i in range(5)]
    r = (xm[0] @ p["w_r"].to(cd)).reshape(b, t, H, K)
    k = (xm[1] @ p["w_k"].to(cd)).reshape(b, t, H, K)
    v = (xm[2] @ p["w_v"].to(cd)).reshape(b, t, H, V)
    g = xm[3] @ p["w_g"].to(cd)
    ww = (xm[4] @ p["w_w"].to(cd)).float().reshape(b, t, H, K)
    ww = ww + p["w_bias"].float().reshape(H, K)[None, None]
    ld = -torch.exp(torch.clamp(ww, -8.0, 1.0))                      # ≤ 0
    return r, k, v, g, ld


def rwkv_forward(p, cfg, x, state=None):
    """x: (B, T, d). Returns (out, new_state). T = 1 with a state is decode."""
    s = cfg.ssm
    b, t, _ = x.shape
    H, V = s.n_heads, s.d_head
    cd = cfg.compute_dtype
    if state is None:
        state = rwkv_empty_state(cfg, b, device=x.device)
    r, k, v, g, ld = rwkv_projections(p, cfg, x, state["x_prev"])
    y, h_last = chunked_gla(r, k, v, ld, state["h"], chunk=s.chunk, mode="bonus",
                            u=p["u"])
    # per-head group norm
    y32 = y.float()
    y32 = y32 * torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + cfg.norm_eps)
    y = (y32.reshape(b, t, H * V) * p["gn"].float()[None, None]).to(cd)
    y = y * silu(g)
    return y @ p["w_out"].to(cd), {"h": h_last, "x_prev": x[:, -1:]}


# ---------------------------------------------------------------------------
# RWKV channel mix (the FFN of the rwkv6 configs)
# ---------------------------------------------------------------------------
def rwkv_cm_defs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix": ParamDef((2, d), "zeros"),
        "w_k": ParamDef((d, f)),
        "w_v": ParamDef((f, d)),
        "w_r": ParamDef((d, d)),
    }


def rwkv_cm_forward(p, cfg, x, x_prev=None):
    """x: (B, T, d). Returns (out, the last token's x: the next x_prev)."""
    b, _, d = x.shape
    cd = cfg.compute_dtype
    if x_prev is None:
        x_prev = torch.zeros((b, 1, d), dtype=cd, device=x.device)
    xs = _token_shift(x, x_prev)
    mix = torch.sigmoid(p["mix"].float()).to(cd)
    xk = x + mix[0][None, None] * (xs - x)
    xr = x + mix[1][None, None] * (xs - x)
    kk = torch.square(torch.relu((xk @ p["w_k"].to(cd)).float())).to(cd)
    rr = torch.sigmoid((xr @ p["w_r"].to(cd)).float()).to(cd)
    return rr * (kk @ p["w_v"].to(cd)), x[:, -1:]
