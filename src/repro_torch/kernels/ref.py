"""Plain oracles for the port's kernels, beside the plain versions each
kernel module keeps (port of ``repro/kernels/ref.py``).

:func:`tropical_matmul_ref` evaluates the weighted (min,+) product in one
broadcast, with the candidate rounding of ``kernels/semiring_matmul.py``;
the tests hold that module's K-chunked plain version against it.
:func:`sdp_pipeline_ref` is K1's (the blocked S-DP table of
``core/sdp.py``); :func:`chunked_scan_ref` and :func:`attention_ref` are
the oracles of K8 and K7 (``kernels/chunked_scan.py``, ``kernels/flash_attention.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.semiring import fma_f32


def tropical_matmul_ref(a, b, av=None, gv=None, bv=None):
    """``C[..,i,j] = min_k fma(av[i]·gv[k], bv[j], A[i,k] + B[k,j])`` (the
    weighted term dropped when ``av`` is None) over the last two axes."""
    t = a[..., :, :, None] + b[..., None, :, :]
    if av is not None:
        t = fma_f32((av[..., :, None] * gv[..., None, :])[..., None],
                    bv[..., None, None, :], t)
    return t.amin(dim=-2)


def sdp_pipeline_ref(st0, offsets, op, n, block):
    """The blocked S-DP table (K1's oracle): ``core.sdp.solve_blocked`` on
    the first ``offsets[0]`` cells of ``st0``."""
    from repro_torch.core.sdp import solve_blocked

    return solve_blocked(st0[: offsets[0]], tuple(offsets), op, n, block=block)


def chunked_scan_ref(x, decay, h0):
    """``h_t = decay_t ⊙ h_{t-1} + x_t`` over the rows of x, decay: (T, D);
    h0: (D,), each step rounded once (the reference's jitted scan contracts
    it into a fused multiply-add). Returns (h_all (T, D), h_final (D,))."""
    h, rows = h0, []
    for t in range(x.shape[0]):
        h = fma_f32(decay[t], h, x[t])
        rows.append(h)
    return torch.stack(rows), h


def attention_ref(q, k, v, causal=True, scale=None):
    """Exact softmax attention, the logits times ``scale`` (divided by
    ``sqrt(D)`` when it is None). q: (B, H, Sq, D); k, v: (B, H, Sk, D) (kv
    already GQA-broadcast); the causal mask is aligned at the end (query i
    sees keys up to i + Sk - Sq)."""
    *_, sq, d = q.shape
    sk = k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d) if scale is None else logits * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(qi < ki, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
