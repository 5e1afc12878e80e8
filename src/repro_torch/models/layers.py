"""Shared neural layers (port of ``repro/models/layers.py``): RMSNorm, RoPE,
SwiGLU, and the parameter definitions with their sharding axes and
initialiser."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape, logical sharding axes (one name per dim, see
    ``runtime/sharding.py``) and initialiser of one parameter: ``normal``
    (N(0, scale²)), ``small_normal`` (N(0, (scale/10)²)), ``ones`` or
    ``zeros``."""
    shape: tuple
    axes: tuple
    init: str = "normal"
    scale: float = 0.02


@torch.no_grad()
def init_param_(p: torch.Tensor, d: ParamDef, generator: torch.Generator) -> None:
    """Fill ``p`` in place by ``d``'s kind. A normal draw is made in float32
    on ``p``'s device, one parameter at a time, and cast to ``p``'s dtype."""
    if d.init == "zeros":
        p.zero_()
    elif d.init == "ones":
        p.fill_(1.0)
    elif d.init in ("normal", "small_normal"):
        s = d.scale if d.init == "normal" else d.scale * 0.1
        draw = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                           device=p.device)
        p.copy_(draw.mul_(s))
    else:
        raise ValueError(f"unknown init kind {d.init!r}")


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMS norm over the last axis, computed in float32, cast back."""
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """x: (..., T, H, D); positions: (..., T) int. Rotates the two halves
    of the head (``x1 = x[..., :D/2]`` with ``x2 = x[..., D/2:]``), as the
    reference's code does (its docstring says pairs (2i, 2i+1))."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs              # (..., T, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    """SiLU in float32, cast back."""
    return torch.nn.functional.silu(x.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, compute_dtype):
    g = x @ w_gate.to(compute_dtype)
    u = x @ w_up.to(compute_dtype)
    return (silu(g) * u) @ w_down.to(compute_dtype)
