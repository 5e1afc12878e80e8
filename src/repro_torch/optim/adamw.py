"""AdamW with global-norm clipping and float32 moments over bf16 params
(port of ``repro/optim/adamw.py``: the same rule, l.41-69).

Functions over a dict of parameters, as the reference's over its pytree:
``init`` builds the moments, ``apply`` takes one step. Unlike the
reference, ``apply`` updates the parameters and moments in place (at
phi3-mini's 3.8 B parameters a second copy of the 30.5 GB of float32
moments would not fit the card) and returns the same dicts. Each
parameter's update is computed in float32 and cast to its dtype:

    g = grad · min(1, clip / max(|grads|, 1e-9))
    m = b1·m + (1-b1)·g;   v = b2·v + (1-b2)·g·g
    u = (m/bc1) / (sqrt(v/bc2) + eps) + wd·p;   p = p - lr·u

``torch.optim.AdamW`` places eps and the decay elsewhere and rounds
differently, so it is not used.

Over a mesh of slots each slot calls ``apply`` on its own shards with its
communicator: the gradient norm then sums the squares of the elements the
slot owns (one copy of each in the mesh) and adds the slots' sums in slot
order. :func:`abstract_state` is the dry run's state: ``meta`` moments
beside one slot's ``meta`` shards.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch



@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # bf16 moments halve the optimizer's memory (the reference's rule:
    # the dry run takes them past 1e11 parameters)
    moment_dtype: torch.dtype = torch.float32


def init(params: dict, moment_dtype=torch.float32) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter, and the step
    (int32, on the parameters' device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    device = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(abstract_params: dict, moment_dtype=torch.float32) -> dict:
    """The optimizer state of ``abstract_params`` (one slot's ``meta``
    shards) on ``meta``: moments of their shapes in ``moment_dtype``."""
    mk = lambda p: torch.empty(p.shape, dtype=moment_dtype, device="meta")
    return {"m": {k: mk(p) for k, p in abstract_params.items()},
            "v": {k: mk(p) for k, p in abstract_params.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: dict, state: dict, params: dict, comm=None,
          owned: dict = None):
    """One step over every parameter, in place. Returns (params, state,
    {"grad_norm", "lr"}), the metrics float32 tensors on the device.

    Over a mesh ``comm`` is the slot's communicator and ``owned[name]``
    says whether the slot counts its shard of ``name`` in the norm (a
    shard replicated over some axes counts on one slot of them); the
    squares are summed over the mesh in slot order. Without them every
    gradient counts once."""
    step = state["step"] + 1
    sq = torch.zeros((), dtype=torch.float32, device=step.device)
    for name, g in grads.items():
        if owned is None or owned[name]:
            f = g.float()
            sq = sq + (f * f).sum()
    gnorm = torch.sqrt(sq if comm is None else comm.all_reduce(sq, comm.mesh.axis_names))
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)
    lr = cfg.lr(step)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * g * g
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
