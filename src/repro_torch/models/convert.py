"""Carry weights and caches across from the reference's trees (numpy).

The reference stacks each layer-pattern position ``j`` of a period as
``groups["b<j>"]`` with a leading ``(n_groups, …)`` axis; the port keeps
one block per layer, so group ``g``, position ``j`` is layer
``g·period + j``. Arrays come as numpy (``np.asarray`` of the JAX leaves);
bfloat16 leaves (``ml_dtypes``) are carried through float32, exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import CausalLM


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _unstack(tree: dict, cfg) -> dict:
    """``{"b<j>": {... (n_groups, …)}}`` -> ``{layer: {path: array}}``."""
    period = cfg.scan_period
    out: dict = {}

    def walk(node, prefix, j):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.", j)
            else:
                for g in range(val.shape[0]):
                    out.setdefault(g * period + j, {})[prefix + key] = val[g]

    for name, sub in tree.items():
        walk(sub, "", int(name[1:]))
    return out


def reference_flat(params_np: dict, cfg) -> dict:
    """The reference's parameter tree (or a tree of its shape, such as its
    gradients) as ``{port parameter name: array}``."""
    flat = {"embed": params_np["embed"], "ln_f": params_np["ln_f"]}
    if not cfg.tie_embeddings:
        flat["lm_head"] = params_np["lm_head"]
    for i, leaves in _unstack(params_np["groups"], cfg).items():
        flat.update({f"layers.{i}.{k}": v for k, v in leaves.items()})
    return flat


def params_from_reference(params_np: dict, cfg, device) -> CausalLM:
    """A :class:`CausalLM` holding the reference's weights, in
    ``cfg.param_dtype`` on ``device``."""
    model = CausalLM(cfg, device=device)
    flat = reference_flat(params_np, cfg)
    own = dict(model.named_parameters())
    if set(own) != set(flat):
        raise ValueError(f"parameter names differ: port only {sorted(set(own) - set(flat))}, "
                         f"reference only {sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            src = _tensor(flat[name], device, p.dtype)
            if src.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return model


def cache_from_reference(cache_np: dict, cfg, device) -> list:
    """The reference's stacked cache as the port's per-layer list of dicts."""
    layers = _unstack(cache_np, cfg)
    return [{k: _tensor(v, device) for k, v in layers[i].items()}
            for i in range(cfg.n_layers)]
