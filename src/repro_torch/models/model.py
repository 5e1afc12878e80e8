"""Causal LM (port of ``repro/models/model.py``): parameters, forward in the
prefill and decode modes, prefill and decode steps.

Dense architectures only (``models/transformer.py``). The reference's
frontend-embedding stubs (VLM, audio) and training (``loss_fn``,
``chunked_xent``, the ``train`` mode) wait for later slices (ROADMAP queue
1 item 15).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.dp.backends import resolve_device
from repro_torch.models.layers import ParamDef, init_param_, rmsnorm
from repro_torch.models.transformer import Block, block_defs, empty_cache


def param_defs(cfg) -> dict:
    """Flat ``{parameter name: ParamDef}`` in the model's parameter order,
    named as ``CausalLM.named_parameters()`` names them."""
    defs = {"embed": ParamDef((cfg.vocab_size, cfg.d_model))}
    for i in range(cfg.n_layers):
        for part, sub in block_defs(cfg, i).items():
            if isinstance(sub, dict):
                defs.update({f"layers.{i}.{part}.{k}": d for k, d in sub.items()})
            else:
                defs[f"layers.{i}.{part}"] = sub
    defs["ln_f"] = ParamDef((cfg.d_model,), "ones")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size))
    return defs


class CausalLM(nn.Module):
    """The port's model. ``CausalLM(cfg, device)`` allocates the parameters
    uninitialised in ``cfg.param_dtype`` (``device="meta"`` allocates
    nothing); :meth:`from_seed` fills them from a seed."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        empty = (lambda shape: nn.Parameter(
            torch.empty(shape, dtype=cfg.param_dtype, device=device),
            requires_grad=False))
        self.embed = empty((cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList(Block(cfg, i, device) for i in range(cfg.n_layers))
        self.ln_f = empty((cfg.d_model,))
        self.lm_head = None if cfg.tie_embeddings else empty((cfg.d_model, cfg.vocab_size))

    @classmethod
    def from_seed(cls, cfg, seed: int = 0, device=None) -> "CausalLM":
        """Random weights from ``seed`` through a ``torch.Generator`` on the
        device (the card unless ``device`` says otherwise). Each parameter
        is drawn in float32 and cast on its own, so no more than one
        parameter ever exists in float32."""
        dev = resolve_device(device)
        model = cls(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        defs = param_defs(cfg)
        for name, p in model.named_parameters():
            init_param_(p, defs[name], gen)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    def embed_tokens(self, tokens):
        return self.embed[tokens].to(self.cfg.compute_dtype)

    def forward(self, tokens, mode: str, cache: list, pos=None):
        """tokens: (B, T) int; mode "prefill" (positions 0..T-1) or
        "decode" (T = 1 at ``pos``). Returns the final hidden states
        (B, T, d); ``cache`` (from :meth:`empty_cache`) is filled or
        advanced in place."""
        b, t = tokens.shape
        if mode == "decode":
            positions = torch.as_tensor(pos, dtype=torch.int64,
                                        device=tokens.device).expand(b)[:, None]
        else:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed_tokens(tokens)
        for block, c in zip(self.layers, cache):
            x = block(x, positions, mode, c, pos)
        return rmsnorm(x, self.ln_f, self.cfg.norm_eps)

    def unembed(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _last_logits(self, hidden):
        return (hidden[:, -1] @ self.unembed().to(hidden.dtype)).float()

    def empty_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
        return empty_cache(self.cfg, batch, max_len, dtype=dtype, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens, max_len: Optional[int] = None,
                cache_dtype=torch.bfloat16):
        """Process the prompt, build the cache. Returns (last logits (B, V)
        float32, cache)."""
        b, t = tokens.shape
        cache = self.empty_cache(b, max_len or t, dtype=cache_dtype)
        hidden = self.forward(tokens, mode="prefill", cache=cache)
        return self._last_logits(hidden), cache

    @torch.no_grad()
    def decode_step(self, token, cache: list, pos):
        """token: (B, 1) int; pos: int or (B,) write positions. Advances
        ``cache`` in place; returns (logits (B, V) float32, cache)."""
        hidden = self.forward(token, mode="decode", cache=cache, pos=pos)
        return self._last_logits(hidden), cache
