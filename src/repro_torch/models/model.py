"""Causal LM (port of ``repro/models/model.py``): parameters, forward in the
train, prefill and decode modes, the chunked cross-entropy and the loss,
prefill and decode steps.

Every block kind of the ten configs (``models/transformer.py``): dense,
MoE (``models/moe.py``), and the Mamba and RWKV6 mixers with their state
caches (``models/ssm.py``). The VLM and audio configs take precomputed
frontend embeddings (the reference's stubs: the modality encoder is out of
scope) that overwrite the first ``n_frontend_tokens`` positions and are
masked out of the loss. Training goes through ``ops.flash_attention``'s
gradient (K7 forward, K7b backward on the card).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dp.backends import resolve_device
from repro_torch.models.layers import ParamDef, init_param_, rmsnorm
from repro_torch.models.transformer import Block, block_defs, empty_cache, train_group

AUX_COEF = 0.01  # MoE load-balance loss coefficient


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
    def embed_tokens(self, tokens, frontend=None):
        """The token embeddings in the compute dtype; ``frontend`` (B, nf,
        d), where given, overwrites the first nf positions."""
        x = self.embed[tokens].to(self.cfg.compute_dtype)
        if frontend is not None:
            nf = frontend.shape[1]
            x = torch.cat([frontend.to(x.dtype), x[:, nf:]], dim=1)
        return x

    def forward(self, tokens, mode: str = "train", cache: list = None, pos=None,
                frontend=None):
        """tokens: (B, T) int; mode "train" or "prefill" (positions
        0..T-1), or "decode" (T = 1 at ``pos``). "train" returns (the final
        hidden states (B, T, d), the MoE aux loss summed over the layers,
        float32), each group of ``cfg.scan_period`` blocks under
        ``torch.utils.checkpoint`` when ``cfg.remat``; the other modes
        return the hidden states and fill or advance ``cache`` (from
        :meth:`empty_cache`) in place."""
        b, t = tokens.shape
        if mode == "decode":
            positions = torch.as_tensor(pos, dtype=torch.int64,
                                        device=tokens.device).expand(b)[:, None]
        else:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed_tokens(tokens, frontend)
        if mode == "train":
            aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
            period = self.cfg.scan_period
            for g0 in range(0, len(self.layers), period):
                group = self.layers[g0:g0 + period]
                if self.cfg.remat:
                    x, aux = checkpoint(train_group, group, x, aux, positions,
                                        use_reentrant=False)
                else:
                    x, aux = train_group(group, x, aux, positions)
            return rmsnorm(x, self.ln_f, self.cfg.norm_eps), aux
        for block, c in zip(self.layers, cache):
            x, _ = block(x, positions, mode, c, pos)
        return rmsnorm(x, self.ln_f, self.cfg.norm_eps)

    def unembed(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _last_logits(self, hidden):
        return (hidden[:, -1] @ self.unembed().to(hidden.dtype)).float()

    def empty_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
        return empty_cache(self.cfg, batch, max_len, dtype=dtype, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens, max_len: Optional[int] = None,
                cache_dtype=torch.bfloat16, frontend=None):
        """Process the prompt (its first positions replaced by ``frontend``
        where given), build the cache. Returns (last logits (B, V) float32,
        cache)."""
        b, t = tokens.shape
        cache = self.empty_cache(b, max_len or t, dtype=cache_dtype)
        hidden = self.forward(tokens, mode="prefill", cache=cache, frontend=frontend)
        return self._last_logits(hidden), cache

    @torch.no_grad()
    def decode_step(self, token, cache: list, pos):
        """token: (B, 1) int; pos: int or (B,) write positions. Advances
        ``cache`` in place; returns (logits (B, V) float32, cache)."""
        hidden = self.forward(token, mode="decode", cache=cache, pos=pos)
        return self._last_logits(hidden), cache


# ---------------------------------------------------------------------------
# Chunked cross-entropy and the loss
# ---------------------------------------------------------------------------
def _xent_chunk(h, w, labels, mask):
    logits = (h @ w.to(h.dtype)).float()                              # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(hidden, w, labels, mask, chunk: int):
    """hidden: (B, T, d); w: (d, V); labels (int64), mask: (B, T).

    Returns (sum_loss, sum_mask), float32; the caller divides. The logits
    are float32 one chunk of ``chunk`` positions at a time, each chunk
    under ``torch.utils.checkpoint``, so the backward recomputes its (B,
    chunk, V) logits instead of keeping every chunk's."""
    t = hidden.shape[1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"chunked_xent: T={t} is not a multiple of the chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    for c0 in range(0, t, chunk):
        s, n = checkpoint(_xent_chunk, hidden[:, c0:c0 + chunk], w, labels[:, c0:c0 + chunk],
                          mask[:, c0:c0 + chunk], use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot, cnt


def loss_fn(model: CausalLM, batch: dict):
    """batch: tokens (B, T), labels (B, T), optional frontend (B, nf, d),
    optional loss_mask (B, T), on the model's device. The default mask
    zeros the frontend positions. Returns (loss, {"xent", "aux",
    "tokens"}), loss = xent + ``AUX_COEF`` · aux."""
    cfg = model.cfg
    labels = batch["labels"]
    hidden, aux = model(batch["tokens"], mode="train", frontend=batch.get("frontend"))
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        if cfg.n_frontend_tokens:
            mask[:, :cfg.n_frontend_tokens] = 0.0
    tot, cnt = chunked_xent(hidden, model.unembed(), labels, mask, cfg.xent_chunk)
    xent = tot / torch.clamp_min(cnt, 1.0)
    loss = xent + AUX_COEF * aux
    return loss, {"xent": xent, "aux": aux, "tokens": cnt}
