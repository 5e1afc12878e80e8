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

:meth:`CausalLM.place` puts a model over a mesh of slots
(``runtime/sharding.py``): :class:`ShardedLM`, whose ``prefill``,
``decode_step`` and ``empty_cache`` keep ``CausalLM``'s signatures and run
the per-rank program on every slot under ``activate``. Each parameter,
cache buffer and batch tensor is placed by ``spec_for`` of its logical
axes (``ParamDef.axes``, ``transformer.cache_axes``): each slot holds the
bytes the reference's ``NamedSharding`` puts on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dp.backends import resolve_device
from repro_torch.models import ssm
from repro_torch.models.layers import ParamDef, init_param_, rmsnorm
from repro_torch.models.transformer import (Block, block_defs, block_forward, cache_axes,
                                            empty_cache, train_group)
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import LOCAL, Mesh, activate, hint

AUX_COEF = 0.01  # MoE load-balance loss coefficient


def param_defs(cfg) -> dict:
    """Flat ``{parameter name: ParamDef}`` in the model's parameter order,
    named as ``CausalLM.named_parameters()`` names them."""
    defs = {"embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    for i in range(cfg.n_layers):
        for part, sub in block_defs(cfg, i).items():
            if isinstance(sub, dict):
                defs.update({f"layers.{i}.{part}.{k}": d for k, d in sub.items()})
            else:
                defs[f"layers.{i}.{part}"] = sub
    defs["ln_f"] = ParamDef((cfg.d_model,), (None,), "ones")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return defs


def embed_tokens(w, cfg, tokens, frontend=None, comm=LOCAL, vocab=None):
    """The token embeddings in the compute dtype; ``frontend`` (B, nf, d),
    where given, overwrites the first nf positions. Over a mesh ``w`` holds
    the slot's rows of the vocab split by spec entry ``vocab``: each slot
    looks the tokens up in its range (zeros elsewhere) and the slots sum
    over ``vocab``'s axes, exactly, since a token has one nonzero term."""
    cd = cfg.compute_dtype
    if vocab is None:
        x = w[tokens].to(cd)
    else:
        rows = tokens - comm.share(vocab)[0] * w.shape[0]
        inside = (rows >= 0) & (rows < w.shape[0])
        x = w[rows.clamp(0, w.shape[0] - 1)].to(cd)
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=cd, device=x.device))
        x = comm.all_reduce(x, vocab)
    if frontend is not None:
        nf = frontend.shape[1]
        x = torch.cat([frontend.to(x.dtype), x[:, nf:]], dim=1)
    return x


def last_logits(hidden, unembed):
    """The last position's logits (B, V), float32."""
    return (hidden[:, -1] @ unembed.to(hidden.dtype)).float()


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
        return embed_tokens(self.embed, self.cfg, tokens, frontend)

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
        return last_logits(hidden, self.unembed())

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

    @torch.no_grad()
    def insert_cache(self, big: list, small: list, row: int) -> None:
        """Copy a batch-1 cache (a prefill's) into row ``row`` of ``big``."""
        for b, s in zip(big, small):
            for name, buf in b.items():
                buf[row] = s[name][0]

    def place(self, mesh: Mesh, rules: Optional[dict] = None) -> "ShardedLM":
        """This model over ``mesh`` (rules: ``make_rules`` for the mesh's
        axes by default); the weights are copied to the slots."""
        return ShardedLM(self, mesh, rules)


# ---------------------------------------------------------------------------
# Over a mesh of slots
# ---------------------------------------------------------------------------
def param_specs(cfg, mesh: Mesh, rules: dict) -> dict:
    """``{parameter name: spec}`` by ``spec_for`` of each ParamDef's axes."""
    return {name: sharding.spec_for(d.shape, d.axes, rules, mesh.shape)
            for name, d in param_defs(cfg).items()}


def param_parts(cfg) -> dict:
    """``{parameter name: parts}`` of the weights whose ``ssm_inner`` dim
    concatenates parts (mamba's x | z and B | C), placed with whole heads
    of each part on every slot."""
    return {f"layers.{i}.mixer.{w}": (1, n) for i in range(cfg.n_layers)
            if cfg.mixer_of(i) == "mamba" for w, n in ssm.MAMBA_PARTS.items()}


def place_params(named: dict, cfg, mesh: Mesh, rules: dict, index: tuple) -> dict:
    """The slot at ``index``'s shard of every parameter of ``named``
    (``{name: tensor}``), copied to the slot's device (nothing is allocated
    on ``meta``)."""
    specs, parts = param_specs(cfg, mesh, rules), param_parts(cfg)
    coord = dict(zip(mesh.axis_names, index))
    return {name: sharding.copy_to(sharding.piece(t, specs[name], coord, mesh.shape,
                                                  parts.get(name)), mesh.slots[index])
            for name, t in named.items()}


def cache_specs(cfg, batch: int, max_len: int, dtype, mesh: Mesh, rules: dict) -> tuple:
    """(the cache's buffers on ``meta``, as :func:`empty_cache` makes them,
    and ``{name: spec}`` per layer by ``spec_for`` of ``cache_axes``)."""
    shapes = empty_cache(cfg, batch, max_len, dtype=dtype, device="meta")
    specs = [{name: sharding.spec_for(buf.shape, axes[name], rules, mesh.shape)
              for name, buf in layer.items()}
             for layer, axes in zip(shapes, cache_axes(cfg))]
    return shapes, specs


def place_cache(cfg, batch: int, max_len: int, dtype, mesh: Mesh, rules: dict,
                index: tuple) -> list:
    """The slot at ``index``'s shard of an empty cache, zeros on its
    device."""
    shapes, specs = cache_specs(cfg, batch, max_len, dtype, mesh, rules)
    coord, slot = dict(zip(mesh.axis_names, index)), mesh.slots[index]
    with slot.scope():
        return [{name: torch.zeros(sharding.piece(buf, spec[name], coord, mesh.shape).shape,
                                   dtype=buf.dtype, device=slot.device)
                 for name, buf in layer.items()} for layer, spec in zip(shapes, specs)]


def _nest(flat: dict, prefix: str) -> dict:
    """``{prefix + "part.leaf": v}`` -> ``{part: {leaf: v}}`` (``{part: v}``
    for a name with no leaf)."""
    out: dict = {}
    for name, v in flat.items():
        part, _, leaf = name[len(prefix):].partition(".")
        if leaf:
            out.setdefault(part, {})[leaf] = v
        else:
            out[part] = v
    return out


@dataclasses.dataclass
class ShardedCache:
    """A cache over a mesh: ``shards[index]`` the slot's list of per-layer
    dicts, ``specs`` the per-layer ``{name: spec}`` it is placed by."""
    shards: np.ndarray
    specs: list


class ShardedLM:
    """A :class:`CausalLM` over a mesh of slots (:meth:`CausalLM.place`).

    ``prefill``, ``decode_step`` and ``empty_cache`` keep ``CausalLM``'s
    signatures (tokens and positions on :attr:`device`, the mesh's first
    slot's; the logits, replicated, come back there). Each runs the
    per-rank program once a slot in a thread of its own
    (``runtime.sharding.run``) under ``activate``: the batch shards over
    ``data``, the vocab-sharded embedding is looked up in each slot's vocab
    range and summed over ``model``, each layer's FSDP shards (``embed``
    on ``data``) are gathered before use and freed after, and
    ``transformer.block_forward`` runs the layer. A slot's failure raises
    out of the call.

    ``moe_stats``, None by default, may be set to a dict: the MoE layers
    then count the (token, k) assignments and capacity drops of the whole
    batch there by mode, summed over the layers (``moe_stats[mode]``, see
    ``moe.moe_forward``)."""

    def __init__(self, model: CausalLM, mesh: Mesh, rules: Optional[dict] = None):
        self.cfg, self.mesh = model.cfg, mesh
        self.moe_stats = None
        self.rules = rules or sharding.make_rules(multi_pod="pod" in mesh.axis_names)
        self.specs = param_specs(self.cfg, mesh, self.rules)
        self.parts = param_parts(self.cfg)
        named = dict(model.named_parameters())
        self.params = np.empty(mesh.slots.shape, dtype=object)
        for idx in np.ndindex(mesh.slots.shape):
            self.params[idx] = place_params(named, self.cfg, mesh, self.rules, idx)
        self._fsdp = self.rules["embed"][0]
        # the FSDP dims (any entry but "model"), gathered before use
        self._fsdp_dims = {n: d for n, spec in self.specs.items()
                           for d, e in enumerate(spec) if e not in (None, "model")}
        self._local_specs = {n: tuple(e if e in (None, "model") else None for e in spec)
                             for n, spec in self.specs.items()}
        self._layers = []
        for i in range(self.cfg.n_layers):
            prefix = f"layers.{i}."
            names = [n for n in self.specs if n.startswith(prefix)]
            self._layers.append((names, _nest({n: self._local_specs[n] for n in names}, prefix)))

    @property
    def device(self) -> torch.device:
        return self.mesh.slots.flat[0].device

    def gather_params(self) -> dict:
        """Every parameter whole on :attr:`device` (inverting the placement
        bit for bit)."""
        out = {}
        for name, spec in self.specs.items():
            arr = np.empty(self.mesh.slots.shape, dtype=object)
            for idx in np.ndindex(arr.shape):
                arr[idx] = self.params[idx][name]
            out[name] = sharding.gather(arr, self.mesh, spec, parts=self.parts.get(name))
        return out

    def empty_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> ShardedCache:
        _, specs = cache_specs(self.cfg, batch, max_len, dtype, self.mesh, self.rules)
        shards = np.empty(self.mesh.slots.shape, dtype=object)
        for idx in np.ndindex(shards.shape):
            shards[idx] = place_cache(self.cfg, batch, max_len, dtype, self.mesh,
                                      self.rules, idx)
        return ShardedCache(shards, specs)

    def gather_cache(self, cache: ShardedCache) -> list:
        """The cache whole on :attr:`device`, as ``CausalLM`` holds it."""
        out = []
        for i, specs in enumerate(cache.specs):
            layer = {}
            for name, spec in specs.items():
                arr = np.empty(self.mesh.slots.shape, dtype=object)
                for idx in np.ndindex(arr.shape):
                    arr[idx] = cache.shards[idx][i][name]
                layer[name] = sharding.gather(arr, self.mesh, spec)
            out.append(layer)
        return out

    # ------------------------------------------------------------------
    def _run(self, fn, *inputs):
        """``fn(comm)`` on every slot under ``activate``, after each slot's
        stream has waited for the work that made ``inputs``; returns slot
        0's result, safe to read on the caller's stream."""
        for slot in self.mesh.slots.flat:
            for t in inputs:
                if isinstance(t, torch.Tensor):
                    slot.follow(t)
        with activate(self.mesh, self.rules):
            out = sharding.run(self.mesh, fn)
        first = out.flat[0]
        return None if first is None else sharding.join(first, self.mesh.slots.flat[0])

    def _gathered(self, comm, names: list) -> dict:
        """``{name: weight}``, this slot's, with the FSDP dims gathered: the
        weights as the layer's code reads them (specs ``_local_specs``)."""
        mine = self.params[comm.index]
        dims = {n: self._fsdp_dims[n] for n in names if n in self._fsdp_dims}
        got = comm.exchange({n: mine[n] for n in dims}, self._fsdp) if dims else []
        return {n: (torch.cat([g[n].to(comm.device) for g in got], dim=dims[n])
                    if n in dims else mine[n]) for n in names}

    def _layer(self, comm, i: int) -> tuple:
        """(layer ``i``'s weights, their specs) nested as ``block_defs``."""
        names, specs = self._layers[i]
        return _nest(self._gathered(comm, names), f"layers.{i}."), specs

    def _forward_rank(self, comm, tokens, mode: str, cache: ShardedCache, pos, frontend):
        cfg = self.cfg
        dev = comm.device
        b_all, t = tokens.shape
        batch_spec = sharding.active_spec((b_all,), ("act_batch",))[0]
        tokens = hint(tokens.to(dev), ("act_batch", "act_seq"))
        b = tokens.shape[0]
        if mode == "decode":
            pos = hint(pos.to(dev), ("act_batch",))
            positions = pos[:, None]
        else:
            positions = torch.arange(t, device=dev).expand(b, t)
        if frontend is not None:
            frontend = hint(frontend.to(dev), ("act_batch", None, None))
        x = embed_tokens(self._gathered(comm, ["embed"])["embed"], cfg, tokens, frontend,
                         comm, self.specs["embed"][0])
        x = hint(x, ("act_batch", "act_seq", "act_embed"), src=(batch_spec, None, None))
        stats = None
        if self.moe_stats is not None:   # slot 0 keeps the counts: every slot has the totals
            stats = self.moe_stats.setdefault(mode, {}) if comm.rank == 0 else {}
        shards = cache.shards[comm.index]
        for i in range(cfg.n_layers):
            p, specs = self._layer(comm, i)
            x, _ = block_forward(p, cfg, i, x, positions, mode, shards[i], pos, stats=stats,
                                 comm=comm, specs=specs, cache_specs=cache.specs[i],
                                 batch_spec=batch_spec)
            del p
        x = rmsnorm(x, self.params[comm.index]["ln_f"], cfg.norm_eps)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        w = self._gathered(comm, [name])[name]
        logits = last_logits(x, w.T if cfg.tie_embeddings else w)
        vocab = self.specs[name][0 if cfg.tie_embeddings else 1]
        return hint(logits, (None, None), src=(batch_spec, vocab))

    @torch.no_grad()
    def prefill(self, tokens, max_len: Optional[int] = None,
                cache_dtype=torch.bfloat16, frontend=None):
        """As :meth:`CausalLM.prefill`; the cache is a :class:`ShardedCache`."""
        b, t = tokens.shape
        cache = self.empty_cache(b, max_len or t, dtype=cache_dtype)
        logits = self._run(lambda comm: self._forward_rank(
            comm, tokens, "prefill", cache, None, frontend), tokens, frontend)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token, cache: ShardedCache, pos):
        """As :meth:`CausalLM.decode_step`, on a :class:`ShardedCache`."""
        pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
        pos = pos.expand(token.shape[0]).contiguous()
        logits = self._run(lambda comm: self._forward_rank(
            comm, token, "decode", cache, pos, None), token, pos)
        return logits, cache

    @torch.no_grad()
    def insert_cache(self, big: ShardedCache, small: ShardedCache, row: int) -> None:
        """Write a batch-1 cache (a prefill's) into row ``row`` of ``big``:
        a re-placement, since ``spec_for`` spreads the batch-1 cache's
        sequence over both axes where ``big``'s rows take ``data``."""
        def fn(comm):
            for i, specs in enumerate(big.specs):
                mine, theirs = big.shards[comm.index][i], small.shards[comm.index][i]
                for name, buf in mine.items():
                    spec = specs[name]
                    x = sharding.reshard(theirs[name], small.specs[i][name],
                                         (None,) + spec[1:], comm)
                    r = row - comm.share(spec[0])[0] * buf.shape[0]
                    if 0 <= r < buf.shape[0]:
                        buf[r] = x[0]

        self._run(fn)


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
