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
bytes the reference's ``NamedSharding`` puts on its device. Its
``grads`` and ``train_step`` run the per-rank program of ``loss_fn``, its
gradient (``runtime.sharding.Tape``) and AdamW on every slot's shards.
:meth:`ShardedLM.of_rank` is one rank of it in a process of its own
(``runtime/distributed.py``): it holds only that rank's shards, and its
entry points run the same per-rank program once, with the rank's
communicator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dp.backends import resolve_device
from repro_torch.models import ssm
from repro_torch.models.layers import ParamDef, init_param_, rmsnorm
from repro_torch.models.transformer import (RESIDUAL, Block, block_defs, block_forward,
                                            cache_axes, empty_cache, train_group, whole_rows)
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
    # looked up in float32 where a gradient is wanted: the rows of a repeated
    # token are then summed in float32 and rounded once, where a bf16 table's
    # own lookup rounds the row to bf16 at every repeat of the token
    table = w.float() if w.requires_grad and torch.is_grad_enabled() else w
    if vocab is None:
        x = table[tokens].to(cd)
    else:
        rows = tokens - comm.share(vocab)[0] * w.shape[0]
        inside = (rows >= 0) & (rows < w.shape[0])
        x = table[rows.clamp(0, w.shape[0] - 1)].to(cd)
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


def _cutter(cfg, mesh: Mesh, rules: dict, index: tuple):
    """``cut(name, tensor)``: the slot at ``index``'s shard of a parameter,
    copied to the slot's device."""
    specs, parts = param_specs(cfg, mesh, rules), param_parts(cfg)
    coord = dict(zip(mesh.axis_names, index))

    def cut(name: str, t: torch.Tensor) -> torch.Tensor:
        return sharding.copy_to(sharding.piece(t.detach(), specs[name], coord, mesh.shape,
                                               parts.get(name)), mesh.slots[index])
    return cut


def place_params(named: dict, cfg, mesh: Mesh, rules: dict, index: tuple) -> dict:
    """The slot at ``index``'s shard of every parameter of ``named``
    (``{name: tensor}``), copied to the slot's device (nothing is allocated
    on ``meta``)."""
    cut = _cutter(cfg, mesh, rules, index)
    return {name: cut(name, t) for name, t in named.items()}


def draw_params(cfg, seed: int, device, take) -> None:
    """Each parameter of ``CausalLM.from_seed(cfg, seed, device)``, bit for
    bit, drawn whole from the same generator in the same order and handed
    to ``take(name, tensor)``, which keeps what it wants: no more than one
    whole parameter exists at a time."""
    defs = param_defs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, p in CausalLM(cfg, device="meta").named_parameters():
        whole = torch.empty(p.shape, dtype=p.dtype, device=device)
        init_param_(whole, defs[name], gen)
        take(name, whole)
        del whole


def drawn_params(cfg, seed: int, mesh: Mesh, rules: dict, index: tuple) -> dict:
    """The slot at ``index``'s shard of every parameter of
    ``CausalLM.from_seed(cfg, seed, device)`` on the slot's device, bit for
    bit, made there alone (:func:`draw_params`, each cut to the slot's
    piece)."""
    slot = mesh.slots[index]
    cut = _cutter(cfg, mesh, rules, index)
    out = {}
    with slot.scope():
        draw_params(cfg, seed, slot.device,
                    lambda name, whole: out.update({name: cut(name, whole)}))
    return out


def stage_params(cfg, seed: int, device, layers: Sequence[int]) -> tuple:
    """(the embedding table, the :class:`Block`\\ s of ``layers``) of
    ``CausalLM.from_seed(cfg, seed, device)``, bit for bit, drawn on
    ``device`` with nothing else kept (:func:`draw_params`): one stage of
    a pipeline of the model's layers."""
    blocks = [Block(cfg, i, device) for i in layers]
    dest = {f"layers.{b.i}.{n}": p for b in blocks for n, p in b.named_parameters()}
    embed = []

    def take(name, whole):
        if name in dest:
            dest[name].copy_(whole)
        elif name == "embed":
            embed.append(whole)

    with torch.no_grad():
        draw_params(cfg, seed, device, take)
    return embed[0], blocks


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

    ``grads`` and ``train_step`` run the reference's train step the same
    way: each slot its share of every microbatch through ``loss_fn``'s
    per-rank program under a ``Tape`` (collectives differentiated in the
    slot's thread, each layer group and cross-entropy chunk a remat
    region), the gradients of each parameter's copies summed, and AdamW on
    the slot's shards.

    ``moe_stats``, None by default, may be set to a dict: the MoE layers
    then count the (token, k) assignments and capacity drops of the whole
    batch there by mode, summed over the layers (``moe_stats[mode]``, see
    ``moe.moe_forward``; rank 0 keeps them).

    :meth:`of_rank` makes one rank of the model in a process of its own
    (``runtime.distributed.launch``): :attr:`comm` is the rank's
    ``ProcessComm``, the model holds its shards alone (``params``,
    caches, optimizer state and batches at its index only), and each
    entry point runs the per-rank program once, in the calling thread, as
    ``run`` runs it in each slot's. :meth:`grads` then returns the rank's
    gradient shards; ``gather_*`` need every shard and refuse."""

    def __init__(self, model: CausalLM, mesh: Mesh, rules: Optional[dict] = None):
        self._setup(model.cfg, mesh, rules)
        named = dict(model.named_parameters())
        for idx in np.ndindex(mesh.slots.shape):
            self.params[tuple(idx)] = place_params(named, self.cfg, mesh, self.rules, tuple(idx))

    @classmethod
    def of_rank(cls, cfg, comm, rules: Optional[dict] = None, seed: int = 0) -> "ShardedLM":
        """Rank ``comm.index`` of ``CausalLM.from_seed(cfg, seed)`` over
        ``comm.mesh``: its shards, drawn on the rank's device
        (:func:`drawn_params`)."""
        self = cls.__new__(cls)
        self._setup(cfg, comm.mesh, rules)
        self.comm = comm
        self.params[comm.index] = drawn_params(cfg, seed, comm.mesh, self.rules, comm.index)
        return self

    @classmethod
    def of_shards(cls, cfg, mesh: Mesh, rules: dict, shards: dict) -> "ShardedLM":
        """A sharded model over given shards: ``shards[index]`` a slot's
        ``{name: tensor}`` as :func:`place_params` makes them (the dry
        run's one rank on ``meta``)."""
        self = cls.__new__(cls)
        self._setup(cfg, mesh, rules)
        for idx, params in shards.items():
            self.params[tuple(idx)] = params
        return self

    def _setup(self, cfg, mesh: Mesh, rules: Optional[dict]) -> None:
        self.cfg, self.mesh = cfg, mesh
        self.moe_stats, self.comm = None, None
        self.rules = rules or sharding.make_rules(multi_pod="pod" in mesh.axis_names)
        self.specs = param_specs(self.cfg, mesh, self.rules)
        self.parts = param_parts(self.cfg)
        self.params = np.empty(mesh.slots.shape, dtype=object)
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
        """The mesh's first slot's device (a rank's own in :meth:`of_rank`)."""
        return self._slots()[0].device

    def _indices(self) -> list:
        """The indices of the slots this object holds shards for: every
        slot's, or a rank's own."""
        if self.comm is not None:
            return [self.comm.index]
        return [tuple(i) for i in np.ndindex(self.mesh.slots.shape)]

    def _slots(self) -> list:
        return [self.mesh.slots[i] for i in self._indices()]

    def _whole(self, what: str) -> None:
        if self.comm is not None:
            raise ValueError(f"{what} needs every rank's shards; a rank of its own process "
                             "holds its own (gather what the ranks report)")

    def gather_params(self) -> dict:
        """Every parameter whole on :attr:`device` (inverting the placement
        bit for bit)."""
        return {n: p.detach() for n, p in self.gather_named(self.params).items()}

    def empty_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> ShardedCache:
        _, specs = cache_specs(self.cfg, batch, max_len, dtype, self.mesh, self.rules)
        shards = np.empty(self.mesh.slots.shape, dtype=object)
        for idx in self._indices():
            shards[idx] = place_cache(self.cfg, batch, max_len, dtype, self.mesh,
                                      self.rules, idx)
        return ShardedCache(shards, specs)

    def gather_cache(self, cache: ShardedCache) -> list:
        """The cache whole on :attr:`device`, as ``CausalLM`` holds it."""
        self._whole("gather_cache")
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
    def _each(self, fn):
        """``fn(comm)`` under ``activate`` on every slot (``sharding.run``),
        or once with this rank's communicator; slot 0's result (the
        rank's own)."""
        with activate(self.mesh, self.rules):
            if self.comm is None:
                return sharding.run(self.mesh, fn).flat[0]
            with sharding.acting_as(self.comm), self.comm.slot.scope():
                return fn(self.comm)

    def _run(self, fn, *inputs):
        """:meth:`_each` after each slot's stream has waited for the work
        that made ``inputs``; slot 0's result, safe to read on the caller's
        stream."""
        slots = self._slots()
        for slot in slots:
            for t in inputs:
                if isinstance(t, torch.Tensor):
                    slot.follow(t)
        first = self._each(fn)
        return None if first is None else sharding.join(first, slots[0])

    def _gathered(self, comm, names: list) -> dict:
        """``{name: weight}``, this slot's, with the FSDP dims gathered (one
        all-gather over the FSDP axes; its adjoint a reduce-scatter): the
        weights as the layer's code reads them (specs ``_local_specs``)."""
        mine = self.params[comm.index]
        dims = {n: self._fsdp_dims[n] for n in names if n in self._fsdp_dims}
        out = {n: mine[n] for n in names}
        if dims:
            full = comm.all_gather(tuple(mine[n] for n in dims), self._fsdp, tuple(dims.values()))
            out.update(zip(dims, full))
        return out

    def _layer(self, comm, i: int) -> tuple:
        """(layer ``i``'s weights, their specs) nested as ``block_defs``."""
        names, specs = self._layers[i]
        return _nest(self._gathered(comm, names), f"layers.{i}."), specs

    def _forward_rank(self, comm, tokens, mode: str, cache: ShardedCache, pos, frontend):
        cfg = self.cfg
        dev = comm.device
        b_all, t = tokens.shape
        batch_spec = sharding.active_spec((b_all,), ("act_batch",))[0]
        tokens = hint(tokens.to(dev), ("act_batch", None))
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
        x = hint(x, RESIDUAL, src=(batch_spec, None, None))
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
        x = whole_rows(x, positions, comm, batch_spec)
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


    # ------------------------------------------------------------------
    # Training: the per-rank program of loss_fn and its gradient
    # ------------------------------------------------------------------
    def _group(self, comm, g0: int, x, aux, positions, batch_spec) -> tuple:
        """Layers g0 .. g0 + ``scan_period`` in mode "train": (x, aux plus
        their aux losses)."""
        for i in range(g0, g0 + self.cfg.scan_period):
            p, specs = self._layer(comm, i)
            x, a = block_forward(p, self.cfg, i, x, positions, "train", comm=comm, specs=specs,
                                 batch_spec=batch_spec)
            aux = aux + a
        return x, aux

    def _loss_rank(self, comm, batch: dict, batch_spec):
        """``loss_fn`` of the whole batch, on this slot's share of it
        (``batch``: tokens, labels, optional frontend and loss_mask, split
        along ``batch_spec``, the ``act_batch`` entry). Each group of
        ``scan_period`` layers and each chunk of the cross-entropy is a
        remat region of ``comm.tape`` when ``cfg.remat``. The loss is
        every slot's: the chunked cross-entropy over the vocab shards (the
        row max and Σexp taken over ``model``, the gold logit from the
        shard that holds it), its sum and mask count summed over
        ``batch_spec``'s axes before the division, and each MoE layer's aux
        loss over the whole batch."""
        cfg, dev = self.cfg, comm.device
        tokens, labels = batch["tokens"], batch["labels"]
        b, t = tokens.shape
        positions = torch.arange(t, device=dev).expand(b, t)
        x = embed_tokens(self._gathered(comm, ["embed"])["embed"], cfg, tokens,
                         batch.get("frontend"), comm, self.specs["embed"][0])
        x = hint(x, RESIDUAL, src=(batch_spec, None, None))
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        tape = comm.tape if cfg.remat else None
        for g0 in range(0, cfg.n_layers, cfg.scan_period):
            def group(x, aux, g0=g0):
                return self._group(comm, g0, x, aux, positions, batch_spec)
            x, aux = tape.remat(group, (x, aux)) if tape is not None else group(x, aux)
        x = whole_rows(x, positions, comm, batch_spec)
        x = rmsnorm(x, self.params[comm.index]["ln_f"], cfg.norm_eps)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        w = self._gathered(comm, [name])[name]
        w = w.T if cfg.tie_embeddings else w
        vocab = self.specs[name][0 if cfg.tie_embeddings else 1]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=dev)
            if cfg.n_frontend_tokens:
                mask[:, :cfg.n_frontend_tokens] = 0.0
        tot, cnt = sharded_xent(x, w, labels, mask, cfg.xent_chunk, comm, vocab, tape)
        tot, cnt = comm.all_reduce((tot, cnt), batch_spec)
        xent = tot / torch.clamp_min(cnt, 1.0)
        loss = xent + AUX_COEF * aux
        return loss, {"xent": xent, "aux": aux, "tokens": cnt}

    def _batch_spec(self, global_batch: int):
        return sharding.spec_for((global_batch,), ("act_batch",), self.rules, self.mesh.shape)[0]

    def rank_grads(self, comm, batches: list, global_batch: int,
                   accum_dtype=torch.float32) -> tuple:
        """The per-rank program of the reference's gradient-accumulating
        step (``launch/dryrun.py::make_train_step``) up to the optimizer:
        for each microbatch of ``batches`` (this slot's share of each, of
        ``global_batch`` rows in all), the loss under a :class:`Tape` and
        its backward (the loss seeded with 1 / slots); the gradients summed
        (in ``accum_dtype`` over more than one microbatch), then each
        parameter's summed over the mesh axes its spec does not shard
        (one all-reduce per set of axes) and divided by the microbatches.
        Returns ({name: this slot's gradient}, metrics)."""
        params = self.params[comm.index]
        for p in params.values():
            p.requires_grad_(True)
        batch_spec = self._batch_spec(global_batch)
        n, seed = len(batches), 1.0 / self.mesh.size
        acc, losses, auxes, metrics = {}, [], [], {}
        for batch in batches:
            tape = sharding.Tape(comm)
            comm.tape = tape
            try:
                with tape:
                    loss, metrics = self._loss_rank(comm, batch, batch_spec)
                tape.backward((loss,),
                              (torch.full((), seed, dtype=loss.dtype, device=loss.device),))
            finally:
                comm.tape = None
            losses.append(loss.detach())
            auxes.append(metrics["aux"].detach())
            for name, p in params.items():
                g = tape.grad(p)
                g = torch.zeros_like(p) if g is None else g
                if n > 1:
                    g = g.to(accum_dtype)
                acc[name] = g if name not in acc else acc[name] + g
            del tape
        for axes, names in self._replicated_axes().items():
            for name, g in zip(names, comm.all_reduce(tuple(acc[k] for k in names), axes)):
                acc[name] = g
        if n == 1:
            return acc, {"loss": losses[0], "xent": metrics["xent"].detach(),
                         "aux": auxes[0], "tokens": metrics["tokens"].detach()}
        acc = {k: g / n for k, g in acc.items()}
        loss = sum(losses[1:], losses[0]) / n
        return acc, {"loss": loss, "xent": loss, "aux": sum(auxes[1:], auxes[0]) / n,
                     "tokens": torch.zeros((), dtype=torch.float32, device=comm.device)}

    def _replicated_axes(self) -> dict:
        """``{mesh axes: parameter names}``: the axes each parameter's spec
        leaves unnamed (its copies), a group of more than one slot."""
        out: dict = {}
        for name, spec in self.specs.items():
            named = {a for e in spec for a in sharding.axes_of(e)}
            axes = tuple(a for a in self.mesh.axis_names
                         if a not in named and self.mesh.shape[a] > 1)
            if axes:
                out.setdefault(axes, []).append(name)
        return out

    def owned(self, comm) -> dict:
        """``{name: whether this slot counts its shard}``: the slot at index
        0 of every axis a parameter's spec leaves unnamed (one copy of each
        element in the mesh)."""
        out = {}
        for name, spec in self.specs.items():
            named = {a for e in spec for a in sharding.axes_of(e)}
            out[name] = all(comm.coord[a] == 0 for a in self.mesh.axis_names if a not in named)
        return out

    def rank_train_step(self, comm, opt_cfg, opt_state: dict, batches: list,
                        global_batch: int, accum_dtype=torch.float32,
                        grads_out: Optional[dict] = None) -> dict:
        """:meth:`rank_grads`, then AdamW on this slot's shards in place
        (``adamw.apply`` with the global gradient norm over every slot's
        owned elements). Returns the metrics with grad_norm and lr;
        ``grads_out``, where given, receives the slot's gradient shards at
        its index."""
        from repro_torch.optim import adamw

        grads, metrics = self.rank_grads(comm, batches, global_batch, accum_dtype)
        if grads_out is not None:
            grads_out[comm.index] = grads
        _, _, om = adamw.apply(opt_cfg, grads, opt_state, self.params[comm.index],
                               comm=comm, owned=self.owned(comm))
        return {**metrics, **om}

    def split_batch(self, batch: dict, microbatches: int = 1) -> tuple:
        """(the mesh-shaped array of each slot's list of microbatch shards,
        the rows of one microbatch): microbatch j is rows [j·B/m, (j+1)·B/m)
        of ``batch``, as the reference's reshape takes them, split over
        ``act_batch``'s axes and copied to each slot."""
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into {microbatches} "
                             "microbatches")
        b = rows // microbatches
        spec = self._batch_spec(b)
        out = np.empty(self.mesh.slots.shape, dtype=object)
        for idx in self._indices():
            coord = dict(zip(self.mesh.axis_names, idx))
            out[idx] = [{k: sharding.copy_to(sharding.piece(
                torch.as_tensor(v[j * b:(j + 1) * b]), (spec,), coord, self.mesh.shape),
                self.mesh.slots[idx]) for k, v in batch.items()} for j in range(microbatches)]
        return out, b

    def init_opt(self, opt_cfg) -> np.ndarray:
        """Each slot's AdamW state (``adamw.init`` of its shards, the
        moments in ``opt_cfg.moment_dtype``)."""
        from repro_torch.optim import adamw

        out = np.empty(self.mesh.slots.shape, dtype=object)
        for idx in self._indices():
            with self.mesh.slots[idx].scope():
                out[idx] = adamw.init(self.params[idx], opt_cfg.moment_dtype)
        return out

    def grads(self, batch: dict, microbatches: int = 1, accum_dtype=torch.float32) -> tuple:
        """(every parameter's gradient whole on :attr:`device`, slot 0's
        metrics): :meth:`rank_grads` on every slot, the shards gathered; in
        a rank of :meth:`of_rank`, (its gradient shards, its metrics)."""
        shards, b = self.split_batch(batch, microbatches)
        out = np.empty(self.mesh.slots.shape, dtype=object)

        def fn(comm):
            grads, metrics = self.rank_grads(comm, shards[comm.index], b, accum_dtype)
            out[comm.index] = grads
            return metrics

        metrics = self._each(fn)
        if self.comm is not None:
            return out[self.comm.index], metrics
        return self.gather_named(out), metrics

    def train_step(self, opt_cfg, opt_state: np.ndarray, batch: dict, microbatches: int = 1,
                   accum_dtype=torch.float32, grads_out: Optional[dict] = None) -> dict:
        """One step of the reference's train step over the mesh: every slot
        runs :meth:`rank_train_step` on its shards of each microbatch of
        ``batch`` (global tensors) and updates its parameters and
        ``opt_state[index]`` in place. Returns slot 0's metrics (every
        slot's are equal); ``grads_out``, where given, receives each slot's
        gradient shards by index."""
        shards, b = self.split_batch(batch, microbatches)
        return self._each(lambda comm: self.rank_train_step(
            comm, opt_cfg, opt_state[comm.index], shards[comm.index], b, accum_dtype,
            grads_out))

    def gather_named(self, shards: np.ndarray) -> dict:
        """Tensors placed as the parameters (``shards[index]`` a slot's
        ``{name: shard}``), each whole on :attr:`device`."""
        self._whole("gather_named")
        out = {}
        for name, spec in self.specs.items():
            arr = np.empty(self.mesh.slots.shape, dtype=object)
            for idx in np.ndindex(arr.shape):
                arr[idx] = shards[idx][name]
            out[name] = sharding.gather(arr, self.mesh, spec, parts=self.parts.get(name))
        return out


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


def _sharded_xent_chunk(h, w, labels, mask, comm, vocab):
    logits = (h @ w.to(h.dtype)).float()                              # (B, c, V shard)
    m = comm.all_max(logits.amax(dim=-1), vocab)
    lse = m + torch.log(comm.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), vocab))
    n = logits.shape[-1]
    rows = labels.long() - comm.share(vocab)[0] * n
    inside = (rows >= 0) & (rows < n)
    gold = logits.gather(-1, rows.clamp(0, n - 1)[..., None])[..., 0]
    gold = comm.all_reduce(torch.where(inside, gold, 0.0), vocab)
    return ((lse - gold) * mask).sum(), mask.sum()


def sharded_xent(hidden, w, labels, mask, chunk: int, comm, vocab, tape=None):
    """:func:`chunked_xent` on a slot: ``w`` (d, V shard) holds the slot's
    columns of the vocab split by spec entry ``vocab``. Each chunk's row
    max (not differentiated: the log Σexp does not depend on it) and Σexp
    are taken over ``vocab``'s axes, and the gold logit comes from the
    shard that holds it (zeros elsewhere, summed). Each chunk is a remat
    region of ``tape`` where one is given. Returns (sum_loss, sum_mask) of
    the slot's rows."""
    t = hidden.shape[1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sharded_xent: T={t} is not a multiple of the chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    for c0 in range(0, t, chunk):
        def part(h, w, c0=c0):
            return _sharded_xent_chunk(h, w, labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                                       comm, vocab)
        h = hidden[:, c0:c0 + chunk]
        s, n = tape.remat(part, (h, w)) if tape is not None else part(h, w)
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
