"""Streaming DP: table extension and the longest-prefix answer cache.

Interactive workloads grow one instance step by step — a parser fed one
token at a time, an alignment extended as reads stream in — and a cold
solve per step recomputes the whole table for a one-column answer. This
module is the warm-start layer over the spec families' extension hooks
(``problem.py``): given a solved prefix instance, only the extension is
recomputed, and the stitched table equals the cold solve of the full
instance bit for bit.

  * :class:`ResumeToken` — a solved prefix (spec + read-only table, and
    optionally a sticky route) that ``DPEngine.submit(..., resume=token)``
    and :func:`resume_solve` warm-start from.
  * :func:`resume_solve` — the single-call warm start (the engine's extend
    drains run the same steps per lane).
  * :class:`PrefixIndex` — the longest-prefix answer cache. Every solved
    instance is indexed under its *chained per-step digest*
    (``prefix_digest_chain``): equal digests at length L certify that two
    instances' prefixes are bit-identical up to L, so a lookup walks
    lengths n, n-1, … with one dict probe each and returns the longest
    solved prefix of the query, across sessions. Entries hold full tables;
    the capacity is an argument (LRU past it).

Contract: for every family, ``stitch_extension(prefix, prefix_table,
run_extend(spec, old_len, extension_state(prefix_table)))`` equals the cold
``run(spec)`` bit for bit, so caches, dedup and reconstruction treat warm
and cold results alike.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.dp import backends as _backends
from repro_torch.dp import problem as _problem
from repro_torch.dp import routing as _routing
from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.problem import Spec

__all__ = ["ChainCursor", "PrefixIndex", "ResumeToken", "StoredPrefix",
           "check_extends", "resume_solve"]

#: default entry capacity of a :class:`PrefixIndex`
PREFIX_INDEX_CAPACITY = 512

_log = _telemetry.get_logger("streaming")


class ChainCursor:
    """Incremental digest-chain state for one growing instance.

    ``prefix_digest_chain`` walks the whole instance — O(n) chained hash
    calls. A session that recomputed it on every append would pay that
    walk per step, swamping the O(k) extension solve it exists to enable.
    The cursor keeps the chain computed so far plus the spec it covers:
    :meth:`advance` certifies the prefix is unchanged with the family's
    ``content_extends`` check — an array memcmp against the retained spec
    (or a digest compare where layouts differ), no per-step work — then
    materializes and chains only the appended steps
    (``step_payloads(start=...)``). An edited prefix, a shrunk instance,
    or changed non-step parameters make ``advance`` return None — the
    caller starts a fresh cursor (the full walk) and loses nothing."""

    def __init__(self, spec: Spec):
        self.seed = spec.chain_seed()
        self.lo = spec.min_prefix_len()
        self.spec = spec
        self.chain, self.acc = _problem.chain_digests(
            self.seed, spec.step_payloads(), self.lo)
        self.length = spec.extend_length()

    def advance(self, spec: Spec) -> Optional[dict]:
        """The digest chain of ``spec``, given it extends this cursor's
        instance (the cursor moves to ``spec``); None when it does not
        (caller falls back to a full walk). Equal lengths are a valid
        no-growth advance — re-appending the same instance is a chain
        no-op feeding the full-hit path."""
        if spec.chain_seed() != self.seed:
            return None
        if spec.extend_length() < self.length:
            return None
        if not spec.content_extends(self.spec):
            return None
        fresh, self.acc = _problem.chain_digests(
            self.seed, spec.step_payloads(start=self.length), self.lo,
            base=self.length, acc=self.acc)
        self.chain = {**self.chain, **fresh}
        self.spec = spec
        self.length = spec.extend_length()
        return self.chain


@dataclasses.dataclass(frozen=True)
class ResumeToken:
    """A solved prefix instance to warm-start from.

    ``prefix_table`` is the full linearized table of ``prefix_spec``
    (frozen read-only — it is shared with caches and other consumers).
    ``affinity`` is the session-sticky backend name: extend drains honor
    it when that backend can extend the spec, so a session's lineage of
    growing shapes keeps hitting the route whose programs it already
    traced."""

    prefix_spec: Spec
    prefix_table: np.ndarray
    affinity: Optional[str] = None

    @property
    def old_len(self) -> int:
        return self.prefix_spec.extend_length()

    def state(self) -> dict:
        """The family-specific minimal resume payload for
        ``Backend.run_extend`` (see ``Spec.extension_state``)."""
        return self.prefix_spec.extension_state(self.prefix_table)


def check_extends(spec: Spec, token: ResumeToken) -> int:
    """Validate that ``token`` really is a solved prefix of ``spec``;
    returns the prefix length. Cheap structural checks first (family,
    shape lineage), then chain-digest equality at the prefix length —
    equal chains certify byte-identical prefix content, the invariant
    every downstream cache relies on."""
    old_len = token.old_len
    new_len = spec.extend_length()
    if not spec.min_prefix_len() <= old_len < new_len:
        raise ValueError(
            f"prefix length {old_len} cannot extend to {new_len} "
            f"(min prefix {spec.min_prefix_len()})")
    if spec.split_spec(old_len).shape_key() != token.prefix_spec.shape_key():
        raise ValueError("resume token's prefix spec is not a shape "
                         "prefix of the extended spec")
    ours = spec.prefix_digest_chain().get(old_len)
    theirs = token.prefix_spec.prefix_digest_chain().get(old_len)
    if ours is None or ours != theirs:
        raise ValueError("resume token's prefix content differs from the "
                         "extended instance's prefix (chain-digest "
                         "mismatch)")
    return old_len


def resume_solve(spec: Spec, token: ResumeToken, backend=None,
                 validate: bool = True, device=None) -> np.ndarray:
    """Warm-start solve on ``device`` (default: the card): extend
    ``token``'s solved prefix to ``spec`` and return the full table,
    bit-identical to a cold solve. With ``validate=False`` the prefix check
    (an O(n) digest chain walk) is skipped — only for callers that already
    certified the prefix, like the service's chain-indexed lookups."""
    device = _backends.resolve_device(device)
    old_len = check_extends(spec, token) if validate else token.old_len
    if backend is None and token.affinity is not None:
        for b in _routing.extend_candidates(spec, device):
            if b.name == token.affinity:
                backend = b
                break
    ext = _routing.run_extend(spec, old_len, token.state(), backend=backend,
                              device=device)
    return spec.stitch_extension(token.prefix_spec, token.prefix_table, ext)


@dataclasses.dataclass
class StoredPrefix:
    """One solved instance retained for future warm starts."""

    problem: str
    spec: Spec
    table: np.ndarray            # read-only
    backend: str
    length: int
    chain: bytes                 # digest chain value at ``length``

    def token(self, affinity: Optional[str] = None) -> ResumeToken:
        return ResumeToken(prefix_spec=self.spec, prefix_table=self.table,
                           affinity=affinity or self.backend)


class PrefixIndex:
    """Longest-prefix answer cache over chained per-step digests.

    Keyed by ``(problem, chain[L])``: the chain value at L commits to
    every step payload up to L *and* the family's non-step parameters,
    so a probe hit certifies the stored instance is a byte-identical
    prefix of the query — no table comparison needed. ``lookup`` probes
    lengths longest-first (each O(1)), returning the best warm start
    available; a hit at the query's own length is a *full* hit whose
    table answers the request outright.

    Entries hold full solved tables (that is what warm starts stitch
    against), so ``capacity`` bounds memory, LRU past it."""

    def __init__(self, capacity: int = PREFIX_INDEX_CAPACITY):
        if capacity < 1:
            raise ValueError("prefix index capacity must be >= 1")
        self.capacity = capacity
        self._map: "OrderedDict[tuple, StoredPrefix]" = OrderedDict()
        self.stats = {"puts": 0, "hits": 0, "full_hits": 0, "misses": 0}

    def __len__(self) -> int:
        return len(self._map)

    def put(self, problem: str, spec: Spec, table: np.ndarray,
            backend: str, chain: Optional[bytes] = None) -> StoredPrefix:
        """Index a solved instance. ``chain`` is its digest chain value
        at full length (recomputed when not passed through from the
        caller's own chain walk). The table is frozen — every future
        consumer shares the same array."""
        n = spec.extend_length()
        if chain is None:
            chain = spec.prefix_digest_chain()[n]
        tab = np.asarray(table)
        tab.setflags(write=False)
        ent = StoredPrefix(problem=problem, spec=spec, table=tab,
                           backend=backend, length=n, chain=chain)
        _backends.lru_put(self._map, (problem, chain), ent, self.capacity)
        self.stats["puts"] += 1
        return ent

    def lookup(self, problem: str, spec: Spec,
               chain: Optional[dict] = None) -> Optional[StoredPrefix]:
        """Longest stored prefix of ``spec`` (possibly ``spec`` itself —
        a full hit), or None. ``chain`` is ``spec.prefix_digest_chain()``
        when the caller already computed it."""
        if chain is None:
            chain = spec.prefix_digest_chain()
        for length in range(spec.extend_length(),
                            spec.min_prefix_len() - 1, -1):
            digest = chain.get(length)
            if digest is None:
                continue
            ent = self._map.get((problem, digest))
            if ent is not None and ent.length == length:
                self._map.move_to_end((problem, digest))
                self.stats["hits"] += 1
                if length == spec.extend_length():
                    self.stats["full_hits"] += 1
                return ent
        self.stats["misses"] += 1
        return None

    def snapshot(self) -> dict:
        total = self.stats["hits"] + self.stats["misses"]
        return {"size": len(self._map), "capacity": self.capacity,
                **self.stats,
                "hit_rate": (self.stats["hits"] / total) if total else 0.0}
