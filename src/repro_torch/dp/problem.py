"""Declarative DP problem specs — the contract between the problem zoo and
the solver routes.

A *spec* is the canonical, fully-materialized numpy form of one problem
instance. Spec classes form an open **family protocol**: each family (a
dataclass with a ``family`` tag) registers itself via
:func:`register_family` and carries its behaviour as hooks on the class —
shape keys, the route cost vocabulary, digest hashing, argument and
traceback support, and the static schedule gate's dependency model and
probe instances (``schedule_model``, ``probe_specs``) — so the routing,
reconstruction and analysis layers stay family-agnostic.

``LinearSpec`` — the paper's (weighted) S-DP recurrence on a 1-D table,

    ST[i] = ⊕_{1≤j≤k} ( ST[i - a_j] ⊙ w[i, j] ),   ST[0..a_1-1] preset,

  with ``(⊕, ⊙)`` the semiring whose ``add`` is ``op`` (min→min-plus,
  max→max-plus, add→plus-times) and ``w ≡ one`` when ``weights`` is None.

``TriangularSpec`` — the canonical split recurrence on the upper triangle,
  diagonal-major linearized like the paper's MCM table,

    m[i, j] = min_{0≤e<d} ( m[i, i+e] + m[i+e+1, j] + W[lin(i,d), e] ),

  diagonal-0 cells preset to 0; MCM-shaped specs also carry ``dims``.

``GridSpec`` — multi-plane 2-D wavefronts: alignment grids filled one
  anti-diagonal at a time (``antidiag``) and parse charts filled one span
  diagonal at a time (``spandiag``); see the class docstring.

Specs, digests and answers are byte-compatible with ``repro.dp``'s:
:func:`spec_from_reference` converts a ``repro`` spec by duck typing, and
:func:`spec_digest` of a port spec equals ``repro``'s of the same instance.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, ClassVar, Optional, Union

import numpy as np


# --- canonical triangular layout (the paper's diagonal-major linearization) --
def num_cells(n: int) -> int:
    return n * (n + 1) // 2


def lin_index(i, d, n):
    """Diagonal-major linear index of cell (i, i+d) in an n-wide table."""
    return d * n - (d * (d - 1)) // 2 + i


# --- the family registry -----------------------------------------------------
#: family tag -> spec class
FAMILIES: dict = {}


def register_family(cls):
    """Register a spec family class (keyed by its ``family`` tag)."""
    if cls.family in FAMILIES:
        raise ValueError(f"duplicate spec family {cls.family!r}")
    FAMILIES[cls.family] = cls
    return cls


def family_class(tag: str):
    """Spec class of a family tag (the first element of a shape_key)."""
    try:
        return FAMILIES[tag]
    except KeyError:
        raise KeyError(f"unknown spec family {tag!r}; "
                       f"registered: {sorted(FAMILIES)}") from None


# --- shared cost-vocabulary constants (see route_costs hooks) ---------------
def _log2(x: float) -> float:
    return math.log2(max(x, 2.0))


#: n below which the analytical prior prices fixed dispatch overhead (the
#: solve itself is a handful of steps there)
_SMALL_N = 16
#: per-route fixed-overhead floors, in 'vectorized device steps'
_LINEAR_OVERHEAD = {"sequential": 0.0, "tournament": 8.0, "pipeline": 8.0,
                    "blocked": 6.0, "companion_scan": 16.0}
_TRIANGULAR_OVERHEAD = {"wavefront": 0.0, "mcm_pipeline": 64.0,
                        "blocked_mcm": 24.0, "tiled_wavefront": 0.0}
_GRID_OVERHEAD = {"grid_wavefront": 0.0}


def _floored(costs: dict, overhead: dict, n: int) -> dict:
    if n <= _SMALL_N:
        costs = {name: c + overhead[name] for name, c in costs.items()}
    return {name: max(1.0, c) for name, c in costs.items()}


# --- the batched walks' host side (see the traceback_program hooks) --------
def _host(tensors) -> list:
    """A walk's small result tensors, of one shape, as int64 numpy arrays
    (one copy to the host)."""
    import torch

    return list(torch.stack([t.to(torch.int64) for t in tensors]).cpu().numpy())


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Weighted S-DP instance: table length ``n``, strictly-decreasing
    ``offsets``, semigroup ``op``, ``init`` of length a_1, optional
    ``(n, k)`` semiring ``weights``."""

    offsets: tuple
    op: str
    n: int
    init: np.ndarray
    weights: Optional[np.ndarray] = None

    family: ClassVar[str] = "linear"
    #: whether traceback entry points (problem ``start`` hooks) apply
    uses_start: ClassVar[bool] = True

    @property
    def geometry(self) -> str:
        return self.family

    def shape_key(self) -> tuple:
        """Instances with equal keys batch into one launch."""
        return ("linear", self.op, tuple(int(a) for a in self.offsets),
                int(self.n), self.weights is not None)

    def validate(self) -> None:
        a = np.asarray(self.offsets)
        if not (a.ndim == 1 and a.size and np.all(np.diff(a) < 0) and a[-1] > 0):
            raise ValueError(f"offsets must be strictly decreasing > 0: {self.offsets}")
        if len(self.init) != int(a[0]):
            raise ValueError(f"init must have a_1={int(a[0])} entries, got {len(self.init)}")
        if self.n <= int(a[0]):
            raise ValueError(f"n={self.n} must exceed a_1={int(a[0])}")
        if self.weights is not None and self.weights.shape != (self.n, a.size):
            raise ValueError(f"weights must be (n, k)=({self.n}, {a.size}), "
                             f"got {self.weights.shape}")

    # --- family protocol hooks ---------------------------------------------
    def digest_into(self, h) -> None:
        h.update(b"linear")
        h.update(self.op.encode())
        h.update(repr(tuple(int(a) for a in self.offsets)).encode())
        h.update(str(int(self.n)).encode())
        _hash_array(h, self.init)
        _hash_array(h, self.weights)

    @classmethod
    def shape_key_size(cls, key: tuple) -> int:
        return int(key[3])

    @classmethod
    def shape_key_compatible(cls, a: tuple, b: tuple) -> bool:
        """Same program modulo table length: op, offsets, and weightedness
        must match."""
        return len(a) == len(b) and (a[1], a[2], a[4]) == (b[1], b[2], b[4])

    @classmethod
    def from_shape_key(cls, key: tuple) -> "LinearSpec":
        _, op, offsets, n, weighted = key
        offsets = tuple(int(a) for a in offsets)
        n, k = int(n), len(offsets)
        return cls(offsets=offsets, op=op, n=n,
                   init=np.zeros(offsets[0], np.float32),
                   weights=np.zeros((n, k), np.float32) if weighted else None)

    def route_costs(self) -> dict:
        """Step-count cost model of the linear routes (paper §III), in
        'vectorized device steps', floored at one step; below ``_SMALL_N``
        each route also pays its fixed dispatch overhead."""
        n, k = self.n, len(self.offsets)
        a1, ak = int(self.offsets[0]), int(self.offsets[-1])
        blocked_steps = max(1, math.ceil((n - a1) / max(1, min(ak, 512))))
        costs = {
            "sequential": float(n * k),
            "tournament": float(n * (1.0 + _log2(k))),
            "pipeline": float(n + k - a1 - 1),
            "blocked": blocked_steps * (1.0 + _log2(k)),
            # log-depth scan, O(n·a1³) work spread over the vector units
            "companion_scan": _log2(n) * (a1 ** 3) / 64.0 + a1,
        }
        return _floored(costs, _LINEAR_OVERHEAD, n)

    def schedule_model(self):
        """Ground-truth dependency structure for the schedule-hazard
        verifier (``repro_torch.analysis``): candidate ``j`` of cell ``c``
        reads the single operand ``c - a_{j+1}``; cells ``< a_1`` are
        preset."""
        from repro_torch.dp.schedule import DependencyModel

        a1 = int(self.offsets[0])
        cands = tuple(
            () if c < a1 else tuple((c - int(a),) for a in self.offsets)
            for c in range(self.n))
        return DependencyModel(
            label=f"linear(offsets={tuple(int(a) for a in self.offsets)}, "
                  f"n={self.n}, op={self.op})",
            cells=self.n, preset=frozenset(range(a1)), candidates=cands)

    @classmethod
    def probe_specs(cls) -> tuple:
        """Small valid instances the static analyzer verifies every
        registered route against (exhaustive symbolic simulation stays
        trivial at these sizes). Coverage: multi-offset, weighted deep
        fan-in, single-offset degenerate, and a non-selective op (the
        linter's ``supports_args`` probe)."""

        def mk(offsets, n, weighted=False, op="min"):
            return cls(offsets=offsets, op=op, n=n,
                       init=np.zeros(offsets[0], np.float32),
                       weights=(np.ones((n, len(offsets)), np.float32)
                                if weighted else None))

        return (mk((2, 1), 6), mk((3, 2, 1), 8, weighted=True),
                mk((1,), 4), mk((2, 1), 6, op="add"))

    def supports_args(self) -> bool:
        """Linear specs need a selective semigroup (min/max)."""
        return self.op in ("min", "max")

    def args_unsupported_reason(self) -> str:
        return f"op={self.op!r} folds every lane"

    def default_start(self, table) -> int:
        return self.n - 1

    def args_from_table(self, table: np.ndarray) -> np.ndarray:
        from repro_torch.core.sdp import linear_args_np

        return linear_args_np(table, self.offsets, self.op,
                              weights=self.weights)

    def traceback_host(self, args: np.ndarray, start: int = -1) -> "Path":
        from repro_torch.core.sdp import linear_traceback_np

        cells, lanes, stop = linear_traceback_np(
            args, self.offsets, start if start >= 0 else self.n - 1)
        return LinearPath(cells=cells, lanes=lanes, stop=int(stop))

    def traceback_program(self):
        """The batched walk: ``walk(args, starts)`` walks a same-shape
        bucket's ``(batch, cells)`` arg tensor where it lies and returns the
        per-instance :class:`LinearPath`s; only the paths come back to the
        host."""
        import torch

        from repro_torch.core.sdp import linear_traceback

        offsets, n = self.offsets, self.n

        def walk(args, starts):
            B = args.shape[0]
            start = torch.as_tensor(np.asarray(
                [n - 1] * B if starts is None else starts, np.int64),
                device=args.device)
            cells, lanes, count = linear_traceback(args, offsets, n, start)
            cells, lanes, count = _host([cells, lanes, count[:, None].expand_as(cells)])
            return [LinearPath(cells=c[:k], lanes=la[:k], stop=int(c[k]))
                    for c, la, k in zip(cells, lanes, count[:, 0])]

        return walk

    # --- streaming/extension hooks ------------------------------------------
    def extend_length(self) -> int:
        """Steps along the growth axis (appendable table cells)."""
        return int(self.n)

    def min_prefix_len(self) -> int:
        """Smallest valid prefix length along the growth axis."""
        return int(self.offsets[0]) + 1

    def split_spec(self, length: int) -> "LinearSpec":
        """The first ``length`` steps as a standalone spec: its cold table
        is exactly the first ``length`` cells of this spec's (cell i reads
        only cells < i and weight row i)."""
        length = int(length)
        if not self.min_prefix_len() <= length <= self.n:
            raise ValueError(f"prefix length {length} outside "
                             f"[{self.min_prefix_len()}, {self.n}]")
        w = (None if self.weights is None
             else np.ascontiguousarray(self.weights[:length]))
        return dataclasses.replace(self, n=length, weights=w)

    def extension_delta(self, prefix: "LinearSpec") -> dict:
        """The delta turning ``prefix`` into ``self``; raises unless
        ``prefix`` is a strict bitwise prefix of this spec."""
        if (not isinstance(prefix, LinearSpec)
                or (prefix.op, tuple(prefix.offsets))
                != (self.op, tuple(self.offsets))
                or not prefix.n < self.n
                or not _same_array(prefix.init, self.init)
                or (prefix.weights is None) != (self.weights is None)
                or (self.weights is not None
                    and not _same_array(prefix.weights,
                                        self.weights[:prefix.n]))):
            raise ValueError("spec is not a bitwise extension of the prefix")
        tail = (None if self.weights is None
                else np.ascontiguousarray(self.weights[prefix.n:]))
        return {"steps": int(self.n - prefix.n), "weights": tail}

    def extend_spec(self, delta: dict) -> "LinearSpec":
        """Append ``delta['steps']`` cells (and their weight rows)."""
        k = int(delta["steps"])
        if k < 1:
            raise ValueError(f"extension must append at least one step, got {k}")
        tail = delta.get("weights")
        if (tail is None) != (self.weights is None):
            raise ValueError("extension weights must match the spec's "
                             "weightedness")
        w = None
        if self.weights is not None:
            tail = np.asarray(tail, dtype=self.weights.dtype)
            if tail.shape != (k, len(self.offsets)):
                raise ValueError(f"extension weights must be "
                                 f"({k}, {len(self.offsets)}), got {tail.shape}")
            w = np.concatenate([self.weights, tail])
        ext = dataclasses.replace(self, n=self.n + k, weights=w)
        ext.validate()
        return ext

    def extension_state(self, table, args=None) -> dict:
        """Minimal resume payload: the last a₁ cells (extension cell i ≥ n
        reads only cells i - a_j ≥ n - a₁)."""
        a1 = int(self.offsets[0])
        return {"suffix": np.array(np.asarray(table)[-a1:])}

    def prefix_cell_map(self, prefix: "LinearSpec") -> np.ndarray:
        """Extended-layout cell id of every prefix-layout cell."""
        return np.arange(prefix.n, dtype=np.int64)

    def saved_state_cells(self, prefix: "LinearSpec") -> np.ndarray:
        """Extended-layout cell ids the resume state retains."""
        a1 = int(self.offsets[0])
        return np.arange(prefix.n - a1, prefix.n, dtype=np.int64)

    def stitch_extension(self, prefix, prefix_table, ext_out) -> np.ndarray:
        """Full extended table: the prefix table, then the new cells."""
        return np.concatenate([np.asarray(prefix_table), np.asarray(ext_out)])

    def chain_seed(self) -> bytes:
        """Digest of everything the chain commits to besides the per-step
        payloads (family tag, semiring, offsets, presets, weight dtype)."""
        h = hashlib.sha256()
        h.update(b"linear")
        h.update(self.op.encode())
        h.update(repr(tuple(int(a) for a in self.offsets)).encode())
        _hash_array(h, self.init)
        h.update(b"none" if self.weights is None
                 else str(self.weights.dtype).encode())
        return h.digest()

    def step_payloads(self, start: int = 0) -> list:
        """Chain payloads of steps ``start..n`` (each step's weight row),
        cut from one bulk ``tobytes``."""
        if self.weights is None:
            return [b""] * (self.n - start)
        w = np.ascontiguousarray(self.weights[start:])
        buf, row = w.tobytes(), w[:1].nbytes
        return [buf[i * row:(i + 1) * row] for i in range(self.n - start)]

    def flat_payload_digest(self, upto: int) -> bytes:
        """One unchained hash over payloads ``0..upto``."""
        if self.weights is None:
            return hashlib.sha256().digest()
        return hashlib.sha256(
            np.ascontiguousarray(self.weights[:upto]).tobytes()).digest()

    def content_extends(self, prev: "LinearSpec") -> bool:
        """Whether ``prev``'s step payloads equal this instance's first
        ``prev.n`` (callers have matched ``chain_seed`` already)."""
        if self.weights is None:
            return True
        return bool(np.array_equal(self.weights[:prev.n], prev.weights))

    def prefix_digest_chain(self) -> dict:
        """``{L: digest}`` for every valid prefix length L; equal chains at
        L imply bit-equal prefix tables."""
        return chain_digests(self.chain_seed(), self.step_payloads(),
                             self.min_prefix_len())[0]


@dataclasses.dataclass(frozen=True)
class TriangularSpec:
    """Canonical triangular instance: width ``n``; ``weights`` is the dense
    (num_cells(n), n-1) split-major table (``core.mcm.weight_table``).
    ``dims`` is set for MCM-shaped weights (w = p_i·p_{s+1}·p_{j+1})."""

    n: int
    weights: np.ndarray
    dims: Optional[np.ndarray] = None

    family: ClassVar[str] = "triangular"
    uses_start: ClassVar[bool] = False

    @property
    def geometry(self) -> str:
        return self.family

    def shape_key(self) -> tuple:
        return ("triangular", int(self.n))

    def validate(self) -> None:
        want = (num_cells(self.n), max(self.n - 1, 1))
        if self.weights.shape != want:
            raise ValueError(f"weights must be {want}, got {self.weights.shape}")
        if self.dims is not None and len(self.dims) != self.n + 1:
            raise ValueError(f"dims must have n+1={self.n + 1} entries")

    # --- family protocol hooks ---------------------------------------------
    def digest_into(self, h) -> None:
        h.update(b"triangular")
        h.update(str(int(self.n)).encode())
        _hash_array(h, self.weights)
        _hash_array(h, self.dims)

    @classmethod
    def shape_key_size(cls, key: tuple) -> int:
        return int(key[1])

    @classmethod
    def shape_key_compatible(cls, a: tuple, b: tuple) -> bool:
        return len(a) == len(b)

    @classmethod
    def from_shape_key(cls, key: tuple) -> "TriangularSpec":
        n = int(key[1])
        return cls(n=n,
                   weights=np.zeros((num_cells(n), max(n - 1, 1)), np.float32))

    def route_costs(self) -> dict:
        """Step-count cost model of the triangular routes; units and floors
        as in :meth:`LinearSpec.route_costs`."""
        n, cells = self.n, num_cells(self.n)
        costs = {
            "wavefront": float(n),              # one masked combine/diagonal
            "mcm_pipeline": float(cells + n),   # Fig.-8 skewed head + drain
            # O(n) wavefront depth with GEMM-fed combines: favored past n ≈ 64
            "blocked_mcm": float(n) * 0.75 + 16.0,
            # O(n) depth over banded tiles, plus a flat streaming-setup term
            "tiled_wavefront": float(n) * 0.85 + 24.0,
        }
        return _floored(costs, _TRIANGULAR_OVERHEAD, n)

    def schedule_model(self):
        """Split-recurrence dependencies: candidate ``e`` of cell
        ``(i, i+d)`` reads ``(i, i+e)`` and ``(i+e+1, i+d)``; diagonal 0 is
        preset. Candidates are ordered by split offset ``e`` ascending (the
        canonical order every route's ``consume`` aligns with)."""
        from repro_torch.dp.schedule import DependencyModel

        n = self.n
        cands = [()] * num_cells(n)
        for d in range(1, n):
            for i in range(n - d):
                cands[lin_index(i, d, n)] = tuple(
                    (lin_index(i, e, n), lin_index(i + e + 1, d - e - 1, n))
                    for e in range(d))
        return DependencyModel(
            label=f"triangular(n={n})", cells=num_cells(n),
            preset=frozenset(range(n)),      # lin_index(i, 0, n) == i
            candidates=tuple(cands))

    @classmethod
    def probe_specs(cls) -> tuple:
        """n=4 is the smallest width where the paper-order pipeline hazard
        manifests; the n=6 probe carries real MCM dims so the
        GEMM-structured ``blocked_mcm`` route (dims-gated, needs a divisible
        tile) is exercised rather than silently skipped."""
        from repro_torch.core.mcm import mcm_weight_fn, weight_table

        dims = np.arange(1.0, 8.0)           # n + 1 = 7 matrix dimensions
        return (
            cls(n=4, weights=np.zeros((num_cells(4), 3), np.float32)),
            cls(n=5, weights=np.zeros((num_cells(5), 4), np.float32)),
            cls(n=6, weights=weight_table(6, mcm_weight_fn(dims)),
                dims=dims),
        )

    def supports_args(self) -> bool:
        """Triangular specs always reduce by min — always selective."""
        return True

    def args_unsupported_reason(self) -> str:
        return "no argument structure"

    def default_start(self, table) -> int:
        return -1

    def args_from_table(self, table: np.ndarray) -> np.ndarray:
        from repro_torch.core.mcm import triangular_args_np

        return triangular_args_np(table, self.weights, self.n)

    def traceback_host(self, args: np.ndarray, start: int = -1) -> "Path":
        from repro_torch.core.mcm import triangular_traceback_np

        return TriangularPath(nodes=triangular_traceback_np(args, self.n))

    def traceback_program(self):
        """The batched walk (see :meth:`LinearSpec.traceback_program`)."""
        from repro_torch.core.mcm import triangular_traceback

        n = self.n

        def walk(args, starts):
            ii, dd, ee = _host(triangular_traceback(args, n))
            nodes = np.stack([ii, dd, ee], axis=2)
            return [TriangularPath(nodes=x) for x in nodes]

        return walk

    # --- streaming/extension hooks ------------------------------------------
    def extend_length(self) -> int:
        """Growth axis = chain width (appendable matrices/leaves)."""
        return int(self.n)

    def min_prefix_len(self) -> int:
        return 2

    def split_spec(self, length: int) -> "TriangularSpec":
        """Width-``length`` prefix: the logical weight entries of every
        chain [i, j ≤ length-1], re-laid-out into the narrower
        diagonal-major table (padding beyond e ≥ d zeroed)."""
        L = int(length)
        if not self.min_prefix_len() <= L <= self.n:
            raise ValueError(f"prefix length {L} outside "
                             f"[{self.min_prefix_len()}, {self.n}]")
        w = np.zeros((num_cells(L), max(L - 1, 1)), self.weights.dtype)
        for d in range(1, L):
            src, dst = lin_index(0, d, self.n), lin_index(0, d, L)
            w[dst:dst + (L - d), :d] = self.weights[src:src + (L - d), :d]
        dims = (None if self.dims is None
                else np.ascontiguousarray(self.dims[:L + 1]))
        return dataclasses.replace(self, n=L, weights=w, dims=dims)

    def _logical_prefix_equal(self, other: "TriangularSpec") -> bool:
        """Do ``other``'s logical weight entries equal this spec's first
        ``other.n`` columns' entries, bitwise (layout-independent)?"""
        if other.weights.dtype != self.weights.dtype or other.n > self.n:
            return False
        for d in range(1, other.n):
            src, dst = lin_index(0, d, self.n), lin_index(0, d, other.n)
            rows = other.n - d
            if not np.array_equal(self.weights[src:src + rows, :d],
                                  other.weights[dst:dst + rows, :d]):
                return False
        return True

    def extension_delta(self, prefix: "TriangularSpec") -> dict:
        if (not isinstance(prefix, TriangularSpec)
                or not prefix.n < self.n
                or not self._logical_prefix_equal(prefix)
                or (prefix.dims is None) != (self.dims is None)
                or (self.dims is not None
                    and not _same_array(prefix.dims,
                                        self.dims[:prefix.n + 1]))):
            raise ValueError("spec is not a bitwise extension of the prefix")
        return {"steps": int(self.n - prefix.n),
                "weights": self.weights, "dims": self.dims}

    def extend_spec(self, delta: dict) -> "TriangularSpec":
        """Append ``delta['steps']`` matrices. The diagonal-major layout
        depends on the width, so the delta carries the FULL new weight
        table; its logical prefix must match this spec bitwise."""
        k = int(delta["steps"])
        if k < 1:
            raise ValueError(f"extension must append at least one step, got {k}")
        n2 = self.n + k
        w = np.asarray(delta["weights"])
        want = (num_cells(n2), max(n2 - 1, 1))
        if w.shape != want:
            raise ValueError(f"extension weights must be {want}, got {w.shape}")
        dims = delta.get("dims")
        if (dims is None) != (self.dims is None):
            raise ValueError("extension dims must match the spec's dims-ness")
        if dims is not None:
            dims = np.asarray(dims)
            if len(dims) != n2 + 1 or not _same_array(
                    np.asarray(dims[:self.n + 1]), self.dims):
                raise ValueError("extension dims must extend the prefix dims")
        ext = dataclasses.replace(self, n=n2, weights=w, dims=dims)
        if not ext._logical_prefix_equal(self):
            raise ValueError("extension weights do not preserve the prefix")
        ext.validate()
        return ext

    def extension_state(self, table, args=None) -> dict:
        """The whole prefix triangle: extension cell (i, j ≥ n) reads (i, s)
        for EVERY s < j, so every prefix cell stays live."""
        return {"suffix": np.array(np.asarray(table))}

    def prefix_cell_map(self, prefix: "TriangularSpec") -> np.ndarray:
        m = np.empty(num_cells(prefix.n), np.int64)
        for d in range(prefix.n):
            src, dst = lin_index(0, d, prefix.n), lin_index(0, d, self.n)
            m[src:src + (prefix.n - d)] = np.arange(
                dst, dst + (prefix.n - d), dtype=np.int64)
        return m

    def saved_state_cells(self, prefix: "TriangularSpec") -> np.ndarray:
        return self.prefix_cell_map(prefix)

    def stitch_extension(self, prefix, prefix_table, ext_out) -> np.ndarray:
        # the windowed extend solver already emits the full new-layout table
        return np.asarray(ext_out)

    def chain_seed(self) -> bytes:
        h = hashlib.sha256()
        h.update(b"triangular")
        h.update(str(self.weights.dtype).encode())
        if self.dims is None:
            h.update(b"none")
        else:
            h.update(str(self.dims.dtype).encode())
            h.update(_arr_bytes(self.dims[:1]))
        return h.digest()

    def step_payloads(self, start: int = 0) -> list:
        """Payload j: the logical weights of every chain ending at leaf j
        (layout-independent slices) plus dims[j+1]."""
        out = []
        for j in range(start, self.n):
            parts = [self.weights[lin_index(i, j - i, self.n), :j - i]
                     for i in range(j)]
            payload = b"".join(_arr_bytes(p) for p in parts)
            if self.dims is not None:
                payload += _arr_bytes(self.dims[j + 1:j + 2])
            out.append(payload)
        return out

    def flat_payload_digest(self, upto: int) -> bytes:
        return hashlib.sha256(
            b"".join(self.step_payloads()[:upto])).digest()

    def content_extends(self, prev: "TriangularSpec") -> bool:
        """The weight layout changes as the chart widens, so compare the
        layout-independent flat payload digests."""
        n_old = prev.extend_length()
        return self.flat_payload_digest(n_old) == \
            prev.flat_payload_digest(n_old)

    def prefix_digest_chain(self) -> dict:
        return chain_digests(self.chain_seed(), self.step_payloads(),
                             self.min_prefix_len())[0]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Multi-plane 2-D wavefront instance.

    ``schedule="antidiag"`` (alignment grids): the table is ``planes``
    stacked ``(rows, cols)`` grids; *shift moves* ``(p_to, p_from, di, dj)``
    (``di + dj ≥ 1``) each carry a per-cell weight plane
    ``weights[ℓ] (rows, cols)``;

        ST[p, i, j] = op_{ℓ: p_to=p} ( ST[p_from, i-di, j-dj] + w_ℓ[i, j] )

    with preset cells given by ``init``/``init_mask`` (``(planes, rows,
    cols)``). Invalid moves are masked with the semiring zero (±inf) in
    their weight plane. Table/args layout: row-major ``(planes·rows·cols,)``
    flat by ``(p, i, j)``.

    ``schedule="spandiag"`` (parse charts; ``rows == cols == n``): the
    triangular split recurrence over planes — cell ``(p, i, i+d)`` combines
    *binary rules* ``(p_to, p_left, p_right)`` with scalar log-weights
    ``rule_weights[r]`` over every split offset ``e``:

        ST[A, lin(i,d)] = op_{e, r: p_to=A}
            ( ST[B, lin(i,e)] + ST[C, lin(i+e+1, d-e-1)] + rw[r] )

    with diagonal 0 preset from ``init`` (``(planes, n)``). Layout:
    ``(planes·num_cells(n),)`` flat, diagonal-major per plane. The packed
    arg of a cell is ``e·len(rules) + r``.
    """

    rows: int
    cols: int
    op: str
    schedule: str
    planes: int = 1
    moves: tuple = ()
    rules: tuple = ()
    weights: Optional[np.ndarray] = None
    rule_weights: Optional[np.ndarray] = None
    init: Optional[np.ndarray] = None
    init_mask: Optional[np.ndarray] = None

    family: ClassVar[str] = "grid"
    uses_start: ClassVar[bool] = True

    @property
    def geometry(self) -> str:
        return self.family

    @property
    def cells(self) -> int:
        """Cells per plane (schedule-dependent layout length)."""
        if self.schedule == "spandiag":
            return num_cells(self.rows)
        return self.rows * self.cols

    def shape_key(self) -> tuple:
        return ("grid", self.schedule, self.op, int(self.planes),
                int(self.rows), int(self.cols),
                tuple(tuple(int(v) for v in m) for m in self.moves),
                tuple(tuple(int(v) for v in r) for r in self.rules))

    def validate(self) -> None:
        if self.op not in ("min", "max"):
            raise ValueError(f"grid op must be min or max, got {self.op!r}")
        if self.schedule not in ("antidiag", "spandiag"):
            raise ValueError(f"unknown grid schedule {self.schedule!r}")
        if self.planes < 1 or self.rows < 1 or self.cols < 1:
            raise ValueError("planes, rows, cols must be positive")
        if self.schedule == "antidiag":
            self._validate_antidiag()
        else:
            self._validate_spandiag()

    def _validate_antidiag(self) -> None:
        if self.rules:
            raise ValueError("antidiag grids take shift moves, not rules")
        if not self.moves:
            raise ValueError("antidiag grids need at least one move")
        for m in self.moves:
            p_to, p_from, di, dj = m
            if not (0 <= p_to < self.planes and 0 <= p_from < self.planes):
                raise ValueError(f"move {m} references a plane out of range")
            if di < 0 or dj < 0 or di + dj < 1:
                raise ValueError(f"move {m} must step strictly forward "
                                 "(di, dj >= 0, di + dj >= 1)")
        shape = (len(self.moves), self.rows, self.cols)
        if self.weights is None or self.weights.shape != shape:
            raise ValueError(f"weights must be {shape}, got "
                             f"{None if self.weights is None else self.weights.shape}")
        pshape = (self.planes, self.rows, self.cols)
        if self.init is None or self.init.shape != pshape:
            raise ValueError(f"init must be {pshape}")
        if self.init_mask is None or self.init_mask.shape != pshape:
            raise ValueError(f"init_mask must be {pshape}")
        if not bool(np.all(self.init_mask[:, 0, 0])):
            raise ValueError("cell (0, 0) must be preset on every plane "
                             "(no move can reach it)")

    def _validate_spandiag(self) -> None:
        if self.moves:
            raise ValueError("spandiag grids take rules, not shift moves")
        if not self.rules:
            raise ValueError("spandiag grids need at least one rule")
        if self.rows != self.cols or self.rows < 2:
            raise ValueError("spandiag grids need rows == cols >= 2")
        for r in self.rules:
            if len(r) != 3 or not all(0 <= p < self.planes for p in r):
                raise ValueError(f"rule {r} references a plane out of range")
        if (self.rule_weights is None
                or self.rule_weights.shape != (len(self.rules),)):
            raise ValueError(f"rule_weights must be ({len(self.rules)},)")
        if self.init is None or self.init.shape != (self.planes, self.rows):
            raise ValueError(f"init must be ({self.planes}, {self.rows})")

    # --- family protocol hooks ---------------------------------------------
    def digest_into(self, h) -> None:
        h.update(b"grid")
        h.update(self.schedule.encode())
        h.update(self.op.encode())
        h.update(repr((int(self.planes), int(self.rows),
                       int(self.cols))).encode())
        h.update(repr(self.shape_key()[6:]).encode())   # moves, rules
        _hash_array(h, self.weights)
        _hash_array(h, self.rule_weights)
        _hash_array(h, self.init)
        _hash_array(h, None if self.init_mask is None
                    else self.init_mask.astype(np.uint8))

    @classmethod
    def shape_key_size(cls, key: tuple) -> int:
        return int(key[4]) * int(key[5])

    @classmethod
    def shape_key_compatible(cls, a: tuple, b: tuple) -> bool:
        """Only the grid extents may differ: schedule, op, planes, moves
        and rules all change the solver's program."""
        return (len(a) == len(b)
                and (a[1], a[2], a[3], a[6], a[7])
                == (b[1], b[2], b[3], b[6], b[7]))

    @classmethod
    def from_shape_key(cls, key: tuple) -> "GridSpec":
        _, schedule, op, planes, rows, cols, moves, rules = key
        planes, rows, cols = int(planes), int(rows), int(cols)
        if schedule == "antidiag":
            mask = np.zeros((planes, rows, cols), bool)
            mask[:, 0, 0] = True          # the minimal valid preset set
            return cls(rows=rows, cols=cols, op=op, schedule=schedule,
                       planes=planes, moves=moves,
                       weights=np.zeros((len(moves), rows, cols), np.float32),
                       init=np.zeros((planes, rows, cols), np.float32),
                       init_mask=mask)
        return cls(rows=rows, cols=cols, op=op, schedule=schedule,
                   planes=planes, rules=rules,
                   rule_weights=np.zeros((len(rules),), np.float32),
                   init=np.zeros((planes, rows), np.float32))

    def route_costs(self) -> dict:
        """Step-count model of the grid routes: one combine per wavefront —
        ``rows + cols - 1`` anti-diagonals or ``rows`` span diagonals —
        scaled by the per-front fan-in (moves or rules). Units and floors
        as in :meth:`LinearSpec.route_costs`."""
        if self.schedule == "antidiag":
            fronts = self.rows + self.cols - 1
            fan = max(1, len(self.moves))
        else:
            fronts = self.rows
            fan = max(1, len(self.rules))
        costs = {"grid_wavefront": float(fronts) * (1.0 + _log2(fan) / 4.0)}
        return _floored(costs, _GRID_OVERHEAD, min(self.rows, self.cols))

    def schedule_model(self):
        """Grid dependencies in plane-major flat cell ids. antidiag: each
        non-preset cell reads ``(p_from, i-di, j-dj)`` per in-range move
        targeting its plane, in move declaration order. spandiag: the
        per-plane split recurrence, split-major then rule order. Cells of
        planes no move/rule targets keep their initialized value — they
        carry no candidates and routes may treat them as preset-final."""
        from repro_torch.dp.schedule import DependencyModel

        per = self.cells
        cands = [()] * (self.planes * per)
        preset = set()
        if self.schedule == "antidiag":
            R, C = self.rows, self.cols
            for p in range(self.planes):
                for i in range(R):
                    for j in range(C):
                        cell = p * per + i * C + j
                        if bool(self.init_mask[p, i, j]):
                            preset.add(cell)
                            continue
                        cands[cell] = tuple(
                            (pf * per + (i - di) * C + (j - dj),)
                            for (pt, pf, di, dj) in self.moves
                            if pt == p and i >= di and j >= dj)
        else:
            n = self.rows
            for p in range(self.planes):
                for i in range(n):
                    preset.add(p * per + i)   # diagonal 0
                for d in range(1, n):
                    for i in range(n - d):
                        cands[p * per + lin_index(i, d, n)] = tuple(
                            (b * per + lin_index(i, e, n),
                             c * per + lin_index(i + e + 1, d - e - 1, n))
                            for e in range(d)
                            for (a, b, c) in self.rules if a == p)
        return DependencyModel(
            label=f"grid[{self.schedule}](planes={self.planes}, "
                  f"rows={self.rows}, cols={self.cols})",
            cells=self.planes * per, preset=frozenset(preset),
            candidates=tuple(cands))

    @classmethod
    def probe_specs(cls) -> tuple:
        """One single-plane and one multi-plane probe per schedule: an
        edit-distance-shaped 3×4 antidiag, a Gotoh-like two-plane 3×3
        (plane 1 feeding back into plane 0), a one-nonterminal CKY chart,
        and a three-rule two-nonterminal chart."""
        mask1 = np.zeros((1, 3, 4), bool)
        mask1[:, 0, :] = mask1[:, :, 0] = True
        mask2 = np.zeros((2, 3, 3), bool)
        mask2[:, 0, :] = mask2[:, :, 0] = True
        return (
            cls(rows=3, cols=4, op="min", schedule="antidiag", planes=1,
                moves=((0, 0, 1, 0), (0, 0, 0, 1), (0, 0, 1, 1)),
                weights=np.zeros((3, 3, 4), np.float32),
                init=np.zeros((1, 3, 4), np.float32), init_mask=mask1),
            cls(rows=3, cols=3, op="max", schedule="antidiag", planes=2,
                moves=((0, 0, 1, 1), (0, 1, 1, 1),
                       (1, 0, 0, 1), (1, 1, 0, 1)),
                weights=np.zeros((4, 3, 3), np.float32),
                init=np.zeros((2, 3, 3), np.float32), init_mask=mask2),
            cls(rows=4, cols=4, op="min", schedule="spandiag", planes=1,
                rules=((0, 0, 0),),
                rule_weights=np.zeros((1,), np.float32),
                init=np.zeros((1, 4), np.float32)),
            cls(rows=4, cols=4, op="max", schedule="spandiag", planes=2,
                rules=((0, 0, 1), (1, 0, 0), (0, 1, 1)),
                rule_weights=np.zeros((3,), np.float32),
                init=np.zeros((2, 4), np.float32)),
        )

    def supports_args(self) -> bool:
        return True         # validate() restricts op to min/max

    def args_unsupported_reason(self) -> str:
        return "no argument structure"

    def default_start(self, table) -> int:
        """Plane 0 at the far corner (antidiag) or the full-span root cell
        (spandiag); problems with a different optimum define ``start``."""
        if self.schedule == "spandiag":
            return int(lin_index(0, self.rows - 1, self.rows))
        return (self.rows - 1) * self.cols + (self.cols - 1)

    # --- solver plumbing (consumed by backends.grid_backend) ----------------
    def device_arrays(self) -> tuple:
        """The per-instance arrays a grid solver consumes, in a fixed slot
        order per schedule: ``(weights, init, init_mask)`` (antidiag) or
        ``(rule_weights, init)`` (spandiag), float32."""
        if self.schedule == "antidiag":
            return (np.asarray(self.weights, np.float32),
                    np.asarray(self.init, np.float32),
                    np.asarray(self.init_mask, np.float32))
        return (np.asarray(self.rule_weights, np.float32),
                np.asarray(self.init, np.float32))

    def static_meta(self) -> tuple:
        """``(schedule, op, planes, rows, cols, moves, rules)``: everything
        the solvers need besides the instance arrays."""
        return self.shape_key()[1:]

    def args_from_table(self, table: np.ndarray) -> np.ndarray:
        from repro_torch.core.grid import grid_args_np

        return grid_args_np(table, self)

    def traceback_host(self, args: np.ndarray, start: int = -1) -> "Path":
        from repro_torch.core.grid import grid_traceback_np

        return grid_traceback_np(
            args, self, start if start >= 0 else self.default_start(None))

    def traceback_program(self):
        """The batched walk (see :meth:`LinearSpec.traceback_program`)."""
        import torch

        from repro_torch.core.grid import grid_traceback

        meta = self.static_meta()
        default = self.default_start(None)
        RC, C = self.rows * self.cols, self.cols

        def walk(args, starts):
            B = args.shape[0]
            start = torch.as_tensor(np.asarray(
                [default] * B if starts is None else starts, np.int64),
                device=args.device)
            out = grid_traceback(args, start, meta)
            if self.schedule == "spandiag":
                return [GridPath(nodes=x, stop=-1)
                        for x in np.stack(_host(out), axis=2)]
            cells, moves, count = out
            cells, moves, count = _host([cells, moves,
                                         count[:, None].expand_as(cells)])
            return [GridPath(nodes=np.stack([c[:k] // RC, c[:k] % RC // C,
                                             c[:k] % C, m[:k]], axis=1),
                             stop=int(c[k]))
                    for c, m, k in zip(cells, moves, count[:, 0])]

        return walk

    # --- streaming/extension hooks ------------------------------------------
    def extend_length(self) -> int:
        """Growth axis: appendable columns (antidiag) or chart width
        (spandiag)."""
        return int(self.cols) if self.schedule == "antidiag" else int(self.rows)

    def frontier_cols(self) -> int:
        """Trailing columns an antidiag extension reaches back into: max dj
        over the moves, at least one."""
        return max(1, max((int(m[3]) for m in self.moves), default=1))

    def min_prefix_len(self) -> int:
        if self.schedule == "antidiag":
            return self.frontier_cols()
        return 2

    def split_spec(self, length: int) -> "GridSpec":
        L = int(length)
        if not self.min_prefix_len() <= L <= self.extend_length():
            raise ValueError(f"prefix length {L} outside "
                             f"[{self.min_prefix_len()}, {self.extend_length()}]")
        if self.schedule == "antidiag":
            return dataclasses.replace(
                self, cols=L,
                weights=np.ascontiguousarray(self.weights[:, :, :L]),
                init=np.ascontiguousarray(self.init[:, :, :L]),
                init_mask=np.ascontiguousarray(self.init_mask[:, :, :L]))
        return dataclasses.replace(
            self, rows=L, cols=L,
            init=np.ascontiguousarray(self.init[:, :L]))

    def extension_delta(self, prefix: "GridSpec") -> dict:
        same = (isinstance(prefix, GridSpec)
                and (prefix.schedule, prefix.op, prefix.planes)
                == (self.schedule, self.op, self.planes)
                and prefix.moves == self.moves
                and prefix.rules == self.rules
                and _same_array(prefix.rule_weights, self.rule_weights))
        if self.schedule == "antidiag":
            C = None if not same else prefix.cols
            if (not same or prefix.rows != self.rows
                    or not C < self.cols
                    or not _same_array(prefix.weights,
                                       self.weights[:, :, :C])
                    or not _same_array(prefix.init, self.init[:, :, :C])
                    or not _same_array(prefix.init_mask,
                                       self.init_mask[:, :, :C])):
                raise ValueError("spec is not a bitwise extension of the prefix")
            return {"cols": int(self.cols - C),
                    "weights": np.ascontiguousarray(self.weights[:, :, C:]),
                    "init": np.ascontiguousarray(self.init[:, :, C:]),
                    "init_mask": np.ascontiguousarray(self.init_mask[:, :, C:])}
        if (not same or not prefix.rows < self.rows
                or not _same_array(prefix.init, self.init[:, :prefix.rows])):
            raise ValueError("spec is not a bitwise extension of the prefix")
        return {"steps": int(self.rows - prefix.rows),
                "init": np.ascontiguousarray(self.init[:, prefix.rows:])}

    def extend_spec(self, delta: dict) -> "GridSpec":
        """Append columns (antidiag) or leaves (spandiag)."""
        if self.schedule == "antidiag":
            k = int(delta["cols"])
            if k < 1:
                raise ValueError("extension must append at least one column")
            w = np.asarray(delta["weights"], dtype=self.weights.dtype)
            ini = np.asarray(delta["init"], dtype=self.init.dtype)
            mask = np.asarray(delta["init_mask"], dtype=bool)
            want = (len(self.moves), self.rows, k)
            pwant = (self.planes, self.rows, k)
            if w.shape != want or ini.shape != pwant or mask.shape != pwant:
                raise ValueError(f"extension arrays must be {want}/{pwant}")
            ext = dataclasses.replace(
                self, cols=self.cols + k,
                weights=np.concatenate([self.weights, w], axis=2),
                init=np.concatenate([self.init, ini], axis=2),
                init_mask=np.concatenate([self.init_mask, mask], axis=2))
        else:
            k = int(delta["steps"])
            if k < 1:
                raise ValueError("extension must append at least one leaf")
            ini = np.asarray(delta["init"], dtype=self.init.dtype)
            if ini.shape != (self.planes, k):
                raise ValueError(f"extension init must be "
                                 f"({self.planes}, {k}), got {ini.shape}")
            ext = dataclasses.replace(
                self, rows=self.rows + k, cols=self.cols + k,
                init=np.concatenate([self.init, ini], axis=1))
        ext.validate()
        return ext

    def extension_state(self, table, args=None) -> dict:
        """antidiag: the last ``frontier_cols()`` columns. spandiag: the
        full prefix chart (the split recurrence keeps every cell live)."""
        if self.schedule == "antidiag":
            W = self.frontier_cols()
            t = np.asarray(table).reshape(self.planes, self.rows, self.cols)
            return {"suffix": np.array(t[:, :, self.cols - W:])}
        return {"suffix": np.array(np.asarray(table))}

    def prefix_cell_map(self, prefix: "GridSpec") -> np.ndarray:
        if self.schedule == "antidiag":
            R, Cn, Co = self.rows, self.cols, prefix.cols
            p = np.arange(self.planes, dtype=np.int64)[:, None, None]
            i = np.arange(R, dtype=np.int64)[None, :, None]
            j = np.arange(Co, dtype=np.int64)[None, None, :]
            return (p * R * Cn + i * Cn + j).ravel()
        no, nn = prefix.rows, self.rows
        base = np.empty(num_cells(no), np.int64)
        for d in range(no):
            src, dst = lin_index(0, d, no), lin_index(0, d, nn)
            base[src:src + (no - d)] = np.arange(dst, dst + (no - d),
                                                 dtype=np.int64)
        p = np.arange(self.planes, dtype=np.int64)[:, None]
        return (p * num_cells(nn) + base[None, :]).ravel()

    def saved_state_cells(self, prefix: "GridSpec") -> np.ndarray:
        if self.schedule == "antidiag":
            R, Cn, Co = self.rows, self.cols, prefix.cols
            W = self.frontier_cols()
            p = np.arange(self.planes, dtype=np.int64)[:, None, None]
            i = np.arange(R, dtype=np.int64)[None, :, None]
            j = np.arange(Co - W, Co, dtype=np.int64)[None, None, :]
            return (p * R * Cn + i * Cn + j).ravel()
        return self.prefix_cell_map(prefix)

    def stitch_extension(self, prefix, prefix_table, ext_out) -> np.ndarray:
        if self.schedule == "antidiag":
            ext_out = np.asarray(ext_out)
            full = np.empty((self.planes, self.rows, self.cols),
                            ext_out.dtype)
            full[:, :, :prefix.cols] = np.asarray(prefix_table).reshape(
                self.planes, self.rows, prefix.cols)
            full[:, :, prefix.cols:] = ext_out
            return full.reshape(-1)
        return np.asarray(ext_out)

    def chain_seed(self) -> bytes:
        h = hashlib.sha256()
        h.update(b"grid")
        h.update(self.schedule.encode())
        h.update(self.op.encode())
        if self.schedule == "antidiag":
            h.update(repr((int(self.planes), int(self.rows))).encode())
            h.update(repr(self.shape_key()[6]).encode())   # moves
            h.update(str(self.weights.dtype).encode())
            h.update(str(self.init.dtype).encode())
        else:
            h.update(str(int(self.planes)).encode())
            h.update(repr(self.shape_key()[7]).encode())   # rules
            _hash_array(h, self.rule_weights)
            h.update(str(self.init.dtype).encode())
        return h.digest()

    def _payload_rows(self, start: int = 0,
                      stop: Optional[int] = None) -> np.ndarray:
        """Byte matrix of step payloads ``start..stop``, one row per step:
        weight/init/mask column bytes (antidiag) or the leaf presets
        (spandiag)."""
        if self.schedule == "antidiag":
            parts = [self.weights[:, :, start:stop],
                     self.init[:, :, start:stop],
                     self.init_mask[:, :, start:stop].astype(np.uint8)]
            rows = [np.ascontiguousarray(np.moveaxis(p, 2, 0))
                    .reshape(p.shape[2], p.shape[0] * p.shape[1])
                    .view(np.uint8) for p in parts]
            return np.concatenate(rows, axis=1)
        return np.ascontiguousarray(
            self.init[:, start:stop].T).view(np.uint8)

    def step_payloads(self, start: int = 0) -> list:
        """Payload j: everything column j contributes — weight/init/mask
        columns (antidiag) or the leaf presets (spandiag)."""
        rows = self._payload_rows(start)
        buf, rb = rows.tobytes(), rows.shape[1]
        return [buf[i * rb:(i + 1) * rb] for i in range(rows.shape[0])]

    def flat_payload_digest(self, upto: int) -> bytes:
        return hashlib.sha256(
            self._payload_rows(0, upto).tobytes()).digest()

    def content_extends(self, prev: "GridSpec") -> bool:
        """Column prefixes are plain array slices: compare them directly."""
        c = prev.extend_length()
        if self.schedule == "antidiag":
            return (np.array_equal(self.weights[:, :, :c], prev.weights)
                    and np.array_equal(self.init[:, :, :c], prev.init)
                    and np.array_equal(self.init_mask[:, :, :c],
                                       prev.init_mask))
        return bool(np.array_equal(self.init[:, :c], prev.init))

    def prefix_digest_chain(self) -> dict:
        return chain_digests(self.chain_seed(), self.step_payloads(),
                             self.min_prefix_len())[0]


Spec = Union[LinearSpec, TriangularSpec, GridSpec]

register_family(LinearSpec)
register_family(TriangularSpec)
register_family(GridSpec)


def _hash_array(h, a: Optional[np.ndarray]) -> None:
    if a is None:
        h.update(b"\x00none")
        return
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def _chain(prev: bytes, payload: bytes) -> bytes:
    """One link of a prefix digest chain: the digest at step ``s`` commits
    to the digest at ``s-1`` plus step ``s``'s payload, so equal chain
    values at a length imply bit-equal logical prefixes."""
    return hashlib.sha256(prev + payload).digest()


def chain_digests(seed: bytes, payloads: list,
                  lo: int, base: int = 0,
                  acc: Optional[bytes] = None) -> tuple:
    """Walk a digest chain: returns ``({L: digest for L >= lo}, acc)`` with
    ``acc`` the chain value after the last payload. ``payloads`` are the
    payloads of steps ``base..base+len(payloads)``; ``base`` / ``acc``
    resume a partly walked chain."""
    acc = seed if acc is None else acc
    chain = {}
    for i, payload in enumerate(payloads, start=base):
        acc = _chain(acc, payload)
        if i + 1 >= lo:
            chain[i + 1] = acc
    return chain, acc


def _arr_bytes(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _same_array(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    """Bitwise array equality (dtype + shape + values); None matches None."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))


def spec_digest(spec: Spec) -> str:
    """Content digest of a canonical instance: equal digests imply
    bit-equal answers (``extract`` and ``decode`` read only the spec, the
    table, the args and the path)."""
    h = hashlib.sha256()
    spec.digest_into(h)
    return h.hexdigest()


def spec_from_reference(obj) -> Spec:
    """The port's spec for any object with the numpy fields of a ``repro``
    spec, read by duck typing: ``offsets``/``op``/``n``/``init``/``weights``
    (linear), ``n``/``weights``/``dims`` (triangular) or ``schedule``,
    ``rows``, ``cols``, ``planes``, ``moves``, ``rules`` and the grid
    arrays (grid)."""
    def arr(a):
        return None if a is None else np.asarray(a)

    if all(hasattr(obj, f) for f in ("schedule", "rows", "cols", "planes",
                                     "moves", "rules")):
        return GridSpec(
            rows=int(obj.rows), cols=int(obj.cols), op=str(obj.op),
            schedule=str(obj.schedule), planes=int(obj.planes),
            moves=tuple(tuple(int(v) for v in m) for m in obj.moves),
            rules=tuple(tuple(int(v) for v in r) for r in obj.rules),
            weights=arr(obj.weights), rule_weights=arr(obj.rule_weights),
            init=arr(obj.init), init_mask=arr(obj.init_mask))
    if all(hasattr(obj, f) for f in ("offsets", "op", "n", "init", "weights")):
        return LinearSpec(offsets=tuple(int(a) for a in obj.offsets),
                          op=str(obj.op), n=int(obj.n), init=arr(obj.init),
                          weights=arr(obj.weights))
    if all(hasattr(obj, f) for f in ("n", "weights", "dims")):
        return TriangularSpec(n=int(obj.n), weights=arr(obj.weights),
                              dims=arr(obj.dims))
    raise TypeError(f"not a linear, triangular or grid spec: {type(obj).__name__}")


# --- reconstruction vocabulary ---------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinearPath:
    """Argument walk over a linear table, in traceback order (start cell
    first). ``cells[t]`` took lane ``lanes[t]``, i.e. its winning
    predecessor is ``cells[t] - offsets[lanes[t]]``; ``stop`` is the preset
    cell the walk ended in."""

    cells: np.ndarray
    lanes: np.ndarray
    stop: int


@dataclasses.dataclass(frozen=True)
class TriangularPath:
    """Split tree of a triangular table as a ``(m, 3)`` preorder array of
    internal nodes ``(i, d, e)``: cell ``(i, i+d)`` split at ``s = i + e``
    into children ``(i, e)`` and ``(i+e+1, d-e-1)``."""

    nodes: np.ndarray


@dataclasses.dataclass(frozen=True)
class GridPath:
    """Argument structure of a grid table, as an ``(m, 4)`` node array.

    antidiag: the walk in traceback order — node ``(plane, i, j, move)``
    took shift move ``move``; the walk ends in preset cell ``stop`` (flat
    ``p·rows·cols + i·cols + j`` index).

    spandiag: the parse tree in preorder — node ``(plane, i, d, a)`` with
    packed arg ``a = e·len(rules) + r``: rule ``r`` split cell ``(i, i+d)``
    at offset ``e`` into ``(p_left, i, e)`` and ``(p_right, i+e+1,
    d-e-1)``; ``stop`` is -1 (leaves are implied by the rules)."""

    nodes: np.ndarray
    stop: int


Path = Union[LinearPath, TriangularPath, GridPath]


@dataclasses.dataclass(frozen=True)
class Answer:
    """A solved instance with its reconstructed solution: ``value`` is what
    ``extract`` returns, ``solution`` what ``DPProblem.decode`` builds;
    ``table``/``args`` are the linearized cost and argument tables (numpy);
    ``source`` is ``"device"`` (arg-emitting solver) or ``"host"`` (numpy
    fallback from the cost table)."""

    value: Any
    solution: Any
    table: np.ndarray
    args: np.ndarray
    source: str


@dataclasses.dataclass(frozen=True)
class DPProblem:
    """One zoo entry.

    encode(**instance) -> Spec        canonical form of an instance
    oracle(**instance) -> np.ndarray  independent numpy reference producing
                                      the full linearized table
    extract(table, spec) -> Any       the problem-level answer from a table
    sample(rng, size) -> dict         random instance kwargs (tests/benches)
    decode(table, args, spec, path)   structured solution from the traceback
    start(table, spec) -> int         traceback start cell where the optimum
                                      is not the family's default cell
    """

    name: str
    geometry: str
    encode: Callable[..., Spec]
    oracle: Callable[..., np.ndarray]
    extract: Callable[[np.ndarray, Spec], Any]
    sample: Callable[[np.random.Generator, int], dict]
    doc: str = ""
    decode: Optional[Callable[[np.ndarray, np.ndarray, Spec, Path], Any]] = None
    start: Optional[Callable[[np.ndarray, Spec], int]] = None

    def solve_reference(self, **instance) -> Any:
        """Oracle answer for an instance."""
        spec = self.encode(**instance)
        return self.extract(self.oracle(**instance), spec)
