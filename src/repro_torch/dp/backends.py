"""Solver-route registry and the batched run paths.

``repro_torch.core.sdp``, ``repro_torch.core.mcm``,
``repro_torch.core.blocked_mcm``, ``repro_torch.core.grid`` and
``repro_torch.kernels`` register their routes here at import time;
:func:`ensure_registered` pulls them in lazily. The dispatcher
(``repro_torch.dp.routing``) ranks the routes that support a spec on a
device by ``(cost(spec, device), name)``. On a CUDA device every kernel
route ranks ahead of every plain route: the plain routes loop on the host
and launch PyTorch ops step by step, so on the card their step counts say
nothing about their time.

Every route runs on an explicit ``torch.device``. Builders stack the specs
of a bucket along a leading batch axis, so a bucket is one solver call —
one kernel launch on the kernel routes.

The cold-call signal: a call whose time includes building or first
loading a kernel library (:func:`build_count` moves across it) measures
nvcc, not the route; the engine leaves such drains out of calibration.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.dp.problem import (GridSpec, LinearSpec, Spec, TriangularPath,
                                    TriangularSpec, family_class)

_BACKENDS: dict = {}
_LOADED = False


def build_count() -> int:
    """Kernel libraries built or loaded by this process so far."""
    from repro_torch.kernels import _build

    return _build.LOADS


def lru_put(cache: "OrderedDict", key, value, max_entries: int):
    """Insert-or-refresh on an OrderedDict used as an LRU, evicting the
    stalest entries past ``max_entries``."""
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > max_entries:
        cache.popitem(last=False)
    return value


def resolve_device(device=None, check: bool = True) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    card. Raises when a CUDA device is asked for (or defaulted to) and none
    is present — the port never carries on on the CPU unasked. ``check=False``
    skips that test for an explicit device where nothing runs (ranking for a
    card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch: no CUDA device is available; pass "
                               "device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if check and dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"repro_torch: device {device!r} requested but no "
                           "CUDA device is available")
    return dev


@dataclasses.dataclass(frozen=True)
class Backend:
    """A solver route. ``run(spec, device)`` returns the full linearized
    table as numpy; ``batch_run(specs, device, sharding=None)`` solves a
    homogeneous list of specs in one call (once a slot of the mesh of a
    ``repro_torch.dp.sharding.ShardContext`` given as ``sharding``, as
    every batch path below takes). Arg-capable routes also expose ``run_with_args``
    returning ``(table, args)`` — the winning lane (linear), best split
    (triangular), or winning move / packed split (grid) per cell — and
    ``batch_run_with_args`` returning ``(tables, args)`` with ``args`` the
    ``(batch, cells)`` tensor left on ``device``, where the bucket's walk
    runs. Fused routes also expose ``batch_run_fused``
    returning ``(tables, argss, paths)``: the tracebacks walked inside the
    solve's launch. ``cost(spec, device)`` is the analytical step-count
    prior and ``supports(spec, device)`` the route's gate on that device;
    ``kernel`` marks a route whose solve is one hand-written kernel launch
    per bucket on the card. ``batch_run`` is None on a route that solves a
    bucket one instance at a time (the routing layer loops ``run``).
    ``run_extend(spec, old_len, state, device)`` (plain routes only)
    warm-starts the solve from a solved prefix: ``spec`` is the extended
    spec, ``state`` the prefix's ``extension_state()``; it returns what
    ``spec.stitch_extension`` assembles into the full table, bit-equal to a
    cold solve. ``blocked_mcm`` launches its GEMM kernel but
    loops on the host over the boundary-wavefront steps, so it is not a
    kernel route: on the card it ranks behind the kernel routes and, among
    the plain ones, by cost (ahead of ``wavefront`` from n = 64 on).
    ``schedule(spec, device)`` is the route's schedule descriptor for the
    static gate (``repro_torch.analysis``): a tuple of
    ``repro_torch.dp.schedule.ScheduleModel``, one for each launch geometry
    the route may take on ``device`` (one for a plain route). Every route
    registers one."""

    name: str
    geometry: str
    run: Callable
    cost: Callable[[Spec, torch.device], float]
    supports: Callable[[Spec, torch.device], bool]
    batch_run: Optional[Callable] = None
    run_with_args: Optional[Callable] = None
    batch_run_with_args: Optional[Callable] = None
    batch_run_fused: Optional[Callable] = None
    run_extend: Optional[Callable] = None
    kernel: bool = False
    schedule: Optional[Callable] = None
    doc: str = ""


def register(backend: Backend) -> Backend:
    if backend.name in _BACKENDS:
        raise ValueError(f"duplicate backend name {backend.name!r}")
    _BACKENDS[backend.name] = backend
    return backend


def get(name: str) -> Backend:
    ensure_registered()
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: {names()}") from None


def names(geometry: Optional[str] = None) -> list:
    ensure_registered()
    return sorted(n for n, b in _BACKENDS.items()
                  if geometry is None or b.geometry == geometry)


def candidates(spec: Spec, device: torch.device) -> list:
    """Routes able to solve ``spec`` on ``device``, cheapest first (name
    tiebreak); on a CUDA device the kernel routes come first, each group in
    cost order."""
    ensure_registered()
    cands = [b for b in _BACKENDS.values()
             if b.geometry == spec.geometry and b.supports(spec, device)]
    plain_last = device.type == "cuda"
    return sorted(cands, key=lambda b: (plain_last and not b.kernel,
                                        b.cost(spec, device), b.name))


def ensure_registered() -> None:
    """Idempotently import every module that registers routes."""
    global _LOADED
    if _LOADED:
        return
    import repro_torch.core.sdp  # noqa: F401  (linear routes)
    import repro_torch.core.mcm  # noqa: F401  (triangular routes)
    import repro_torch.core.blocked_mcm  # noqa: F401  (tropical-GEMM route)
    import repro_torch.core.grid  # noqa: F401  (grid route)
    import repro_torch.kernels  # noqa: F401  (kernel routes)
    _LOADED = True


# ---------------------------------------------------------------------------
# Builders used by the registering modules
# ---------------------------------------------------------------------------
def host_stack(arrays) -> np.ndarray:
    """float32 ``(batch, ...)`` numpy array of the arrays (one conversion
    pass on the host)."""
    out = np.empty((len(arrays),) + np.shape(arrays[0]), dtype=np.float32)
    for i, a in enumerate(arrays):
        out[i] = a
    return out


def _stack(arrays, device: torch.device, sharding=None):
    """float32 ``(batch, ...)`` tensor on ``device`` from numpy arrays
    (:func:`host_stack`, one copy to the device); under ``sharding`` (a
    ``repro_torch.dp.sharding.ShardContext``) one tensor a slot it runs
    instead, each slot's contiguous share copied to its device
    (``ShardContext.stack``)."""
    if sharding is not None:
        return sharding.stack(arrays)
    return torch.from_numpy(host_stack(arrays)).to(device)


def _call(apply: Callable, stacked: tuple, sharding=None):
    """``apply(*stacked)`` on the stacked inputs of :func:`_stack`; under
    ``sharding`` once a slot on its shards, gathered in slot order."""
    if sharding is None:
        return apply(*stacked)
    return sharding.wrap(apply)(*stacked)


def _rows(t: torch.Tensor) -> list:
    return list(t.cpu().numpy())


def _backend(name: str, geometry: str, call: Callable, fn: Callable,
             cost: Callable, supports: Optional[Callable],
             arg_fn: Optional[Callable], kernel: bool, doc: str,
             fused: Optional[Callable] = None,
             run_extend: Optional[Callable] = None,
             schedule: Optional[Callable] = None) -> Backend:
    """A Backend whose batch paths run ``call(f, specs, device,
    sharding)`` with ``f = fn`` (the table) or ``f = arg_fn`` (``(table,
    args)``); ``fused(specs, device, sharding)`` (``(tables, argss,
    paths)``) is the fused batch path. Every batch path takes
    ``sharding=None``: a ``ShardContext`` runs it once a slot of its mesh
    on the slot's shard of the bucket."""

    def batch_run(specs, device, sharding=None) -> list:
        return _rows(call(fn, specs, device, sharding))

    run_with_args = batch_run_with_args = None
    if arg_fn is not None:
        def batch_run_with_args(specs, device, sharding=None):
            st, args = call(arg_fn, specs, device, sharding)
            return _rows(st), args

        def run_with_args(spec: Spec, device):
            sts, args = batch_run_with_args([spec], device)
            return sts[0], args[0].cpu().numpy()

    return Backend(name=name, geometry=geometry,
                   run=lambda spec, device: batch_run([spec], device)[0],
                   cost=cost, supports=supports or (lambda s, device: True),
                   batch_run=batch_run, run_with_args=run_with_args,
                   batch_run_with_args=batch_run_with_args,
                   batch_run_fused=fused, run_extend=run_extend,
                   kernel=kernel, schedule=schedule, doc=doc)


def linear_backend(name: str, fn: Callable, cost: Callable,
                   supports: Optional[Callable] = None,
                   arg_fn: Optional[Callable] = None, kernel: bool = False,
                   run_extend: Optional[Callable] = None,
                   schedule: Optional[Callable] = None,
                   doc: str = "") -> Backend:
    """Wrap a batched S-DP solver ``fn(init, offsets, op, n, weights=None)``
    into a Backend. ``arg_fn`` (same signature, returns ``(st, args)``)
    adds the arg-capable pair."""

    def call(f, specs, device, sharding=None):
        s0 = specs[0]
        init = _stack([s.init for s in specs], device, sharding)
        w = (None if s0.weights is None
             else _stack([s.weights for s in specs], device, sharding))
        return _call(lambda i, w: f(i, s0.offsets, s0.op, s0.n, weights=w),
                     (init, w), sharding)

    return _backend(name, "linear", call, fn, cost, supports, arg_fn, kernel,
                    doc, run_extend=run_extend, schedule=schedule)


def triangular_tab_backend(name: str, fn: Callable, cost: Callable,
                           supports: Optional[Callable] = None,
                           arg_fn: Optional[Callable] = None,
                           fused_fn: Optional[Callable] = None,
                           kernel: bool = False,
                           run_extend: Optional[Callable] = None,
                           schedule: Optional[Callable] = None,
                           doc: str = "") -> Backend:
    """Wrap a batched weight-table triangular solver ``fn(wtab, n)`` into a
    Backend; ``arg_fn`` (returns ``(st, args)``) adds the arg-capable pair,
    ``fused_fn`` (returns ``(st, args, (ii, dd, ee))``, the node arrays in
    ``triangular_traceback_np``'s preorder) the fused batch path."""

    def call(f, specs, device, sharding=None):
        n = specs[0].n
        return _call(lambda w: f(w, n),
                     (_stack([s.weights for s in specs], device, sharding),),
                     sharding)

    fused = None
    if fused_fn is not None:
        def fused(specs, device, sharding=None):
            st, args, nodes = call(fused_fn, specs, device, sharding)
            nodes = torch.stack(nodes, dim=-1).cpu().numpy().astype(np.int64)
            return _rows(st), _rows(args), [TriangularPath(nodes=x) for x in nodes]

    return _backend(name, "triangular", call, fn, cost, supports, arg_fn,
                    kernel, doc, fused, run_extend, schedule)


def grid_backend(name: str, fn: Callable, cost: Callable,
                 supports: Optional[Callable] = None,
                 arg_fn: Optional[Callable] = None, kernel: bool = False,
                 run_extend: Optional[Callable] = None,
                 schedule: Optional[Callable] = None,
                 doc: str = "") -> Backend:
    """Wrap a batched grid solver ``fn(arrs, meta)`` — ``arrs`` one stacked
    tensor per ``GridSpec.device_arrays()`` slot, ``meta`` the shared
    ``static_meta()`` — into a Backend; ``arg_fn`` (returns ``(st,
    args)``) adds the arg-capable pair."""

    def call(f, specs, device, sharding=None):
        meta = specs[0].static_meta()
        slots = zip(*(s.device_arrays() for s in specs))
        return _call(lambda *arrs: f(arrs, meta),
                     tuple(_stack(slot, device, sharding) for slot in slots),
                     sharding)

    return _backend(name, "grid", call, fn, cost, supports, arg_fn, kernel,
                    doc, run_extend=run_extend, schedule=schedule)


# shared cost vocabulary (the per-family step-count tables live on the
# spec classes' ``route_costs`` hooks)
def linear_costs(spec: LinearSpec) -> dict:
    return spec.route_costs()


def triangular_costs(spec: TriangularSpec) -> dict:
    return spec.route_costs()


def grid_costs(spec: GridSpec) -> dict:
    return spec.route_costs()


# shape-key plumbing for the calibration layer (repro_torch.dp.autotune) ----
#: measurement-regime markers a calibration key may end with: ``batch`` =
#: amortized per-instance ms of an engine bucket drain, ``reconstruct`` =
#: the arg-emitting solve, ``extend`` = warm-start extension solves. Sharded
#: drains (``repro_torch.dp.sharding``) end theirs with the tuple marker
#: ``("shard", ndev)``, or ``("shard", ndev, "reconstruct")`` for sharded
#: arg-emitting drains. Plain keys hold single-instance offline timings.
#: The regimes never cross-match.
SHAPE_KEY_REGIMES = ("batch", "reconstruct", "extend")


def is_regime_marker(x) -> bool:
    """Whether ``x`` is a measurement-regime marker (a string or the
    sharded tuple form)."""
    if x in SHAPE_KEY_REGIMES:
        return True
    return isinstance(x, tuple) and len(x) >= 2 and x[0] == "shard"


def split_shape_key(key: tuple) -> tuple:
    """``(geometric_key, regime_marker_or_None)`` of a calibration key."""
    if key and is_regime_marker(key[-1]):
        return key[:-1], key[-1]
    return key, None


def shape_key_size(key: tuple) -> int:
    """The table size a ``Spec.shape_key()`` encodes (the family's
    ``shape_key_size`` hook)."""
    key, _ = split_shape_key(key)
    return family_class(key[0]).shape_key_size(key)


def shape_key_distance(a: tuple, b: tuple) -> Optional[float]:
    """Table-size gap between two shape keys for nearest-shape calibration
    transfer, or None where a measurement cannot transfer: another family,
    another regime, or structure the family's ``shape_key_compatible``
    rejects."""
    a, regime_a = split_shape_key(a)
    b, regime_b = split_shape_key(b)
    if regime_a != regime_b or a[0] != b[0]:
        return None
    cls = family_class(a[0])
    if not cls.shape_key_compatible(a, b):
        return None
    return float(abs(cls.shape_key_size(a) - cls.shape_key_size(b)))


def spec_from_shape_key(key: tuple) -> Spec:
    """A placeholder spec with exactly the structure the cost models read
    (regime suffix stripped; the family's ``from_shape_key`` hook)."""
    key, _ = split_shape_key(key)
    return family_class(key[0]).from_shape_key(key)
