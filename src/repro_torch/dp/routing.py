"""Shape-aware routing of specs to solver routes, plus the batched solve.

``dispatch(spec, device=...)`` ranks the routes that support the spec on
the device in two tiers: *measured* latencies from the calibration table
(``repro_torch.dp.autotune``) first, then the analytical order
``(cost(spec, device), name)`` — kernel routes first on the card — as prior
and tiebreak. With an empty table the ranking is exactly the analytical
one, and a measurement only reorders routes that ``supports(spec,
device)`` admitted. Under ``reconstruct`` dispatch prefers arg-capable
routes. ``batch_candidates`` orders the pool of a bucket drain (batchable
routes ahead of loop-only ones, measured on the engine's regimes);
``extend_candidates`` / ``run_extend`` serve warm starts. ``solve`` / ``solve_spec`` run
the choice; ``batch_solve`` stacks B same-shape instances into one call of
the chosen route. Under ``reconstruct``, a fused route returns
the traceback walked inside its solve launch, and no host walk runs.

Every entry point takes ``device=`` (default: the card; see
``backends.resolve_device``). An explicit ``backend=`` is validated here; a
dispatched route was already validated by ``backends.candidates``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.dp import autotune as _autotune
from repro_torch.dp import backends as _backends
from repro_torch.dp import reconstruct as _reconstruct
from repro_torch.dp import registry as _registry
from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.problem import DPProblem, Spec

#: calibration-key regime markers (``backends.SHAPE_KEY_REGIMES``):
#: arg-emitting solves, amortized bucket drains and warm starts cost
#: differently from plain single-instance solves and never share entries
RECONSTRUCT_SUFFIX = ("reconstruct",)
BATCH_SUFFIX = ("batch",)
EXTEND_SUFFIX = ("extend",)


def _resolve(problem: Union[str, DPProblem]) -> DPProblem:
    return _registry.get(problem) if isinstance(problem, str) else problem


def _best(spec: Spec, device, reconstruct: bool) -> _backends.Backend:
    """Both paths rank on plain (single-instance) entries: the engine's
    regime entries are batch-amortized, the wrong figure for one call."""
    cands = _backends.candidates(spec, device)
    if not cands:
        raise RuntimeError(f"no backend supports spec {spec.shape_key()}")
    _telemetry.count("dp_routing_dispatch_total")
    if reconstruct and _reconstruct.supports_args(spec):
        arg_capable = [b for b in cands if b.run_with_args is not None]
        if arg_capable:
            return _autotune.rank(spec, arg_capable, device=device)[0]
    return _autotune.rank(spec, cands, device=device)[0]


def batch_candidates(spec: Spec, reconstruct: bool = False, device=None,
                     batch_suffix: Optional[tuple] = None,
                     loop_suffix: Optional[tuple] = None) -> list:
    """Ordered route pool for a homogeneous bucket on ``device``. Structure
    first — arg-capable routes under ``reconstruct``, batchable routes
    ahead of loop-only ones otherwise — then the measured ranking on top
    (``autotune.rank_batch``: a loop-only route overrules the batching
    prior only on an amortized drain measurement). With no measurements
    the order is the analytical one. The engine explores alternates from
    exactly this pool.

    ``batch_suffix`` / ``loop_suffix`` select the measurement regimes the
    batchable and loop-only routes rank on (defaults: the single-device
    regimes). The sharded engine passes its ``("shard", ndev)`` regime as
    ``batch_suffix``; loop-only routes run unsharded there, so they keep
    ranking on their own regime."""
    device = _backends.resolve_device(device, check=False)
    cands = _backends.candidates(spec, device)
    if not cands:
        raise RuntimeError(f"no backend supports spec {spec.shape_key()}")
    if reconstruct and _reconstruct.supports_args(spec):
        pool = [c for c in cands if c.batch_run_with_args is not None]
        if pool:
            return _autotune.rank(spec, pool,
                                  suffix=batch_suffix or RECONSTRUCT_SUFFIX,
                                  device=device)
    batchable = [c for c in cands if c.batch_run is not None]
    loop_only = [c for c in cands if c.batch_run is None]
    return _autotune.rank_batch(spec, batchable, loop_only,
                                batch_suffix=batch_suffix or BATCH_SUFFIX,
                                loop_suffix=loop_suffix or BATCH_SUFFIX,
                                device=device)


def select_batch_backend(spec: Spec, reconstruct: bool = False,
                         device=None) -> _backends.Backend:
    """The head of :func:`batch_candidates`."""
    return batch_candidates(spec, reconstruct=reconstruct, device=device)[0]


def dispatch(spec_or_problem, reconstruct: bool = False, device=None,
             **instance) -> _backends.Backend:
    """Cheapest supporting route for a spec (or a problem + instance) on
    ``device``. With ``reconstruct`` the cheapest *arg-capable* route wins
    when one exists."""
    if isinstance(spec_or_problem, (str, DPProblem)) or instance:
        spec = _resolve(spec_or_problem).encode(**instance)
    else:
        spec = spec_or_problem
    return _best(spec, _backends.resolve_device(device), reconstruct)


def resolve_backend(spec: Spec, backend=None, reconstruct: bool = False,
                    device=None, batch: bool = False) -> _backends.Backend:
    """Resolve a route exactly once: dispatch (the bucket pool's head with
    ``batch``) or an explicit override (validated here)."""
    device = _backends.resolve_device(device)
    if backend is None:
        if batch:
            return select_batch_backend(spec, reconstruct, device)
        return _best(spec, device, reconstruct)
    b = backend if isinstance(backend, _backends.Backend) else _backends.get(backend)
    if not (b.geometry == spec.geometry and b.supports(spec, device)):
        raise ValueError(f"backend {b.name!r} does not support this spec on "
                         f"{device}")
    return b


def solve_spec(spec: Spec, backend: Optional[str] = None,
               device=None) -> np.ndarray:
    """Solve one canonical spec; returns the full linearized table."""
    device = _backends.resolve_device(device)
    return resolve_backend(spec, backend, device=device).run(spec, device)


def run_with_args(b: _backends.Backend, spec: Spec, device=None):
    """Run a resolved route with arg tracking. Returns ``(table, args,
    source)`` — solver-emitted args when the route can, the numpy fallback
    from the cost table otherwise."""
    device = _backends.resolve_device(device)
    if b.run_with_args is not None and _reconstruct.supports_args(spec):
        table, args = b.run_with_args(spec, device)
        return table, args, "device"
    table = b.run(spec, device)
    return table, _reconstruct.args_from_table(table, spec), "host"


def solve_spec_with_args(spec: Spec, backend: Optional[str] = None,
                         device=None):
    """Solve one spec with arg tracking; returns ``(table, args, source)``."""
    device = _backends.resolve_device(device)
    return run_with_args(resolve_backend(spec, backend, reconstruct=True,
                                         device=device), spec, device)


def solve(problem: Union[str, DPProblem], backend: Optional[str] = None,
          reconstruct: bool = False, device=None, **instance):
    """Encode an instance, route it, and return the problem-level answer —
    the ``extract`` value, or an :class:`Answer` under ``reconstruct``."""
    prob = _resolve(problem)
    spec = prob.encode(**instance)
    if not reconstruct:
        return prob.extract(solve_spec(spec, backend, device), spec)
    device = _backends.resolve_device(device)
    b = resolve_backend(spec, backend, reconstruct=True, device=device)
    tables, argss, source, paths = run_batch_with_args(b, [spec], device)
    return _reconstruct.reconstruct_batch(prob, [spec], tables, argss, source,
                                          paths=paths)[0]


def extend_candidates(spec: Spec, device=None) -> list:
    """Routes that support the extended ``spec`` on ``device`` and declare
    ``run_extend``, ranked on the ``extend`` regime (a warm start
    recomputes only the extension, so its latencies never share entries
    with cold solves)."""
    device = _backends.resolve_device(device, check=False)
    cands = [b for b in _backends.candidates(spec, device)
             if b.run_extend is not None]
    if not cands:
        return []
    return _autotune.rank(spec, cands, suffix=EXTEND_SUFFIX, device=device)


def run_extend(spec: Spec, old_len: int, state, backend=None, device=None):
    """Warm-start extension solve on the best extend-capable route (or an
    explicit override, validated here). ``state`` is the prefix's
    ``extension_state(...)``; returns what ``spec.stitch_extension``
    assembles."""
    device = _backends.resolve_device(device)
    if backend is not None:
        b = (backend if isinstance(backend, _backends.Backend)
             else _backends.get(backend))
        if b.run_extend is None or not (b.geometry == spec.geometry
                                        and b.supports(spec, device)):
            raise ValueError(f"backend {b.name!r} cannot extend this spec")
    else:
        cands = extend_candidates(spec, device)
        if not cands:
            raise RuntimeError(
                f"no extend-capable backend for spec {spec.shape_key()}")
        b = cands[0]
    _telemetry.count("dp_routing_extend_total")
    return b.run_extend(spec, old_len, state, device)


def run_batch(b: _backends.Backend, specs: Sequence[Spec], device=None,
              sharding=None) -> list:
    """Run a resolved route over a homogeneous batch: one call on a
    batchable route, a loop of single solves on a loop-only one.
    ``sharding`` (a ``repro_torch.dp.sharding.ShardContext``) splits the
    batch over its mesh's slots — only on batchable routes, whose batch the
    caller already padded to the mesh size."""
    device = _backends.resolve_device(device)
    if b.batch_run is not None:
        _telemetry.count("dp_routing_batch_runs_total")
        return b.batch_run(list(specs), device, sharding=sharding)
    _telemetry.count("dp_routing_loop_fallback_total")
    return [b.run(s, device) for s in specs]


def run_batch_with_args(b: _backends.Backend, specs: Sequence[Spec],
                        device=None, sharding=None):
    """Batched :func:`run_with_args`; returns ``(tables, args, source,
    paths)``: ``args`` the route's ``(batch, cells)`` tensor on ``device``
    (source ``"device"``) or host-recovered arrays (``"host"``), ``paths``
    the in-launch tracebacks of a fused route (beside host args) and None
    elsewhere. ``sharding`` as in :func:`run_batch` (the args gathered on
    its first slot's device)."""
    device = _backends.resolve_device(device)
    specs = list(specs)
    if _reconstruct.supports_args(specs[0]):
        if b.batch_run_fused is not None:
            _telemetry.count("dp_routing_args_device_total")
            _telemetry.count("dp_routing_fused_total")
            tables, argss, paths = b.batch_run_fused(specs, device,
                                                     sharding=sharding)
            return tables, argss, "device", paths
        if b.batch_run_with_args is not None:
            _telemetry.count("dp_routing_args_device_total")
            tables, args = b.batch_run_with_args(specs, device,
                                                 sharding=sharding)
            return tables, args, "device", None
    _telemetry.count("dp_routing_args_host_total")
    tables = run_batch(b, specs, device, sharding=sharding)
    argss = [_reconstruct.args_from_table(t, s) for t, s in zip(tables, specs)]
    return tables, argss, "host", None


def batch_solve_specs(specs: Sequence[Spec], backend: Optional[str] = None,
                      device=None) -> list:
    """Batched solve over homogeneous specs; returns linearized tables."""
    specs = list(specs)
    if not specs:
        return []
    device = _backends.resolve_device(device)
    b = resolve_backend(specs[0], backend, device=device, batch=True)
    return run_batch(b, specs, device)


def batch_solve_specs_with_args(specs: Sequence[Spec],
                                backend: Optional[str] = None, device=None):
    """Batched arg-tracking solve; returns ``(tables, argss, source,
    paths)`` (``paths`` non-None only on fused routes)."""
    specs = list(specs)
    if not specs:
        return [], [], "device", None
    device = _backends.resolve_device(device)
    b = resolve_backend(specs[0], backend, reconstruct=True, device=device,
                        batch=True)
    return run_batch_with_args(b, specs, device)


def batch_solve(problem: Union[str, DPProblem], instances: Sequence[dict],
                backend: Optional[str] = None, reconstruct: bool = False,
                device=None) -> list:
    """Solve B instances of one problem that share a shape_key: one call of
    the selected route (one kernel launch on the kernel routes). Under
    ``reconstruct`` the return is a list of :class:`Answer`."""
    prob = _resolve(problem)
    specs = [prob.encode(**kw) for kw in instances]
    if not specs:
        return []
    keys = {s.shape_key() for s in specs}
    if len(keys) > 1:
        raise ValueError(f"heterogeneous batch: {sorted(keys)}; "
                         "bucket by shape_key first")
    if not reconstruct:
        tables = batch_solve_specs(specs, backend=backend, device=device)
        return [prob.extract(t, s) for t, s in zip(tables, specs)]
    device = _backends.resolve_device(device)
    tables, argss, source, paths = batch_solve_specs_with_args(
        specs, backend=backend, device=device)
    return _reconstruct.reconstruct_batch(prob, specs, tables, argss, source,
                                          paths=paths)
