"""Shape-aware routing of specs to solver routes, plus the batched solve.

``dispatch(spec, device=...)`` ranks the routes that support the spec on
the device by ``(cost(spec, device), name)`` — ``repro.dp``'s order with an
empty calibration table, kernel routes first on the card — and under
``reconstruct`` prefers arg-capable routes. ``solve`` / ``solve_spec`` run
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

from repro_torch.dp import backends as _backends
from repro_torch.dp import reconstruct as _reconstruct
from repro_torch.dp import registry as _registry
from repro_torch.dp.problem import DPProblem, Spec


def _resolve(problem: Union[str, DPProblem]) -> DPProblem:
    return _registry.get(problem) if isinstance(problem, str) else problem


def _best(spec: Spec, device, reconstruct: bool) -> _backends.Backend:
    cands = _backends.candidates(spec, device)
    if not cands:
        raise RuntimeError(f"no backend supports spec {spec.shape_key()}")
    if reconstruct and _reconstruct.supports_args(spec):
        arg_capable = [b for b in cands if b.run_with_args is not None]
        if arg_capable:
            return arg_capable[0]
    return cands[0]


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
                    device=None) -> _backends.Backend:
    """Resolve a route exactly once: dispatch or an explicit override
    (validated here)."""
    device = _backends.resolve_device(device)
    if backend is None:
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


def run_batch(b: _backends.Backend, specs: Sequence[Spec], device=None) -> list:
    """Run a resolved route over a homogeneous batch in one call."""
    return b.batch_run(list(specs), _backends.resolve_device(device))


def run_batch_with_args(b: _backends.Backend, specs: Sequence[Spec],
                        device=None):
    """Batched :func:`run_with_args`; returns ``(tables, argss, source,
    paths)``, with ``paths`` the in-launch tracebacks of a fused route and
    None elsewhere."""
    device = _backends.resolve_device(device)
    specs = list(specs)
    if _reconstruct.supports_args(specs[0]):
        if b.batch_run_fused is not None:
            tables, argss, paths = b.batch_run_fused(specs, device)
            return tables, argss, "device", paths
        if b.batch_run_with_args is not None:
            tables, argss = b.batch_run_with_args(specs, device)
            return tables, argss, "device", None
    tables = run_batch(b, specs, device)
    argss = [_reconstruct.args_from_table(t, s) for t, s in zip(tables, specs)]
    return tables, argss, "host", None


def batch_solve_specs(specs: Sequence[Spec], backend: Optional[str] = None,
                      device=None) -> list:
    """Batched solve over homogeneous specs; returns linearized tables."""
    specs = list(specs)
    if not specs:
        return []
    device = _backends.resolve_device(device)
    b = resolve_backend(specs[0], backend, device=device)
    return run_batch(b, specs, device)


def batch_solve_specs_with_args(specs: Sequence[Spec],
                                backend: Optional[str] = None, device=None):
    """Batched arg-tracking solve; returns ``(tables, argss, source,
    paths)`` (``paths`` non-None only on fused routes)."""
    specs = list(specs)
    if not specs:
        return [], [], "device", None
    device = _backends.resolve_device(device)
    b = resolve_backend(specs[0], backend, reconstruct=True, device=device)
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
    tables, argss, source, paths = batch_solve_specs_with_args(
        specs, backend=backend, device=device)
    return _reconstruct.reconstruct_batch(prob, specs, tables, argss, source,
                                          paths=paths)
