"""Solution reconstruction: arg tables → tracebacks → decoded answers.

  1. *args* — the per-cell winning argument (lane index for linear specs,
     split offset for triangular ones). Arg-capable routes emit it beside
     the cost table; for the others :func:`args_from_table` recovers it on
     the host by re-ranking each cell's candidates against the finished
     table.
  2. *path* — a lane walk (:class:`LinearPath`), a preorder split tree
     (:class:`TriangularPath`) or a move walk / rule tree
     (:class:`GridPath`). :func:`traceback_batch` walks every arg table of
     a same-shape bucket together where the route left them (the
     family's ``traceback_program`` hook: on the card for a kernel route),
     and only the paths come back to the host; host-recovered args are
     walked per instance on the host; a fused route walked its paths
     inside its solve launch.
  3. *decode* — ``DPProblem.decode(table, args, spec, path)``;
     :func:`reconstruct_one` wraps it all in an :class:`Answer`.

Every family-specific step is a hook on the spec class.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.dp import telemetry as _telemetry
from repro_torch.dp.problem import Answer, DPProblem, Path, Spec


def supports_args(spec: Spec) -> bool:
    """Whether argument tracking is defined for this spec."""
    return spec.supports_args()


def check_reconstructable(prob: DPProblem, spec: Spec) -> None:
    """Raise ValueError unless ``reconstruct=True`` is admissible for this
    (problem, instance): the one admission check the engine and the
    service both run."""
    if prob.decode is None:
        raise ValueError(f"problem {prob.name!r} does not define decode()")
    if not spec.supports_args():
        raise ValueError(
            f"problem {prob.name!r} instance has no argument structure "
            f"to reconstruct ({spec.args_unsupported_reason()})")


def args_from_table(table: np.ndarray, spec: Spec) -> np.ndarray:
    """Winning-argument table recomputed from a finished cost table."""
    return spec.args_from_table(table)


def start_cell(prob: DPProblem, table: np.ndarray, spec: Spec) -> int:
    """Traceback entry point: the problem's ``start`` hook or the family
    default."""
    if prob.start is not None:
        return int(prob.start(table, spec))
    return int(spec.default_start(table))


def traceback_host(args: np.ndarray, spec: Spec, start: int = -1) -> Path:
    """Per-instance host walk (the family's ``traceback_host``)."""
    return spec.traceback_host(args, start)


def traceback_batch(args, spec0: Spec,
                    starts: Optional[Sequence[int]] = None) -> list:
    """Walk every arg table of a same-shape bucket together: ``args`` is the
    route's ``(batch, cells)`` arg tensor, walked on its own device (the
    family's ``traceback_program`` hook); returns the paths."""
    return spec0.traceback_program()(args, starts)


def reconstruct_one(prob: DPProblem, spec: Spec, table: np.ndarray,
                    args: np.ndarray, source: str,
                    path: Optional[Path] = None) -> Answer:
    """Assemble an :class:`Answer`, walking the traceback on the host when
    no path is given."""
    if prob.decode is None:
        raise NotImplementedError(
            f"problem {prob.name!r} does not define decode()")
    if path is None:
        start = start_cell(prob, table, spec) if spec.uses_start else -1
        path = traceback_host(args, spec, start)
    solution = prob.decode(table, args, spec, path)
    return Answer(value=prob.extract(table, spec), solution=solution,
                  table=table, args=args, source=source)


def reconstruct_batch(prob: DPProblem, specs: Sequence[Spec],
                      tables: Sequence[np.ndarray], args, source: str,
                      paths: Optional[Sequence[Path]] = None) -> list:
    """Batch assembly. Route-emitted ``args`` (the ``(batch, cells)`` tensor
    the route left on its device) are walked together where they lie
    (:func:`traceback_batch`) and then copied to the host; host-recovered
    args (a list of arrays) by one host walk each; a fused route passes
    its ``paths`` in beside host args. The walk and the decode loop each
    report their time as a telemetry phase (``traceback`` / ``decode``):
    onto the engine's open drain report, and into the registry histograms
    (no-op when telemetry is off)."""
    spec0 = specs[0]
    t0 = time.perf_counter()
    if paths is not None:
        paths = list(paths)
    elif source == "device":
        starts = None
        if spec0.uses_start:
            starts = [start_cell(prob, t, s) for t, s in zip(tables, specs)]
        paths = traceback_batch(args, spec0, starts)
    else:
        paths = [traceback_host(a, s,
                                start_cell(prob, t, s) if s.uses_start else -1)
                 for a, s, t in zip(args, specs, tables)]
    if isinstance(args, torch.Tensor):
        args = list(args.cpu().numpy())
    t1 = time.perf_counter()
    _telemetry.add_phase("traceback", (t1 - t0) * 1e3)
    answers = [reconstruct_one(prob, s, t, a, source, path=p)
               for s, t, a, p in zip(specs, tables, args, paths)]
    _telemetry.add_phase("decode", (time.perf_counter() - t1) * 1e3)
    return answers
