"""Solution reconstruction: arg tables → tracebacks → decoded answers.

  1. *args* — the per-cell winning argument (lane index for linear specs,
     split offset for triangular ones). Arg-capable routes emit it beside
     the cost table; for the others :func:`args_from_table` recovers it on
     the host by re-ranking each cell's candidates against the finished
     table.
  2. *path* — a lane walk (:class:`LinearPath`) or a preorder split tree
     (:class:`TriangularPath`), walked on the host per instance unless a
     fused route walked it inside its solve launch.
  3. *decode* — ``DPProblem.decode(table, args, spec, path)``;
     :func:`reconstruct_one` wraps it all in an :class:`Answer`.

Every family-specific step is a hook on the spec class.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.dp.problem import Answer, DPProblem, Path, Spec


def supports_args(spec: Spec) -> bool:
    """Whether argument tracking is defined for this spec."""
    return spec.supports_args()


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
                      tables: Sequence[np.ndarray],
                      argss: Sequence[np.ndarray], source: str,
                      paths: Optional[Sequence[Path]] = None) -> list:
    """Batch assembly: one decode per instance, after one host walk each
    unless a fused route passes its ``paths`` in."""
    paths = [None] * len(specs) if paths is None else list(paths)
    return [reconstruct_one(prob, s, t, a, source, path=p)
            for s, t, a, p in zip(specs, tables, argss, paths)]
