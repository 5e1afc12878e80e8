"""Problem registry: name -> DPProblem, populated by ``repro_torch.dp.zoo``
at import time."""
from __future__ import annotations

from repro_torch.dp.problem import FAMILIES, DPProblem

_PROBLEMS: dict = {}


def register(problem: DPProblem) -> DPProblem:
    if problem.name in _PROBLEMS:
        raise ValueError(f"duplicate problem name {problem.name!r}")
    if problem.geometry not in FAMILIES:
        raise ValueError(f"unknown geometry {problem.geometry!r}; "
                         f"registered families: {sorted(FAMILIES)}")
    _PROBLEMS[problem.name] = problem
    return problem


def get(name: str) -> DPProblem:
    try:
        return _PROBLEMS[name]
    except KeyError:
        raise KeyError(f"unknown DP problem {name!r}; registered: {names()}") from None


def names() -> list:
    return sorted(_PROBLEMS)


def problems() -> list:
    return [_PROBLEMS[n] for n in names()]
