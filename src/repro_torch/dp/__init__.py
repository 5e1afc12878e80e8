"""repro_torch.dp — the declarative DP problem zoo and its routes, on
PyTorch.

Layers:

  problem     — the spec-family protocol (FAMILIES) + LinearSpec /
                TriangularSpec / GridSpec canonical forms, DPProblem,
                Answer / LinearPath / TriangularPath / GridPath,
                spec_digest, spec_from_reference
  registry    — name -> DPProblem (the zoo populates it at import)
  backends    — solver routes registered by core/sdp, core/mcm, core/grid
                and kernels
  zoo         — sdp, edit_distance, lcs, viterbi, unbounded_knapsack, mcm,
                optimal_bst, polygon_triangulation, needleman_wunsch,
                gotoh, cky, edit_distance_grid, lcs_grid (all decodable)
  routing     — analytical dispatch + the batched solve
  reconstruct — arg tables → host tracebacks → decoded Answers

Every entry point takes ``device=`` and defaults to the card::

    from repro_torch import dp
    ans = dp.solve("mcm", dims=[30, 35, 15, 5], reconstruct=True)
    ans.value, ans.solution["string"]        # cost, '((A0·A1)·A2)'
    dp.solve("edit_distance", x=[1, 2, 3], y=[1, 3], device="cpu")
"""
from repro_torch.dp import backends, reconstruct, registry, routing, zoo  # noqa: F401
from repro_torch.dp.problem import (  # noqa: F401
    Answer, DPProblem, GridPath, GridSpec, LinearPath, LinearSpec, Spec,
    TriangularPath, TriangularSpec, spec_digest, spec_from_reference)
from repro_torch.dp.registry import get as get_problem  # noqa: F401
from repro_torch.dp.registry import names as problem_names  # noqa: F401
from repro_torch.dp.registry import problems  # noqa: F401
from repro_torch.dp.routing import (  # noqa: F401
    batch_solve, batch_solve_specs, dispatch, solve, solve_spec)

route = dispatch

__all__ = [
    "Answer", "DPProblem", "GridPath", "GridSpec", "LinearPath",
    "LinearSpec", "Spec",
    "TriangularPath", "TriangularSpec", "backends", "batch_solve",
    "batch_solve_specs", "dispatch", "get_problem", "problem_names",
    "problems", "reconstruct", "registry", "route", "routing", "solve",
    "solve_spec", "spec_digest", "spec_from_reference", "zoo",
]
