"""repro_torch.dp — the declarative DP problem zoo, its routes and the
serving stack, on PyTorch.

Layers:

  problem     — the spec-family protocol (FAMILIES) + LinearSpec /
                TriangularSpec / GridSpec canonical forms, DPProblem,
                Answer / LinearPath / TriangularPath / GridPath,
                spec_digest, spec_from_reference, the extension and
                digest-chain hooks
  registry    — name -> DPProblem (the zoo populates it at import)
  backends    — solver routes registered by core/sdp, core/mcm, core/grid
                and kernels
  zoo         — sdp, edit_distance, lcs, viterbi, unbounded_knapsack, mcm,
                optimal_bst, polygon_triangulation, needleman_wunsch,
                gotoh, cky, edit_distance_grid, lcs_grid (all decodable)
  autotune    — measured-latency calibration tables; calibrate() /
                routing_report(); the engine's online feedback sink
  routing     — two-tier (measured > analytical) dispatch + the batched
                solve
  reconstruct — arg tables → batched tracebacks → decoded Answers
  engine      — DPEngine: bucketed request/response front end, one solve
                (one kernel launch on a kernel route) per drain
  sharding    — ShardContext / ShardedDPEngine: bucket drains split over a
                mesh of slots (cards, or one card's concurrent streams)
  streaming   — ResumeToken / resume_solve warm starts + the chain-digest
                longest-prefix answer cache (PrefixIndex)
  service     — DPService: tickets, admission control with deadlines and
                priorities, the content-digest answer cache, streaming
                sessions
  telemetry   — request spans, metrics registry, routing audit, exporters

Every entry point takes ``device=`` and defaults to the card::

    from repro_torch import dp
    ans = dp.solve("mcm", dims=[30, 35, 15, 5], reconstruct=True)
    ans.value, ans.solution["string"]        # cost, '((A0·A1)·A2)'
    dp.solve("edit_distance", x=[1, 2, 3], y=[1, 3], device="cpu")
    svc = dp.DPService(max_batch=32)
    tid = svc.submit("mcm", dims=[30, 35, 15, 5], priority=1)
    res = svc.run()[tid]                     # res.answer, res.backend
"""
from repro_torch.dp import backends, reconstruct, registry, routing, zoo  # noqa: F401
from repro_torch.dp import autotune  # noqa: F401
from repro_torch.dp.autotune import calibrate, routing_report  # noqa: F401
from repro_torch.dp.engine import DPEngine, DPRequest, DPResponse  # noqa: F401
from repro_torch.dp.problem import (  # noqa: F401
    Answer, DPProblem, GridPath, GridSpec, LinearPath, LinearSpec, Spec,
    TriangularPath, TriangularSpec, spec_digest, spec_from_reference)
from repro_torch.dp.registry import get as get_problem  # noqa: F401
from repro_torch.dp.registry import names as problem_names  # noqa: F401
from repro_torch.dp.registry import problems  # noqa: F401
from repro_torch.dp.routing import (  # noqa: F401
    batch_solve, batch_solve_specs, dispatch, solve, solve_spec)
from repro_torch.dp.sharding import (  # noqa: F401
    ShardContext, ShardedDPEngine, default_mesh)
from repro_torch.dp.service import (  # noqa: F401
    AdmissionError, DPService, ServiceResult, Session)
from repro_torch.dp.streaming import PrefixIndex, ResumeToken, resume_solve  # noqa: F401
from repro_torch.dp.telemetry import Span  # noqa: F401
from repro_torch.dp import service, sharding, streaming, telemetry  # noqa: F401

route = dispatch

__all__ = [
    "AdmissionError", "Answer", "DPEngine", "DPProblem", "DPRequest",
    "DPResponse", "DPService", "GridPath", "GridSpec", "LinearPath",
    "LinearSpec", "PrefixIndex", "ResumeToken", "ServiceResult", "Session",
    "Span", "Spec", "TriangularPath", "TriangularSpec", "autotune",
    "backends", "batch_solve", "batch_solve_specs", "calibrate", "dispatch",
    "get_problem", "problem_names", "problems", "reconstruct", "registry",
    "resume_solve", "route", "routing", "routing_report", "service",
    "ShardContext", "ShardedDPEngine", "default_mesh", "sharding",
    "solve", "solve_spec", "spec_digest", "spec_from_reference",
    "streaming", "telemetry", "zoo",
]
