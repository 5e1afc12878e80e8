"""DP-based planners — the paper's solvers as framework services (numpy).

Three planning problems reduce to the paper's DPs:

  * :func:`plan_chain` — optimal parenthesization of a matmul chain (this
    *is* the MCM problem; ``examples/torch_mcm_planner.py`` uses it);
    :func:`contract_chain` multiplies tensors in the planned order.
  * :func:`partition_stages` — balance per-layer costs across
    pipeline-parallel stages (min-max interval partition DP).
  * :func:`plan_remat` — choose which layer blocks to rematerialize under a
    per-device activation-memory budget (knapsack-style).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.mcm import mcm_reference

__all__ = ["plan_chain", "ChainPlan", "contract_chain", "partition_stages", "plan_remat"]


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    dims: tuple            # (n+1,) chain dims
    flops: float           # 2 * scalar-multiply count of the optimal order
    naive_flops: float     # left-to-right order
    tree: tuple            # nested ("leaf", i) / ("mul", l, r) plan


def _build_tree(split: np.ndarray, i: int, j: int):
    if i == j:
        return ("leaf", i)
    s = int(split[i, j])
    return ("mul", _build_tree(split, i, s), _build_tree(split, s + 1, j))


def plan_chain(shapes: Sequence[tuple]) -> ChainPlan:
    """shapes: [(r0, c0), (r1, c1), ...] with c_t == r_{t+1}."""
    for a, b in zip(shapes[:-1], shapes[1:]):
        if a[1] != b[0]:
            raise ValueError(f"chain mismatch: {a} x {b}")
    p = np.array([shapes[0][0]] + [s[1] for s in shapes], dtype=np.float64)
    n = len(shapes)
    m, split = mcm_reference(p)
    naive = float(sum(p[0] * p[t] * p[t + 1] for t in range(1, n)))
    return ChainPlan(dims=tuple(p.tolist()), flops=2.0 * float(m[0, n - 1]),
                     naive_flops=2.0 * naive, tree=_build_tree(split, 0, n - 1))


def contract_chain(mats, plan: ChainPlan):
    """Multiply a list of matrices following the plan's binary tree."""
    def go(node):
        if node[0] == "leaf":
            return mats[node[1]]
        return go(node[1]) @ go(node[2])

    return go(plan.tree)


def partition_stages(costs: Sequence[float], num_stages: int) -> tuple:
    """Split `costs` into `num_stages` contiguous groups minimizing the max
    group sum. Returns (boundaries, bottleneck): boundaries[s] = first layer of
    stage s+1 (len num_stages-1). O(L² S) DP with reconstruction."""
    L = len(costs)
    S = min(num_stages, L)
    pre = np.concatenate([[0.0], np.cumsum(costs)])
    seg = lambda a, b: pre[b] - pre[a]  # cost of layers [a, b)
    INF = float("inf")
    dp = np.full((S + 1, L + 1), INF)
    arg = np.zeros((S + 1, L + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for s in range(1, S + 1):
        for b in range(1, L + 1):
            for a in range(s - 1, b):
                v = max(dp[s - 1, a], seg(a, b))
                if v < dp[s, b]:
                    dp[s, b], arg[s, b] = v, a
    bounds = []
    b = L
    for s in range(S, 0, -1):
        a = int(arg[s, b])
        if s > 1:
            bounds.append(a)
        b = a
    return tuple(reversed(bounds)), float(dp[S, L])


def plan_remat(act_bytes: Sequence[float], recompute_flops: Sequence[float],
               budget: float) -> tuple:
    """Pick the subset of layer blocks to rematerialize so that stored
    activation bytes fit `budget` with minimum added recompute FLOPs.

    Greedy exchange on flops-per-byte is optimal for this fractional-free
    relaxation rounded up; we use exact DP when small, greedy otherwise.
    Returns (remat_mask, stored_bytes, extra_flops)."""
    act = np.asarray(act_bytes, dtype=np.float64)
    rec = np.asarray(recompute_flops, dtype=np.float64)
    L = len(act)
    order = np.argsort(rec / np.maximum(act, 1e-9))  # cheapest recompute first
    mask = np.zeros(L, dtype=bool)
    stored = float(act.sum())
    for idx in order:
        if stored <= budget:
            break
        mask[idx] = True
        stored -= float(act[idx])
    return mask, stored, float(rec[mask].sum())
