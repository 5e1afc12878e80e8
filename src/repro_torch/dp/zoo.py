"""The DP problem zoo: classic scenarios reduced to the canonical forms.

Linear (weighted S-DP):
  * ``sdp``                — the paper's Definition-1 problem itself
  * ``edit_distance``      — Levenshtein on a row-major linearized grid,
                             offsets (W+1, W, 1), min-plus weights
  * ``lcs``                — longest common subsequence, max-plus weights
  * ``viterbi``            — HMM decoding; trellis rows linearized with
                             offsets {1..2S-1} and -inf masking
  * ``unbounded_knapsack`` — offsets = distinct item weights ∪ {1},
                             constant per-lane max-plus weights

Triangular (canonical split form):
  * ``mcm``                    — matrix-chain multiplication (paper §IV)
  * ``optimal_bst``            — optimal binary search tree; split-independent
                                 weight W(i,j) = Σ freq[i..j-1]
  * ``polygon_triangulation``  — min-cost triangulation ≡ MCM with
                                 dims = vertex weights

Grid (multi-plane wavefronts):
  * ``needleman_wunsch``   — global alignment, linear gaps (antidiag)
  * ``gotoh``              — affine-gap alignment, three planes (antidiag)
  * ``cky``                — Viterbi CKY parsing, one plane per
                             nonterminal (spandiag)
  * ``edit_distance_grid`` / ``lcs_grid`` — the linear problems on their
                             native grid: equal answers through another family

Encoders, oracles, samplers and decoders are numpy and produce the same
specs, digests and answers as ``repro.dp.zoo``. Every entry carries an
independent numpy oracle (the textbook recurrence in its native shape).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import mcm as _mcm
from repro_torch.core import sdp as _sdp
from repro_torch.dp.problem import (DPProblem, GridSpec, LinearSpec,
                                    TriangularSpec, lin_index)
from repro_torch.dp.registry import register

_NEG = -np.inf
_POS = np.inf


# ===========================================================================
# sdp — the paper's own problem (pure semigroup form)
# ===========================================================================
def _sdp_encode(init, offsets, op, n):
    spec = LinearSpec(offsets=tuple(int(a) for a in offsets), op=op, n=int(n),
                      init=np.asarray(init, dtype=np.float32))
    spec.validate()
    return spec


def _sdp_oracle(init, offsets, op, n):
    return _sdp.sdp_reference(np.asarray(init, dtype=np.float32),
                              tuple(offsets), op, int(n)).astype(np.float64)


def _sdp_sample(rng, size):
    n = max(8, int(size))
    a1 = int(rng.integers(2, min(12, n - 1)))
    k = int(rng.integers(1, a1 + 1))
    offs = np.sort(rng.choice(np.arange(1, a1 + 1), size=k, replace=False))[::-1]
    offs[0] = a1
    offs = tuple(int(a) for a in sorted(set(offs), reverse=True))
    return {
        "init": rng.normal(size=a1).astype(np.float32),
        "offsets": offs,
        "op": str(rng.choice(["min", "max"])),
        "n": n,
    }


def _sdp_decode(table, args, spec, path):
    """The witness chain of the last cell: which offset each visited cell
    took, ending in the preset init cell that the optimum flows from (for
    min/max semigroups, ST[n-1] == init[terminal])."""
    offs = np.asarray(spec.offsets)
    return {"cells": [int(c) for c in path.cells],
            "offsets_taken": [int(o) for o in offs[path.lanes]],
            "terminal": int(path.stop)}


register(DPProblem(
    name="sdp", geometry="linear",
    encode=_sdp_encode, oracle=_sdp_oracle,
    extract=lambda table, spec: table,
    sample=_sdp_sample, decode=_sdp_decode,
    doc="Definition-1 S-DP: ST[i] = ⊗_j ST[i-a_j]; answer = full table."))


# ===========================================================================
# edit_distance — (m+1)×(|y|+1) grid, row-major; offsets (W+1, W, 1)
# ===========================================================================
def _edit_encode(x, y):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    if m < 1 or c < 1:
        raise ValueError("edit_distance needs non-empty sequences")
    W = c + 1                      # row width of the padded grid
    n = (m + 1) * W
    w = np.full((n, 3), _POS)      # lanes: 0=diag(W+1), 1=up(W), 2=left(1)
    rows = np.arange(1, m + 1)[:, None]
    cols = np.arange(0, W)[None, :]
    cells = (rows * W + cols).ravel()
    jj = np.broadcast_to(cols, (m, W)).ravel()
    ii = np.broadcast_to(rows, (m, W)).ravel()
    w[cells, 1] = 1.0                                  # deletion (up) always
    interior = jj >= 1
    ci, cj = ii[interior], jj[interior]
    w[cells[interior], 0] = np.where(x[ci - 1] == y[cj - 1], 0.0, 1.0)
    w[cells[interior], 2] = 1.0                        # insertion (left)
    init = np.concatenate([np.arange(W, dtype=np.float32), [1.0]])
    spec = LinearSpec(offsets=(W + 1, W, 1), op="min", n=n,
                      init=init.astype(np.float32),
                      weights=w.astype(np.float32))
    spec.validate()
    return spec


def _edit_oracle(x, y):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    D = np.zeros((m + 1, c + 1))
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(c + 1)
    for i in range(1, m + 1):
        for j in range(1, c + 1):
            sub = D[i - 1, j - 1] + (0.0 if x[i - 1] == y[j - 1] else 1.0)
            D[i, j] = min(sub, D[i - 1, j] + 1.0, D[i, j - 1] + 1.0)
    return D.reshape(-1)


def _edit_sample(rng, size):
    m = int(rng.integers(2, max(3, size)))
    c = int(rng.integers(2, max(3, size)))
    return {"x": rng.integers(0, 4, size=m), "y": rng.integers(0, 4, size=c)}


def _edit_decode(table, args, spec, path):
    """Alignment script x→y in forward order: ('match'|'sub', i, j),
    ('del', i), ('ins', j) with 0-based sequence positions. The walk covers
    the grid down to the preset region; the terminal init cell contributes
    the leading column-0/row-0 ops."""
    W = int(spec.offsets[1])               # grid row width = |y| + 1
    ops = []
    for c, lane in zip(path.cells[::-1], path.lanes[::-1]):
        i, j = divmod(int(c), W)
        if lane == 0:
            kind = "match" if spec.weights[int(c), 0] == 0.0 else "sub"
            ops.append((kind, i - 1, j - 1))
        elif lane == 1:
            ops.append(("del", i - 1))
        else:
            ops.append(("ins", j - 1))
    stop = int(path.stop)
    if stop == W:                          # cell (1, 0): x[0] still unmatched
        lead = [("del", 0)]
    else:                                  # cell (0, j0): y[:j0] inserted
        lead = [("ins", t) for t in range(stop)]
    return {"ops": lead + ops, "cost": float(table[-1])}


register(DPProblem(
    name="edit_distance", geometry="linear",
    encode=_edit_encode, oracle=_edit_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=_edit_sample, decode=_edit_decode,
    doc="Levenshtein distance; grid linearized row-major, inf-masked lanes."))


# ===========================================================================
# lcs — same grid, max-plus
# ===========================================================================
def _lcs_encode(x, y):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    if m < 1 or c < 1:
        raise ValueError("lcs needs non-empty sequences")
    W = c + 1
    n = (m + 1) * W
    w = np.full((n, 3), _NEG)
    rows = np.arange(1, m + 1)[:, None]
    cols = np.arange(0, W)[None, :]
    cells = (rows * W + cols).ravel()
    jj = np.broadcast_to(cols, (m, W)).ravel()
    ii = np.broadcast_to(rows, (m, W)).ravel()
    w[cells, 1] = 0.0                                  # skip x[i-1] (up)
    interior = jj >= 1
    ci, cj = ii[interior], jj[interior]
    w[cells[interior], 0] = np.where(x[ci - 1] == y[cj - 1], 1.0, _NEG)
    w[cells[interior], 2] = 0.0                        # skip y[j-1] (left)
    init = np.zeros(W + 1, dtype=np.float32)
    spec = LinearSpec(offsets=(W + 1, W, 1), op="max", n=n, init=init,
                      weights=w.astype(np.float32))
    spec.validate()
    return spec


def _lcs_oracle(x, y):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    L = np.zeros((m + 1, c + 1))
    for i in range(1, m + 1):
        for j in range(1, c + 1):
            if x[i - 1] == y[j - 1]:
                L[i, j] = L[i - 1, j - 1] + 1.0
            else:
                L[i, j] = max(L[i - 1, j], L[i, j - 1])
    return L.reshape(-1)


def _lcs_decode(table, args, spec, path):
    """The common subsequence as (i, j) index pairs into x and y, in forward
    order — the diagonal steps whose match weight (+1) won the cell."""
    W = int(spec.offsets[1])
    pairs = []
    for c, lane in zip(path.cells[::-1], path.lanes[::-1]):
        if lane == 0 and spec.weights[int(c), 0] == 1.0:
            i, j = divmod(int(c), W)
            pairs.append((i - 1, j - 1))
    return {"pairs": pairs, "length": float(table[-1])}


register(DPProblem(
    name="lcs", geometry="linear",
    encode=_lcs_encode, oracle=_lcs_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=_edit_sample, decode=_lcs_decode,
    doc="Longest common subsequence; max-plus grid linearization."))


# ===========================================================================
# viterbi — HMM decoding over a T×S trellis, offsets {1..2S-1}
# ===========================================================================
def _viterbi_encode(log_a, log_b, log_pi, obs):
    log_a, log_b = np.asarray(log_a), np.asarray(log_b)
    log_pi, obs = np.asarray(log_pi), np.asarray(obs)
    S = len(log_pi)
    T = len(obs)
    if T < 2 or S < 2:
        raise ValueError("viterbi reduction needs T >= 2 and S >= 2")
    n, k, a1 = T * S, 2 * S - 1, 2 * S - 1
    offsets = tuple(range(a1, 0, -1))   # offsets[l] = 2S-1-l
    w = np.full((n, k), _NEG)
    # cell c = t·S + s reads (t-1)·S + s' at offset o = S + s - s'
    ts = np.arange(1, T)[:, None, None]          # t
    ss = np.arange(S)[None, :, None]             # s
    sp = np.arange(S)[None, None, :]             # s'
    cells = (ts * S + ss)                        # (T-1, S, 1)
    lanes = a1 - (S + ss - sp)                   # (1, S, S)
    emit = log_b[ss[..., 0], obs[ts[..., 0, 0]][:, None]]   # (T-1, S)
    vals = log_a[sp, ss] + emit[:, :, None]      # (T-1, S, S)
    w[np.broadcast_to(cells, vals.shape).ravel(),
      np.broadcast_to(lanes, vals.shape).ravel()] = vals.ravel()
    # init = trellis row 0 plus the first S-1 cells of row 1 (host-computed)
    d0 = log_pi + log_b[:, obs[0]]
    d1 = np.max(d0[:, None] + log_a, axis=0) + log_b[:, obs[1]]
    init = np.concatenate([d0, d1[: S - 1]]).astype(np.float32)
    spec = LinearSpec(offsets=offsets, op="max", n=n, init=init,
                      weights=w.astype(np.float32))
    spec.validate()
    return spec


def _viterbi_oracle(log_a, log_b, log_pi, obs):
    log_a, log_b = np.asarray(log_a), np.asarray(log_b)
    log_pi, obs = np.asarray(log_pi), np.asarray(obs)
    T, S = len(obs), len(log_pi)
    d = np.empty((T, S))
    d[0] = log_pi + log_b[:, obs[0]]
    for t in range(1, T):
        d[t] = np.max(d[t - 1][:, None] + log_a, axis=0) + log_b[:, obs[t]]
    return d.reshape(-1)


def _viterbi_sample(rng, size):
    S = int(rng.integers(2, 6))
    M = int(rng.integers(2, 5))
    T = max(2, int(size))

    def lognorm(x, axis):
        x = np.log(x / x.sum(axis=axis, keepdims=True))
        return x

    return {
        "log_a": lognorm(rng.random((S, S)) + 0.05, axis=1),
        "log_b": lognorm(rng.random((S, M)) + 0.05, axis=1),
        "log_pi": lognorm(rng.random(S) + 0.05, axis=0),
        "obs": rng.integers(0, M, size=T),
    }


def _viterbi_start(table, spec):
    """Traceback enters at the best end state of the last trellis row, not at
    the last linear cell."""
    S = (int(spec.offsets[0]) + 1) // 2
    return spec.n - S + int(np.argmax(np.asarray(table[-S:], dtype=np.float64)))


def _viterbi_decode(table, args, spec, path):
    """The maximum-likelihood state path, length T. Rows 0/1 sit (partly) in
    the preset init region; their states are recovered from the init values
    and the row-1 transition weights the encoder laid down."""
    S = (int(spec.offsets[0]) + 1) // 2
    T = spec.n // S
    states = np.full(T, -1, dtype=np.int64)
    for c in path.cells:                   # visited cell (t, s) = divmod(c, S)
        states[int(c) // S] = int(c) % S
    stop = int(path.stop)
    if stop >= S:                          # walk ended inside trellis row 1
        s1 = stop - S
        states[1] = s1
        # cell (1, s1) reads row 0 through lanes l = S-1-s1+s0; the emit term
        # inside w is constant over s0, so the argmax is the transition argmax
        s0 = np.arange(S)
        cand = (np.asarray(spec.init[:S], dtype=np.float64)
                + np.asarray(spec.weights[S + s1, S - 1 - s1 + s0],
                             dtype=np.float64))
        states[0] = int(np.argmax(cand))
    else:                                  # walk ended in trellis row 0
        states[0] = stop
    return {"states": states.tolist(),
            "log_prob": float(np.max(np.asarray(table[-S:], dtype=np.float64)))}


register(DPProblem(
    name="viterbi", geometry="linear",
    encode=_viterbi_encode, oracle=_viterbi_oracle,
    extract=lambda table, spec: float(np.max(table[-(len(spec.init) + 1) // 2:])),
    sample=_viterbi_sample, decode=_viterbi_decode, start=_viterbi_start,
    doc="HMM max-likelihood path score; trellis rows as weighted S-DP."))


# ===========================================================================
# unbounded_knapsack — offsets = distinct item weights ∪ {1}
# ===========================================================================
def _knapsack_encode(item_weights, item_values, capacity):
    iw = np.asarray(item_weights, dtype=np.int64)
    iv = np.asarray(item_values, dtype=np.float64)
    C = int(capacity)
    if len(iw) == 0 or np.any(iw < 1):
        raise ValueError("need positive item weights")
    a1 = int(iw.max())
    if C < a1:
        raise ValueError(f"capacity {C} must be >= max item weight {a1}")
    offsets = tuple(sorted(set(iw.tolist()) | {1}, reverse=True))
    lane_val = np.array(
        [max([0.0] + [float(v) for wt, v in zip(iw, iv) if wt == o])
         for o in offsets])
    n = C + 1
    w = np.broadcast_to(lane_val, (n, len(offsets))).astype(np.float32).copy()
    # dp prefix for ST[0..a1-1] (host-side O(a1·items))
    dp = np.zeros(max(a1, 1))
    for cc in range(1, a1):
        best = dp[cc - 1]
        for wt, v in zip(iw, iv):
            if wt <= cc:
                best = max(best, dp[cc - wt] + v)
        dp[cc] = best
    spec = LinearSpec(offsets=offsets, op="max", n=n,
                      init=dp.astype(np.float32), weights=w)
    spec.validate()
    return spec


def _knapsack_oracle(item_weights, item_values, capacity):
    iw = np.asarray(item_weights, dtype=np.int64)
    iv = np.asarray(item_values, dtype=np.float64)
    C = int(capacity)
    dp = np.zeros(C + 1)
    for cc in range(1, C + 1):
        best = dp[cc - 1]
        for wt, v in zip(iw, iv):
            if wt <= cc:
                best = max(best, dp[cc - wt] + v)
        dp[cc] = best
    return dp


def _knapsack_sample(rng, size):
    items = int(rng.integers(2, 6))
    return {
        "item_weights": rng.integers(1, 9, size=items),
        "item_values": np.round(rng.random(items) * 10 + 0.5, 3),
        "capacity": max(10, int(size)),
    }


def _knapsack_decode(table, args, spec, path):
    """The chosen item multiset as (weight, value) pairs. Lane j of the
    encoding is "take the best item of weight a_j" when its constant value is
    positive, and pure slack otherwise; the preset prefix (capacities below
    a_1) is unrolled with the same lane argbest on the init values."""
    offs = np.asarray(spec.offsets, dtype=np.int64)
    lane_val = np.asarray(spec.weights[0], dtype=np.float64)  # constant rows
    items = []
    for lane in path.lanes:
        if lane_val[int(lane)] > 0.0:
            items.append((int(offs[int(lane)]), float(lane_val[int(lane)])))
    cc = int(path.stop)
    init = np.asarray(spec.init, dtype=np.float64)
    while cc > 0:
        cand = np.where(offs <= cc,
                        init[np.clip(cc - offs, 0, len(init) - 1)] + lane_val,
                        -np.inf)
        j = int(np.argmax(cand))
        if lane_val[j] > 0.0:
            items.append((int(offs[j]), float(lane_val[j])))
        cc -= int(offs[j])
    items.sort()
    return {"items": items,
            "total_weight": int(sum(w for w, _ in items)),
            "total_value": float(sum(v for _, v in items))}


register(DPProblem(
    name="unbounded_knapsack", geometry="linear",
    encode=_knapsack_encode, oracle=_knapsack_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=_knapsack_sample, decode=_knapsack_decode,
    doc="Unbounded knapsack; per-lane constant max-plus weights."))


# ===========================================================================
# Triangular decode helpers: the preorder split-tree path as a lookup table
# ===========================================================================
def _split_map(path) -> dict:
    """{(i, d): e} for every internal node of the traceback's split tree."""
    return {(int(i), int(d)): int(e) for i, d, e in path.nodes}


# ===========================================================================
# mcm — the paper's §IV problem, canonical triangular form
# ===========================================================================
def _mcm_encode(dims):
    p = np.asarray(dims, dtype=np.float64)
    n = len(p) - 1
    spec = TriangularSpec(
        n=n, weights=_mcm.weight_table(n, _mcm.mcm_weight_fn(p)), dims=p)
    spec.validate()
    return spec


def _mcm_sample(rng, size):
    n = max(2, int(size))
    return {"dims": rng.integers(1, 30, size=n + 1).astype(np.float64)}


def _mcm_render(tree) -> str:
    if isinstance(tree, int):
        return f"A{tree}"
    return f"({_mcm_render(tree[0])}·{_mcm_render(tree[1])})"


def _mcm_decode(table, args, spec, path):
    """Optimal parenthesization as a nested (left, right) tuple tree with
    matrix indices at the leaves, plus a rendered product string."""
    split = _split_map(path)

    def build(i, d):
        if d == 0:
            return i
        e = split[(i, d)]
        return (build(i, e), build(i + e + 1, d - e - 1))

    tree = build(0, spec.n - 1)
    return {"tree": tree, "string": _mcm_render(tree),
            "cost": float(table[-1])}


register(DPProblem(
    name="mcm", geometry="triangular",
    encode=_mcm_encode,
    oracle=lambda dims: _mcm.reference_linear(dims),
    extract=lambda table, spec: float(table[-1]),
    sample=_mcm_sample, decode=_mcm_decode,
    doc="Matrix-chain multiplication; min scalar-multiplication count."))


# ===========================================================================
# optimal_bst — split-independent weight W(i,j) = Σ freq[i..j-1]
# ===========================================================================
def _bst_encode(freq):
    q = np.asarray(freq, dtype=np.float64)
    m = len(q)
    if m < 1:
        raise ValueError("need at least one key")
    n = m + 1                       # chain-form width: cell (i,j) ~ keys i..j-1
    P = np.concatenate([[0.0], np.cumsum(q)])
    spec = TriangularSpec(
        n=n, weights=_mcm.weight_table(n, lambda i, s, j: P[j] - P[i]))
    spec.validate()
    return spec


def _bst_oracle(freq):
    q = np.asarray(freq, dtype=np.float64)
    m = len(q)
    n = m + 1
    P = np.concatenate([[0.0], np.cumsum(q)])
    e = np.zeros((n, n))            # e[i][j]: cost of keys i..j-1
    for length in range(1, m + 1):
        for i in range(0, m - length + 1):
            j = i + length
            best = np.inf
            for r in range(i, j):   # root key r
                best = min(best, e[i][r] + e[r + 1][j])
            e[i][j] = best + (P[j] - P[i])
    st = np.zeros(n * (n + 1) // 2)
    for d in range(n):
        for i in range(n - d):
            st[lin_index(i, d, n)] = e[i][i + d]
    return st


def _bst_decode(table, args, spec, path):
    """The optimal tree as nested ``(root_key, left, right)`` tuples (None =
    empty subtree); cell (i, i+d) covers keys i..i+d-1, split e roots it at
    key i+e."""
    split = _split_map(path)

    def build(i, d):
        if d == 0:
            return None
        e = split[(i, d)]
        return (i + e, build(i, e), build(i + e + 1, d - e - 1))

    return {"tree": build(0, spec.n - 1), "cost": float(table[-1])}


register(DPProblem(
    name="optimal_bst", geometry="triangular",
    encode=_bst_encode, oracle=_bst_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=lambda rng, size: {"freq": rng.random(max(2, int(size))) + 0.01},
    decode=_bst_decode,
    doc="Optimal BST expected search cost (CLRS 15.5, key frequencies only)."))


# ===========================================================================
# polygon_triangulation — ≡ MCM with dims = vertex weights
# ===========================================================================
def _poly_encode(vertices):
    v = np.asarray(vertices, dtype=np.float64)
    if len(v) < 3:
        raise ValueError("need at least 3 vertices")
    n = len(v) - 1
    spec = TriangularSpec(
        n=n, weights=_mcm.weight_table(n, _mcm.mcm_weight_fn(v)), dims=v)
    spec.validate()
    return spec


def _poly_oracle(vertices):
    v = np.asarray(vertices, dtype=np.float64)
    nv = len(v)
    t = np.zeros((nv, nv))
    for gap in range(2, nv):
        for i in range(nv - gap):
            j = i + gap
            t[i][j] = min(t[i][s] + t[s][j] + v[i] * v[s] * v[j]
                          for s in range(i + 1, j))
    n = nv - 1                      # chain cell (i, i+d) ~ vertices i..i+d+1
    st = np.zeros(n * (n + 1) // 2)
    for d in range(n):
        for i in range(n - d):
            st[lin_index(i, d, n)] = t[i][i + d + 1]
    return st


def _poly_decode(table, args, spec, path):
    """The triangle fan as (a, b, c) vertex-index triples: chain cell
    (i, i+d) spans vertices i..i+d+1, and split e cuts off triangle
    (i, i+e+1, i+d+1). An (n+1)-gon yields exactly n-1 triangles."""
    triangles = [(int(i), int(i + e + 1), int(i + d + 1))
                 for i, d, e in path.nodes]
    triangles.sort()
    return {"triangles": triangles, "cost": float(table[-1])}


register(DPProblem(
    name="polygon_triangulation", geometry="triangular",
    encode=_poly_encode, oracle=_poly_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=lambda rng, size: {"vertices": rng.integers(1, 20, size=max(3, int(size))).astype(np.float64)},
    decode=_poly_decode,
    doc="Min-cost convex polygon triangulation (vertex-weight product cost)."))


# ===========================================================================
# Grid-family helpers
# ===========================================================================
def _grid_lead_ops(stop: int, R: int, C: int):
    """Leading gap ops implied by the preset cell an antidiag alignment
    walk terminated in: column 0 means x[:i0] deleted first, row 0 means
    y[:j0] inserted first."""
    RC = R * C
    i0, j0 = (stop % RC) // C, stop % C
    if j0 == 0:
        return [("del", t) for t in range(i0)]
    return [("ins", t) for t in range(j0)]


def _alignment_ops(path, R: int, C: int, kinds):
    """Forward-order alignment script from an antidiag move walk: ``kinds``
    maps move index -> 'align' | 'del' | 'ins'."""
    ops = []
    for p, i, j, mv in path.nodes[::-1]:
        kind = kinds[int(mv)]
        if kind == "align":
            ops.append(("align", int(i) - 1, int(j) - 1))
        elif kind == "del":
            ops.append(("del", int(i) - 1))
        else:
            ops.append(("ins", int(j) - 1))
    return _grid_lead_ops(int(path.stop), R, C) + ops


# ===========================================================================
# needleman_wunsch — global alignment on the native grid (antidiag)
# ===========================================================================
def _nw_encode(x, y, match=2.0, mismatch=-1.0, gap=-2.0):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    if m < 1 or c < 1:
        raise ValueError("needleman_wunsch needs non-empty sequences")
    R, C = m + 1, c + 1
    w = np.full((3, R, C), _NEG, dtype=np.float32)
    w[0, 1:, 1:] = np.where(x[:, None] == y[None, :], match, mismatch)
    w[1, 1:, :] = gap                                  # up: gap against x_i
    w[2, :, 1:] = gap                                  # left: gap against y_j
    init = np.zeros((1, R, C), dtype=np.float32)
    init[0, 0, :] = gap * np.arange(C)
    init[0, :, 0] = gap * np.arange(R)
    mask = np.zeros((1, R, C), dtype=bool)
    mask[0, 0, :] = mask[0, :, 0] = True
    spec = GridSpec(rows=R, cols=C, op="max", schedule="antidiag", planes=1,
                    moves=((0, 0, 1, 1), (0, 0, 1, 0), (0, 0, 0, 1)),
                    weights=w, init=init, init_mask=mask)
    spec.validate()
    return spec


def _nw_oracle(x, y, match=2.0, mismatch=-1.0, gap=-2.0):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    D = np.zeros((m + 1, c + 1))
    D[0, :] = gap * np.arange(c + 1)
    D[:, 0] = gap * np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, c + 1):
            s = match if x[i - 1] == y[j - 1] else mismatch
            D[i, j] = max(D[i - 1, j - 1] + s, D[i - 1, j] + gap,
                          D[i, j - 1] + gap)
    return D.reshape(-1)


def _nw_sample(rng, size):
    m = int(rng.integers(2, max(3, size)))
    c = int(rng.integers(2, max(3, size)))
    return {"x": rng.integers(0, 4, size=m), "y": rng.integers(0, 4, size=c),
            "match": float(np.round(rng.uniform(1.0, 3.0), 2)),
            "mismatch": float(np.round(rng.uniform(-2.0, -0.5), 2)),
            "gap": float(np.round(rng.uniform(-3.0, -1.0), 2))}


def _nw_decode(table, args, spec, path):
    """Global alignment script in forward order: ('align', i, j) pairs
    x[i]↔y[j] (match or mismatch), ('del', i) gaps x[i], ('ins', j) gaps
    y[j]; 0-based sequence positions."""
    ops = _alignment_ops(path, spec.rows, spec.cols,
                         {0: "align", 1: "del", 2: "ins"})
    return {"ops": ops, "score": float(table[-1])}


register(DPProblem(
    name="needleman_wunsch", geometry="grid",
    encode=_nw_encode, oracle=_nw_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=_nw_sample, decode=_nw_decode,
    doc="Global alignment (linear gap) on the native antidiag grid."))


# ===========================================================================
# gotoh — affine-gap global alignment; planes M=0, X=1 (gap in y), Y=2
# ===========================================================================
_GOTOH_MOVES = (
    (0, 0, 1, 1), (0, 1, 1, 1), (0, 2, 1, 1),   # M from M/X/Y, diagonal
    (1, 0, 1, 0), (1, 1, 1, 0),                 # X: open / extend (up)
    (2, 0, 0, 1), (2, 2, 0, 1))                 # Y: open / extend (left)


def _gotoh_encode(x, y, match=2.0, mismatch=-1.0, gap_open=-3.0,
                  gap_extend=-1.0):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    if m < 1 or c < 1:
        raise ValueError("gotoh needs non-empty sequences")
    R, C = m + 1, c + 1
    w = np.full((7, R, C), _NEG, dtype=np.float32)
    s = np.where(x[:, None] == y[None, :], match, mismatch)
    w[0, 1:, 1:] = w[1, 1:, 1:] = w[2, 1:, 1:] = s
    w[3, 1:, :] = gap_open
    w[4, 1:, :] = gap_extend
    w[5, :, 1:] = gap_open
    w[6, :, 1:] = gap_extend
    init = np.full((3, R, C), _NEG, dtype=np.float32)
    mask = np.zeros((3, R, C), dtype=bool)
    mask[:, 0, :] = mask[:, :, 0] = True
    init[0, 0, 0] = 0.0
    init[1, 1:, 0] = gap_open + gap_extend * np.arange(m)
    init[2, 0, 1:] = gap_open + gap_extend * np.arange(c)
    spec = GridSpec(rows=R, cols=C, op="max", schedule="antidiag", planes=3,
                    moves=_GOTOH_MOVES, weights=w, init=init, init_mask=mask)
    spec.validate()
    return spec


def _gotoh_oracle(x, y, match=2.0, mismatch=-1.0, gap_open=-3.0,
                  gap_extend=-1.0):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    R, C = m + 1, c + 1
    M = np.full((R, C), -np.inf)
    X = np.full((R, C), -np.inf)
    Y = np.full((R, C), -np.inf)
    M[0, 0] = 0.0
    X[1:, 0] = gap_open + gap_extend * np.arange(m)
    Y[0, 1:] = gap_open + gap_extend * np.arange(c)
    for i in range(1, R):
        for j in range(1, C):
            s = match if x[i - 1] == y[j - 1] else mismatch
            M[i, j] = s + max(M[i - 1, j - 1], X[i - 1, j - 1],
                              Y[i - 1, j - 1])
            X[i, j] = max(M[i - 1, j] + gap_open, X[i - 1, j] + gap_extend)
            Y[i, j] = max(M[i, j - 1] + gap_open, Y[i, j - 1] + gap_extend)
    return np.stack([M, X, Y]).reshape(-1)


def _gotoh_sample(rng, size):
    kw = _nw_sample(rng, size)
    kw.pop("gap")
    kw["gap_open"] = float(np.round(rng.uniform(-4.0, -2.0), 2))
    kw["gap_extend"] = float(np.round(rng.uniform(-1.5, -0.5), 2))
    return kw


def _gotoh_start(table, spec):
    """Traceback enters at the best of the three planes' far corners."""
    RC = spec.rows * spec.cols
    corner = np.asarray([table[p * RC + RC - 1] for p in range(spec.planes)],
                        dtype=np.float64)
    return int(np.argmax(corner)) * RC + RC - 1


def _gotoh_decode(table, args, spec, path):
    """Affine-gap alignment script (same op vocabulary as
    ``needleman_wunsch``) plus the plane the optimum ends in."""
    ops = _alignment_ops(path, spec.rows, spec.cols,
                         {0: "align", 1: "align", 2: "align",
                          3: "del", 4: "del", 5: "ins", 6: "ins"})
    RC = spec.rows * spec.cols
    score = max(float(table[p * RC + RC - 1]) for p in range(spec.planes))
    return {"ops": ops, "score": score}


register(DPProblem(
    name="gotoh", geometry="grid",
    encode=_gotoh_encode, oracle=_gotoh_oracle,
    extract=lambda table, spec: max(
        float(table[p * spec.rows * spec.cols + spec.rows * spec.cols - 1])
        for p in range(spec.planes)),
    sample=_gotoh_sample, decode=_gotoh_decode, start=_gotoh_start,
    doc="Affine-gap global alignment (Gotoh); three-plane antidiag grid."))


# ===========================================================================
# cky — Viterbi parsing; spandiag chart, one plane per nonterminal
# ===========================================================================
def _cky_encode(tokens, rules, rule_logp, lex):
    tokens = np.asarray(tokens, dtype=np.int64)
    lex = np.asarray(lex, dtype=np.float64)
    n = len(tokens)
    if n < 2:
        raise ValueError("cky needs at least 2 tokens")
    P = lex.shape[0]
    init = lex[:, tokens].astype(np.float32)            # (P, n) leaf scores
    spec = GridSpec(rows=n, cols=n, op="max", schedule="spandiag", planes=P,
                    rules=tuple(tuple(int(v) for v in r) for r in rules),
                    rule_weights=np.asarray(rule_logp, dtype=np.float32),
                    init=init)
    spec.validate()
    return spec


def _cky_oracle(tokens, rules, rule_logp, lex):
    tokens = np.asarray(tokens, dtype=np.int64)
    lex = np.asarray(lex, dtype=np.float64)
    n, P = len(tokens), lex.shape[0]
    chart = np.full((P, n, n), -np.inf)     # chart[A, i, j]: span i..j incl.
    for i in range(n):
        chart[:, i, i] = lex[:, tokens[i]]
    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            for (A, B, C), lp in zip(rules, np.asarray(rule_logp)):
                for k in range(i, j):
                    v = chart[B, i, k] + chart[C, k + 1, j] + lp
                    if v > chart[A, i, j]:
                        chart[A, i, j] = v
    cells = (n * (n + 1)) // 2
    st = np.empty(P * cells)
    for p in range(P):
        for d in range(n):
            for i in range(n - d):
                st[p * cells + lin_index(i, d, n)] = chart[p, i, i + d]
    return st


def _cky_sample(rng, size):
    n = max(2, min(int(size), 12))
    P, V = 3, 4
    rules = [(0, 0, 0), (0, 1, 2), (1, 2, 0), (2, 1, 1)]
    extra = int(rng.integers(0, 3))
    for _ in range(extra):
        rules.append(tuple(int(v) for v in rng.integers(0, P, size=3)))
    return {"tokens": rng.integers(0, V, size=n),
            "rules": rules,
            "rule_logp": -np.round(rng.uniform(0.3, 2.5, size=len(rules)), 3),
            "lex": -np.round(rng.uniform(0.3, 2.5, size=(P, V)), 3)}


def _cky_render(tree):
    if len(tree) == 2:                      # leaf: (nonterminal, position)
        return f"(N{tree[0]} {tree[1]})"
    return (f"(N{tree[0]} {_cky_render(tree[1])} {_cky_render(tree[2])})")


def _cky_decode(table, args, spec, path):
    """The Viterbi parse as nested ``(A, left, right)`` tuples with
    ``(A, position)`` leaves, plus a bracketed render. Internal node
    (A, i, d) took packed arg ``e·len(rules) + r``: rule r splits the span
    after offset e."""
    NR = len(spec.rules)
    amap = {(int(p), int(i), int(d)): int(a) for p, i, d, a in path.nodes}

    def build(p, i, d):
        if d == 0:
            return (p, i)
        e, r = divmod(amap[(p, i, d)], NR)
        _, B, C = spec.rules[r]
        return (p, build(B, i, e), build(C, i + e + 1, d - e - 1))

    n = spec.rows
    tree = build(0, 0, n - 1)
    return {"tree": tree, "bracket": _cky_render(tree),
            "logp": float(table[lin_index(0, n - 1, n)])}


register(DPProblem(
    name="cky", geometry="grid",
    encode=_cky_encode, oracle=_cky_oracle,
    extract=lambda table, spec: float(
        table[lin_index(0, spec.rows - 1, spec.rows)]),
    sample=_cky_sample, decode=_cky_decode,
    doc="Viterbi CKY parsing; spandiag chart, binary log-prob rules, "
        "root nonterminal 0 over the full span."))


# ===========================================================================
# edit_distance_grid / lcs_grid — the linear problems on their native grid
# (differential encodings: equal answers through a different family)
# ===========================================================================
def _edit_grid_encode(x, y):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    if m < 1 or c < 1:
        raise ValueError("edit_distance_grid needs non-empty sequences")
    R, C = m + 1, c + 1
    w = np.full((3, R, C), _POS, dtype=np.float32)
    w[0, 1:, 1:] = np.where(x[:, None] == y[None, :], 0.0, 1.0)
    w[1, 1:, :] = 1.0                                  # deletion (up)
    w[2, :, 1:] = 1.0                                  # insertion (left)
    init = np.zeros((1, R, C), dtype=np.float32)
    init[0, 0, :] = np.arange(C)
    init[0, :, 0] = np.arange(R)
    mask = np.zeros((1, R, C), dtype=bool)
    mask[0, 0, :] = mask[0, :, 0] = True
    spec = GridSpec(rows=R, cols=C, op="min", schedule="antidiag", planes=1,
                    moves=((0, 0, 1, 1), (0, 0, 1, 0), (0, 0, 0, 1)),
                    weights=w, init=init, init_mask=mask)
    spec.validate()
    return spec


def _edit_grid_decode(table, args, spec, path):
    """Same op vocabulary as the linear ``edit_distance`` decode, recovered
    from the native grid walk."""
    ops = []
    for _, i, j, mv in path.nodes[::-1]:
        i, j = int(i), int(j)
        if mv == 0:
            kind = "match" if spec.weights[0, i, j] == 0.0 else "sub"
            ops.append((kind, i - 1, j - 1))
        elif mv == 1:
            ops.append(("del", i - 1))
        else:
            ops.append(("ins", j - 1))
    return {"ops": _grid_lead_ops(int(path.stop), spec.rows, spec.cols) + ops,
            "cost": float(table[-1])}


register(DPProblem(
    name="edit_distance_grid", geometry="grid",
    encode=_edit_grid_encode, oracle=_edit_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=_edit_sample, decode=_edit_grid_decode,
    doc="Levenshtein on the native antidiag grid; same answers as the "
        "linear edit_distance encoding."))


def _lcs_grid_encode(x, y):
    x, y = np.asarray(x), np.asarray(y)
    m, c = len(x), len(y)
    if m < 1 or c < 1:
        raise ValueError("lcs_grid needs non-empty sequences")
    R, C = m + 1, c + 1
    w = np.full((3, R, C), _NEG, dtype=np.float32)
    w[0, 1:, 1:] = np.where(x[:, None] == y[None, :], 1.0, _NEG)
    w[1, 1:, :] = 0.0
    w[2, :, 1:] = 0.0
    init = np.zeros((1, R, C), dtype=np.float32)
    mask = np.zeros((1, R, C), dtype=bool)
    mask[0, 0, :] = mask[0, :, 0] = True
    spec = GridSpec(rows=R, cols=C, op="max", schedule="antidiag", planes=1,
                    moves=((0, 0, 1, 1), (0, 0, 1, 0), (0, 0, 0, 1)),
                    weights=w, init=init, init_mask=mask)
    spec.validate()
    return spec


def _lcs_grid_decode(table, args, spec, path):
    """Common-subsequence index pairs, forward order — diagonal moves whose
    +1 match weight won the cell (same format as the linear ``lcs``)."""
    pairs = [(int(i) - 1, int(j) - 1) for _, i, j, mv in path.nodes[::-1]
             if int(mv) == 0 and spec.weights[0, int(i), int(j)] == 1.0]
    return {"pairs": pairs, "length": float(table[-1])}


register(DPProblem(
    name="lcs_grid", geometry="grid",
    encode=_lcs_grid_encode, oracle=_lcs_oracle,
    extract=lambda table, spec: float(table[-1]),
    sample=_edit_sample, decode=_lcs_grid_decode,
    doc="Longest common subsequence on the native antidiag grid; same "
        "answers as the linear lcs encoding."))
