"""The DP problem zoo: classic scenarios reduced to the two canonical forms.

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

Encoders, oracles, samplers and decoders are numpy and produce the same
specs, digests and answers as ``repro.dp.zoo``. Every entry carries an
independent numpy oracle (the textbook recurrence in its native shape).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import mcm as _mcm
from repro_torch.core import sdp as _sdp
from repro_torch.dp.problem import DPProblem, LinearSpec, TriangularSpec, lin_index
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
