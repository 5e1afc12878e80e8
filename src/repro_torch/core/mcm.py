"""Matrix-chain multiplication (MCM) and the canonical triangular split
recurrence — §IV of the paper.

Cells ``(i, j)`` with ``0 ≤ i ≤ j < n``; diagonal ``d = j - i``; the
diagonal-major linearization of the paper's Fig. 5/7,

    lin(i, d) = d·n - d(d-1)/2 + i            (diagonal d holds n-d cells),

and the recurrence ``m[i, i+d] = min_{0≤e<d} (m[i, i+e] + m[i+e+1, i+d] +
W[lin(i,d), e])`` with diagonal-0 cells preset to 0. MCM is
``W = p_i·p_{i+e+1}·p_{i+d+1}``; optimal BST and polygon triangulation reduce
to the same shape with other weights (see ``repro_torch.dp.zoo``).

The tensor solvers take a weight table of shape ``(cells, n-1)`` or
``(batch, cells, n-1)`` and run on its device.

**The paper's Fig.-8 pipeline and its hazard.** The pipeline assigns
candidate slot ``j`` of cell ``c`` (executed at step ``c + j``) to split
``s = i + j``. Theorem 1 proves that the cells written in one step are
distinct, but not that a slot's operands are final when it reads them:
slot 0's right operand ``(i+1, j)`` still needs ``d-2`` candidates. For
``n ≥ 5`` the paper's order gives inflated results
(:func:`solve_pipeline_np` counts the violations). ``order="safe"`` (the
default) keeps the machinery — skewed head, one candidate per cell per
step, cell ``c`` final at step ``c + k_c - 1`` — and permutes each cell's
candidates by the step their operands are ready; cells per step stay
distinct, reads may repeat.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

__all__ = [
    "mcm_reference",
    "reference_linear",
    "num_cells",
    "lin_index",
    "diag_of",
    "mcm_weight_fn",
    "weight_table",
    "solve_wavefront",
    "solve_wavefront_tab",
    "solve_wavefront_tab_with_args",
    "embed_prefix_table",
    "extend_wavefront_tab",
    "triangular_traceback",
    "triangular_args_np",
    "triangular_traceback_np",
    "PipelineTables",
    "build_tables",
    "build_pipeline_tables",
    "tables_from_weight_array",
    "pipeline_num_steps",
    "solve_pipeline",
    "solve_mcm_pipeline",
    "solve_pipeline_np",
]


def num_cells(n: int) -> int:
    return n * (n + 1) // 2


def lin_index(i, d, n):
    """Diagonal-major linear index of cell (i, i+d) in an n-chain table."""
    return d * n - (d * (d - 1)) // 2 + i


def diag_of(c: int, n: int) -> int:
    """Diagonal containing linear cell c (host-side helper)."""
    d, off = 0, 0
    while off + (n - d) <= c:
        off += n - d
        d += 1
    return d


# ---------------------------------------------------------------------------
# numpy oracle (CLRS 15.2)
# ---------------------------------------------------------------------------
def mcm_reference(dims) -> tuple[np.ndarray, np.ndarray]:
    """O(n³) DP. Returns (m, split): m[i][j] = min cost of A_i..A_j."""
    p = np.asarray(dims, dtype=np.float64)
    n = len(p) - 1
    m = np.zeros((n, n))
    split = np.full((n, n), -1, dtype=np.int64)
    for d in range(1, n):
        for i in range(n - d):
            j = i + d
            best, bs = np.inf, -1
            for s in range(i, j):
                c = m[i, s] + m[s + 1, j] + p[i] * p[s + 1] * p[j + 1]
                if c < best:
                    best, bs = c, s
            m[i, j] = best
            split[i, j] = bs
    return m, split


def reference_linear(dims) -> np.ndarray:
    """Oracle table flattened in the paper's diagonal-major order."""
    n = len(np.asarray(dims)) - 1
    m, _ = mcm_reference(dims)
    st = np.zeros(num_cells(n))
    for d in range(n):
        for i in range(n - d):
            st[lin_index(i, d, n)] = m[i, i + d]
    return st


def mcm_weight_fn(dims):
    """The MCM instance of the canonical triangular weight: p_i·p_{s+1}·p_{j+1}."""
    p = np.asarray(dims, dtype=np.float64)
    return lambda i, s, j: p[i] * p[s + 1] * p[j + 1]


def weight_table(n: int, weight_fn) -> np.ndarray:
    """Dense (cells, n-1) split-major float64 weights: W[lin(i,d), e] =
    weight_fn(i, i+e, i+d). ``weight_fn`` is called once per diagonal with
    broadcast numpy index arrays."""
    cells = num_cells(n)
    w = np.zeros((cells, max(n - 1, 1)), dtype=np.float64)
    for d in range(1, n):
        ii = np.arange(n - d)[:, None]          # (rows, 1)
        ee = np.arange(d)[None, :]              # (1, d)
        rows = lin_index(ii[:, 0], d, n)
        w[rows[:, None], ee] = weight_fn(ii, ii + ee, ii + d)
    return w


# ---------------------------------------------------------------------------
# Wavefront solver: one diagonal per step, each cell's split candidates
# combined as (left + right) + w and reduced by min (first index on ties).
# ---------------------------------------------------------------------------
def _wavefront(wtab: torch.Tensor, n: int, with_args: bool):
    squeeze = wtab.dim() == 2
    if squeeze:
        wtab = wtab[None]
    dev, cells = wtab.device, num_cells(n)
    st = torch.zeros((wtab.shape[0], cells), dtype=wtab.dtype, device=dev)
    ar = torch.full(st.shape, -1, dtype=torch.int32, device=dev)
    for d in range(1, n):
        ii = torch.arange(n - d, device=dev)[:, None]       # rows of diagonal d
        ee = torch.arange(d, device=dev)[None, :]           # split offsets
        rows = lin_index(ii[:, 0], d, n)
        cand = ((st[:, lin_index(ii, ee, n)]
                 + st[:, lin_index(ii + ee + 1, d - ee - 1, n)])
                + wtab[:, rows[:, None], ee])
        best, arg = cand.min(dim=2)
        st[:, rows] = best
        ar[:, rows] = arg.to(torch.int32)
    if squeeze:
        st, ar = st[0], ar[0]
    return (st, ar) if with_args else st


def solve_wavefront_tab(wtab: torch.Tensor, n: int) -> torch.Tensor:
    """Linearized cost table (diagonal-0 cells preset to 0)."""
    return _wavefront(wtab, n, with_args=False)


def solve_wavefront_tab_with_args(wtab: torch.Tensor, n: int):
    """``solve_wavefront_tab`` + the best-split table: ``args[lin(i,d)] = e``
    such that split ``s = i+e`` wins cell ``(i, i+d)`` (-1 on diagonal 0)."""
    return _wavefront(wtab, n, with_args=True)


def solve_wavefront(p: torch.Tensor, n: int) -> torch.Tensor:
    """The MCM table from its ``(n+1,)`` (or ``(batch, n+1)``) dims: each
    diagonal's split weights ``p_i·p_{i+e+1}·p_{i+d+1}`` computed from the
    dims (left to right, as ``repro``'s ``solve_wavefront``) instead of
    read from a weight table."""
    squeeze = p.dim() == 1
    if squeeze:
        p = p[None]
    dev, cells = p.device, num_cells(n)
    st = torch.zeros((p.shape[0], cells), dtype=p.dtype, device=dev)
    for d in range(1, n):
        ii = torch.arange(n - d, device=dev)[:, None]
        ee = torch.arange(d, device=dev)[None, :]
        w = (p[:, ii] * p[:, ii + ee + 1]) * p[:, ii + d + 1]
        cand = ((st[:, lin_index(ii, ee, n)]
                 + st[:, lin_index(ii + ee + 1, d - ee - 1, n)]) + w)
        st[:, lin_index(ii[:, 0], d, n)] = cand.min(dim=2).values
    return st[0] if squeeze else st


# ---------------------------------------------------------------------------
# Warm-start extension. The split recurrence keeps every prefix cell live
# (cell (i, j ≥ n_old) reads (i, s) for every s < j), so the resume state
# is the whole prefix triangle, re-embedded into the wider diagonal-major
# layout on the host; the loop then recomputes only the ≤ k = n - n_old
# trailing rows of each diagonal with the cold solver's candidate vector
# (same operands, same association, same min), so every new cell equals
# the cold solve's bit for bit.
# ---------------------------------------------------------------------------
def embed_prefix_table(st_old: np.ndarray, n_old: int, n: int) -> np.ndarray:
    """Re-embed a width-``n_old`` table into the width-``n`` diagonal-major
    layout (new cells zeroed: diagonal-0 presets are 0, and the windowed
    loop overwrites the rest)."""
    out = np.zeros(num_cells(n), dtype=np.asarray(st_old).dtype)
    for d in range(n_old):
        src, dst = lin_index(0, d, n_old), lin_index(0, d, n)
        out[dst:dst + (n_old - d)] = st_old[src:src + (n_old - d)]
    return out


def extend_wavefront_tab(st0: torch.Tensor, wtab: torch.Tensor, n: int,
                         n_old: int) -> torch.Tensor:
    """Windowed wavefront over the extension region: ``st0`` the width-``n``
    table with the prefix embedded (:func:`embed_prefix_table`), ``wtab``
    the extended spec's weight table. Returns the full table — O(n²·k)
    work instead of the cold solve's O(n³)."""
    st, dev = st0.clone(), st0.device
    for d in range(1, n):
        lo = max(0, n_old - d)
        ii = torch.arange(lo, n - d, device=dev)[:, None]   # trailing rows
        ee = torch.arange(d, device=dev)[None, :]
        rows = lin_index(ii[:, 0], d, n)
        cand = ((st[lin_index(ii, ee, n)]
                 + st[lin_index(ii + ee + 1, d - ee - 1, n)])
                + wtab[rows[:, None], ee])
        st[rows] = cand.min(dim=1).values
    return st


# ---------------------------------------------------------------------------
# Traceback on the device for every instance of a bucket at once. A split
# tree's preorder is its nodes sorted by (i ascending, d descending): a
# node's descendants start at its own i or later, its left subtree ends
# before its right one begins, and nodes that share an i form a chain of
# left children. A child's span diagonal lies below its parent's, so the
# tree's nodes are found by spreading marks one diagonal a step, top down:
# n - 2 steps of two kernels each and no host sync, then one sort.
# ---------------------------------------------------------------------------
def span_coords(n: int, device) -> tuple:
    """``(i, d)`` of every diagonal-major cell of an n-chain table."""
    d = torch.repeat_interleave(torch.arange(n, device=device),
                                torch.arange(n, 0, -1, device=device),
                                output_size=num_cells(n))
    return torch.arange(num_cells(n), device=device) - lin_index(0, d, n), d


def split_kids(i, d, e, left_plane, right_plane, n: int, none: int):
    """``(..., 2)`` packed cells (``plane·cells + lin``) of the internal
    children of cells ``(i, i+d)`` split at offset ``e``: ``(i, e)`` and
    ``(i+e+1, d-e-1)``, ``none`` where a child is a leaf."""
    cells, rd = num_cells(n), d - e - 1
    left = torch.where(e >= 1, left_plane * cells + lin_index(i, e, n), none)
    right = torch.where(rd >= 1, right_plane * cells + lin_index(i + e + 1, rd, n),
                        none)
    return torch.stack([left, right], dim=-1)


def _spread(mark: torch.Tensor, kids: torch.Tensor, n: int) -> None:
    """Mark the children of marked cells, one span diagonal a step from the
    top: ``mark`` is ``(batch, planes·cells + 1)``, its last slot the sink
    of ``none``."""
    B, P, cells = kids.shape[:3]
    none = P * cells
    span = mark[:, :none].view(B, P, cells)
    for d in range(n - 1, 1, -1):
        lo, hi = lin_index(0, d, n), lin_index(0, d, n) + n - d
        to = torch.where(span[:, :, lo:hi, None], kids[:, :, lo:hi], none)
        mark.scatter_(1, to.view(B, -1), True)


#: :func:`_spread` on the card by (shape, n, device), LRU: None after a
#: shape's first walk, its captured CUDA graph from the second on
_SPREAD_GRAPHS: "OrderedDict[tuple, Optional[tuple]]" = OrderedDict()
_SPREAD_GRAPHS_MAX = 64


def _spread_on_card(mark: torch.Tensor, kids: torch.Tensor, n: int) -> None:
    """:func:`_spread` on a CUDA device. Its 2(n - 2) small launches cost
    the host far more than the card, so a shape walked a second time has
    its steps captured as a CUDA graph, replayed from then on; a shape
    walked once runs them as they come."""
    key = (tuple(kids.shape), n, kids.device)
    entry = _SPREAD_GRAPHS.get(key)
    if entry is None:
        _spread(mark, kids, n)
        if key in _SPREAD_GRAPHS:
            m, k = torch.zeros_like(mark), torch.zeros_like(kids)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                _spread(m, k, n)
            entry = (graph, m, k)
        _SPREAD_GRAPHS[key] = entry
        while len(_SPREAD_GRAPHS) > _SPREAD_GRAPHS_MAX:
            _SPREAD_GRAPHS.popitem(last=False)
        return
    _SPREAD_GRAPHS.move_to_end(key)
    graph, m, k = entry
    m.copy_(mark)
    k.copy_(kids)
    graph.replay()
    mark.copy_(m)


def tree_preorder(kids: torch.Tensor, root: torch.Tensor, n: int,
                  coords: tuple) -> torch.Tensor:
    """The internal nodes a split tree reaches from packed cell ``root``
    (``(batch,)``), as ``(batch, n-1)`` packed cells in preorder.
    ``kids`` is ``(batch, planes, cells, 2)``: each cell's internal
    children (:func:`split_kids`), ``planes·cells`` for none; ``coords``
    is :func:`span_coords`. No step waits for the host."""
    B, P, cells = kids.shape[:3]
    none = P * cells
    mark = torch.zeros((B, none + 1), dtype=torch.bool, device=kids.device)
    mark[torch.arange(B, device=kids.device), root] = True
    if kids.is_cuda:
        _spread_on_card(mark, kids, n)
    else:
        _spread(mark, kids, n)
    # every tree has n - 1 internal nodes: the marked cells sort first
    b = torch.arange(B, device=kids.device)[:, None]
    i, d = (x.repeat(P) for x in coords)
    key = torch.where(mark[:, :none], (b * n + i) * n + (n - 1 - d),
                      B * n * n)
    order = torch.argsort(key.view(-1))[:B * (n - 1)]
    return (order % none).view(B, n - 1)


def triangular_traceback(args: torch.Tensor, n: int):
    """Walk a ``(batch, cells)`` best-split table on its device. Returns
    preorder ``(ii, dd, ee)``, each ``(batch, n-1)``: internal node
    ``(i, i+d)`` chose split offset ``e`` (children ``(i, e)`` and
    ``(i+e+1, d-e-1)``); the contract of :func:`triangular_traceback_np`."""
    B, dev = args.shape[0], args.device
    if n < 2:
        empty = torch.zeros((B, 0), dtype=torch.int64, device=dev)
        return empty, empty, empty
    cells = num_cells(n)
    i, d = span_coords(n, dev)
    e = torch.minimum(args.to(torch.int64).clamp(min=0), (d - 1).clamp(min=0))
    kids = split_kids(i, d, e, 0, 0, n, cells)
    node = tree_preorder(kids[:, None], torch.full((B,), lin_index(0, n - 1, n),
                                                   device=dev), n, (i, d))
    return i[node], d[node], e.gather(1, node)


# ---------------------------------------------------------------------------
# Host traceback helpers
# ---------------------------------------------------------------------------
def triangular_args_np(table: np.ndarray, wtab: np.ndarray, n: int) -> np.ndarray:
    """Best-split table recovered from a finished cost table; candidates
    recomputed in float64."""
    table = np.asarray(table, dtype=np.float64)
    wtab = np.asarray(wtab, dtype=np.float64)
    args = np.full(num_cells(n), -1, dtype=np.int32)
    for d in range(1, n):
        ii = np.arange(n - d)[:, None]
        ee = np.arange(d)[None, :]
        rows = lin_index(ii[:, 0], d, n)
        cand = (table[lin_index(ii, ee, n)]
                + table[lin_index(ii + ee + 1, d - ee - 1, n)]
                + wtab[rows[:, None], ee])
        args[rows] = np.argmin(cand, axis=1)
    return args


def triangular_traceback_np(args: np.ndarray, n: int) -> np.ndarray:
    """Host DFS over the split tree; returns an (n-1, 3) preorder array of
    (i, d, e) internal nodes."""
    nodes = []
    stack = [(0, n - 1)] if n >= 2 else []
    while stack:
        i, d = stack.pop()
        e = int(args[lin_index(i, d, n)])
        nodes.append((i, d, e))
        if d - e - 1 >= 1:
            stack.append((i + e + 1, d - e - 1))
        if e >= 1:
            stack.append((i, e))
    return np.asarray(nodes, dtype=np.int64).reshape(-1, 3)


# ---------------------------------------------------------------------------
# The paper's pipeline (Fig. 8): per-(cell, slot) index tables (the l/r/w
# maps of equation (2)), then one gather/gather/f/min-scatter per outer
# step, vectorized over the n-1 stages.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PipelineTables:
    """Per-(cell, slot) index maps. O(n³/2) entries — paper-scale only."""

    n: int
    order: str
    left: np.ndarray    # (cells, n-1) linear index of the slot's left operand
    right: np.ndarray   # (cells, n-1) linear index of the slot's right operand
    weight: np.ndarray  # (cells, n-1) the slot's split weight
    k: np.ndarray       # (cells,) candidate count (= diagonal of the cell)
    feasible: bool      # every slot's operands finalized before its read step


def build_tables(n: int, weight_fn, order: str = "safe") -> PipelineTables:
    """Pipeline tables for any canonical triangular DP,

        m[i, j] = min_{0≤e<d} ( m[i, i+e] + m[i+e+1, j] + weight_fn(i, i+e, j) ),

    d = j - i, diagonal-0 cells preset to 0. ``order="paper"``: Fig.-8 slot
    j ↔ split i+j (has the hazard above); ``order="safe"``: each cell's
    candidates sorted by the step their operands are ready (exact)."""
    cells = num_cells(n)
    maxk = max(n - 1, 1)
    left = np.zeros((cells, maxk), dtype=np.int64)
    right = np.zeros((cells, maxk), dtype=np.int64)
    weight = np.zeros((cells, maxk), dtype=np.float64)
    kk = np.zeros((cells,), dtype=np.int64)

    # finalize step of each cell: c + k_c - 1 (diag-0 cells are preset)
    final = np.full(cells, -(10**9), dtype=np.int64)
    for d in range(1, n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            final[c] = c + d - 1

    feasible = True
    for d in range(1, n):
        for i in range(n - d):
            c = lin_index(i, d, n)
            kk[c] = d
            cand = []
            for e in range(d):  # split s = i + e; left diag e, right diag d-e-1
                s = i + e
                L = lin_index(i, e, n)
                R = lin_index(s + 1, d - e - 1, n)
                ready = max(final[L], final[R]) + 1
                cand.append((ready, L, R, weight_fn(i, s, i + d)))
            if order == "safe":
                cand.sort(key=lambda x: x[0])
            elif order != "paper":
                raise ValueError(order)
            for jc, (ready, L, R, w) in enumerate(cand):
                if c + jc < ready:
                    feasible = False
                left[c, jc], right[c, jc], weight[c, jc] = L, R, w
    return PipelineTables(n=n, order=order, left=left, right=right,
                          weight=weight, k=kk, feasible=feasible)


def build_pipeline_tables(dims, order: str = "safe") -> PipelineTables:
    """MCM tables: :func:`build_tables` with the MCM weight."""
    n = len(np.asarray(dims)) - 1
    return build_tables(n, mcm_weight_fn(dims), order=order)


def tables_from_weight_array(wtab: np.ndarray, n: int,
                             order: str = "safe") -> PipelineTables:
    """Pipeline tables for a dense (cells, n-1) split-major weight array."""
    return build_tables(
        n, lambda i, s, j: wtab[lin_index(i, j - i, n), s - i], order=order)


def pipeline_num_steps(n: int) -> int:
    """Outer steps of Fig. 8: head sweeps cells n..cells-1 plus (n-2) drain."""
    return num_cells(n) + (n - 1) - 1 - n


def solve_pipeline(left, right, weight, k, n: int) -> torch.Tensor:
    """Run the pipeline on (possibly permuted) tables, on their device.
    Substeps 1–4 of Fig. 8: gather l, gather r, f = (l + r) + w,
    min-accumulate (slot 0 overwrites). The cells written in a step are
    consecutive, hence distinct (Theorem 1)."""
    cells = num_cells(n)
    maxk = left.shape[1]
    js = torch.arange(maxk, device=weight.device)
    st = torch.zeros((cells,), dtype=weight.dtype, device=weight.device)
    for t in range(n, cells + maxk - 1):
        c = t - js                                           # (maxk,) cells
        cc = c.clamp(0, cells - 1)
        active = (c >= n) & (c < cells) & (js < k[cc])
        v_l = st[left[cc, js].clamp(0, cells - 1)]           # substep 1
        v_r = st[right[cc, js].clamp(0, cells - 1)]          # substep 2
        v_s = v_l + v_r + weight[cc, js]                     # substep 3
        new = torch.where(js == 0, v_s, torch.minimum(st[cc], v_s))  # substep 4
        st[c[active]] = new[active]
    return st


def _pipeline_tensors(t: PipelineTables, device):
    return (torch.from_numpy(t.left).to(device), torch.from_numpy(t.right).to(device),
            torch.from_numpy(t.weight.astype(np.float32)).to(device),
            torch.from_numpy(t.k).to(device))


def solve_mcm_pipeline(dims, order: str = "safe") -> np.ndarray:
    """Tables + the tensor pipeline (on the CPU) -> linearized float32
    table."""
    t = build_pipeline_tables(dims, order=order)
    return solve_pipeline(*_pipeline_tensors(t, "cpu"), t.n).numpy()


def solve_pipeline_np(dims, order: str = "safe", check_conflicts: bool = False):
    """Host step-by-step pipeline (float64). Returns ``(st, stats)`` with
    stats = dict(max_read_dup, max_write_dup, dependency_violations)
    measured per substep — Theorem 1 says write dup must be 1; the safe
    order may raise read dup."""
    t = build_pipeline_tables(dims, order=order)
    n, cells = t.n, num_cells(t.n)
    maxk = t.left.shape[1]
    st = np.zeros(cells)
    final = {lin_index(i, d, n): lin_index(i, d, n) + d - 1
             for d in range(1, n) for i in range(n - d)}
    stats = {"max_read_dup": 1, "max_write_dup": 1, "dependency_violations": 0}
    for step in range(n, cells + maxk - 1):
        js = np.arange(maxk)
        c = step - js
        ok = (c >= n) & (c < cells)
        cc = np.where(ok, c, 0)
        active = ok & (js < t.k[cc])
        if check_conflicts and active.any():
            for name, addr in (("read", t.left[cc, js][active]),
                               ("read", t.right[cc, js][active]),
                               ("write", c[active])):
                _, counts = np.unique(addr, return_counts=True)
                key = f"max_{name}_dup"
                stats[key] = max(stats[key], int(counts.max()))
            for src in (t.left[cc, js][active], t.right[cc, js][active]):
                for a in src:
                    if a in final and final[a] >= step:
                        stats["dependency_violations"] += 1
        snap = st.copy()
        v = snap[t.left[cc, js]] + snap[t.right[cc, js]] + t.weight[cc, js]
        for j in np.nonzero(active)[0]:
            ci = c[j]
            st[ci] = v[j] if j == 0 else min(st[ci], v[j])
    return st, stats


# ---------------------------------------------------------------------------
# Backend registration (repro_torch.dp): the triangular routes.
# ---------------------------------------------------------------------------
from repro_torch.dp import backends as _dp_backends  # noqa: E402
from repro_torch.dp import schedule as _sched  # noqa: E402

def _run_extend(spec, n_old: int, state: dict, device) -> np.ndarray:
    """``Backend.run_extend`` for the wavefront route: the prefix
    re-embedded on the host, then the windowed loop on ``device``."""
    n_old = int(n_old)
    st0 = embed_prefix_table(np.asarray(state["suffix"], np.float32), n_old,
                             spec.n)
    wtab = torch.as_tensor(np.asarray(spec.weights, np.float32), device=device)
    return extend_wavefront_tab(torch.as_tensor(st0, device=device), wtab,
                                spec.n, n_old).cpu().numpy()


_dp_backends.register(_dp_backends.triangular_tab_backend(
    "wavefront", solve_wavefront_tab,
    cost=lambda s, device: _dp_backends.triangular_costs(s)["wavefront"],
    arg_fn=solve_wavefront_tab_with_args, run_extend=_run_extend,
    schedule=_sched.plain_route(_sched.triangular_wavefront_schedule),
    doc="dense per-diagonal combine (n-1 vectorized steps)"))


def _pipeline_run(spec, device) -> np.ndarray:
    t = tables_from_weight_array(np.asarray(spec.weights), spec.n)
    return solve_pipeline(*_pipeline_tensors(t, device), t.n).cpu().numpy()


_dp_backends.register(_dp_backends.Backend(
    name="mcm_pipeline", geometry="triangular",
    run=_pipeline_run,
    cost=lambda s, device: _dp_backends.triangular_costs(s)["mcm_pipeline"],
    supports=lambda s, device: True,
    # the tables are built on the host per instance: no batch path, the
    # routing layer loops ``run`` over a bucket
    batch_run=None,
    schedule=_sched.plain_route(_sched.mcm_pipeline_schedule, order="safe"),
    doc="paper Fig.-8 pipeline (order=safe); O(n²) outer steps"))
