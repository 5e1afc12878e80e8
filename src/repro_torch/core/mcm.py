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
"""
from __future__ import annotations

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
    "solve_wavefront_tab",
    "solve_wavefront_tab_with_args",
    "triangular_args_np",
    "triangular_traceback_np",
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
# Backend registration (repro_torch.dp): the triangular route.
# ---------------------------------------------------------------------------
from repro_torch.dp import backends as _dp_backends  # noqa: E402

_dp_backends.register(_dp_backends.triangular_tab_backend(
    "wavefront", solve_wavefront_tab,
    cost=lambda s, device: _dp_backends.triangular_costs(s)["wavefront"],
    arg_fn=solve_wavefront_tab_with_args,
    doc="dense per-diagonal combine (n-1 vectorized steps)"))
