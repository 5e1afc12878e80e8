"""Blocked MCM via weighted tropical (min,+) tile products.

For tiles of size T, the splits ``s`` inside the *middle* tiles of block
``(I, J)`` contribute the weighted (min,+) product

    C[i,j] = min_s ( m[i,s] + m[s+1,j] + p_i · p_{s+1} · p_{j+1} )
           = min_s ( A[i,s] + B[s,j] + a_i · g_s · b_j )

with ``A = m[tile I, tiles I+1..J-1]`` and ``B`` the same tiles' rows
shifted down by one, ``m[.. + 1, tile J]``. Those middle tiles are one
contiguous run, so each block diagonal ``D ≥ 2`` is ONE batched call of the
K5 kernel (``kernels/semiring_matmul.py``) over every instance and block,
with ``K = (D-1)·T``, on strided views of the table (two batch axes:
instance, block). Only the two *boundary* tiles (splits in tile I or
tile J) keep sequential structure; a local anti-diagonal wavefront of
2T-1 steps resolves them — the paper's pipeline idea at tile granularity.

Port of ``repro/core/blocked_mcm.py``; ``repro`` folds the middle tiles one
at a time with its jnp product, and min is exact, so the tables are equal
bit for bit. Each candidate rounds as ``repro``'s does on the CPU, where
XLA fuses the weighted term into one multiply-add (``core.semiring
.fma_f32``). The table is float32 throughout (``repro`` casts ``dims`` to
float32). Solvers take ``p`` of shape ``(n+1,)`` or ``(batch, n+1)`` and
run on its device; the boundary wavefront is plain PyTorch, looped on the
host.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.mcm import lin_index, mcm_weight_fn, num_cells, weight_table
from repro_torch.core.semiring import fma_f32
from repro_torch.kernels import ops

__all__ = ["solve_blocked", "weighted_tropical_matmul", "gemm_fraction",
           "blocked_to_linear"]


def weighted_tropical_matmul(a_tile, b_tile, av, gv, bv, acc=None):
    """``C[i,j] = min_s (A[i,s] + B[s,j] + av[i]·gv[s]·bv[j])``, min-combined
    with ``acc`` — through K5 on the card, its plain version on the CPU."""
    c = ops.tropical_matmul(a_tile, b_tile, av, gv, bv)
    return c if acc is None else torch.minimum(acc, c)


def gemm_fraction(n: int, tile: int) -> float:
    """Fraction of split-combine work performed as tropical GEMMs."""
    nt = n // tile
    gemm = sum(max(d - 1, 0) * (nt - d) for d in range(1, nt)) * tile**3
    total = sum(d * (n - d) for d in range(1, n))  # total split evaluations
    return gemm / max(total, 1)


def _weight(p, i, s1, j1):
    """``p_i · p_{s+1} · p_{j+1}`` gathered per instance, the last product
    left for :func:`fma_f32`: returns ``(p_i·p_{s+1}, p_{j+1})``."""
    return p[:, i] * p[:, s1], p[:, j1]


def _block_wavefront(m, blk, D: int, p, T: int, n: int):
    """Resolve the boundary splits of every block ``(I, I+D)`` by a
    2T-1-step local wavefront over ``blk`` ``(batch, blocks, T, T)`` (the
    GEMM partials; for D = 0 +inf with a zero local diagonal). Reads the
    frozen ``m`` (earlier block diagonals) and the block carry; returns
    the finished blocks. Step ``l`` finishes local diagonal ``l - (T-1)``
    of every block, reading only cells finished before it."""
    dev = m.device
    diag = D == 0
    bt, nb = blk.shape[:2]
    inf = torch.tensor(float("inf"), dtype=m.dtype, device=dev)
    li = torch.arange(T, device=dev)
    r0 = (torch.arange(nb, device=dev) * T)[:, None, None]   # (nb, 1, 1)
    c0 = r0 + D * T
    sI = r0 + li                                              # (nb, 1, T)
    sJ = c0 + li
    srow = li + 1                                             # local row of s+1
    in_blk = srow < T
    srowc = srow.clamp(0, T - 1)
    bidx = torch.arange(bt, device=dev)[:, None, None, None]
    blk = blk.clone()
    for step in range(2 * T - 1):
        cols = li + (step - (T - 1))
        valid = (cols >= 0) & (cols < T)
        colsc = cols.clamp(0, T - 1)
        i_g = (r0[..., 0] + li)[:, :, None]                  # (nb, T, 1)
        j_g = (c0[..., 0] + colsc)[:, :, None]               # (nb, T, 1)

        # --- boundary splits in tile I: s ∈ [i, min((I+1)T, j)) ----------
        okI = sI >= i_g
        if diag:
            okI = okI & (sI < j_g)
            a1 = blk                                          # [row, split]
        else:
            a1 = m[bidx, i_g, sI.clamp(0, n - 1)]            # diag tile (I, I)
        b_in = blk[:, :, srowc[None, :], colsc[:, None]]     # (bt, nb, T, T)
        b_out = m[bidx, (sI + 1).clamp(0, n - 1), j_g]
        b1 = torch.where(in_blk, b_in, b_out)
        w, pj = _weight(p, i_g, (sI + 1).clamp(0, n), (j_g + 1).clamp(0, n))
        c1 = torch.where(okI, fma_f32(w, pj, a1 + b1), inf)
        best = c1.amin(dim=-1)

        if not diag:
            # --- boundary splits in tile J: s ∈ [JT, j) -------------------
            okJ = sJ < j_g
            a2 = blk                                          # [row, split]
            b2 = m[bidx, (sJ + 1).clamp(0, n - 1), j_g]      # diag tile (J, J)
            w, pj = _weight(p, i_g, (sJ + 1).clamp(0, n), (j_g + 1).clamp(0, n))
            c2 = torch.where(okJ, fma_f32(w, pj, a2 + b2), inf)
            best = torch.minimum(best, c2.amin(dim=-1))

        cur = blk[:, :, li, colsc]                           # (bt, nb, T)
        blk[:, :, li, colsc] = torch.where(valid, torch.minimum(cur, best), cur)
    return blk


def solve_blocked(p: torch.Tensor, n: int, tile: int) -> torch.Tensor:
    """Blocked MCM. ``p``: ``(n+1,)`` or ``(batch, n+1)`` dims (float32 on
    the solve's device), ``n % tile == 0``. Returns the ``(n, n)`` tables
    (``(batch, n, n)`` for batched ``p``); the lower triangle outside the
    diagonal tiles is 0, inside them +inf."""
    if n % tile:
        raise ValueError(f"n={n} must be divisible by tile={tile}")
    squeeze = p.dim() == 1
    if squeeze:
        p = p[None]
    T, nt, bt = tile, n // tile, p.shape[0]
    m = torch.zeros((bt, n, n), dtype=p.dtype, device=p.device)

    def blocks(D: int):
        nb = nt - D
        return m.as_strided((bt, nb, T, T), (n * n, T * (n + 1), n, 1), D * T)

    # ---- D = 0: diagonal tiles, independent local wavefronts --------------
    eye0 = torch.full((T, T), float("inf"), dtype=p.dtype, device=p.device)
    eye0.fill_diagonal_(0.0)
    blocks(0).copy_(_block_wavefront(m, eye0.expand(bt, nt, T, T), 0, p, T, n))

    # ---- D ≥ 1: GEMM over the middle tiles, then the boundary wavefront ----
    for D in range(1, nt):
        nb = nt - D
        acc = torch.full((bt, nb, T, T), float("inf"), dtype=p.dtype,
                         device=p.device)
        if D >= 2:
            K = (D - 1) * T
            # block I: A = m[I·T.., (I+1)T..(I+D)T), B = m[(I+1)T+1.., (I+D)T..]
            a = m.as_strided((bt, nb, T, K), (n * n, T * (n + 1), n, 1), T)
            b = m.as_strided((bt, nb, K, T), (n * n, T * (n + 1), n, 1),
                             (T + 1) * n + D * T)
            av = p[:, :nb * T].reshape(bt, nb, T)
            gv = p[:, T + 1:].unfold(1, K, T)[:, :nb]
            bv = p[:, D * T + 1:D * T + 1 + nb * T].reshape(bt, nb, T)
            acc = ops.tropical_matmul(a, b, av, gv, bv)      # views, no copies
        blocks(D).copy_(_block_wavefront(m, acc, D, p, T, n))
    return m[0] if squeeze else m


def blocked_to_linear(m: torch.Tensor) -> torch.Tensor:
    """Flatten ``(.., n, n)`` tables to the paper's diagonal-major linear
    order, ``st[lin(i, d)] = m[i, i+d]``."""
    n = m.shape[-1]
    d = np.repeat(np.arange(n), np.arange(n, 0, -1))
    i = np.arange(num_cells(n)) - lin_index(0, d, n)
    ii = torch.from_numpy(i).to(m.device)
    return m[..., ii, ii + torch.from_numpy(d).to(m.device)]


# ---------------------------------------------------------------------------
# Route registration (repro_torch.dp): MCM-shaped triangular specs (weight
# = p_i·p_{s+1}·p_{j+1}, i.e. spec.dims is set) can route through the
# tropical-GEMM tiling.
# ---------------------------------------------------------------------------
from repro_torch.dp import backends as _dp_backends  # noqa: E402
from repro_torch.dp import schedule as _sched  # noqa: E402

_TILES = (16, 8, 4, 2)


def _pick_tile(n: int):
    for t in _TILES:
        if n % t == 0 and n // t >= 2:
            return t
    return None


def _batch_run(specs, device, sharding=None) -> list:
    """Stack B same-shape instances' dims: one blocked solve, one K5
    launch per block diagonal (a solve a slot under ``sharding``)."""
    n = specs[0].n
    p = _dp_backends._stack([np.asarray(s.dims) for s in specs], device, sharding)
    return _dp_backends._rows(_dp_backends._call(
        lambda p: blocked_to_linear(solve_blocked(p, n, _pick_tile(n))), (p,), sharding))


_GUARD_CACHE: "OrderedDict[tuple, bool]" = OrderedDict()
_GUARD_CACHE_MAX = 256


def _probe_indices(n: int):
    """The (d, i, e) split coordinates the eligibility check inspects for
    large tables — a deterministic O(n) sample. None ⇒ small table, check
    (and hash) the whole thing."""
    if n <= 32:
        return None
    rng = np.random.default_rng(n)          # deterministic per shape
    m = 8 * n
    d = rng.integers(1, n, size=m)
    i = (rng.random(m) * (n - d)).astype(np.int64)
    e = (rng.random(m) * d).astype(np.int64)
    return d, i, e


def _dims_match_weights(spec) -> bool:
    """This route solves from ``dims`` and ignores ``weights``, so it
    supports only specs whose weight table really is the MCM one for those
    dims (guards hand-built inconsistent specs): exhaustive for small
    tables, a deterministic O(n) sample for large ones. Memoized (LRU)
    under a digest of dims plus exactly the weight entries read, because
    ``supports`` runs on every dispatch."""
    n = spec.n
    w = np.asarray(spec.weights)
    idx = _probe_indices(n)
    probe = w if idx is None else w[lin_index(idx[1], idx[0], n), idx[2]]
    digest = hashlib.blake2b(np.ascontiguousarray(spec.dims).tobytes(),
                             digest_size=16)
    digest.update(np.ascontiguousarray(probe).tobytes())
    key = (n, digest.digest())
    hit = _GUARD_CACHE.get(key)
    if hit is not None:
        _GUARD_CACHE.move_to_end(key)
        return hit
    fn = mcm_weight_fn(np.asarray(spec.dims))
    if idx is None:  # full table is tiny — compare exactly
        ok = bool(np.allclose(probe, weight_table(n, fn), rtol=1e-9))
    else:
        d, i, e = idx
        ok = bool(np.allclose(probe, fn(i, i + e, i + d), rtol=1e-9))
    _GUARD_CACHE[key] = ok
    while len(_GUARD_CACHE) > _GUARD_CACHE_MAX:
        _GUARD_CACHE.popitem(last=False)
    return ok


_dp_backends.register(_dp_backends.Backend(
    name="blocked_mcm", geometry="triangular",
    run=lambda spec, device: _batch_run([spec], device)[0],
    cost=lambda s, device: _dp_backends.triangular_costs(s)["blocked_mcm"],
    supports=lambda s, device: (s.dims is not None
                                and _pick_tile(s.n) is not None
                                and _dims_match_weights(s)),
    batch_run=_batch_run,
    schedule=_sched.plain_route(_sched.blocked_mcm_schedule),
    doc="tropical-tile (min,+) GEMM MCM solver: the semiring_matmul CUDA "
        "kernel per block diagonal on the card, its plain version on the "
        "CPU; boundary wavefront plain PyTorch"))
