"""K5's launch plan (``semiring_matmul.plan``) and a PyTorch model of its
split-K combine, on the CPU.

The kernel splits K of one output tile over a cluster of CTAs (rank ``r``
takes columns ``[r·slice, (r+1)·slice)``) and, in the split regime, over
groups of 256 threads inside a CTA (group ``g`` takes columns ``[g·16,
(g+1)·16)`` of every stage of ``16·G`` columns); each thread folds its
columns in order with a NaN-keeping min, groups merge into group 0, ranks
into rank 0. Min is exact and no candidate's rounding depends on its
neighbours, so the combine equals the plain version bit for bit whatever
the partition: the model below deals the columns as the kernel does and
must equal the plain version and ``jax.jit(ref.tropical_matmul_ref)`` on
tie-heavy integer inputs and on rows of ±inf and NaN. The plan must cover
every output and every K column exactly once and fit shared memory at
every launch shape of the blocked MCM route.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import blocked_mcm as tblocked  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import semiring_matmul as k5  # noqa: E402

#: H100 SXM: SMs; the largest cluster with and without non-portable sizes
SMS = 132
RAGGED = [(1, 1, 1, 1), (1, 7, 13, 5), (2, 33, 100, 17), (3, 16, 16, 16),
          (1, 128, 128, 128), (62, 16, 992, 16), (1, 1024, 1024, 1024)]


def _route_shapes(n: int, batch: int = 1) -> list:
    """(batch, M, K, N) of every K5 launch of ``blocked_mcm`` at width n."""
    T = tblocked._pick_tile(n)
    nt = n // T
    return [(batch * (nt - D), T, (D - 1) * T, T) for D in range(2, nt)]


ROUTE = sorted({s for n in (32, 64, 256, 1024) for s in _route_shapes(n)}
               | set(_route_shapes(256, 8)))


def _stage_columns(p: k5.Plan, k: int) -> list:
    """[(rank, group, columns in the thread's fold order)] as the kernel
    deals them."""
    out = []
    width = k5.KS * p.groups
    for r in range(p.cluster):
        lo, hi = min(k, r * p.slice), min(k, r * p.slice + p.slice)
        for g in range(p.groups):
            cols = [c for s0 in range(lo, hi, width)
                    for c in range(s0 + g * k5.KS, min(hi, s0 + (g + 1) * k5.KS))]
            out.append((r, g, cols))
    return out


def _check_plan(batch, m, k, n, max_cluster):
    p = k5.plan(batch, m, n, k, SMS, max_cluster)
    assert (p.tile, p.per_thread) == ((16, 1) if p.regime == k5.SPLIT else (64, 4))
    assert p.regime == (k5.SPLIT if m <= 16 and n <= 16 else k5.REGISTER)
    assert 1 <= p.cluster <= max_cluster and p.groups in (1, 2, 4)
    assert p.regime == k5.SPLIT or p.groups == 1
    assert p.threads == 256 * p.groups <= 1024
    assert 1 <= p.stages <= k5.MAX_STAGES and p.slice % 4 == 0
    assert k5.smem_bytes(p.regime, p.cluster, p.groups, p.stages) <= _build.SMEM_OPTIN_BYTES
    units = batch * -(-m // p.tile) * -(-n // p.tile)
    assert p.cluster == 1 or units * p.cluster <= 2 * SMS
    # every K column exactly once, every rank and group within its slice
    cols = [c for _, _, cs in _stage_columns(p, k) for c in cs]
    assert sorted(cols) == list(range(k))
    # every output exactly once: tiles x threads of a group x R x R
    side, R = p.tile // p.per_thread, p.per_thread
    ty, tx = np.divmod(np.arange(256), side)
    rr, cc = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    rows = (ty[:, None, None] * R + rr).ravel()              # a tile's outputs
    cols = (tx[:, None, None] * R + cc).ravel()
    hits = np.zeros((-(-m // p.tile) * p.tile, -(-n // p.tile) * p.tile), np.int64)
    for ti in range(-(-m // p.tile)):
        for tj in range(-(-n // p.tile)):
            np.add.at(hits, (ti * p.tile + rows, tj * p.tile + cols), 1)
    assert (hits == 1).all()
    return p


@pytest.mark.parametrize("batch,m,k,n", ROUTE)
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_covers_route_launches(batch, m, k, n, max_cluster):
    p = _check_plan(batch, m, k, n, max_cluster)
    assert p.regime == k5.SPLIT
    if k == 16:                       # D = 2: nothing to split
        assert (p.cluster, p.groups) == (1, 1)
    # the ring holds a CTA's whole slice (one memory latency a launch), a
    # few stages, not the K / 16 of one CTA walking all of K
    assert p.stages * k5.KS * p.groups >= p.slice


@pytest.mark.parametrize("batch,m,k,n", RAGGED)
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_plan_covers_ragged_shapes(batch, m, k, n, max_cluster):
    _check_plan(batch, m, k, n, max_cluster)


def test_plan_at_the_path_shapes():
    """MCM 1024's largest launch splits K over clusters of 8 CTAs (256 CTAs,
    2 stages of 32 columns in flight); its D = 63 launch over 16 CTAs of
    two groups (8 where the card allows no more); the weighted 1024^3
    square takes 256 register tiles and a ring of 4."""
    assert k5.plan(32, 16, 16, 496, SMS) == k5.Plan(k5.SPLIT, 16, 1, 8, 1, 64, 2)
    assert k5.plan(1, 16, 16, 992, SMS) == k5.Plan(k5.SPLIT, 16, 1, 16, 2, 64, 1)
    assert k5.plan(1, 16, 16, 992, SMS, max_cluster=8).cluster == 8
    assert k5.plan(1, 1024, 1024, 1024, SMS) == k5.Plan(k5.REGISTER, 64, 4, 1, 1, 1024, 4)


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _inputs(bt, m, k, n, weighted, special, tag):
    rng = _rng(tag)
    a = rng.integers(-3, 4, (bt, m, k)).astype(np.float32)     # ties everywhere
    b = rng.integers(-3, 4, (bt, k, n)).astype(np.float32)
    if special:
        a[:, 0, :] = np.inf
        a[:, -1, rng.integers(0, k)] = np.nan
        b[:, rng.integers(0, k), 0] = -np.inf
        b[:, :, -1] = np.inf
    w = (None, None, None)
    if weighted:
        w = tuple(rng.integers(1, 4, (bt, x)).astype(np.float32) for x in (m, k, n))
    return (a, b) + w


def _split_model(p: k5.Plan, a, b, av, gv, bv):
    """The kernel's combine in PyTorch: each (rank, group) the plain
    product over its columns, groups merged into group 0 in order, then
    ranks into rank 0 (``torch.minimum`` keeps NaN, as min.NaN does)."""
    k = a.shape[-1]
    parts = {}
    for r, g, cols in _stage_columns(p, k):
        acc = torch.full((a.shape[0], a.shape[1], b.shape[2]), float("inf"))
        if cols:
            idx = torch.tensor(cols)
            w = (None,) * 3 if av is None else (av, gv[:, idx], bv)
            acc = k5.tropical_matmul_plain(a[:, :, idx], b[:, idx, :], *w)
        parts[r, g] = acc
    ranks = []
    for r in range(p.cluster):
        acc = parts[r, 0]
        for g in range(1, p.groups):
            acc = torch.minimum(acc, parts[r, g])
        ranks.append(acc)
    out = ranks[0]
    for acc in ranks[1:]:
        out = torch.minimum(out, acc)
    return out


def _same(got: torch.Tensor, want: np.ndarray) -> bool:
    w = torch.from_numpy(np.array(want))
    return torch.equal(got.isnan(), w.isnan()) and torch.equal(got.nan_to_num(), w.nan_to_num())


@pytest.mark.parametrize("bt,m,k,n,cluster,groups", [
    (2, 16, 70, 16, 1, 4), (2, 16, 70, 16, 3, 2), (1, 16, 200, 16, 4, 4),
    (3, 7, 33, 5, 2, 1), (1, 16, 992, 16, 16, 4), (1, 33, 100, 17, 4, 1)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("special", [False, True])
def test_split_combine_bit_equal_to_plain_and_reference(bt, m, k, n, cluster, groups,
                                                        weighted, special):
    xs = _inputs(bt, m, k, n, weighted, special, f"{bt}-{m}-{k}-{n}-{weighted}-{special}")
    regime = k5.SPLIT if m <= 16 and n <= 16 else k5.REGISTER
    tile, r = (16, 1) if regime == k5.SPLIT else (64, 4)
    p = k5.Plan(regime, tile, r, cluster, groups, -(-k // cluster), 2)
    t = [None if x is None else torch.from_numpy(x) for x in xs]
    got = _split_model(p, *t)
    plain = k5.tropical_matmul_plain(*t)
    assert torch.equal(got.isnan(), plain.isnan())
    assert torch.equal(got.nan_to_num(), plain.nan_to_num())
    ref = jax.jit(jref.tropical_matmul_ref)
    for i in range(bt):
        want = ref(*[None if x is None else jnp.asarray(x[i]) for x in xs])
        assert _same(got[i], want)
    if special:
        assert got.isnan().any() and got.isinf().any()


@pytest.mark.parametrize("n,batch", [(64, 1), (96, 2)])
def test_route_views_equal_flat_operands(n, batch):
    """The blocked route's strided 4-D views (two batch axes) through
    ``ops.tropical_matmul`` give what the flat contiguous 3-D operands
    give, and the CPU takes no launch."""
    rng = _rng(f"views-{n}-{batch}")
    T = tblocked._pick_tile(n)
    nt = n // T
    m = torch.from_numpy(rng.integers(0, 40, (batch, n, n)).astype(np.float32))
    p = torch.from_numpy(rng.integers(1, 9, (batch, n + 1)).astype(np.float32))
    before = dict(k5.LAUNCHES)
    for D in range(2, nt):
        nb, K = nt - D, (D - 1) * T
        a = m.as_strided((batch, nb, T, K), (n * n, T * (n + 1), n, 1), T)
        b = m.as_strided((batch, nb, K, T), (n * n, T * (n + 1), n, 1),
                         (T + 1) * n + D * T)
        av = p[:, :nb * T].reshape(batch, nb, T)
        gv = p[:, T + 1:].unfold(1, K, T)[:, :nb]
        bv = p[:, D * T + 1:D * T + 1 + nb * T].reshape(batch, nb, T)
        got = ops.tropical_matmul(a, b, av, gv, bv)
        flat = [x.reshape(batch * nb, *x.shape[2:]).contiguous() for x in (a, b, av, gv, bv)]
        want = k5.tropical_matmul_plain(*flat).view(batch, nb, T, T)
        assert got.shape == (batch, nb, T, T) and torch.equal(got, want)
    assert k5.LAUNCHES == before
