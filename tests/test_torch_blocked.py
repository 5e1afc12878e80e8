"""The tropical GEMM K5's plain version, the blocked MCM route over it, the
companion-matrix scan and the Fig.-8 MCM pipeline, against ``repro`` on the
same inputs, made with numpy from a seed (CPU, n ≤ 64).

Bit-equality holds where ``repro`` is exact-order: min/max reductions, and
K5's candidates, which round as XLA compiles ``repro``'s jitted product and
its interpreted Pallas kernel on the CPU (the weighted term fused into one
multiply-add). ``repro``'s *eager* ``tropical_matmul_ref`` rounds that
product separately, so weighted it agrees within ``EAGER_RTOL`` (the
tolerance of ``tests/test_kernels.py``). ``companion_scan`` with
``op="add"`` multiplies with ``torch.matmul``, which sums in another order
than XLA's dot: within ``ADD_RTOL``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import dp as jdp  # noqa: E402
from repro.core import blocked_mcm as jblocked  # noqa: E402
from repro.core import mcm as jmcm  # noqa: E402
from repro.core import sdp as jsdp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.semiring_matmul import tropical_matmul_pallas  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.core import blocked_mcm as tblocked  # noqa: E402
from repro_torch.core import mcm as tmcm  # noqa: E402
from repro_torch.core import sdp as tsdp  # noqa: E402
from repro_torch.core.semiring import fma_f32  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import semiring_matmul as tk5  # noqa: E402

EAGER_RTOL, EAGER_ATOL = 1e-5, 1e-6
ADD_RTOL = 2e-4
#: the shapes of tests/test_kernels.py's sweep, plus ragged ones
K5_SHAPES = [(8, 8, 8), (16, 32, 16), (64, 16, 32), (128, 128, 128),
             (7, 13, 5), (1, 1, 1), (33, 17, 20)]


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _k5_inputs(m, k, n, weighted, tag, batch=()):
    rng = _rng(tag)
    a = rng.normal(size=batch + (m, k)).astype(np.float32)
    b = rng.normal(size=batch + (k, n)).astype(np.float32)
    w = (None, None, None)
    if weighted:
        w = tuple(rng.uniform(1, 3, size=batch + (x,)).astype(np.float32)
                  for x in (m, k, n))
    return (a, b) + w


def _t(xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _j(xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# K5: the weighted tropical GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", K5_SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_k5_plain_bit_equal_to_reference(m, k, n, weighted):
    xs = _k5_inputs(m, k, n, weighted, f"k5-{m}-{k}-{n}-{weighted}")
    got = tk5.tropical_matmul_plain(*_t(xs)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jref.tropical_matmul_ref)(*_j(xs))))
    np.testing.assert_array_equal(got, tref.tropical_matmul_ref(*_t(xs)).numpy())
    eager = np.asarray(jref.tropical_matmul_ref(*_j(xs)))
    if weighted:
        np.testing.assert_allclose(got, eager, rtol=EAGER_RTOL, atol=EAGER_ATOL)
    else:
        np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("m,k,n", K5_SHAPES[:4])
@pytest.mark.parametrize("weighted", [False, True])
def test_k5_plain_bit_equal_to_pallas(m, k, n, weighted):
    xs = _k5_inputs(m, k, n, weighted, f"k5p-{m}-{k}-{n}-{weighted}")
    want = tropical_matmul_pallas(*_j(xs), bm=min(128, m), bn=min(128, n),
                                  bk=min(8, k), interpret=True)
    np.testing.assert_array_equal(tk5.tropical_matmul_plain(*_t(xs)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("weighted", [False, True])
def test_k5_batch_axis_equals_each_instance(monkeypatch, weighted):
    """A batch of 3 through the wrapper (the CPU takes the plain version,
    no launch) equals each instance through the Pallas kernel; a small
    K chunk makes the running min fold several chunks."""
    monkeypatch.setattr(tk5, "_CHUNK_ELEMS", 3 * 16 * 16 * 5)
    xs = _k5_inputs(16, 32, 16, weighted, f"k5b-{weighted}", batch=(3,))
    before = dict(tk5.LAUNCHES)
    got = ops.tropical_matmul(*_t(xs)).numpy()
    assert tk5.LAUNCHES == before
    for i in range(3):
        one = [None if x is None else x[i] for x in xs]
        want = tropical_matmul_pallas(*_j(one), bm=16, bn=16, bk=8, interpret=True)
        np.testing.assert_array_equal(got[i], np.asarray(want))


def test_k5_rejects_partial_weights():
    a, b, av, gv, bv = _t(_k5_inputs(4, 4, 4, True, "k5-partial"))
    with pytest.raises(ValueError, match="all of av, gv, bv"):
        tk5.tropical_matmul(a, b, av, None, bv)


def test_fma_f32_rounds_once():
    """Against XLA's fused ``z + x·y`` over wide magnitudes and near
    cancellation (normal range: XLA flushes subnormals, the port does
    not)."""
    rng = _rng("fma")
    fused = jax.jit(lambda x, y, z: z + x * y)
    for scale in (1e-6, 1.0, 1e6):
        x, y, z = (rng.normal(size=4096).astype(np.float32) * s
                   for s in (scale, 1.0 / scale, 1.0))
        z[:1024] = -(x[:1024].astype(np.float64) * y[:1024]).astype(np.float32)
        got = fma_f32(*_t((x, y, z))).numpy()
        np.testing.assert_array_equal(got, np.asarray(fused(x, y, z)))
    inf = np.float32(np.inf)
    got = fma_f32(*_t((np.array([1, 2], np.float32), np.array([3, 1], np.float32),
                       np.array([inf, -inf], np.float32))))
    assert got.tolist() == [np.inf, -np.inf]


# ---------------------------------------------------------------------------
# Blocked MCM
# ---------------------------------------------------------------------------
def _dims(n, integer, tag):
    rng = _rng(tag)
    if integer:
        return rng.integers(1, 61, size=n + 1).astype(np.float64)
    return rng.uniform(0.5, 5.0, size=n + 1)


@pytest.mark.parametrize("n,tile", [(4, 2), (8, 2), (12, 4), (16, 4), (32, 8),
                                    (48, 8), (32, 16), (64, 16)])
@pytest.mark.parametrize("integer", [True, False])
def test_solve_blocked_bit_equal_to_reference(n, tile, integer):
    dims = _dims(n, integer, f"blocked-{n}-{tile}-{integer}")
    want = np.asarray(jblocked.solve_blocked(jnp.asarray(dims), n, tile))
    got = tblocked.solve_blocked(torch.from_numpy(dims).float(), n, tile)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tblocked.blocked_to_linear(got).numpy(),
                                  jblocked.blocked_to_linear(want))


def test_solve_blocked_batch_equals_each_instance():
    dims = np.stack([_dims(32, i % 2 == 0, f"bb-{i}") for i in range(3)])
    got = tblocked.solve_blocked(torch.from_numpy(dims).float(), 32, 8)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(jblocked.solve_blocked(jnp.asarray(dims[i]), 32, 8)))
    with pytest.raises(ValueError, match="divisible"):
        tblocked.solve_blocked(torch.ones(11), 10, 4)


@pytest.mark.parametrize("with_acc", [False, True])
def test_weighted_tropical_matmul_matches_reference(with_acc):
    """The route's tile product against ``repro``'s as its jitted solver
    compiles it."""
    xs = _k5_inputs(8, 8, 8, True, f"wtm-{with_acc}")
    acc = _rng("acc").normal(size=(8, 8)).astype(np.float32) if with_acc else None
    want = jax.jit(jblocked.weighted_tropical_matmul)(*_j(xs), acc=None if acc is None
                                                      else jnp.asarray(acc))
    got = tblocked.weighted_tropical_matmul(*_t(xs), acc=None if acc is None
                                            else torch.from_numpy(acc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gemm_fraction_and_tile_choice_match_reference():
    for n in range(1, 130):
        assert tblocked._pick_tile(n) == jblocked._pick_tile(n), n
        for tile in (2, 4, 8, 16):
            if n % tile == 0:
                assert tblocked.gemm_fraction(n, tile) == jblocked.gemm_fraction(n, tile)
    assert tblocked.gemm_fraction(64, 8) > tblocked.gemm_fraction(64, 16)


@pytest.mark.parametrize("n", [8, 40])
def test_dims_guard_rejects_inconsistent_specs(n):
    """A hand-built spec whose weights are not the MCM weights of its dims
    is refused (exhaustive check at n ≤ 32, the O(n) probe above), as by
    ``repro``; the zoo's own spec is accepted."""
    cpu = torch.device("cpu")
    route = tdp.backends.get("blocked_mcm")
    dims = _dims(n, True, f"guard-{n}")
    spec = tdp.get_problem("mcm").encode(dims=dims)
    assert route.supports(spec, cpu)
    bad_dims = dims.copy()
    bad_dims[n // 2] += 1.0
    bad = tdp.TriangularSpec(n=n, weights=spec.weights, dims=bad_dims)
    assert not route.supports(bad, cpu)
    jbad = jdp.TriangularSpec(n=n, weights=spec.weights, dims=bad_dims)
    assert not jdp.backends.get("blocked_mcm").supports(jbad)
    assert not route.supports(tdp.TriangularSpec(n=n, weights=spec.weights), cpu)
    odd = tdp.get_problem("mcm").encode(dims=_dims(7, True, "guard-odd"))
    assert not route.supports(odd, cpu)                   # no tile divides 7


@pytest.mark.parametrize("name,n", [("mcm", 16), ("mcm", 48), ("mcm", 64)])
def test_blocked_mcm_route_matches_reference(monkeypatch, name, n):
    """``solve(..., backend="blocked_mcm", reconstruct=True)`` and the
    batched route against ``repro``'s: tables, host args and trees equal."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    insts = [{"dims": _dims(n, i == 0, f"route-{n}-{i}")} for i in range(2)]
    for inst in insts:
        want = jdp.solve(name, backend="blocked_mcm", reconstruct=True, **inst)
        got = tdp.solve(name, backend="blocked_mcm", reconstruct=True,
                        device="cpu", **inst)
        np.testing.assert_array_equal(got.table, want.table)
        np.testing.assert_array_equal(got.args, want.args)
        assert got.solution == want.solution and got.source == want.source == "host"
    specs = [tdp.get_problem(name).encode(**i) for i in insts]
    tables = tdp.batch_solve_specs(specs, backend="blocked_mcm", device="cpu")
    for t, inst in zip(tables, insts):
        np.testing.assert_array_equal(
            t, jdp.solve_spec(jdp.get_problem(name).encode(**inst),
                              backend="blocked_mcm"))


# ---------------------------------------------------------------------------
# Companion-matrix scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length", list(range(1, 12)) + [31, 32])
def test_associative_scan_tree_matches_jax(length):
    """Float32 addition rounds by its combination tree: the port's scan
    equals ``jax.lax.associative_scan``'s bit for bit at even and odd
    lengths (both branches of the recursion, at every depth)."""
    x = (_rng(f"scan-{length}").normal(size=(length, 3)) * 1e3).astype(np.float32)
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=0)
    got = tsdp.associative_scan(torch.add, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


#: (offsets, n): live steps n - a_1 of 1, 2, 3 (the recursion's base and
#: both branches), odd and even lengths, a_1 up to the route's cap of 16
SCAN_CASES = [((3, 1), 4), ((3, 1), 5), ((3, 1), 6), ((2, 1), 19),
              ((5, 3, 2), 40), ((5, 3, 2), 41), ((16, 8, 3, 1), 64),
              ((1,), 9), ((7, 4), 7)]


@pytest.mark.parametrize("offsets,n", SCAN_CASES)
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_companion_scan_matches_reference(offsets, n, op, weighted):
    rng = _rng(f"cs-{offsets}-{n}-{op}-{weighted}")
    init = rng.normal(size=offsets[0]).astype(np.float32)
    w = rng.normal(size=(n, len(offsets))).astype(np.float32) if weighted else None
    if weighted and op != "add":          # mask ~20% of lanes with the zero
        w[rng.random(w.shape) < 0.2] = np.inf if op == "min" else -np.inf
    want = np.asarray(jsdp.solve_companion_scan(
        jnp.asarray(init), offsets, op, n, None if w is None else jnp.asarray(w)))
    got = tsdp.solve_companion_scan(torch.from_numpy(init), offsets, op, n,
                                    None if w is None else torch.from_numpy(w))
    if op == "add":
        np.testing.assert_allclose(got.numpy(), want, rtol=ADD_RTOL, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    batch = tsdp.solve_companion_scan(
        torch.from_numpy(np.stack([init, init])), offsets, op, n,
        None if w is None else torch.from_numpy(np.stack([w, w])))
    np.testing.assert_array_equal(batch[1].numpy(), got.numpy())


@pytest.mark.parametrize("name", ["edit_distance", "lcs", "viterbi",
                                  "unbounded_knapsack", "sdp"])
def test_companion_scan_route_matches_reference(name):
    rng = _rng(f"csr-{name}")
    inst = tdp.get_problem(name).sample(rng, 12)
    jspec = jdp.get_problem(name).encode(**inst)
    assert int(jspec.offsets[0]) <= 16            # within the route's cap
    want = jdp.solve_spec(jspec, backend="companion_scan")
    got = tdp.solve_spec(tdp.get_problem(name).encode(**inst),
                         backend="companion_scan", device="cpu")
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The Fig.-8 pipeline (mcm_pipeline)
# ---------------------------------------------------------------------------
def _random_dims(n, seed):
    return np.random.default_rng(seed).integers(1, 30, size=n + 1).astype(np.float64)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9, 16])
@pytest.mark.parametrize("order", ["safe", "paper"])
def test_pipeline_tables_and_solvers_match_reference(n, order):
    dims = _random_dims(n, n)
    want, got = (jmcm.build_pipeline_tables(dims, order=order),
                 tmcm.build_pipeline_tables(dims, order=order))
    for f in ("left", "right", "weight", "k"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.feasible == want.feasible
    np.testing.assert_array_equal(tmcm.solve_mcm_pipeline(dims, order=order),
                                  jmcm.solve_mcm_pipeline(dims, order=order))
    (st, stats), (jst, jstats) = (tmcm.solve_pipeline_np(dims, order, True),
                                  jmcm.solve_pipeline_np(dims, order, True))
    np.testing.assert_array_equal(st, jst)
    assert stats == jstats
    assert tmcm.pipeline_num_steps(n) == jmcm.pipeline_num_steps(n)


def test_paper_order_hazard():
    """The literal Fig.-8 candidate order reads operands before they are
    final for n ≥ 5 and inflates costs on random instances; Theorem 1's
    write distinctness holds regardless."""
    assert not tmcm.build_pipeline_tables(_random_dims(8, 1), order="paper").feasible
    mismatch = 0
    for s in range(25):
        dims = _random_dims(6, 100 + s)
        st, stats = tmcm.solve_pipeline_np(dims, order="paper", check_conflicts=True)
        assert stats["max_write_dup"] == 1
        ref = tmcm.reference_linear(dims)
        if not np.allclose(st, ref):
            mismatch += 1
            assert np.all(st >= ref - 1e-9)  # partial reads only inflate
    assert mismatch > 0


def test_safe_order_is_feasible_and_exact():
    for n in (2, 3, 5, 8, 13, 21):
        dims = _random_dims(n, n)
        assert tmcm.build_pipeline_tables(dims, order="safe").feasible, n
        st, stats = tmcm.solve_pipeline_np(dims, order="safe", check_conflicts=True)
        assert stats["dependency_violations"] == 0
        assert stats["max_write_dup"] == 1
        np.testing.assert_allclose(st, tmcm.reference_linear(dims))
        np.testing.assert_allclose(tmcm.solve_mcm_pipeline(dims),
                                   tmcm.reference_linear(dims), rtol=1e-6)


@pytest.mark.parametrize("name", ["mcm", "optimal_bst", "polygon_triangulation"])
def test_mcm_pipeline_route_matches_reference(name):
    insts = [tdp.get_problem(name).sample(_rng(f"pipe-{name}-{i}"), 9)
             for i in range(2)]
    specs = [tdp.get_problem(name).encode(**i) for i in insts]
    got = tdp.batch_solve_specs(specs, backend="mcm_pipeline", device="cpu")
    for g, inst in zip(got, insts):
        np.testing.assert_array_equal(
            g, jdp.solve_spec(jdp.get_problem(name).encode(**inst),
                              backend="mcm_pipeline"))
