"""The streaming kernels' plain versions — K3 ``sdp_chunked`` and K4
``mcm_tiled`` (with its fused traceback) — and their routes
``kernel_tiled`` / ``kernel_tiled_wavefront``, against ``repro``'s Pallas
kernels in interpret mode and its jnp ``mcm_tiled_ref*`` on the same inputs,
made with numpy from a seed.

Tables, args and traceback nodes are bit-equal for min and max. K3 with
``op="add"``: unweighted bit-equal; weighted, the port is bit-equal to
``repro``'s numpy oracle and to K1's plain version, and within ``ADD_RTOL``
of the interpreted Pallas kernel, whose XLA program rounds ``acc + t*w``
differently (ROADMAP queue 3; the same tolerance as the K1 tests).
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import dp as jdp  # noqa: E402
from repro.core.mcm import triangular_traceback_np as ref_walk  # noqa: E402
from repro.core.sdp import sdp_reference  # noqa: E402
from repro.kernels.mcm_tiled import (mcm_tiled_pallas,  # noqa: E402
                                     mcm_tiled_pallas_fused,
                                     mcm_tiled_pallas_with_args, mcm_tiled_ref,
                                     mcm_tiled_ref_fused,
                                     mcm_tiled_ref_with_args)
from repro.kernels.sdp_pipeline import (sdp_chunked_pallas,  # noqa: E402
                                        sdp_chunked_pallas_with_args)
from repro_torch import dp as tdp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core.mcm import num_cells, triangular_traceback_np  # noqa: E402
from repro_torch.dp import reconstruct as treconstruct  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mcm_tiled as tk4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sdp_chunked as tk3  # noqa: E402
from repro_torch.kernels import sdp_pipeline as tk1  # noqa: E402

ADD_RTOL = 2e-4
LINEAR = ("sdp", "edit_distance", "lcs", "viterbi", "unbounded_knapsack")
TRIANGULAR = ("mcm", "optimal_bst", "polygon_triangulation")


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# K3: sdp_chunked
# ---------------------------------------------------------------------------
#: (offsets, n, block, chunk): ``chunk`` sizes the Pallas kernel's window
#: only (shorter than a_1: its overlapping carry); the port's ring is fixed
#: by the offsets, tight (R = a_1 + B: the ring wraps every step or two)
#: where a_1 + B is a multiple of 32. Single-cell steps, ragged last steps,
#: the default window.
LIN_CASES = [((3, 1), 5, 512, 1), ((3, 1), 64, 2, 7), ((5, 3, 2), 129, 1, 3),
             ((5, 3, 2), 300, 512, 64), ((7, 4, 1), 17, 512, 1),
             ((16, 8, 3), 129, 512, 7), ((12, 9, 8), 70, 512, None),
             ((30, 2), 200, 512, 5), ((28, 20, 4), 301, 512, 9)]


def _sdp_inputs(offsets, n, op, weighted, tag):
    rng = _rng(tag)
    init = rng.normal(size=(offsets[0],)).astype(np.float32)
    w = None
    if weighted:
        w = rng.normal(size=(n, len(offsets))).astype(np.float32)
        if op != "add":  # mask ~20% of lanes with the semiring zero
            w[rng.random(w.shape) < 0.2] = np.inf if op == "min" else -np.inf
    return init, w


@pytest.mark.parametrize("offsets,n,block,chunk", LIN_CASES)
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_plain_bit_equal_to_pallas(offsets, n, block, chunk, op, weighted):
    init, w = _sdp_inputs(offsets, n, op, weighted,
                          f"k3/{offsets}/{n}/{chunk}/{op}/{weighted}")
    want = sdp_chunked_pallas(jnp.asarray(init), offsets, op, n, block=block,
                              chunk=chunk, weights=_j(w), interpret=True)
    got = tk3.sdp_chunked(_t(init), offsets, op, n, block=block,
                          weights=_t(w))
    # the ring computes K1's cells
    np.testing.assert_array_equal(
        got.numpy(), tk1.sdp_pipeline(_t(init), offsets, op, n, block=block,
                                      weights=_t(w)).numpy())
    if op == "add" and weighted:
        np.testing.assert_array_equal(
            got.numpy(), sdp_reference(init, offsets, op, n, weights=w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ADD_RTOL, atol=1e-6)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if op == "add":
        return
    wt, wa = sdp_chunked_pallas_with_args(
        jnp.asarray(init), offsets, op, n, block=block, chunk=chunk,
        weights=_j(w), interpret=True)
    gt, ga = tk3.sdp_chunked_with_args(_t(init), offsets, op, n, block=block,
                                       weights=_t(w))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


@pytest.mark.parametrize("n", [3, 5])
def test_k3_preset_only_returns_presets(n):
    init = np.arange(5, dtype=np.float32)
    want_t, want_a = sdp_chunked_pallas_with_args(
        jnp.asarray(init), (5, 3, 1), "min", n, interpret=True)
    st, args = tk3.sdp_chunked_with_args(_t(init), (5, 3, 1), "min", n)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(args.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(
        tk3.sdp_chunked(_t(init), (5, 3, 1), "min", n).numpy(), init[:n])


def test_k3_batch_axis_matches_single_instances():
    offsets, n = (6, 4, 3), 50
    rng = _rng("k3-batch")
    init = rng.normal(size=(3, 6)).astype(np.float32)
    w = rng.normal(size=(3, n, 3)).astype(np.float32)
    st, ar = ops.sdp_chunked_with_args(_t(init), offsets, "max", n, block=2,
                                       weights=_t(w))
    for b in range(3):
        s1, a1 = tk3.sdp_chunked_with_args(_t(init[b]), offsets, "max", n,
                                           block=2, weights=_t(w[b]))
        np.testing.assert_array_equal(st[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(ar[b].numpy(), a1.numpy())


def _qrn(p) -> tuple:
    return p.Q, p.R, p.near


def test_k3_window_geometry():
    """The walk's plan: the ring holds the a_1-cell horizon and a whole
    chunk, its length the least multiple of 32 that does; the chunk is as
    long as near offsets below the warp window allow, halved until shared
    memory fits; shared memory counts ring, staged weights of odd row
    stride and, with near lanes, the partials and the lane table."""
    for offsets in [(3, 1), (2048, 1025), (16384, 8193), (70, 69, 68, 40, 35)]:
        p = tk3.plan(offsets, True)
        assert p.R >= offsets[0] + p.Q and p.R % 32 == 0 and p.R - 32 < offsets[0] + p.Q
        near = 2 * p.Q + tk3.sdp_walk.WINDOW + 1 if p.near else 0
        assert tk3.smem_bytes(offsets, True) == 4 * (
            p.R + 2 * p.Q * (len(offsets) | 1) + near) <= _build.SMEM_OPTIN_BYTES
    assert _qrn(tk3.plan((30, 2), False)) == (1024, 1056, 2)     # near {30, 2}
    assert _qrn(tk3.plan((28, 20, 4), False)) == (1024, 1056, 2)
    assert _qrn(tk3.plan((31, 2), True)) == (1024, 1056, 2)
    assert _qrn(tk3.plan((2050, 2049, 1), True)) == (1024, 3104, 1)   # near {1}
    assert _qrn(tk3.plan(tuple(range(127, 0, -1)), True)) == (64, 192, 2)
    assert _qrn(tk3.plan(tuple(range(2048, 1024, -1)), False)) == (1024, 3072, 0)
    # the paper's top row (a_1 = 2^14): a 68 KB window, over the 48 KB default
    assert 48 * 1024 < tk3.smem_bytes((2 ** 14, 2 ** 13 + 1), False) <= _build.SMEM_OPTIN_BYTES


#: offset sets for the planner: the zoo's shapes (edit_distance / lcs at
#: 512 and 2048, viterbi at 64 states, knapsack), the paper's Table-I rows,
#: the smoke's, and edges (a lone offset, the ring at the shared-memory limit)
PLAN_OFFSETS = [
    (1,), (2, 1), (3, 1), (514, 513, 1), (2050, 2049, 1), (65, 64, 1),
    tuple(range(127, 0, -1)), tuple(range(3, 0, -1)), tuple(range(63, 0, -1)),
    tuple(range(64, 0, -1)), (32, 30, 25, 17, 12, 8, 5, 3, 2, 1),
    tuple(range(2048, 1024, -1)), (2048, 1025), (2 ** 14, 2 ** 13 + 1),
    (60000, 1), (57000, 1), (58000, 1), (40, 33, 32), (70, 69, 68, 40, 35),
    (1200, 700, 650, 64, 63, 2), tuple(range(600, 0, -3)),
]


def _old_window_bytes(offsets, weighted):
    """The shared memory of K3's first design, which fixed the streaming
    route's domain: ring of the least multiple of 32 >= a_1 + B cells
    (B = min(a_k, 512)), the offsets, and a weight tile of B·(J|1) floats."""
    a1, ak, k = offsets[0], offsets[-1], len(offsets)
    B = max(1, min(ak, 512))
    J = min(k, max(1, 8192 // B))
    return 4 * (-(-(a1 + B) // 32) * 32 + k + (B * (J | 1) if weighted else 0))


@pytest.mark.parametrize("offsets", PLAN_OFFSETS, ids=lambda o: f"a1={o[0]}-k={len(o)}")
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ring", [False, True])
def test_walk_plan_invariants(offsets, weighted, ring):
    """Every far lane of a chunk reads an earlier chunk (a lane is near
    exactly when its offset is below Q, and near offsets stay inside the
    warp's 64-cell window); the near mode names the near set; the ring
    holds a_1 + Q cells; shared memory fits; the plan never asks for more
    than the first design's window where that fitted."""
    from repro_torch.kernels import sdp_walk

    p = sdp_walk.plan(offsets, weighted, ring)
    admitted = _old_window_bytes(offsets, weighted) <= _build.SMEM_OPTIN_BYTES
    if p is None:
        assert ring and not admitted
        return
    near = [a for a in offsets if a < p.Q]
    assert 1 <= p.Q <= sdp_walk.MAX_CHUNK and all(a < sdp_walk.WINDOW for a in near)
    assert p.near == (0 if not near else 1 if near == [1] else 2)
    assert p.stage <= weighted
    if p.near == 0:                  # every lane far: no source inside the chunk
        assert offsets[-1] >= p.Q
    assert (p.R >= offsets[0] + p.Q and p.R % 32 == 0) if ring else p.R == 0
    assert sdp_walk.smem_bytes(offsets, p) <= _build.SMEM_OPTIN_BYTES
    assert sdp_walk.threads(p) >= p.Q and sdp_walk.threads(p) % 32 == 0
    for op in ("min", "max", "add"):     # lane splits of the far fold
        S = sdp_walk.splits(offsets, p, op)
        assert (S == 1) if op == "add" else 1 <= S <= sdp_walk.MAX_SPLITS
        assert sdp_walk.threads(p, 1, S) <= 1024
        assert sdp_walk.smem_bytes(offsets, p, 1, S) <= _build.SMEM_OPTIN_BYTES
    if p.wide:
        for c in sdp_walk.cluster_candidates(p):
            assert p.Q // c >= sdp_walk.CLUSTER_MIN_CELLS
            assert sdp_walk.smem_bytes(offsets, p, c) <= sdp_walk.smem_bytes(offsets, p)
            for op in ("min", "max", "add"):
                S = sdp_walk.splits(offsets, p, op, c)
                assert (S == 1) if op == "add" else 1 <= S <= sdp_walk.MAX_SPLITS
                assert sdp_walk.threads(p, c, S) <= 1024
    runs = sdp_walk.runs(offsets)
    assert [a0 - t for a0, _, n, _ in runs for t in range(n)] == list(offsets)
    assert [j0 + t for _, j0, n, _ in runs for t in range(n)] == list(range(len(offsets)))


@pytest.mark.parametrize("offsets", PLAN_OFFSETS,
                         ids=lambda o: f"a1={o[0]}-k={len(o)}")
@pytest.mark.parametrize("weighted", [False, True])
def test_tiled_supports_admits_the_specs_it_admitted(offsets, weighted):
    """The streaming route's domain on the card is unchanged by the walk:
    exactly the specs whose first-design window fits, each with a plan."""
    spec = tdp.LinearSpec(offsets=offsets, op="min", n=2 * offsets[0] + 5,
                          init=np.zeros(offsets[0], np.float32),
                          weights=np.zeros((1, 1), np.float32) if weighted else None)
    admitted = _old_window_bytes(offsets, weighted) <= _build.SMEM_OPTIN_BYTES
    assert kernels._tiled_supports(spec, torch.device("cuda")) == admitted
    assert kernels._tiled_supports(spec, torch.device("cpu"))
    if admitted:
        assert tk3.smem_bytes(offsets, weighted) <= _build.SMEM_OPTIN_BYTES


def test_k3_rejects_args_for_add():
    with pytest.raises(ValueError, match="undefined"):
        tk3.sdp_chunked_with_args(torch.zeros(2), (2, 1), "add", 8)


@pytest.mark.parametrize("name", LINEAR)
def test_kernel_tiled_route_matches_reference_past_a_tiny_budget(monkeypatch, name):
    """Each linear problem through ``kernel_tiled`` against ``repro``'s,
    whose Pallas window shrinks to a few cells under a 2 KB budget (chunks
    far shorter than a_1): tables, args and solutions bit-equal, in one
    solve and in a batch."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "2048")
    prob = tdp.get_problem(name)
    rng = _rng(f"tiled-route/{name}")
    inst = prob.sample(rng, 30)
    key = prob.encode(**inst).shape_key()
    insts = [inst]
    while len(insts) < 3:
        cand = prob.sample(rng, 30)
        if prob.encode(**cand).shape_key() == key:
            insts.append(cand)
    want = jdp.batch_solve(name, insts, backend="kernel_tiled", reconstruct=True)
    got = tdp.batch_solve(name, insts, backend="kernel_tiled", reconstruct=True,
                          device="cpu")
    one = tdp.solve(name, backend="kernel_tiled", reconstruct=True, device="cpu",
                    **insts[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.table, w.table)
        np.testing.assert_array_equal(g.args, w.args)
        assert g.solution == w.solution and g.source == w.source == "device"
    np.testing.assert_array_equal(one.table, got[1].table)
    assert one.solution == got[1].solution


def test_kernel_tiled_gate_is_shared_memory_on_the_card():
    """The streaming linear route needs only its window on chip: a horizon
    of 60000 cells is over 227 KB, so the card refuses it; the CPU's plain
    version has no such limit."""
    spec = tdp.LinearSpec(offsets=(60000, 1), op="min", n=70000,
                          init=np.zeros(60000, np.float32))
    b = tdp.backends.get("kernel_tiled")
    assert not b.supports(spec, torch.device("cuda"))
    assert b.supports(spec, torch.device("cpu"))
    small = tdp.LinearSpec(offsets=(2050, 2049, 1), op="min", n=2049 ** 2,
                           init=np.zeros(2050, np.float32),
                           weights=np.zeros((1, 1), np.float32))
    assert b.supports(small, torch.device("cuda"))


# ---------------------------------------------------------------------------
# K4: mcm_tiled
# ---------------------------------------------------------------------------
def _wtab(n, tag, ties):
    rng = _rng(tag)
    if ties:  # small integers make equal candidates, exercising the tie rule
        return rng.integers(0, 3, size=(num_cells(n), max(n - 1, 1))).astype(np.float32)
    return rng.normal(size=(num_cells(n), max(n - 1, 1))).astype(np.float32)


def _nodes(ii, dd, ee):
    return np.stack([np.asarray(ii), np.asarray(dd), np.asarray(ee)], axis=1)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 40, 66])
@pytest.mark.parametrize("tiles", [None, (7, 5), (3, 2)])
@pytest.mark.parametrize("ties", [False, True])
def test_k4_plain_bit_equal_to_pallas_and_ref(n, tiles, ties):
    """All three twins against the interpreted Pallas kernel and the jnp
    same-geometry oracle, with tiles that do not divide the band. ``tiles``
    sizes the reference's tiles only; the port's are fixed (64 splits:
    n = 66 folds a second, one-split tile)."""
    w = _wtab(n, f"k4/{n}/{tiles}/{ties}", ties)
    kw = {} if tiles is None else {"tile_t": tiles[0], "tile_e": tiles[1]}
    ref_st, ref_ar = mcm_tiled_ref_with_args(jnp.asarray(w), n, **kw)
    np.testing.assert_array_equal(np.asarray(mcm_tiled_ref(jnp.asarray(w), n, **kw)),
                                  np.asarray(ref_st))
    np.testing.assert_array_equal(
        np.asarray(mcm_tiled_pallas(jnp.asarray(w), n, interpret=True, **kw)),
        np.asarray(ref_st))
    np.testing.assert_array_equal(tk4.mcm_tiled(_t(w), n).numpy(),
                                  np.asarray(ref_st))
    pt, pa = mcm_tiled_pallas_with_args(jnp.asarray(w), n, interpret=True, **kw)
    gt, ga = tk4.mcm_tiled_with_args(_t(w), n)
    for got, want in ((gt, pt), (ga, pa), (gt, ref_st), (ga, ref_ar)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fst, far, fnodes = tk4.mcm_tiled_fused(_t(w), n)
    pst, par, pnodes = mcm_tiled_pallas_fused(jnp.asarray(w), n, interpret=True, **kw)
    np.testing.assert_array_equal(fst.numpy(), np.asarray(pst))
    np.testing.assert_array_equal(far.numpy(), np.asarray(par))
    nodes = _nodes(*fnodes)
    np.testing.assert_array_equal(nodes, _nodes(*pnodes))
    # the fused walk is the host walk, of both packages
    np.testing.assert_array_equal(nodes, triangular_traceback_np(far.numpy(), n)
                                  .reshape(-1, 3))
    np.testing.assert_array_equal(nodes, ref_walk(np.asarray(par), n).reshape(-1, 3))
    _, _, jnodes = mcm_tiled_ref_fused(jnp.asarray(w), n, **kw)
    np.testing.assert_array_equal(nodes, _nodes(*jnodes))


def test_k4_batch_axis_matches_single_instances():
    n = 11
    ws = np.stack([_wtab(n, f"k4-batch/{b}", ties=b == 1) for b in range(3)])
    st, ar, (ii, dd, ee) = ops.mcm_tiled_fused(_t(ws), n)
    assert ii.shape == dd.shape == ee.shape == (3, n - 1)
    for b in range(3):
        s1, a1, nodes = tk4.mcm_tiled_fused(_t(ws[b]), n)
        np.testing.assert_array_equal(st[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(ar[b].numpy(), a1.numpy())
        np.testing.assert_array_equal(_nodes(ii[b], dd[b], ee[b]), _nodes(*nodes))


def test_k4_tile_plan_fits_shared_memory():
    for n in (2, 40, 257, 1024, 8192):
        T, E = tk4.tile_plan(n)
        assert T % 32 == 0 and T <= 1024 and 1 <= E <= max(n - 1, 1)
        assert tk4.smem_bytes(n, fused=True) <= _build.SMEM_OPTIN_BYTES
    assert tk4.tile_plan(1024) == (256, 64)
    assert tk4.smem_bytes(1024, fused=False) == 4 * (2 * 64 * 256 + 256 * 65)
    assert tk4.smem_bytes(40000, fused=True) == 8 * 40002  # the walk's stack
    assert tk4.tile_plan(66) == (96, 64) and tk4.tile_plan(17) == (32, 16)


@pytest.mark.parametrize("n,batch,ctas", [(2, 1, 132), (40, 1, 132),
                                          (1024, 1, 132), (512, 8, 132),
                                          (700, 3, 7), (4096, 1, 264)])
def test_k4_spread_plan_per_diagonal(n, batch, ctas):
    """Warps per cell on each diagonal: a power of two, at most a CTA's
    warps; enough lanes for the splits unless the cells would then
    outnumber the groups; and the merge buffer (or the walk's stack)
    within the shared memory the route's admission already reserves."""
    for d in range(1, n):
        cells = batch * (n - d)
        g = tk4.warps_per_cell(d, cells, ctas)
        assert 1 <= g <= tk4.WARPS and g & (g - 1) == 0
        assert 32 * g >= d or g == tk4.WARPS or cells * 2 * g > ctas * tk4.WARPS
        assert g == 1 or cells * g <= ctas * tk4.WARPS
    assert tk4.warps_per_cell(1023, 1, 132) == tk4.WARPS
    assert tk4.warps_per_cell(40, 10 ** 6, 132) == 1
    for fused in (False, True):
        assert tk4.spread_smem_bytes(n, fused) <= tk4.smem_bytes(n, fused)
        assert tk4.spread_smem_bytes(n, fused) <= _build.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("n", [2, 17, 257, 1024, 4096, 29054, 29055, 40000, 65535])
def test_tiled_wavefront_supports_admits_the_n_it_admitted(n):
    """The fused route's domain on the card is the first design's: its
    walk's stack of n + 2 int32 pairs within 227 KB, n ≤ 29054."""
    spec = tdp.TriangularSpec(n=n, weights=np.zeros((1, 1), np.float32))
    assert kernels._tiled_wavefront_supports(spec, torch.device("cuda")) == (n <= 29054)
    assert kernels._tiled_wavefront_supports(spec, torch.device("cpu"))


# ---------------------------------------------------------------------------
# the fused route through the public entry points
# ---------------------------------------------------------------------------
def _no_host_walk(monkeypatch):
    """Fail any traceback walk outside the fused launch: the per-instance
    host walk and the batched device walk alike."""
    def boom(*args, **kw):
        raise AssertionError("the fused route must not walk on the host "
                             "or the device")

    monkeypatch.setattr(treconstruct, "traceback_host", boom)
    monkeypatch.setattr(treconstruct, "traceback_batch", boom)


@pytest.mark.parametrize("name", TRIANGULAR)
def test_fused_route_matches_reference_without_a_host_walk(monkeypatch, name):
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    prob = tdp.get_problem(name)
    rng = _rng(f"fused/{name}")
    insts = [prob.sample(rng, 9) for _ in range(3)]
    want = jdp.batch_solve(name, insts, backend="kernel_tiled_wavefront",
                           reconstruct=True)
    want_one = jdp.solve(name, backend="kernel_tiled_wavefront",
                         reconstruct=True, **insts[0])
    _no_host_walk(monkeypatch)
    got = tdp.batch_solve(name, insts, backend="kernel_tiled_wavefront",
                          reconstruct=True, device="cpu")
    one = tdp.solve(name, backend="kernel_tiled_wavefront", reconstruct=True,
                    device="cpu", **insts[0])
    for g, w in list(zip(got, want)) + [(one, want_one)]:
        np.testing.assert_array_equal(g.table, w.table)
        np.testing.assert_array_equal(g.args, w.args)
        assert g.solution == w.solution
        assert g.value == w.value and g.source == w.source == "device"


def test_fused_path_is_the_host_walk(monkeypatch):
    """The fused nodes equal the host walk's, and the non-fused route does
    walk outside its launch (on the device, through the batched walk), so
    the patch above would have caught a walk."""
    prob = tdp.get_problem("mcm")
    spec = prob.encode(**prob.sample(_rng("fused-path"), 12))
    b = tdp.backends.get("kernel_tiled_wavefront")
    (table,), (args,), (path,) = b.batch_run_fused([spec], torch.device("cpu"))
    assert path.nodes.dtype == np.int64 and path.nodes.shape == (spec.n - 1, 3)
    np.testing.assert_array_equal(path.nodes, spec.traceback_host(args).nodes)
    assert tdp.backends.get("kernel_wavefront").batch_run_fused is None
    _no_host_walk(monkeypatch)
    with pytest.raises(AssertionError, match="host"):
        tdp.solve("mcm", backend="kernel_wavefront", reconstruct=True,
                  device="cpu", dims=[3, 4, 5, 6])


def test_gate_formulas_match_reference():
    """The working-set formulas the card's gate uses are ``repro``'s."""
    from repro import kernels as jkernels

    for n in (2, 40, 290, 297, 1024):
        w = np.zeros((1, 1), np.float32)
        assert (kernels._triangular_vmem_bytes(tdp.TriangularSpec(n=n, weights=w))
                == jkernels._triangular_vmem_bytes(jdp.TriangularSpec(n=n, weights=w)))
    for offsets, weighted in (((3, 1), False), ((2050, 2049, 1), True),
                              (tuple(range(127, 0, -1)), True)):
        kw = dict(offsets=offsets, op="max", n=131072,
                  init=np.zeros(offsets[0], np.float32),
                  weights=np.zeros((1, 1), np.float32) if weighted else None)
        assert (kernels._linear_vmem_bytes(tdp.LinearSpec(**kw))
                == jkernels._linear_vmem_bytes(jdp.LinearSpec(**kw)))
