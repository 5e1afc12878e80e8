"""Tests that need the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the main path on the card against the
CPU path. Marked ``gpu``; the ``cuda`` fixture skips them where no CUDA
device is present. This file imports no JAX; ``grid_edge_specs`` and
``grid_arrs`` are shared with the CPU tests of ``tests/test_torch_grid.py``.

Run on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import ctypes
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import dp  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.core.mcm import num_cells  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import grid_pipeline as k6  # noqa: E402
from repro_torch.kernels import mcm_pipeline as k2  # noqa: E402
from repro_torch.kernels import mcm_tiled as k4  # noqa: E402
from repro_torch.kernels import sdp_chunked as k3  # noqa: E402
from repro_torch.kernels import sdp_pipeline as k1  # noqa: E402
from repro_torch.kernels import sdp_walk  # noqa: E402
from repro_torch.kernels import semiring_matmul as k5  # noqa: E402
from repro_torch.kernels import chunked_scan as k8  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402

pytestmark = pytest.mark.gpu


def grid_edge_specs() -> list:
    """``(label, GridSpec)`` cases the zoo does not reach: rows ≠ cols both
    ways and a single row or column (every regime of the frontier-major
    offsets), a move with di + dj = 3, a plane that no move or rule
    targets, a rule with B == A, and cells where every candidate is the
    semiring zero (their arg is the first move or rule into the plane)."""
    rng = np.random.default_rng(12)
    cases = []
    moves = ((0, 0, 1, 1), (0, 1, 2, 1), (0, 0, 0, 1), (1, 0, 1, 0), (1, 1, 1, 0))
    rules = ((0, 0, 1), (1, 1, 1), (0, 1, 0), (1, 0, 0), (3, 2, 2))
    for op in ("min", "max"):
        zero = np.float32(np.inf if op == "min" else -np.inf)
        for R, C in ((3, 7), (7, 3), (5, 5), (1, 4), (4, 1)):
            w = rng.normal(size=(len(moves), R, C)).astype(np.float32)
            w[rng.random(w.shape) < 0.2] = zero
            w[:, R // 2, C // 2] = zero                 # all candidates zero
            for l, (_, _, di, dj) in enumerate(moves):  # the spec's contract:
                w[l, :di], w[l, :, :dj] = zero, zero    # out-of-grid moves masked
            mask = rng.random((3, R, C)) < 0.1          # plane 2: untargeted
            mask[:, 0, 0] = True
            mask[0, 0, :] = mask[1, :, 0] = True
            cases.append((f"antidiag-{op}-{R}x{C}", dp.GridSpec(
                rows=R, cols=C, op=op, schedule="antidiag", planes=3,
                moves=moves, weights=w, init_mask=mask,
                init=rng.normal(size=(3, R, C)).astype(np.float32))))
        for n in (2, 3, 7):
            init = rng.normal(size=(4, n)).astype(np.float32)
            init[2] = zero        # plane 2 untargeted: plane 3 sees only zero
            cases.append((f"spandiag-{op}-{n}", dp.GridSpec(
                rows=n, cols=n, op=op, schedule="spandiag", planes=4,
                rules=rules, init=init,
                rule_weights=rng.normal(size=len(rules)).astype(np.float32))))
    for _, spec in cases:
        spec.validate()
    return cases


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("offsets,n,block", [
    ((5, 3, 1), 640, 16), ((7, 4, 2), 573, 3), ((3, 2, 1), 4100, 512),
    ((40, 33, 32), 5000, 512), ((2, 1), 9, 1), ((5, 3, 1), 4, 512),
])
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_sdp_kernel_bit_equal_to_plain(cuda, offsets, n, block, op, weighted):
    rng = np.random.default_rng(n + len(offsets))
    init = torch.tensor(rng.normal(size=(3, offsets[0])), dtype=torch.float32,
                        device=cuda)
    w = None
    if weighted:
        w = torch.tensor(rng.normal(size=(3, n, len(offsets))) * 0.1,
                         dtype=torch.float32, device=cuda)
    got = k1.sdp_pipeline(init, offsets, op, n, block=block, weights=w)
    want = k1.sdp_pipeline_plain(init, offsets, op, n, block=block, weights=w)
    assert torch.equal(got, want)
    if op != "add":
        gt, ga = k1.sdp_pipeline_with_args(init, offsets, op, n, block=block,
                                           weights=w)
        wt, wa = k1.sdp_pipeline_plain(init, offsets, op, n, block=block,
                                       weights=w, with_args=True)
        assert torch.equal(gt, wt) and torch.equal(ga, wa)


def _k2_equals_plain(w, n, cluster=None):
    gt, ga = k2._launch(w, n, True, cluster)
    wt, wa = k2.mcm_pipeline_plain(w, n, with_args=True)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)
    assert torch.equal(k2._launch(w, n, False, cluster), wt)
    return wt, wa


@pytest.mark.parametrize("n,batch", [(1, 2), (2, 2), (3, 2), (33, 3),
                                     (100, 2), (256, 2), (295, 1), (296, 1),
                                     (340, 1), (341, 1), (1100, 1)])
def test_mcm_kernel_bit_equal_to_plain(cuda, n, batch):
    """Small integer weights make ties, exercising the first-best rule; the
    table in shared memory up to n = 340 (295: the L2 gate's largest),
    in device memory from 341 (1100: more cells a diagonal than a cluster
    has threads)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    w = torch.randint(0, 50, (batch, num_cells(n), max(n - 1, 1)), generator=g,
                      dtype=torch.float32, device=cuda)
    gt, ga = k2.mcm_pipeline_with_args(w, n)
    wt, wa = k2.mcm_pipeline_plain(w, n, with_args=True)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)
    assert torch.equal(k2.mcm_pipeline(w, n), wt)


def test_mcm_kernel_rules_match_the_card(cuda):
    """The wrapper's table home, shared memory and threads are the
    kernel's own; the wrapper's cluster is one the card runs."""
    lib = tkernels._build.load("mcm_pipeline")
    lib.mcm_pipeline_smem_bytes.restype = k2.ctypes.c_longlong
    assert lib.mcm_pipeline_threads() == k2.THREADS
    for n in (1, 2, 64, 256, 295, 296, 340, 341, 1024):
        assert lib.mcm_pipeline_table_in_smem(n) == (k2.table_home(n) == "shared")
        assert lib.mcm_pipeline_smem_bytes(n) == k2.smem_bytes(n)
    for n, batch in ((256, 8), (1024, 1), (64, 40)):
        C = k2.cluster_size(True, n, batch, cuda)
        assert C in k2.CLUSTER_SIZES and k2.max_clusters(True, n, C, cuda) >= 1


@pytest.mark.parametrize("n", [64, 256, 400])
def test_mcm_kernel_every_cluster_size(cuda, n):
    """Each size the wrapper may pick (16 non-portable) that the card runs,
    with the table in shared (64, 256) and device (400) memory."""
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    w = torch.randint(0, 4, (2, num_cells(n), n - 1), generator=g,
                      dtype=torch.float32, device=cuda)
    sizes = [c for c in k2.CLUSTER_SIZES if k2.max_clusters(True, n, c, cuda) >= 1]
    assert 1 in sizes and 8 in sizes
    for C in sizes:
        _k2_equals_plain(w, n, cluster=C)


def test_mcm_kernel_batch_beyond_resident_clusters(cuda):
    """40 instances at n = 64 on a cluster size of which the card keeps
    fewer than 40 resident: the clusters run in waves."""
    n, batch = 64, 40
    C = max(c for c in k2.CLUSTER_SIZES if 1 <= k2.max_clusters(True, n, c, cuda) < batch)
    g = torch.Generator(device=cuda).manual_seed(40)
    w = torch.randint(0, 9, (batch, num_cells(n), n - 1), generator=g,
                      dtype=torch.float32, device=cuda)
    _k2_equals_plain(w, n, cluster=C)
    _k2_equals_plain(w, n)


@pytest.mark.parametrize("n", [150, 500])
def test_mcm_kernel_all_inf_rows_keep_arg_zero(cuda, n):
    """Rows whose every split weight is inf keep inf and arg 0 (table in
    shared memory at 150, device memory at 500)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randint(0, 3, (2, num_cells(n), n - 1), generator=g,
                      dtype=torch.float32, device=cuda)
    rows = torch.randint(n, num_cells(n), (40,), generator=g, device=cuda)
    w[0, rows] = float("inf")
    w[1, rows[:10]] = float("inf")
    st, ar = _k2_equals_plain(w, n)
    assert torch.isinf(st[0, rows]).all() and (ar[0, rows] == 0).all()


@pytest.mark.parametrize("offsets,n,block", [
    ((5, 3, 1), 640, 16), ((30, 4, 2), 573, 3), ((3, 2, 1), 4100, 512),
    ((40, 33, 32), 5000, 512), ((29, 8, 3), 900, 512), ((2, 1), 9, 1),
    ((5, 3, 1), 4, 512), (tuple(range(560, 520, -1)), 3000, 512),
])
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_sdp_chunked_kernel_bit_equal_to_plain(cuda, offsets, n, block, op,
                                               weighted):
    """Both K3 twins, batched, under several of the reference's step
    geometries (``block``), on which no result of the kernel depends."""
    rng = np.random.default_rng(n + len(offsets))
    init = torch.tensor(rng.normal(size=(3, offsets[0])), dtype=torch.float32,
                        device=cuda)
    w = None
    if weighted:
        w = torch.tensor(rng.normal(size=(3, n, len(offsets))) * 0.1,
                         dtype=torch.float32, device=cuda)
    got = k3.sdp_chunked(init, offsets, op, n, block=block, weights=w)
    want = k3.sdp_chunked_plain(init, offsets, op, n, block=block, weights=w)
    assert torch.equal(got, want)
    if op != "add":
        gt, ga = k3.sdp_chunked_with_args(init, offsets, op, n, block=block,
                                          weights=w)
        wt, wa = k3.sdp_chunked_plain(init, offsets, op, n, block=block,
                                      weights=w, with_args=True)
        assert torch.equal(gt, wt) and torch.equal(ga, wa)


@pytest.mark.parametrize("weighted", [False, True])
def test_sdp_chunked_window_beyond_48k_shared_memory(cuda, weighted):
    """a_1 = 2^14: a 68 KB ring (opt-in above 48 KB), 92 KB weighted."""
    offsets, n = (2 ** 14, 2 ** 13 + 1), 40000
    assert k3.smem_bytes(offsets, weighted) > 48 * 1024
    rng = np.random.default_rng(14)
    init = torch.tensor(rng.normal(size=(2, offsets[0])), dtype=torch.float32,
                        device=cuda)
    w = (torch.tensor(rng.normal(size=(2, n, 2)), dtype=torch.float32, device=cuda)
         if weighted else None)
    gt, ga = k3.sdp_chunked_with_args(init, offsets, "min", n, weights=w)
    wt, wa = k3.sdp_chunked_plain(init, offsets, "min", n, weights=w, with_args=True)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)


def _walk_inputs(cuda, offsets, n, op, weighted, batch=2, ties=False,
                 masked=False, seed=0):
    rng = np.random.default_rng(seed)
    a1, k = offsets[0], len(offsets)
    if ties:          # small integers: many lanes tie, exercising the arg rule
        init = rng.integers(0, 3, (batch, a1))
        w = rng.integers(0, 3, (batch, n, k)) if weighted else None
    else:
        init = rng.normal(size=(batch, a1))
        w = rng.normal(size=(batch, n, k)) * 0.1 if weighted else None
    if masked:        # a third of the lanes hold the semiring zero
        w[rng.random(w.shape) < 0.3] = np.inf if op == "min" else -np.inf
    to = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)  # noqa: E731
    return to(init), None if w is None else to(w)


def _walk_equals_plain(init, offsets, n, op, w):
    """K1 and K3, both twins, against their plain versions, bit for bit."""
    for kernel, kernel_args, plain in (
            (k1.sdp_pipeline, k1.sdp_pipeline_with_args, k1.sdp_pipeline_plain),
            (k3.sdp_chunked, k3.sdp_chunked_with_args, k3.sdp_chunked_plain)):
        want = plain(init, offsets, op, n, weights=w)
        assert torch.equal(kernel(init, offsets, op, n, weights=w), want)
        if op != "add":
            gt, ga = kernel_args(init, offsets, op, n, weights=w)
            wt, wa = plain(init, offsets, op, n, weights=w, with_args=True)
            assert torch.equal(gt, wt) and torch.equal(ga, wa)


#: (offsets, n): the chunk's far/near boundary at every lane — edit_distance's
#: (W+1, W, 1) at small W (near {1}, or near {W, 1} in the warp window),
#: viterbi's contiguous 2S-1 .. 1 (near up to 63), all lanes far (2048, 1025),
#: a knapsack-like scattered set, and n ≤ a_1 or not a multiple of Q
SPLIT_WALK_CASES = [
    ((3, 2, 1), 700), ((6, 5, 1), 1500), ((33, 32, 1), 2000), ((65, 64, 1), 3000),
    ((701, 700, 1), 4000), (tuple(range(3, 0, -1)), 500), (tuple(range(15, 0, -1)), 900),
    (tuple(range(63, 0, -1)), 1100), (tuple(range(127, 0, -1)), 2100),
    ((2048, 1025), 9000), ((32, 30, 25, 17, 12, 8, 5, 3, 2, 1), 3000),
    ((5, 3, 1), 4), ((40, 33, 32), 1057),
]


@pytest.mark.parametrize("offsets,n", SPLIT_WALK_CASES,
                         ids=[f"a1={o[0]}-k={len(o)}-n={n}" for o, n in SPLIT_WALK_CASES])
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_split_walk_bit_equal_to_plain(cuda, offsets, n, op, weighted):
    init, w = _walk_inputs(cuda, offsets, n, op, weighted)
    _walk_equals_plain(init, offsets, n, op, w)


@pytest.mark.parametrize("offsets,n", SPLIT_WALK_CASES[:10])
@pytest.mark.parametrize("op", ["min", "max"])
def test_split_walk_ties_and_masked_lanes(cuda, offsets, n, op):
    """All-tie lanes from small-integer weights, and lanes masked with the
    semiring zero (cells whose candidates are all zero take lane 0)."""
    init, w = _walk_inputs(cuda, offsets, n, op, True, ties=True)
    _walk_equals_plain(init, offsets, n, op, w)
    init, w = _walk_inputs(cuda, offsets, n, op, True, masked=True)
    _walk_equals_plain(init, offsets, n, op, w)


@pytest.mark.parametrize("offsets,n", [((2048, 1025), 12000),
                                       (tuple(range(2048, 1024, -1)), 7000)])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_split_walk_cluster_path(cuda, offsets, n, batch, weighted):
    """Wide all-far chunks run one cluster per instance (batch 1 and 3)."""
    if not weighted:
        assert k3.cluster_size(offsets, "min", False, True, cuda) > 1
        plan = sdp_walk.plan(offsets, False, ring=False)
        assert sdp_walk.cluster_size("sdp_pipeline", offsets, plan, "min", False,
                                     True, cuda) > 1
    init, w = _walk_inputs(cuda, offsets, n, "min", weighted, batch=batch)
    _walk_equals_plain(init, offsets, n, "min", w)


def test_split_walk_horizon_near_the_shared_memory_limit(cuda):
    """a_1 = 57000 weighted: the route's window rule admits it with 4 KB to
    spare, so the walk shrinks its chunk until the ring and the staged
    weights fit."""
    offsets, n = (57000, 1), 60100
    assert tkernels._tiled_supports(dp.LinearSpec(
        offsets=offsets, op="min", n=n, init=np.zeros(57000, np.float32),
        weights=np.zeros((1, 1), np.float32)), cuda)
    assert k3.smem_bytes(offsets, True) <= 232448
    init, w = _walk_inputs(cuda, offsets, n, "min", True, batch=1)
    _walk_equals_plain(init, offsets, n, "min", w)


def _k4_equals_plain(w, n):
    gt, ga, gn = k4.mcm_tiled_fused(w, n)
    wt, wa, wn = k4.mcm_tiled_plain(w, n, fused=True)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)
    assert all(torch.equal(a, b) for a, b in zip(gn, wn))
    st, ar = k4.mcm_tiled_with_args(w, n)
    assert torch.equal(st, wt) and torch.equal(ar, wa)
    assert torch.equal(k4.mcm_tiled(w, n), wt)
    k2t, k2a = k2.mcm_pipeline_with_args(w, n)          # and K2's tables
    assert torch.equal(k2t, wt) and torch.equal(k2a, wa)


@pytest.mark.parametrize("n,batch", [(1, 2), (2, 2), (3, 2), (33, 3),
                                     (100, 2), (300, 1), (1100, 1)])
def test_mcm_tiled_kernel_bit_equal_to_plain(cuda, n, batch):
    """All three K4 twins against the plain version (and K2); small integer
    weights make ties; n = 1100 has more rows than one tile."""
    g = torch.Generator(device=cuda).manual_seed(n)
    w = torch.randint(0, 50, (batch, num_cells(n), max(n - 1, 1)), generator=g,
                      dtype=torch.float32, device=cuda)
    _k4_equals_plain(w, n)


@pytest.mark.parametrize("n", [257, 258, 65, 66, 129, 130, 513, 514])
def test_mcm_tiled_kernel_at_tile_edges(cuda, n):
    """Bands exactly whole tiles long (n - 1 a multiple of T = 256 or of
    E = 64) and one row or split past them."""
    assert k4.tile_plan(n)[1] == 64
    g = torch.Generator(device=cuda).manual_seed(n)
    w = torch.randint(0, 9, (2, num_cells(n), n - 1), generator=g,
                      dtype=torch.float32, device=cuda)
    _k4_equals_plain(w, n)


@pytest.mark.parametrize("n,batch", [
    (40, 1),     # every diagonal has fewer rows than the grid has CTAs
    (700, 1),    # late diagonals: more splits than a warp, several warps a cell
    (97, 5),     # instances share the grid's cells on every diagonal
    (260, 3),
])
def test_mcm_tiled_spread_bit_equal_to_plain(cuda, n, batch):
    """K4's three twins against the plain version and K2 where one
    diagonal's cells are fewer than the CTAs, where splits outnumber a
    warp's lanes, and with batched instances; weights of 0..3 tie often."""
    g = torch.Generator(device=cuda).manual_seed(n * 7 + batch)
    w = torch.randint(0, 4, (batch, num_cells(n), n - 1), generator=g,
                      dtype=torch.float32, device=cuda)
    ctas = k4.ctas(True, True, n, cuda)
    assert any(k4.warps_per_cell(d, batch * (n - d), ctas) > 1 for d in range(1, n)) \
        == (n > 32)
    _k4_equals_plain(w, n)


def test_mcm_tiled_all_inf_rows_keep_arg_zero(cuda):
    """Rows whose every split weight is inf keep inf and arg 0."""
    n = 150
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randint(0, 3, (2, num_cells(n), n - 1), generator=g,
                      dtype=torch.float32, device=cuda)
    rows = torch.randint(n, num_cells(n), (40,), generator=g, device=cuda)
    w[0, rows] = float("inf")
    w[1, rows[:10]] = float("inf")
    _k4_equals_plain(w, n)
    st, ar = k4.mcm_tiled_with_args(w, n)
    assert torch.isinf(st[0, rows]).all() and (ar[0, rows] == 0).all()


def test_mcm_tiled_grid_is_co_resident(cuda):
    """The wrapper's grid is what the occupancy API keeps resident; a
    larger one is refused by the cooperative launch, never run."""
    lib = tkernels._build.load("mcm_tiled")
    assert lib.mcm_tiled_threads() == k4.THREADS
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for with_args, fused in ((False, False), (True, False), (True, True)):
        fn = lib.mcm_tiled_blocks_per_sm
        fn.argtypes = [k4.ctypes.c_int, k4.ctypes.c_int, k4.ctypes.c_longlong]
        per_sm = fn(int(with_args), int(fused), k4.spread_smem_bytes(1024, fused))
        assert 1 <= k4.ctas(with_args, fused, 1024, cuda) <= per_sm * sms
    w = torch.zeros((1, num_cells(9), 8), device=cuda)
    with pytest.raises(RuntimeError, match="co-resident"):
        k4._launch(w, 9, False, False, grid=per_sm * sms + 1)


def test_streaming_kernels_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        k3.sdp_chunked(torch.zeros(3, dtype=torch.float64, device=cuda),
                       (3, 1), "min", 10)
    with pytest.raises(ValueError, match="shared memory"):   # window > 227 KB
        k3.sdp_chunked(torch.zeros(60000, device=cuda), (60000, 1), "min", 70000)
    with pytest.raises(ValueError):
        k4.mcm_tiled(torch.zeros((6, 3), device=cuda), 4)    # wrong rows


def grid_arrs(spec, device, batch=None):
    """A spec's ``device_arrays()`` as tensors on ``device``; with ``batch``,
    that many distinct instances (each copy's weights shifted by 0.25)."""
    arrs = [torch.from_numpy(np.ascontiguousarray(a)) for a in spec.device_arrays()]
    if batch is not None:
        arrs[0] = torch.stack([arrs[0] + 0.25 * b for b in range(batch)])
        arrs[1:] = [torch.stack([a] * batch) for a in arrs[1:]]
    return tuple(a.to(device) for a in arrs)


def _grid_kernel_equals_plain(arrs, meta):
    gt, ga = k6.grid_pipeline_with_args(arrs, meta)
    wt, wa = k6.grid_pipeline_plain(arrs, meta, with_args=True)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)
    assert torch.equal(k6.grid_pipeline(arrs, meta), wt)


@pytest.mark.parametrize("name", ["needleman_wunsch", "gotoh", "cky",
                                  "edit_distance_grid", "lcs_grid"])
@pytest.mark.parametrize("size,batch", [(3, None), (12, 3), (40, None),
                                        (1100, None)])
def test_grid_kernel_bit_equal_to_plain(cuda, name, size, batch):
    """Zoo instances, batched and not; 1100 has more lanes (antidiag) than
    a CTA has threads."""
    prob = dp.get_problem(name)
    inst = prob.sample(np.random.default_rng(size), size)
    if name == "cky":       # the sampler caps n at 12; widen the sentence
        inst["tokens"] = np.random.default_rng(size).integers(0, 4, size=min(size, 64))
    spec = prob.encode(**inst)
    _grid_kernel_equals_plain(grid_arrs(spec, cuda, batch), spec.static_meta())


@pytest.mark.parametrize("spec", [pytest.param(spec, id=label)
                                  for label, spec in grid_edge_specs()])
def test_grid_kernel_edge_cases(cuda, spec):
    _grid_kernel_equals_plain(grid_arrs(spec, cuda), spec.static_meta())
    _grid_kernel_equals_plain(grid_arrs(spec, cuda, batch=2), spec.static_meta())


GOTOH_MOVES = ((0, 0, 1, 1), (0, 1, 1, 1), (0, 2, 1, 1), (1, 0, 1, 0),
               (1, 1, 1, 0), (2, 0, 0, 1), (2, 2, 0, 1))


def antidiag_spec(R, C, moves, planes, op, seed):
    """A random antidiag spec: normal weights with out-of-grid moves masked,
    the first row and column preset on every plane, ~5 % presets inside."""
    rng = np.random.default_rng(seed)
    zero = np.float32(np.inf if op == "min" else -np.inf)
    w = rng.normal(size=(len(moves), R, C)).astype(np.float32)
    for l, (_, _, di, dj) in enumerate(moves):
        w[l, :di], w[l, :, :dj] = zero, zero
    mask = rng.random((planes, R, C)) < 0.05
    mask[:, 0, :] = mask[:, :, 0] = True
    spec = dp.GridSpec(rows=R, cols=C, op=op, schedule="antidiag", planes=planes,
                       moves=moves, weights=w, init_mask=mask,
                       init=rng.normal(size=(planes, R, C)).astype(np.float32))
    spec.validate()
    return spec


@pytest.mark.parametrize("R,C", [(1, 300), (300, 1), (130, 67), (129, 200),
                                 (57, 57), (64, 65)])
@pytest.mark.parametrize("op", ["min", "max"])
def test_grid_antidiag_tiles_bit_equal_to_plain(cuda, R, C, op):
    """R and C that are not multiples of the tile (56 for gotoh's moves
    with args, 64 without), a single row or column, batched and not."""
    spec = antidiag_spec(R, C, GOTOH_MOVES, 3, op, R * 1000 + C)
    assert k6.tile_plan(3, GOTOH_MOVES, True).T == 56
    assert k6.tile_plan(3, GOTOH_MOVES, False).T == 64
    _grid_kernel_equals_plain(grid_arrs(spec, cuda), spec.static_meta())
    _grid_kernel_equals_plain(grid_arrs(spec, cuda, batch=4), spec.static_meta())


@pytest.mark.parametrize("moves", [
    ((0, 0, 1, 1), (0, 0, 70, 0), (0, 0, 0, 1)),        # past a whole tile down
    ((0, 0, 1, 0), (0, 0, 3, 66), (0, 0, 0, 130)),      # and right, twice over
    ((0, 1, 5, 5), (1, 0, 1, 0), (1, 1, 0, 2), (0, 0, 2, 1)),  # past the halo
    ((0, 0, 1, 1), (0, 0, 1, 0), (0, 0, 0, 1), (0, 0, 2, 1), (0, 0, 1, 2),
     (0, 0, 3, 3), (0, 0, 2, 2), (0, 0, 7, 1)),         # more than registers hold
])
def test_grid_antidiag_long_moves_read_finished_tiles(cuda, moves):
    """Moves whose source lies beyond the staged halo, or a whole tile
    away, read the finished table in device memory; a plane's moves past
    the four held in registers fold from shared memory, in order."""
    planes = 1 + max(max(m[0], m[1]) for m in moves)
    spec = antidiag_spec(150, 280, moves, planes, "max", len(moves))
    _grid_kernel_equals_plain(grid_arrs(spec, cuda, batch=2), spec.static_meta())


def test_grid_antidiag_grid_is_co_resident(cuda):
    """The antidiag grid is at most what the occupancy API keeps resident;
    a larger one is refused by the cooperative launch, never run."""
    spec = antidiag_spec(300, 300, GOTOH_MOVES, 3, "max", 1)
    lib = tkernels._build.load("grid_pipeline")
    fn = lib.grid_antidiag_blocks_per_sm
    fn.argtypes = [k6.ctypes.c_int] * 3 + [k6.ctypes.c_longlong]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for with_args in (False, True):
        plan = k6.tile_plan(3, GOTOH_MOVES, with_args)
        per_sm = fn(0, int(with_args), plan.threads, plan.smem)
        assert 1 <= k6.antidiag_ctas("max", with_args, plan, 10 ** 6, cuda) <= per_sm * sms
        assert k6.antidiag_ctas("max", with_args, plan, 7, cuda) == 7
    arrs = grid_arrs(spec, cuda)
    with pytest.raises(RuntimeError, match="co-resident"):
        k6._launch_antidiag(arrs, spec.static_meta(), True, grid=per_sm * sms + 1)


def cky_full_spec(seed: int = 0):
    """The grid path's chart (64 tokens, 32 nonterminals, 1024 rules) with
    plane 31 untargeted (-inf above the words, init -inf) and every rule
    into plane 30 reading it on the left: plane 30's candidates are all
    -inf, so its args keep its first rule (30)."""
    rng = np.random.default_rng(seed)
    n, P, NR = 64, 32, 1024
    rules = tuple((r % 31, 31 if r % 31 == 30 else int(rng.integers(0, P)),
                   int(rng.integers(0, P))) for r in range(NR))
    init = -rng.uniform(0.3, 2.5, (P, n)).astype(np.float32)
    init[31] = -np.inf
    spec = dp.GridSpec(rows=n, cols=n, op="max", schedule="spandiag", planes=P,
                       rules=rules, init=init,
                       rule_weights=-rng.uniform(0.3, 2.5, NR).astype(np.float32))
    spec.validate()
    return spec


def test_grid_spandiag_full_chart(cuda):
    """cky at the grid path's width, a batch of 3, with args: a plane no rule
    targets stays -inf with args -1; a plane whose candidates are all -inf
    keeps its first rule's arg."""
    spec = cky_full_spec()
    meta, n = spec.static_meta(), spec.rows
    cells = num_cells(n)
    arrs = grid_arrs(spec, cuda, batch=3)
    _grid_kernel_equals_plain(arrs, meta)
    st, ar = k6.grid_pipeline_with_args(arrs, meta)
    st, ar = st.reshape(3, 32, cells), ar.reshape(3, 32, cells)
    assert torch.isinf(st[:, 31]).all() and (ar[:, 31] == -1).all()
    assert torch.isinf(st[:, 30, n:]).all() and (ar[:, 30, n:] == 30).all()
    assert torch.isfinite(st[:, :30]).all()


def test_grid_spandiag_grid_is_co_resident(cuda):
    """The spandiag grid is at most what the occupancy API keeps resident;
    a larger one is refused by the cooperative launch, never run."""
    spec = cky_full_spec(1)
    meta = spec.static_meta()
    lib = tkernels._build.load("grid_pipeline")
    assert lib.grid_spandiag_threads() == k6.SD_THREADS
    lib.grid_spandiag_smem_bytes.restype = k6.ctypes.c_longlong
    assert lib.grid_spandiag_smem_bytes(32, 1024) == k6.spandiag_smem_bytes(32, 1024)
    fn = lib.grid_spandiag_blocks_per_sm
    fn.argtypes = [k6.ctypes.c_int] * 2 + [k6.ctypes.c_longlong]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    smem = k6.spandiag_smem_bytes(32, 1024)
    for with_args in (False, True):
        per_sm = fn(0, int(with_args), smem)
        assert 1 <= k6.spandiag_ctas("max", with_args, 32, 1024, cuda) <= per_sm * sms
    arrs = grid_arrs(spec, cuda)
    with pytest.raises(RuntimeError, match="co-resident"):
        k6._launch_spandiag(arrs, meta, True, grid=per_sm * sms + 1)
    _grid_kernel_equals_plain(arrs, meta)               # the card still runs


@pytest.mark.parametrize("grid", [1, 7, 132])
def test_grid_spandiag_any_grid(cuda, grid):
    """Any resident grid gives the same chart: one CTA folds every triple;
    7 deal them unevenly; 132 give late diagonals several warps a triple."""
    spec = cky_full_spec(2)
    meta = spec.static_meta()
    arrs = grid_arrs(spec, cuda, batch=2)
    wt, wa = k6.grid_pipeline_plain(arrs, meta, with_args=True)
    gt, ga = k6._launch_spandiag(arrs, meta, True, grid=grid)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)
    assert torch.equal(k6._launch_spandiag(arrs, meta, False, grid=grid), wt)


def test_grid_spandiag_rules_beyond_48k_shared_memory(cuda):
    """4000 rules take 64 KB of dynamic shared memory (opt-in above 48 KB)."""
    rng = np.random.default_rng(3)
    P, n, NR = 8, 6, 4000
    rules = tuple(tuple(int(v) for v in r) for r in rng.integers(0, P, (NR, 3)))
    spec = dp.GridSpec(rows=n, cols=n, op="max", schedule="spandiag", planes=P,
                       rules=rules,
                       rule_weights=-rng.uniform(0.3, 2.5, NR).astype(np.float32),
                       init=-rng.uniform(0.3, 2.5, (P, n)).astype(np.float32))
    _grid_kernel_equals_plain(grid_arrs(spec, cuda), spec.static_meta())


def test_kernels_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        k1.sdp_pipeline(torch.zeros(3, dtype=torch.float64, device=cuda),
                        (3, 1), "min", 10)
    with pytest.raises(ValueError):
        k2.mcm_pipeline(torch.zeros((6, 3), device=cuda), 4)  # wrong rows
    spec = dp.get_problem("needleman_wunsch").encode(x=[1, 2], y=[2, 1, 3])
    w, init, mask = grid_arrs(spec, cuda)
    with pytest.raises(ValueError):                          # wrong moves
        k6.grid_pipeline((w[:2], init, mask), spec.static_meta())
    with pytest.raises(ValueError):                          # not contiguous
        k6.grid_pipeline((w.transpose(1, 2), init, mask), spec.static_meta())


@pytest.mark.parametrize("name", ["sdp", "edit_distance", "lcs", "viterbi",
                                  "unbounded_knapsack", "mcm", "optimal_bst",
                                  "polygon_triangulation", "needleman_wunsch",
                                  "gotoh", "cky", "edit_distance_grid",
                                  "lcs_grid"])
def test_main_path_on_the_card_matches_cpu(cuda, name):
    prob = dp.get_problem(name)
    rng = np.random.default_rng(7)
    inst = prob.sample(rng, 24)
    before = dict(k1.LAUNCHES, **k2.LAUNCHES, **k3.LAUNCHES, **k4.LAUNCHES,
                  **k6.LAUNCHES)
    got = dp.solve(name, reconstruct=True, device=cuda, **inst)
    want = dp.solve(name, backend=dp.dispatch(name, reconstruct=True,
                                              device=cuda, **inst).name,
                    reconstruct=True, device="cpu", **inst)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.args, want.args)
    assert got.solution == want.solution
    after = dict(k1.LAUNCHES, **k2.LAUNCHES, **k3.LAUNCHES, **k4.LAUNCHES,
                 **k6.LAUNCHES)
    assert sum(after.values()) > sum(before.values())


@pytest.mark.parametrize("name", ["sdp", "edit_distance", "lcs", "viterbi",
                                  "unbounded_knapsack", "mcm", "optimal_bst",
                                  "polygon_triangulation"])
def test_streaming_routes_on_the_card_match_cpu(cuda, name):
    """``kernel_tiled`` / ``kernel_tiled_wavefront`` (fused) on the card
    against the same route's plain version on the CPU, one solve and a
    batch of two."""
    prob = dp.get_problem(name)
    route = "kernel_tiled" if prob.geometry == "linear" else "kernel_tiled_wavefront"
    rng = np.random.default_rng(11)
    inst = prob.sample(rng, 24)
    key = prob.encode(**inst).shape_key()
    insts = [inst]
    while len(insts) < 2:
        cand = prob.sample(rng, 24)
        if prob.encode(**cand).shape_key() == key:
            insts.append(cand)
    before = sum(dict(k3.LAUNCHES, **k4.LAUNCHES).values())
    got = dp.batch_solve(name, insts, backend=route, reconstruct=True, device=cuda)
    got.append(dp.solve(name, backend=route, reconstruct=True, device=cuda, **inst))
    want = dp.batch_solve(name, insts, backend=route, reconstruct=True, device="cpu")
    want.append(want[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.table, w.table)
        np.testing.assert_array_equal(g.args, w.args)
        assert g.solution == w.solution
    assert sum(dict(k3.LAUNCHES, **k4.LAUNCHES).values()) - before == 2


@pytest.mark.parametrize("m,k,n,batch", [(1, 1, 1, None), (7, 13, 5, None),
                                         (16, 16, 16, 3), (33, 100, 17, 2),
                                         (128, 128, 128, None), (16, 992, 16, 62),
                                         (16, 496, 16, 32), (8, 40, 8, 5), (65, 300, 130, 1),
                                         (16, 0, 16, 2), (200, 17, 3, None)])
@pytest.mark.parametrize("weighted", [False, True])
def test_tropical_matmul_kernel_bit_equal_to_plain(cuda, m, k, n, batch, weighted):
    """K5 against its plain version: ragged shapes (no tile divides them),
    a batch axis, and a shape past the blocked route's extremes at MCM 1024
    (T = 16: 62 blocks, as at D = 2, each with K = 992, as at D = 63)."""
    g = torch.Generator(device=cuda).manual_seed(m * k * n)
    lead = () if batch is None else (batch,)
    a = torch.randn(lead + (m, k), generator=g, device=cuda)
    b = torch.randn(lead + (k, n), generator=g, device=cuda)
    w = [None] * 3
    if weighted:
        w = [torch.rand(lead + (x,), generator=g, device=cuda) * 2 + 1
             for x in (m, k, n)]
    before = k5.LAUNCHES["tropical_matmul"]
    got = k5.tropical_matmul(a, b, *w)
    assert k5.LAUNCHES["tropical_matmul"] == before + 1
    assert torch.equal(got, k5.tropical_matmul_plain(a, b, *w))


def test_tropical_matmul_kernel_infinities_and_nan(cuda):
    a = torch.tensor([[float("inf"), 1.0], [float("nan"), 2.0]], device=cuda)
    b = torch.tensor([[0.0, float("inf")], [3.0, -1.0]], device=cuda)
    got = k5.tropical_matmul(a, b)
    want = k5.tropical_matmul_plain(a, b)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    with pytest.raises(ValueError):
        k5.tropical_matmul(a.double(), b.double())


def _k5_operands(cuda, lead, m, k, n, weighted, seed, special=False):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randint(-3, 4, lead + (m, k), generator=g, device=cuda).float()
    b = torch.randint(-3, 4, lead + (k, n), generator=g, device=cuda).float()
    if special:                     # a row of +inf, NaNs and -inf entries
        a[..., 0, :] = float("inf")
        a[..., -1, k // 2] = float("nan")
        b[..., k // 3, 0] = float("-inf")
    w = [None] * 3
    if weighted:
        w = [torch.randint(1, 4, lead + (x,), generator=g, device=cuda).float()
             for x in (m, k, n)]
    return a, b, w


def _k5_equal(got, want):
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(),
                                                                  want.nan_to_num())


K5_FORCED = [(k5.SPLIT, c, g, st) for c in (1, 2, 4, 8, 16) for g in (1, 2, 4)
             for st in (1, 3, 8)] + [(k5.REGISTER, c, 1, st) for c in (1, 2, 4, 8)
                                     for st in (1, 2, 4)]


@pytest.mark.parametrize("regime,cluster,groups,stages", K5_FORCED)
@pytest.mark.parametrize("weighted", [False, True])
def test_tropical_matmul_every_plan_bit_equal_to_plain(cuda, regime, cluster, groups,
                                                       stages, weighted):
    """K5 at every regime, cluster size (16 non-portable), group count and
    ring depth (a ring shorter than the slice refills stages), forced
    through ``_launch(plan=)``, on tie-heavy integers with rows of +inf
    and NaN: one launch, bit-equal to the plain version (NaN where it has
    NaN)."""
    m, n = (16, 16) if regime == k5.SPLIT else (70, 130)
    k = 600
    a, b, w = _k5_operands(cuda, (3,), m, k, n, weighted, cluster * 7 + groups, True)
    tile, r = (16, 1) if regime == k5.SPLIT else (64, 4)
    p = k5.Plan(regime, tile, r, cluster, groups, -(-k // cluster), stages)
    before = k5.LAUNCHES["tropical_matmul"]
    got = k5._launch(a, b, *w, plan=p)
    assert k5.LAUNCHES["tropical_matmul"] == before + 1
    assert _k5_equal(got, k5.tropical_matmul_plain(a, b, *w))


def test_tropical_matmul_plan_rules_match_the_card(cuda):
    """The Python plan's shared memory equals the kernel's, every plan the
    rule can give is one the launcher takes, and the card's cluster limit
    is 16 or 8."""
    lib = _build.load("semiring_matmul")
    fn = lib.tropical_matmul_smem_bytes
    fn.restype = ctypes.c_longlong
    for regime, cluster, groups, stages in K5_FORCED:
        r = 1 if regime == k5.SPLIT else 4
        want = k5.smem_bytes(regime, cluster, groups, stages)
        got = fn(r, cluster, groups, stages)
        assert got == (want if want <= _build.SMEM_OPTIN_BYTES else -1)
    sms, max_cluster = k5.card_limits(cuda)
    assert sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    assert max_cluster in (8, 16)


@pytest.mark.parametrize("n,batch", [(1024, 1), (256, 8)])
def test_tropical_matmul_route_operands_every_block_diagonal(cuda, n, batch):
    """K5 on the blocked route's own strided views of a table (two batch
    axes, no copies) at every block diagonal of MCM n: bit-equal to the
    plain version on flat copies, one launch each."""
    T, nt = 16, n // 16
    g = torch.Generator(device=cuda).manual_seed(n)
    m = torch.randint(0, 10 ** 6, (batch, n, n), generator=g, device=cuda).float()
    p = torch.randint(1, 61, (batch, n + 1), generator=g, device=cuda).float()
    for D in range(2, nt):
        nb, K = nt - D, (D - 1) * T
        a = m.as_strided((batch, nb, T, K), (n * n, T * (n + 1), n, 1), T)
        b = m.as_strided((batch, nb, K, T), (n * n, T * (n + 1), n, 1), (T + 1) * n + D * T)
        av = p[:, :nb * T].reshape(batch, nb, T)
        gv = p[:, T + 1:].unfold(1, K, T)[:, :nb]
        bv = p[:, D * T + 1:D * T + 1 + nb * T].reshape(batch, nb, T)
        before = k5.LAUNCHES["tropical_matmul"]
        got = k5.tropical_matmul(a, b, av, gv, bv)
        assert k5.LAUNCHES["tropical_matmul"] == before + 1
        flat = [x.reshape(batch * nb, *x.shape[2:]).contiguous() for x in (a, b, av, gv, bv)]
        want = k5.tropical_matmul_plain(*flat).view(batch, nb, T, T)
        assert torch.equal(got, want), f"D={D}"


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("m,k,n", [(16, 300, 16), (100, 200, 70)])
def test_tropical_matmul_views_at_any_alignment(cuda, offset, m, k, n):
    """Operands as views into wider buffers, starting ``offset`` floats in:
    16-byte copies where the rows start on 16 bytes (offset 0), 4-byte
    copies elsewhere; bit-equal to the plain version either way."""
    a, b, w = _k5_operands(cuda, (2,), m, k + 8, n + 8, True, offset + m)
    a, b = a[..., offset:offset + k], b[..., offset:offset + k, offset:offset + n]
    w = [w[0], w[1][..., :k], w[2][..., :n]]
    got = k5.tropical_matmul(a, b, *w)
    assert torch.equal(got, k5.tropical_matmul_plain(a.contiguous(), b.contiguous(),
                                                     *[x.contiguous() for x in w]))


@pytest.mark.parametrize("batch,cluster", [(600, None), (40, 16), (300, 4)])
def test_tropical_matmul_batch_beyond_one_wave(cuda, batch, cluster):
    """More CTAs (or clusters) than the card keeps resident: the launch
    runs in waves and stays bit-equal."""
    a, b, w = _k5_operands(cuda, (batch,), 16, 496, 16, True, batch)
    p = None if cluster is None else k5.Plan(k5.SPLIT, 16, 1, cluster, 4, -(-496 // cluster), 2)
    got = k5._launch(a, b, *w, plan=p)
    assert torch.equal(got, k5.tropical_matmul_plain(a, b, *w))


@pytest.mark.parametrize("n,batch", [(32, 1), (64, 2), (96, 3), (256, 1)])
def test_blocked_mcm_on_the_card(cuda, n, batch):
    """``blocked_mcm`` on the card: bit-equal to its CPU version for
    integer and non-integer dims, and with integer dims (every candidate an
    exact float32 sum) to ``kernel_tiled_wavefront``'s tables; K5 launches
    once per block diagonal past the first."""
    rng = np.random.default_rng(n)
    for integer in (True, False):
        dims = [rng.integers(1, 61, n + 1).astype(np.float64) if integer
                else rng.uniform(0.5, 5.0, n + 1) for _ in range(batch)]
        specs = [dp.get_problem("mcm").encode(dims=d) for d in dims]
        before = k5.LAUNCHES["tropical_matmul"]
        got = dp.batch_solve_specs(specs, backend="blocked_mcm", device=cuda)
        assert k5.LAUNCHES["tropical_matmul"] - before == n // 16 - 2
        want = dp.batch_solve_specs(specs, backend="blocked_mcm", device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if integer:
            k4_tables = dp.batch_solve_specs(specs, backend="kernel_tiled_wavefront",
                                             device=cuda)
            for g, w in zip(got, k4_tables):
                np.testing.assert_array_equal(g, w)


#: K7 against its plain version on the card: float32 sums in another order
#: and exp2 against exp; bfloat16 outputs round to 8 bits
K7_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("d", [16, 96, 128, 160])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("s", [1, 65, 127, 128, 129, 333, 1746])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, d, hq, hkv, s, dtype):
    """K7 at the head dims of the dense configs (16 reduced, 96 phi3, 128
    qwen3/granite, 160 stablelm), MHA, GQA and MQA, ragged S (no whole
    64-row tile; one row short of, at and past the tensor-core body's
    128-row tile; a served prompt's 1746), q, k, v as the heads-major views
    the model passes. bfloat16 runs the tensor-core body, float32 the
    CUDA-core one (their counters say which ran)."""
    g = torch.Generator(device=cuda).manual_seed(d * s + hq)
    q, k, v = (torch.randn((2, s, h, d), generator=g, device=cuda).to(dtype).transpose(1, 2)
               for h in (hq, hkv, hkv))
    tc = dtype == torch.bfloat16
    assert k7.body_for(q, k, v) == (k7.TENSOR_CORES if tc else k7.CUDA_CORES)
    before = dict(k7.LAUNCHES)
    got = k7.flash_attention(q, k, v)
    assert k7.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert k7.LAUNCHES["flash_attention_tc"] == before["flash_attention_tc"] + tc
    want = k7.flash_attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=K7_TOL[dtype],
                               atol=K7_TOL[dtype])


@pytest.mark.parametrize("sq,sk,causal", [(64, 64, False), (37, 200, True),
                                          (1, 130, True), (70, 70, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_end_aligned_and_non_causal(cuda, sq, sk, causal, dtype):
    """Fewer queries than keys (the mask aligned at the end) and no mask,
    in both bodies."""
    g = torch.Generator(device=cuda).manual_seed(sq * sk)
    q = torch.randn((1, 4, sq, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, 2, sk, 64), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = k7.LAUNCHES["flash_attention_tc"]
    got = k7.flash_attention(q, k, v, causal=causal)
    assert k7.LAUNCHES["flash_attention_tc"] == before + (dtype == torch.bfloat16)
    torch.testing.assert_close(got.float(),
                               k7.flash_attention_plain(q, k, v, causal=causal).float(),
                               rtol=K7_TOL[dtype], atol=K7_TOL[dtype])


@pytest.mark.parametrize("s", [65, 333])
def test_flash_attention_kernel_unaligned_bf16_takes_cuda_cores(cuda, s):
    """bfloat16 rows 68 elements apart (136 bytes, not a multiple of 16):
    TMA cannot address them, so by the rule the CUDA-core body runs."""
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((1, h, s, 68), generator=g, device=cuda)
               .to(torch.bfloat16)[..., :64] for h in (8, 2, 2))
    assert k7.body_for(q, k, v) == k7.CUDA_CORES
    before = dict(k7.LAUNCHES)
    got = k7.flash_attention(q, k, v)
    assert k7.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert k7.LAUNCHES["flash_attention_tc"] == before["flash_attention_tc"]
    torch.testing.assert_close(got.float(), k7.flash_attention_plain(q, k, v).float(),
                               rtol=K7_TOL[torch.bfloat16], atol=K7_TOL[torch.bfloat16])


def test_flash_attention_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    k = torch.zeros((1, 3, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="Hq=4"):
        k7.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k7.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 1, 8, 272), device=cuda)
        k7.flash_attention(big, big, big)


@pytest.mark.parametrize("t,d", [(1, 1), (100, 33), (4097, 2048)] + [
    (t, d) for t in (1, 100, 4097, 32769) for d in (1, 33, 2048, 2050)
    if (t, d) not in ((1, 1), (100, 33), (4097, 2048))])
def test_linear_scan_kernel_bit_equal_to_plain(cuda, t, d):
    g = torch.Generator(device=cuda).manual_seed(t + d)
    x = torch.randn((t, d), generator=g, device=cuda)
    decay = torch.rand((t, d), generator=g, device=cuda) * 0.2 + 0.8
    h0 = torch.randn((d,), generator=g, device=cuda)
    before = k8.LAUNCHES["linear_scan"]
    got_all, got_last = k8.chunked_scan(x, decay, h0)
    assert k8.LAUNCHES["linear_scan"] == before + 1
    want_all, want_last = k8.chunked_scan_plain(x, decay, h0)
    assert torch.equal(got_all, want_all) and torch.equal(got_last, want_last)


def _scan_operands(cuda, t, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((t, d), generator=g, device=cuda)
    decay = torch.rand((t, d), generator=g, device=cuda) * 0.2 + 0.8
    h0 = torch.randn((d,), generator=g, device=cuda)
    return x, decay, h0


@pytest.mark.parametrize("features", [8, 16, 32])
@pytest.mark.parametrize("stages", [1, 2, 6, 12])
@pytest.mark.parametrize("mode", ["tma", "cp.async"])
def test_linear_scan_kernel_every_plan(cuda, features, stages, mode):
    """K8 at every CTA width, ring depth and staging mode, forced through
    ``_launch(plan=)`` (T ragged against the 64-row stages, D past a
    whole CTA): bit-equal to the plain version."""
    x, decay, h0 = _scan_operands(cuda, 1000, 2056, features * stages)
    p = k8.Plan(features, k8.STAGE_ROWS, stages, mode)
    got_all, got_last = k8._launch(x, decay, h0, plan=p)
    want_all, want_last = k8.chunked_scan_plain(x, decay, h0)
    assert torch.equal(got_all, want_all) and torch.equal(got_last, want_last)


@pytest.mark.parametrize("t,d", [(300, 64), (4097, 2048)])
def test_linear_scan_kernel_unaligned_view(cuda, t, d):
    """x and decay as contiguous views starting 4 bytes past a 16-byte
    boundary: TMA cannot address them, so the plan stages by cp.async, and
    the result stays bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(t)
    x = torch.empty(t * d + 1, device=cuda)[1:].view(t, d)
    decay = torch.empty(t * d + 1, device=cuda)[1:].view(t, d)
    x.copy_(torch.randn((t, d), generator=g, device=cuda))
    decay.copy_(torch.rand((t, d), generator=g, device=cuda) * 0.2 + 0.8)
    h0 = torch.randn((d,), generator=g, device=cuda)
    assert x.is_contiguous() and x.data_ptr() % 16 and decay.data_ptr() % 16
    assert k8._auto_plan(x, decay, torch.empty_like(x)).mode == k8.CP_ASYNC
    before = k8.LAUNCHES["linear_scan"]
    got_all, got_last = k8.chunked_scan(x, decay, h0)
    assert k8.LAUNCHES["linear_scan"] == before + 1
    want_all, want_last = k8.chunked_scan_plain(x, decay, h0)
    assert torch.equal(got_all, want_all) and torch.equal(got_last, want_last)


def test_linear_scan_plan_rules_match_the_card(cuda):
    """The Python plan's shared memory equals the kernel's at every CTA
    width, ring depth and mode; a plan past the opt-in is refused."""
    fn = _build.load("chunked_scan").chunked_scan_smem_bytes
    fn.restype = ctypes.c_longlong
    for features in (8, 16, 32):
        for stages in range(1, 17):
            for mode in (k8.TMA, k8.CP_ASYNC):
                want = k8.smem_bytes(k8.Plan(features, k8.STAGE_ROWS, stages, mode))
                got = fn(features, stages, int(mode == k8.TMA))
                assert got == (want if want <= _build.SMEM_OPTIN_BYTES else -1)
    assert _build.load("chunked_scan").chunked_scan_rows() == k8.STAGE_ROWS


def test_linear_scan_kernel_rejects_bad_plans(cuda):
    x, decay, h0 = _scan_operands(cuda, 10, 6, 0)
    with pytest.raises(RuntimeError):               # rows not 16-byte aligned
        k8._launch(x, decay, h0, plan=k8.Plan(16, k8.STAGE_ROWS, 2, k8.TMA))
    with pytest.raises(RuntimeError):               # no such CTA width
        k8._launch(x, decay, h0, plan=k8.Plan(12, k8.STAGE_ROWS, 2, k8.CP_ASYNC))


def test_reduced_engine_on_the_card_matches_cpu(cuda):
    """The reduced qwen3-14b served on the card (prefill through K7) gives
    the CPU engine's tokens, from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import CausalLM
    from repro_torch.serving import Engine, Request, Scheduler

    cfg = get_config("qwen3-14b").reduced()
    cpu_model = CausalLM.from_seed(cfg, seed=0, device="cpu")
    card_model = CausalLM(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 70, 9, 130, 3)]
    outs = []
    for model in (cpu_model, card_model):
        before = k7.LAUNCHES["flash_attention"]
        sched = Scheduler(Engine(model, max_batch=3, max_len=160))
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        outs.append({r.rid: r.out for r in sched.run()})
    assert outs[1] == outs[0] and len(outs[0]) == len(prompts)
    # the card's prefills, one launch per layer and prompt; decode has none
    assert k7.LAUNCHES["flash_attention"] - before == cfg.n_layers * len(prompts)


def _k6_refused_specs() -> list:
    """Grid specs K6's launchers refuse: a move table past shared memory
    (8 planes, 9700 moves: no tile plan) and a rule table past it."""
    moves = tuple((p % 8, (p * 3) % 8, 1, p % 2) for p in range(9700))
    mask = np.zeros((8, 6, 5), bool)
    mask[:, 0, :] = mask[:, :, 0] = True
    rng = np.random.default_rng(3)
    anti = dp.GridSpec(rows=6, cols=5, op="max", schedule="antidiag", planes=8,
                       moves=moves, init_mask=mask,
                       weights=rng.normal(size=(9700, 6, 5)).astype(np.float32),
                       init=rng.normal(size=(8, 6, 5)).astype(np.float32))
    rules = tuple((r % 4, (r * 3) % 4, (r * 5 + 1) % 4) for r in range(15000))
    chart = dp.GridSpec(rows=4, cols=4, op="max", schedule="spandiag", planes=4,
                        rules=rules,
                        rule_weights=rng.normal(size=15000).astype(np.float32),
                        init=rng.normal(size=(4, 4)).astype(np.float32))
    return [anti, chart]


def test_specs_k6_refuses_solve_on_the_plain_route_on_the_card(cuda):
    """Such a spec dispatches to ``grid_wavefront`` on the card and solves
    there (no raise), to the CPU port's table."""
    for spec in _k6_refused_specs():
        spec.validate()
        assert dp.dispatch(spec, device=cuda).name == "grid_wavefront"
        assert dp.dispatch(spec, reconstruct=True, device=cuda).name == "grid_wavefront"
        before = dict(k6.LAUNCHES)
        got = dp.solve_spec(spec, device=cuda)
        assert k6.LAUNCHES == before
        np.testing.assert_array_equal(got, dp.solve_spec(spec, device="cpu"))


def test_engine_and_service_on_the_card_answer_the_cpu_answers(cuda):
    """A small mixed batch through ``DPEngine`` and ``DPService`` on the
    card: every drain of a kernel route is one kernel launch, and every
    answer and decoded solution equals the CPU port's."""
    rng = np.random.default_rng(21)
    traffic = []
    for name, size in (("mcm", 12), ("edit_distance", 24), ("viterbi", 20),
                       ("needleman_wunsch", 20), ("cky", 8),
                       ("unbounded_knapsack", 40)):
        prob = dp.get_problem(name)
        traffic += [(name, prob.sample(rng, size), i == 0) for i in range(3)]
    traffic.append(traffic[1])                      # a repeat: dedup / cache
    launches = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES, k4.LAUNCHES, k6.LAUNCHES)

    def total():
        return sum(sum(d.values()) for d in launches)

    def engine_run(device):
        eng = dp.DPEngine(max_batch=8, feedback=False, device=device)
        rids = [eng.submit(n, reconstruct=r, **kw) for n, kw, r in traffic]
        out, kernel_drains, before = {}, 0, total()
        while eng.pending():
            resps = eng.step()
            kernel_drains += dp.backends.get(resps[0].backend).kernel
            out.update((r.rid, r) for r in resps)
        return [out[r] for r in rids], kernel_drains, total() - before

    cpu, _, cpu_launches = engine_run("cpu")
    card, kernel_drains, card_launches = engine_run(cuda)
    assert cpu_launches == 0 and kernel_drains > 0
    assert card_launches == kernel_drains
    # bit-equality holds per route: each card answer against the CPU port
    # on the route that served it
    for (name, kw, recon), c, g in zip(traffic, cpu, card):
        want = dp.solve(name, backend=g.backend, reconstruct=recon, device="cpu", **kw)
        assert np.float32(g.answer) == np.float32(want.value if recon else want), name
        np.testing.assert_allclose(g.answer, c.answer, rtol=1e-5)
        if recon:
            assert g.solution.solution == want.solution, name

    for device in ("cpu", cuda):
        svc = dp.DPService(max_batch=8, device=device)
        tids = [svc.submit(n, reconstruct=r, **kw) for n, kw, r in traffic]
        out = svc.run()
        assert svc.engine.stats["dedup_hits"] + svc.stats["cache_hits"] >= 1
        for (name, kw, recon), tid in zip(traffic, tids):
            res = out[tid]
            want = dp.solve(name, backend=res.backend, reconstruct=recon,
                            device="cpu", **kw)
            assert res.status == "done"
            assert np.float32(res.answer) == np.float32(want.value if recon else want)


@pytest.mark.parametrize("name,size,route", [
    ("edit_distance", 40, "kernel_blocked"), ("viterbi", 30, "kernel_tiled"),
    ("mcm", 40, "kernel_wavefront"), ("optimal_bst", 30, "kernel_wavefront"),
    ("gotoh", 40, "kernel_grid"), ("cky", 12, "kernel_grid")])
def test_bucket_walk_on_the_card_equals_the_host_walks(cuda, name, size, route):
    """A kernel route leaves a bucket's args on the card, the batched walk
    runs there, and its paths equal each instance's host walk — also on
    later walks of the same shape with other content (the tree walks
    capture their steps on the second and replay them on the third)."""
    from repro_torch.dp import reconstruct

    prob = dp.get_problem(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kw0 = prob.sample(rng, size)
    kws = [kw0]
    while len(kws) < 4:                 # same shape, other content
        kw = prob.sample(rng, size)
        if prob.encode(**kw).shape_key() == prob.encode(**kw0).shape_key():
            kws.append(kw)
    specs = [prob.encode(**kw) for kw in kws]
    tables, args = dp.backends.get(route).batch_run_with_args(specs, cuda)
    assert args.device.type == "cuda"
    starts = ([reconstruct.start_cell(prob, t, s) for t, s in zip(tables, specs)]
              if specs[0].uses_start else None)
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2]):
        paths = reconstruct.traceback_batch(
            args[order], specs[0], [starts[b] for b in order] if starts else None)
        for b, row in enumerate(order):
            host = specs[row].traceback_host(args[row].cpu().numpy(),
                                             starts[row] if starts else -1)
            for f in ("cells", "lanes", "nodes", "stop"):
                if hasattr(host, f):
                    np.testing.assert_array_equal(getattr(paths[b], f),
                                                  getattr(host, f))


def test_schedule_gate_on_the_card(cuda):
    """The static schedule gate at the card's own geometry is clean; a
    solve on every kernel route records launch geometries equal to the
    descriptors' (both K6 schedules, K4's fused twin); a launch forced off
    the launcher's geometry is flagged."""
    from repro_torch.analysis import run_all, verify_launches
    from repro_torch.kernels import schedule as kschedule

    findings, stats = run_all(cuda)
    assert findings == [], [f"{f.check}:{f.subject}:{f.message}" for f in findings]
    assert stats["routes"] == 14 and stats["schedules_verified"] >= 14

    kschedule.forget_launches()
    rng = np.random.default_rng(0)
    for name, size, route in [
            ("edit_distance", 200, "kernel_blocked"), ("viterbi", 30, "kernel_tiled"),
            ("mcm", 40, "kernel_wavefront"), ("mcm", 40, "kernel_tiled_wavefront"),
            ("gotoh", 100, "kernel_grid"), ("cky", 12, "kernel_grid")]:
        kw = dp.get_problem(name).sample(rng, size)
        for recon in (False, True):
            dp.solve(name, backend=route, reconstruct=recon, device=cuda, **kw)
    recorded = {name for name, _, _ in kschedule.recorded_launches()}
    assert {"sdp_pipeline", "sdp_chunked_with_args", "mcm_pipeline_with_args",
            "mcm_tiled", "grid_pipeline_antidiag_with_args",
            "grid_pipeline_spandiag_with_args"} <= recorded, recorded
    findings, stats = verify_launches(cuda)
    assert findings == [], [f"{f.check}:{f.subject}:{f.message}" for f in findings]
    assert stats["launch_shapes_checked"] == len(kschedule.recorded_launches())

    w = torch.zeros((1, num_cells(40), 39), dtype=torch.float32, device=cuda)
    k4._launch(w, 40, False, False, grid=1)
    findings, _ = verify_launches(cuda)
    assert [f.check for f in findings] == ["geometry_mismatch"]
    kschedule.forget_launches()


# ---------------------------------------------------------------------------
# the MoE and SSM blocks on the card
# ---------------------------------------------------------------------------
def _moe_case(cuda, dtype, n_tokens=300, seed=0):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_defs

    cfg = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, param_dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(seed)
    p = {k: (torch.randn(d.shape, generator=g, device=cuda) * d.scale).to(dtype)
         for k, d in moe_defs(cfg).items()}
    x = torch.randn((1, n_tokens, cfg.d_model), generator=g, device=cuda).to(dtype)
    return cfg, p, x


def test_moe_combine_bit_equal_across_runs(cuda):
    """granite-moe's MoE block at full width in bf16: two calls on the same
    inputs give the same bits (the combine sums a token's top-8 in order,
    no atomics)."""
    from repro_torch.models.moe import moe_forward

    cfg, p, x = _moe_case(cuda, torch.bfloat16)
    a, aux_a = moe_forward(p, cfg, x)
    b, aux_b = moe_forward(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()


def test_stable_top_k_on_tied_logits_on_the_card(cuda):
    """Tied probabilities on the card: the lower expert first, as on the
    CPU (``jax.lax.top_k``'s order), including a whole row of ties."""
    from repro_torch.models.moe import top_k

    rows = torch.tensor([[0.1, .3, .3, .3, 0, .3], [0.5] * 6, [0.2, 0.1] * 3])
    rng = np.random.default_rng(0)
    ties = torch.from_numpy(rng.integers(0, 4, size=(4096, 40)).astype(np.float32) / 4)
    for probs, k in ((rows, 3), (ties, 8)):
        want_v, want_i = top_k(probs, k)
        got_v, got_i = top_k(probs.to(cuda), k)
        assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_v.cpu(), want_v)
    assert top_k(rows.to(cuda), 3)[1][0].tolist() == [1, 2, 3]


@pytest.mark.parametrize("mode", ["bonus", "inclusive"])
def test_chunked_gla_matches_gla_reference_on_the_card(cuda, mode):
    """rwkv6-1.6b's head count and widths (32 heads of 64 by 64), vector
    decay, chunk 32 and a ragged tail: within 1e-4 of max|y| in float32."""
    from repro_torch.models.ssm import chunked_gla, gla_reference

    g = torch.Generator(device=cuda).manual_seed(1)
    b, t, h, k, v = 2, 333, 32, 64, 64
    q, kk = (torch.randn((b, t, h, k), generator=g, device=cuda) * 0.125 for _ in range(2))
    vv = torch.randn((b, t, h, v), generator=g, device=cuda)
    ld = -torch.exp(torch.randn((b, t, h, k), generator=g, device=cuda) - 3)
    h0 = torch.randn((b, h, k, v), generator=g, device=cuda) * 0.3
    u = torch.randn((h, k), generator=g, device=cuda) * 0.5
    y, h_last = chunked_gla(q, kk, vv, ld, h0, chunk=32, mode=mode, u=u)
    want_y, want_h = gla_reference(q, kk, vv, ld, h0, mode=mode, u=u)
    assert float((y - want_y).abs().max()) <= 1e-4 * float(want_y.abs().max())
    assert float((h_last - want_h).abs().max()) <= 1e-4 * float(want_h.abs().max())


def test_reduced_jamba_engine_on_the_card_matches_cpu(cuda):
    """The reduced jamba (one period: attention, Mamba, MoE every other
    layer) served on the card gives the CPU engine's tokens, from the same
    weights; its attention layer's prefills go through K7."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import CausalLM
    from repro_torch.serving import Engine, Request, Scheduler

    cfg = get_config("jamba-1.5-large-398b").reduced()
    cpu_model = CausalLM.from_seed(cfg, seed=0, device="cpu")
    card_model = CausalLM(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 70, 9, 130, 3)]
    outs = []
    for model in (cpu_model, card_model):
        before = k7.LAUNCHES["flash_attention"]
        sched = Scheduler(Engine(model, max_batch=3, max_len=160))
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        outs.append({r.rid: r.out for r in sched.run()})
    assert outs[1] == outs[0] and len(outs[0]) == len(prompts)
    n_attn = sum(cfg.mixer_of(i) == "attn" for i in range(cfg.n_layers))
    assert k7.LAUNCHES["flash_attention"] - before == n_attn * len(prompts)
