"""Tests that need the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the main path on the card against the
CPU path. Marked ``gpu``; the ``cuda`` fixture skips them where no CUDA
device is present. This file imports no JAX.

Run on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import dp  # noqa: E402
from repro_torch.core.mcm import num_cells  # noqa: E402
from repro_torch.kernels import mcm_pipeline as k2  # noqa: E402
from repro_torch.kernels import sdp_pipeline as k1  # noqa: E402

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("n,batch", [(1, 2), (2, 2), (3, 2), (33, 3),
                                     (100, 2), (1100, 1)])
def test_mcm_kernel_bit_equal_to_plain(cuda, n, batch):
    """Small integer weights make ties, exercising the first-best rule;
    n = 1100 has more lanes than a CTA has threads."""
    g = torch.Generator(device=cuda).manual_seed(n)
    w = torch.randint(0, 50, (batch, num_cells(n), max(n - 1, 1)), generator=g,
                      dtype=torch.float32, device=cuda)
    gt, ga = k2.mcm_pipeline_with_args(w, n)
    wt, wa = k2.mcm_pipeline_plain(w, n, with_args=True)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)
    assert torch.equal(k2.mcm_pipeline(w, n), wt)


def test_kernels_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        k1.sdp_pipeline(torch.zeros(3, dtype=torch.float64, device=cuda),
                        (3, 1), "min", 10)
    with pytest.raises(ValueError):
        k2.mcm_pipeline(torch.zeros((6, 3), device=cuda), 4)  # wrong rows


@pytest.mark.parametrize("name", ["sdp", "edit_distance", "lcs", "viterbi",
                                  "unbounded_knapsack", "mcm", "optimal_bst",
                                  "polygon_triangulation"])
def test_main_path_on_the_card_matches_cpu(cuda, name):
    prob = dp.get_problem(name)
    rng = np.random.default_rng(7)
    inst = prob.sample(rng, 24)
    before = dict(k1.LAUNCHES, **k2.LAUNCHES)
    got = dp.solve(name, reconstruct=True, device=cuda, **inst)
    want = dp.solve(name, backend=dp.dispatch(name, reconstruct=True,
                                              device=cuda, **inst).name,
                    reconstruct=True, device="cpu", **inst)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.args, want.args)
    assert got.solution == want.solution
    after = dict(k1.LAUNCHES, **k2.LAUNCHES)
    assert sum(after.values()) > sum(before.values())
