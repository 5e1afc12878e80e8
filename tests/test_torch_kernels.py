"""The port's kernels (plain PyTorch versions, as they run on the CPU)
against ``repro``'s Pallas kernels in interpret mode, on the same inputs
made with numpy from a seed.

K1 ``sdp_pipeline``: min/max tables and args bit-equal. op="add" folds
lanes in ascending j on both sides; unweighted it is bit-equal. Weighted,
XLA's CPU program for the interpreted kernel rounds ``acc + t*w``
differently (it matches neither a float32 fold nor the port), so there the
port is held bit-equal to ``repro``'s numpy oracle — a float32 ascending
fold with separate multiply and add — and to the Pallas kernel within
``ADD_RTOL`` (the relative error grows along the recurrence; 6.8e-5 is the
largest seen at these sizes). K2 ``mcm_pipeline``: tables and args
bit-equal for n in 2..24.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.sdp import sdp_reference  # noqa: E402
from repro.kernels.mcm_pipeline import (mcm_pipeline_pallas,  # noqa: E402
                                        mcm_pipeline_pallas_with_args)
from repro.kernels.sdp_pipeline import (sdp_pipeline_pallas,  # noqa: E402
                                        sdp_pipeline_pallas_with_args)
from repro_torch.core.mcm import num_cells  # noqa: E402
from repro_torch.kernels import mcm_pipeline as tk2  # noqa: E402
from repro_torch.kernels import sdp_pipeline as tk1  # noqa: E402


ADD_RTOL = 2e-4


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _sdp_inputs(offsets, n, op, weighted, tag):
    rng = _rng(tag)
    init = rng.normal(size=(offsets[0],)).astype(np.float32)
    w = None
    if weighted:
        w = rng.normal(size=(n, len(offsets))).astype(np.float32)
        if op != "add":  # mask ~20% of lanes with the semiring zero
            w[rng.random(w.shape) < 0.2] = np.inf if op == "min" else -np.inf
    return init, w


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("offsets,n,block", [
    ((5, 3, 1), 64, 16), ((7, 4, 2), 57, 3), ((3, 2, 1), 41, 512),
    ((16, 8, 4, 2), 100, 5), ((2, 1), 9, 1), ((12, 9, 8), 70, 512),
])
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_k1_plain_bit_equal_to_pallas(offsets, n, block, op, weighted):
    init, w = _sdp_inputs(offsets, n, op, weighted, f"{offsets}/{n}/{op}/{weighted}")
    want = sdp_pipeline_pallas(jnp.asarray(init), offsets, op, n, block=block,
                               weights=None if w is None else jnp.asarray(w),
                               interpret=True)
    got = tk1.sdp_pipeline(_t(init), offsets, op, n, block=block, weights=_t(w))
    if op == "add" and weighted:
        np.testing.assert_array_equal(
            got.numpy(), sdp_reference(init, offsets, op, n, weights=w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ADD_RTOL, atol=1e-6)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if op == "add":
        return
    wt, wa = sdp_pipeline_pallas_with_args(
        jnp.asarray(init), offsets, op, n, block=block,
        weights=None if w is None else jnp.asarray(w), interpret=True)
    gt, ga = tk1.sdp_pipeline_with_args(_t(init), offsets, op, n, block=block,
                                        weights=_t(w))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


@pytest.mark.parametrize("n", [3, 5])
def test_k1_preset_only_returns_presets(n):
    init = np.arange(5, dtype=np.float32)
    want_t, want_a = sdp_pipeline_pallas_with_args(
        jnp.asarray(init), (5, 3, 1), "min", n, interpret=True)
    st, args = tk1.sdp_pipeline_with_args(_t(init), (5, 3, 1), "min", n)
    np.testing.assert_array_equal(st.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(args.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(
        tk1.sdp_pipeline(_t(init), (5, 3, 1), "min", n).numpy(), init[:n])


def test_k1_batch_axis_matches_single_instances():
    offsets, n = (6, 4, 3), 50
    rng = _rng("k1-batch")
    init = rng.normal(size=(3, 6)).astype(np.float32)
    w = rng.normal(size=(3, n, 3)).astype(np.float32)
    st, ar = tk1.sdp_pipeline_with_args(_t(init), offsets, "max", n, block=2,
                                        weights=_t(w))
    for b in range(3):
        s1, a1 = tk1.sdp_pipeline_with_args(_t(init[b]), offsets, "max", n,
                                            block=2, weights=_t(w[b]))
        np.testing.assert_array_equal(st[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(ar[b].numpy(), a1.numpy())


def test_k1_rejects_args_for_add():
    with pytest.raises(ValueError, match="undefined"):
        tk1.sdp_pipeline_with_args(torch.zeros(2), (2, 1), "add", 8)


def _wtab(n, tag, ties=False):
    rng = _rng(tag)
    w = rng.normal(size=(num_cells(n), max(n - 1, 1))).astype(np.float32)
    if ties:  # small integers make equal candidates, exercising the tie rule
        w = rng.integers(0, 3, size=w.shape).astype(np.float32)
    return w


@pytest.mark.parametrize("n", [2, 3, 4, 7, 12, 24])
@pytest.mark.parametrize("ties", [False, True])
def test_k2_plain_bit_equal_to_pallas(n, ties):
    w = _wtab(n, f"k2/{n}/{ties}", ties)
    want = mcm_pipeline_pallas(jnp.asarray(w), n, interpret=True)
    np.testing.assert_array_equal(tk2.mcm_pipeline(_t(w), n).numpy(),
                                  np.asarray(want))
    wt, wa = mcm_pipeline_pallas_with_args(jnp.asarray(w), n, interpret=True)
    gt, ga = tk2.mcm_pipeline_with_args(_t(w), n)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_k2_batch_axis_matches_single_instances():
    n = 9
    ws = np.stack([_wtab(n, f"k2-batch/{b}") for b in range(3)])
    st, ar = tk2.mcm_pipeline_with_args(_t(ws), n)
    for b in range(3):
        s1, a1 = tk2.mcm_pipeline_with_args(_t(ws[b]), n)
        np.testing.assert_array_equal(st[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(ar[b].numpy(), a1.numpy())
