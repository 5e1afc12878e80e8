"""The port's core solvers (``repro_torch.core``) against ``repro.core`` on
the same numpy inputs, on the CPU.

min/max tables and args are bit-equal on every route. op="add": the
sequential route folds in ascending j on both sides and the tournament and
blocked routes use the same pairwise tree, so unweighted sums are
bit-equal; weighted sums are held within ``ADD_RTOL``, because XLA's CPU
program may round ``acc + t*w`` differently from PyTorch's separate
multiply and add.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import mcm as jmcm  # noqa: E402
from repro.core import sdp as jsdp  # noqa: E402
from repro_torch.core import mcm as tmcm  # noqa: E402
from repro_torch.core import sdp as tsdp  # noqa: E402

ADD_RTOL = 2e-4
CASES = [((5, 3, 1), 40), ((7, 4, 2), 33), ((2, 1), 9), ((6,), 20)]


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _inputs(offsets, n, op, weighted, tag):
    rng = _rng(tag)
    init = rng.normal(size=(offsets[0],)).astype(np.float32)
    w = None
    if weighted:
        w = rng.normal(size=(n, len(offsets))).astype(np.float32)
        if op != "add":
            w[rng.random(w.shape) < 0.2] = np.inf if op == "min" else -np.inf
    return init, w


def _check(got, want, op, weighted):
    got, want = np.asarray(got), np.asarray(want)
    if op == "add" and weighted:
        np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["sequential", "tournament", "pipeline",
                                   "blocked"])
@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_linear_solvers_match_reference(route, op, weighted):
    for offsets, n in CASES:
        init, w = _inputs(offsets, n, op, weighted, f"{route}/{op}/{offsets}")
        jfn, tfn = getattr(jsdp, f"solve_{route}"), getattr(tsdp, f"solve_{route}")
        want = jfn(jnp.asarray(init), offsets, op, n,
                   weights=None if w is None else jnp.asarray(w))
        got = tfn(torch.from_numpy(init), offsets, op, n,
                  weights=None if w is None else torch.from_numpy(w))
        _check(got.numpy(), want, op, weighted)
        if op == "add" or route not in ("tournament", "blocked"):
            continue
        jst, jar = getattr(jsdp, f"solve_{route}_with_args")(
            jnp.asarray(init), offsets, op, n,
            weights=None if w is None else jnp.asarray(w))
        tst, tar = getattr(tsdp, f"solve_{route}_with_args")(
            torch.from_numpy(init), offsets, op, n,
            weights=None if w is None else torch.from_numpy(w))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tar.numpy(), np.asarray(jar))
        np.testing.assert_array_equal(
            tsdp.linear_args_np(tst.numpy(), offsets, op, weights=w),
            jsdp.linear_args_np(np.asarray(jst), offsets, op, weights=w))
        cells, lanes, stop = tsdp.linear_traceback_np(tar.numpy(), offsets, n - 1)
        jc, jl, js = jsdp.linear_traceback_np(np.asarray(jar), offsets, n - 1)
        np.testing.assert_array_equal(cells, jc)
        np.testing.assert_array_equal(lanes, jl)
        assert stop == js


@pytest.mark.parametrize("op", ["min", "max", "add"])
def test_sdp_reference_and_steps_match(op):
    init, w = _inputs((4, 3, 1), 30, op, True, f"oracle/{op}")
    np.testing.assert_array_equal(
        tsdp.sdp_reference(init, (4, 3, 1), op, 30, weights=w),
        jsdp.sdp_reference(init, (4, 3, 1), op, 30, weights=w))
    assert (tsdp.linear_traceback_steps(30, (4, 3, 1))
            == jsdp.linear_traceback_steps(30, (4, 3, 1)))


def test_preset_only_tables_clamp():
    init = np.arange(5, dtype=np.float32)
    for route in ("sequential", "tournament", "pipeline", "blocked"):
        got = getattr(tsdp, f"solve_{route}")(torch.from_numpy(init), (5, 3, 1),
                                              "min", 3)
        np.testing.assert_array_equal(got.numpy(), init[:3], err_msg=route)


def test_linear_batch_axis_matches_single_instances():
    rng = _rng("linear-batch")
    init = rng.normal(size=(4, 3)).astype(np.float32)
    w = rng.normal(size=(4, 25, 2)).astype(np.float32)
    for route in ("sequential", "tournament", "pipeline", "blocked"):
        fn = getattr(tsdp, f"solve_{route}")
        batch = fn(torch.from_numpy(init), (3, 1), "max", 25,
                   weights=torch.from_numpy(w))
        for b in range(4):
            one = fn(torch.from_numpy(init[b]), (3, 1), "max", 25,
                     weights=torch.from_numpy(w[b]))
            np.testing.assert_array_equal(batch[b].numpy(), one.numpy(),
                                          err_msg=route)


@pytest.mark.parametrize("n", [1, 2, 5, 11, 17])
def test_triangular_solvers_match_reference(n):
    rng = _rng(f"tri/{n}")
    dims = rng.integers(1, 30, size=n + 1).astype(np.float64)
    wt = tmcm.weight_table(n, tmcm.mcm_weight_fn(dims))
    np.testing.assert_array_equal(wt, jmcm.weight_table(n, jmcm.mcm_weight_fn(dims)))
    np.testing.assert_array_equal(tmcm.reference_linear(dims),
                                  jmcm.reference_linear(dims))
    w32 = wt.astype(np.float32)
    jst, jar = jmcm.solve_wavefront_tab_with_args(jnp.asarray(w32), n)
    tst, tar = tmcm.solve_wavefront_tab_with_args(torch.from_numpy(w32), n)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tar.numpy(), np.asarray(jar))
    np.testing.assert_array_equal(
        tmcm.solve_wavefront_tab(torch.from_numpy(w32), n).numpy(),
        np.asarray(jmcm.solve_wavefront_tab(jnp.asarray(w32), n)))
    np.testing.assert_array_equal(tmcm.triangular_args_np(tst.numpy(), wt, n),
                                  jmcm.triangular_args_np(np.asarray(jst), wt, n))
    np.testing.assert_array_equal(tmcm.triangular_traceback_np(tar.numpy(), n),
                                  jmcm.triangular_traceback_np(np.asarray(jar), n))
    for c in range(tmcm.num_cells(n)):
        assert tmcm.diag_of(c, n) == jmcm.diag_of(c, n)


def test_triangular_ties_and_batch_axis():
    n = 10
    rng = _rng("tri-ties")
    ws = rng.integers(0, 3, size=(3, tmcm.num_cells(n), n - 1)).astype(np.float32)
    tst, tar = tmcm.solve_wavefront_tab_with_args(torch.from_numpy(ws), n)
    for b in range(3):
        jst, jar = jmcm.solve_wavefront_tab_with_args(jnp.asarray(ws[b]), n)
        np.testing.assert_array_equal(tst[b].numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tar[b].numpy(), np.asarray(jar))
