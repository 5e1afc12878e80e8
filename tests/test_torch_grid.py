"""The port's grid family against ``repro``'s on the CPU.

``repro_torch.core.grid.solve_grid(_with_args)`` (the vectorized route) and
``repro_torch.kernels.grid_pipeline.grid_pipeline_plain`` (K6's plain
version, in the kernel's frontier-major layout and step order) are held
bit-equal, tables and args, to ``repro.core.grid.solve_grid(_with_args)``
and to the Pallas K6 in interpret mode, on zoo instances sampled with numpy
from a seed (antidiag grids up to 12 × 12, parse charts up to n = 10) and
on hand-built edge cases (``test_torch_gpu.grid_edge_specs``). The numpy
helpers are held to ``repro``'s: the float64 oracle exactly and within
``ORACLE_RTOL`` of the float32 tables, host args and walks exactly.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import dp as jdp  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.kernels.grid_pipeline import (grid_pipeline_pallas,  # noqa: E402
                                         grid_pipeline_pallas_with_args)
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.core import grid as tgrid  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import grid_pipeline as tk6  # noqa: E402
from test_torch_gpu import GOTOH_MOVES, grid_arrs, grid_edge_specs  # noqa: E402

GRID = ("needleman_wunsch", "gotoh", "cky", "edit_distance_grid", "lcs_grid")
#: float32 tables against the float64 oracle (sums of a few dozen terms)
ORACLE_RTOL = 1e-5


def _zoo_specs(name, sizes=(3, 7, 12)):
    rng = np.random.default_rng(zlib.crc32(f"grid/{name}".encode()))
    prob = tdp.get_problem(name)
    return [(f"{name}-{size}", prob.encode(**prob.sample(rng, size)))
            for size in sizes]


CASES = [pytest.param(spec, id=label) for name in GRID
         for label, spec in _zoo_specs(name)]
CASES += [pytest.param(spec, id=label) for label, spec in grid_edge_specs()]


def _reference(spec):
    """The same instance as a ``repro`` spec."""
    return jdp.GridSpec(**{f.name: getattr(spec, f.name)
                           for f in dataclasses.fields(spec)})


@pytest.mark.parametrize("spec", CASES)
def test_solvers_bit_equal_to_reference_and_pallas(spec):
    meta = spec.static_meta()
    jarrs = tuple(jnp.asarray(a) for a in spec.device_arrays())
    want_t, want_a = (np.asarray(x) for x in jgrid.solve_grid_with_args(jarrs, meta))
    pal_t, pal_a = (np.asarray(x) for x in
                    grid_pipeline_pallas_with_args(jarrs, meta, True))
    np.testing.assert_array_equal(np.asarray(grid_pipeline_pallas(jarrs, meta, True)),
                                  want_t)
    np.testing.assert_array_equal(pal_t, want_t)
    np.testing.assert_array_equal(pal_a, want_a)
    arrs = grid_arrs(spec, "cpu")
    for label, (t, a) in {
            "core": tgrid.solve_grid_with_args(arrs, meta),
            "plain": tk6.grid_pipeline_plain(arrs, meta, with_args=True),
            "ops": tk6.grid_pipeline_with_args(arrs, meta)}.items():
        np.testing.assert_array_equal(t.numpy(), want_t, err_msg=label)
        np.testing.assert_array_equal(a.numpy(), want_a, err_msg=label)
    for label, t in {"core": tgrid.solve_grid(arrs, meta),
                     "plain": tk6.grid_pipeline_plain(arrs, meta),
                     "ops": tk6.grid_pipeline(arrs, meta)}.items():
        np.testing.assert_array_equal(t.numpy(), want_t, err_msg=label)


@pytest.mark.parametrize("spec", CASES)
def test_numpy_helpers_match_reference(spec):
    ref = _reference(spec)
    oracle = tgrid.grid_reference(spec)
    np.testing.assert_array_equal(oracle, jgrid.grid_reference(ref))
    table, args = (x.numpy() for x in tgrid.solve_grid_with_args(
        grid_arrs(spec, "cpu"), spec.static_meta()))
    finite = np.isfinite(oracle)
    np.testing.assert_array_equal(np.isfinite(table), finite)
    np.testing.assert_allclose(table[finite], oracle[finite],
                               rtol=ORACLE_RTOL, atol=1e-5)
    host = tgrid.grid_args_np(table, spec)
    np.testing.assert_array_equal(host, jgrid.grid_args_np(table, ref))
    # both packages' host re-ranking leaves -1 on a cell no move reaches
    # (unpreset border cells; the zoo presets them), the solvers the first move
    reach = host >= 0
    np.testing.assert_array_equal(host[reach], args[reach])
    corners = {spec.default_start(None), spec.planes * spec.cells - 1}
    for start in sorted(corners):
        got = tgrid.grid_traceback_np(args, spec, start)
        want = jgrid.grid_traceback_np(args, ref, start)
        np.testing.assert_array_equal(got.nodes, want.nodes)
        assert got.stop == want.stop


@pytest.mark.parametrize("spec", CASES[::3])
def test_batch_axis_matches_single_instances(spec):
    meta = spec.static_meta()
    batched = grid_arrs(spec, "cpu", batch=3)
    for solve in (tgrid.solve_grid_with_args,
                  lambda a, m: tk6.grid_pipeline_plain(a, m, with_args=True)):
        st, ar = solve(batched, meta)
        for b in range(3):
            one = tuple(a[b] for a in batched)
            s1, a1 = solve(one, meta)
            np.testing.assert_array_equal(st[b].numpy(), s1.numpy())
            np.testing.assert_array_equal(ar[b].numpy(), a1.numpy())


@pytest.mark.parametrize("R,C", [(1, 1), (1, 6), (6, 1), (3, 8), (8, 3), (5, 5)])
def test_frontier_layout(R, C):
    """The closed-form front offsets equal the running sum of the front
    lengths, and every front is one contiguous run of the layout."""
    lengths = [min(t, C - 1) - max(0, t - R + 1) + 1 for t in range(R + C - 1)]
    bases = np.concatenate([[0], np.cumsum(lengths)])
    assert [tk6.front_base(t, R, C) for t in range(R + C)] == bases.tolist()
    t = torch.arange(R + C)
    assert tk6.front_base(t, R, C).tolist() == bases.tolist()
    pos = tk6.front_positions(R, C, "cpu").reshape(R, C)
    assert sorted(pos.reshape(-1).tolist()) == list(range(R * C))
    for f in range(R + C - 1):
        run = [int(pos[f - j, j]) for j in range(max(0, f - R + 1), min(f, C - 1) + 1)]
        assert run == list(range(bases[f], bases[f + 1]))


NW_MOVES = ((0, 0, 1, 1), (0, 0, 1, 0), (0, 0, 0, 1))
PLAN_MOVES = [(1, NW_MOVES), (3, GOTOH_MOVES), (3, grid_edge_specs()[0][1].moves),
              (1, ((0, 0, 1, 1), (0, 0, 70, 0), (0, 0, 0, 1))),
              (2, ((0, 1, 5, 5), (1, 0, 1, 0), (1, 1, 0, 2), (0, 0, 2, 1))),
              (40, tuple((p, (p * 7) % 40, 1, p % 2) for p in range(40))),
              (4, tuple((p % 4, (p * 3) % 4, 1 + p % 3, p % 2) for p in range(900)))]


@pytest.mark.parametrize("P,moves", PLAN_MOVES, ids=lambda v: str(v)[:12])
@pytest.mark.parametrize("with_args", [False, True])
def test_antidiag_tile_plan_fits_shared_memory(P, moves, with_args):
    """The largest tile side with one thread per (plane, row) whose staged
    planes fit the shared memory a block can use (beside the kernel's
    static shared memory); even row strides; a halo of at most HALO."""
    plan = tk6.tile_plan(P, moves, with_args)
    assert plan.smem <= _build.SMEM_OPTIN_BYTES - tk6._STATIC_SMEM
    assert P * plan.T <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.S1 % 2 == 0 and plan.S1 >= plan.T + plan.HJ
    assert plan.SW % 2 == 0 and plan.SW >= plan.T
    assert plan.HI == min(max(m[2] for m in moves), tk6.HALO)
    assert plan.HJ == min(max(m[3] for m in moves), tk6.HALO)
    assert plan.tab % 4 == 0 and plan.tab >= P + 1 + 4 * len(moves)
    L = len(moves)
    planes = L + P + (P if with_args else 0)
    assert plan.smem == 4 * (plan.tab + P * (plan.T + plan.HI) * plan.S1
                             + planes * plan.T * plan.SW)
    larger = [t for t in tk6.TILE_SIDES if t > plan.T and P * t <= 1024]
    for t in larger:    # every larger side overflows
        assert tk6._tile_smem(t, plan.HI, plan.HJ, plan.tab, P, L, with_args)[2] \
            > _build.SMEM_OPTIN_BYTES - tk6._STATIC_SMEM


def test_antidiag_tile_plan_of_the_zoo():
    assert tk6.tile_plan(1, NW_MOVES, True).T == 64
    assert tk6.tile_plan(3, GOTOH_MOVES, True).T == 56
    assert tk6.tile_plan(3, GOTOH_MOVES, False).T == 64
    assert tk6.tile_plan(40, PLAN_MOVES[5][1], True).T == 16     # 40 planes staged


def test_antidiag_launch_rejects_a_move_table_past_shared_memory():
    """A spec whose move table leaves no room for even a 1 x 1 tile is
    refused before any launch."""
    moves = tuple((p % 8, (p * 3) % 8, 1, p % 2) for p in range(12000))
    assert tk6.tile_plan(8, moves, True) is None
    arrs = (torch.zeros((1, len(moves), 2, 2)), torch.zeros((1, 8, 2, 2)),
            torch.ones((1, 8, 2, 2)))
    meta = ("antidiag", "max", 8, 2, 2, moves, ())
    with pytest.raises(ValueError, match="moves exceed shared memory"):
        tk6._launch_antidiag(arrs, meta, True)


@pytest.mark.parametrize("spec", [pytest.param(s, id=label)
                                  for label, s in grid_edge_specs()])
def test_edge_specs_carry_over_digest_equal(spec):
    ref = _reference(spec)
    carried = tdp.spec_from_reference(ref)
    assert tdp.spec_digest(carried) == tdp.spec_digest(spec) == jdp.spec_digest(ref)
    assert carried.shape_key() == ref.shape_key()
    assert tdp.backends.get("kernel_grid").supports(carried, torch.device("cpu"))


def test_grid_spec_validation_errors():
    good = tdp.get_problem("needleman_wunsch").encode(x=[1, 2], y=[2, 1])
    with pytest.raises(ValueError, match="min or max"):
        dataclasses.replace(good, op="add").validate()
    with pytest.raises(ValueError, match="schedule"):
        dataclasses.replace(good, schedule="zigzag").validate()
    with pytest.raises(ValueError, match="weights"):
        dataclasses.replace(good, weights=good.weights[:2]).validate()
    with pytest.raises(ValueError, match="forward"):
        dataclasses.replace(good, moves=((0, 0, 0, 0),) * 3).validate()
    with pytest.raises(ValueError, match=r"\(0, 0\)"):
        mask = good.init_mask.copy()
        mask[0, 0, 0] = False
        dataclasses.replace(good, init_mask=mask).validate()
    cky = tdp.get_problem("cky").encode(tokens=[0, 1], rules=[(0, 0, 0)],
                                        rule_logp=[-0.5], lex=np.full((1, 2), -1.0))
    with pytest.raises(ValueError, match="plane out of range"):
        dataclasses.replace(cky, rules=((0, 0, 1),)).validate()
    with pytest.raises(ValueError, match="rows == cols"):
        dataclasses.replace(cky, cols=3).validate()


@pytest.mark.parametrize("grid_name,linear_name", [("edit_distance_grid", "edit_distance"),
                                                   ("lcs_grid", "lcs")])
def test_grid_and_linear_encodings_agree(grid_name, linear_name):
    """The same strings through both families give the same optimum, on
    the kernel routes of both (their plain versions, here)."""
    rng = np.random.default_rng(zlib.crc32(f"diff/{grid_name}".encode()))
    for _ in range(4):
        kw = {"x": rng.integers(0, 4, int(rng.integers(2, 12))),
              "y": rng.integers(0, 4, int(rng.integers(2, 12)))}
        g = tdp.solve(grid_name, backend="kernel_grid", reconstruct=True,
                      device="cpu", **kw)
        lin = tdp.solve(linear_name, backend="kernel_blocked", reconstruct=True,
                        device="cpu", **kw)
        assert g.value == lin.value
        key = "cost" if grid_name == "edit_distance_grid" else "length"
        assert g.solution[key] == lin.solution[key]
        if grid_name == "lcs_grid":
            assert len(g.solution["pairs"]) == g.value
