"""The port's main path (``repro_torch.dp``) against ``repro.dp`` on the
CPU: the same instances (sampled with numpy from a seed) through
``solve``/``batch_solve`` with ``reconstruct=True`` on both sides, for all
thirteen problems (linear, triangular and grid), on the kernel route and on
the plain route.

Tables and args are bit-equal and solutions and values equal (every zoo
problem reduces by min or max, which is exact). ``repro``'s kernel routes
run their Pallas kernels in interpret mode (``REPRO_KERNELS=interpret``);
the port's run their kernels' plain PyTorch versions (``device="cpu"``).
Default-dispatch values agree with ``repro``'s and with the numpy oracles
within ``VALUE_RTOL`` (float32 tables against float64 oracles).
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import dp as jdp  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402

LINEAR = ("sdp", "edit_distance", "lcs", "viterbi", "unbounded_knapsack")
TRIANGULAR = ("mcm", "optimal_bst", "polygon_triangulation")
GRID = ("needleman_wunsch", "gotoh", "cky", "edit_distance_grid", "lcs_grid")
PROBLEMS = LINEAR + TRIANGULAR + GRID
ROUTES = {"linear": ("kernel_blocked", "blocked"),
          "triangular": ("kernel_wavefront", "wavefront"),
          "grid": ("kernel_grid", "grid_wavefront")}
VALUE_RTOL = 1e-5


def _instances(name, count=2, size=9):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    prob = tdp.get_problem(name)
    return [prob.sample(rng, size) for _ in range(count)]


def _same_answer(got, want, label, source="device"):
    np.testing.assert_array_equal(got.table, want.table, err_msg=label)
    np.testing.assert_array_equal(got.args, want.args, err_msg=label)
    assert got.solution == want.solution, label
    assert np.array_equal(np.asarray(got.value), np.asarray(want.value)), label
    assert got.source == want.source == source, label


def test_zoo_has_the_thirteen_problems():
    assert sorted(tdp.problem_names()) == sorted(PROBLEMS)
    assert set(tdp.problem_names()) <= set(jdp.problem_names())


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("kernel", [True, False])
def test_solve_reconstruct_matches_reference(monkeypatch, name, kernel):
    geometry = tdp.get_problem(name).geometry
    route = ROUTES[geometry][0 if kernel else 1]
    if kernel:
        monkeypatch.setenv("REPRO_KERNELS", "interpret")
    for i, inst in enumerate(_instances(name)):
        want = jdp.solve(name, backend=route, reconstruct=True, **inst)
        got = tdp.solve(name, backend=route, reconstruct=True, device="cpu",
                        **inst)
        _same_answer(got, want, f"{name}/{route}/{i}")


@pytest.mark.parametrize("name", LINEAR)
def test_host_args_fallback_matches_reference(name):
    """A route without an arg twin (``pipeline``) reconstructs from the
    finished table on the host, on both sides alike."""
    for i, inst in enumerate(_instances(name)):
        want = jdp.solve(name, backend="pipeline", reconstruct=True, **inst)
        got = tdp.solve(name, backend="pipeline", reconstruct=True,
                        device="cpu", **inst)
        _same_answer(got, want, f"{name}/pipeline/{i}", source="host")


@pytest.mark.parametrize("name", PROBLEMS)
def test_batch_solve_equals_single_solves(name):
    insts = _instances(name, count=4)
    # one shape per batch: resample until four instances share a shape key
    prob = tdp.get_problem(name)
    key = prob.encode(**insts[0]).shape_key()
    rng = np.random.default_rng(zlib.crc32(f"batch/{name}".encode()))
    same = [insts[0]]
    while len(same) < 4:
        cand = prob.sample(rng, 9)
        if prob.encode(**cand).shape_key() == key:
            same.append(cand)
    for route in ROUTES[prob.geometry]:
        batch = tdp.batch_solve(name, same, backend=route, reconstruct=True,
                                device="cpu")
        for i, inst in enumerate(same):
            one = tdp.solve(name, backend=route, reconstruct=True,
                            device="cpu", **inst)
            _same_answer(batch[i], one, f"{name}/{route}/batch{i}")
        values = tdp.batch_solve(name, same, backend=route, device="cpu")
        for got, ans in zip(values, batch):
            assert np.array_equal(np.asarray(got), np.asarray(ans.value))


@pytest.mark.parametrize("name", PROBLEMS)
def test_default_dispatch_values_match_reference_and_oracle(name):
    prob = tdp.get_problem(name)
    for inst in _instances(name):
        got = tdp.solve(name, device="cpu", **inst)
        want = jdp.solve(name, **inst)
        oracle = prob.extract(prob.oracle(**inst), prob.encode(**inst))
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=VALUE_RTOL, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(oracle, np.float64),
                                   rtol=VALUE_RTOL, atol=1e-4)


@pytest.mark.parametrize("name", PROBLEMS)
def test_spec_digests_match_reference(name):
    jprob, tprob = jdp.get_problem(name), tdp.get_problem(name)
    for inst in _instances(name, count=3):
        tspec, jspec = tprob.encode(**inst), jprob.encode(**inst)
        digest = jdp.spec_digest(jspec)
        assert tdp.spec_digest(tspec) == digest
        carried = tdp.spec_from_reference(jspec)
        assert tdp.spec_digest(carried) == digest
        assert carried.shape_key() == jspec.shape_key() == tspec.shape_key()


@pytest.mark.parametrize("name", PROBLEMS)
def test_reference_specs_solve_identically(name):
    """Specs carried over from ``repro`` solve to the same tables."""
    for inst in _instances(name):
        jspec = jdp.get_problem(name).encode(**inst)
        route = ROUTES[jspec.geometry][1]
        np.testing.assert_array_equal(
            tdp.solve_spec(tdp.spec_from_reference(jspec), backend=route,
                           device="cpu"),
            jdp.solve_spec(jspec, backend=route))


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("size", [5, 40])
def test_dispatch_order_matches_reference(monkeypatch, name, size):
    """The port's analytical ranking equals ``repro``'s (ref mode, CPU)
    restricted to the routes the port has."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    inst = _instances(name, count=1, size=size)[0]
    jspec = jdp.get_problem(name).encode(**inst)
    tspec = tdp.get_problem(name).encode(**inst)
    ported = set(tdp.backends.names(jspec.geometry))
    want = [b.name for b in jdp.backends.candidates(jspec) if b.name in ported]
    got = [b.name for b in tdp.backends.candidates(tspec, torch.device("cpu"))]
    assert got == want
    for reconstruct in (False, True):
        jname = jdp.dispatch(jspec, reconstruct=reconstruct).name
        if jname in ported:
            assert tdp.dispatch(tspec, reconstruct=reconstruct,
                                device="cpu").name == jname


def test_kernel_routes_win_on_the_card():
    """The ×0.5 device factor makes dispatch pick the kernel routes on a
    CUDA device for the paper's shapes (ranking only; nothing runs)."""
    cuda = torch.device("cuda")
    sdp = tdp.LinearSpec(offsets=tuple(range(2048, 1024, -1)), op="min",
                         n=2 ** 20, init=np.zeros(2048, np.float32))
    assert tdp.backends.candidates(sdp, cuda)[0].name == "kernel_blocked"
    assert tdp.backends.candidates(sdp, torch.device("cpu"))[0].name != "kernel_blocked"
    tri = tdp.TriangularSpec(n=1024, weights=np.zeros((1, 1), np.float32))
    assert tdp.backends.candidates(tri, cuda)[0].name == "kernel_wavefront"
    assert tdp.backends.candidates(tri, torch.device("cpu"))[0].name == "wavefront"
    gotoh = tdp.GridSpec.from_shape_key(("grid", "antidiag", "max", 3, 4097, 4097,
                                         tdp.zoo._GOTOH_MOVES, ()))
    cky = tdp.GridSpec.from_shape_key(("grid", "spandiag", "max", 32, 64, 64,
                                       (), ((0, 1, 2),) * 1024))
    for grid in (gotoh, cky):
        assert tdp.backends.candidates(grid, cuda)[0].name == "kernel_grid"
        assert tdp.backends.candidates(grid, torch.device("cpu"))[0].name == "grid_wavefront"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.solve("mcm", dims=[3, 4, 5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.batch_solve("mcm", [{"dims": [3, 4, 5]}], device="cuda")
    assert tdp.solve("mcm", dims=[3, 4, 5], device="cpu") == 60.0
