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
from repro_torch import kernels  # noqa: E402

LINEAR = ("sdp", "edit_distance", "lcs", "viterbi", "unbounded_knapsack")
TRIANGULAR = ("mcm", "optimal_bst", "polygon_triangulation")
GRID = ("needleman_wunsch", "gotoh", "cky", "edit_distance_grid", "lcs_grid")
PROBLEMS = LINEAR + TRIANGULAR + GRID
#: per geometry: the resident kernel route, the plain route, then the
#: streaming kernel route where the family has one
ROUTES = {"linear": ("kernel_blocked", "blocked", "kernel_tiled"),
          "triangular": ("kernel_wavefront", "wavefront",
                         "kernel_tiled_wavefront"),
          "grid": ("kernel_grid", "grid_wavefront")}
KERNEL_ROUTES = ("kernel_blocked", "kernel_tiled", "kernel_wavefront",
                 "kernel_tiled_wavefront")
#: the L2 size an H100 reports, for ranking on a stubbed card
L2_BYTES = 50 * 2 ** 20
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


@pytest.mark.parametrize("name", LINEAR + TRIANGULAR)
def test_streaming_route_reconstruct_matches_reference(monkeypatch, name):
    """The streaming kernel routes (``kernel_tiled``, and
    ``kernel_tiled_wavefront`` with its fused traceback) against
    ``repro``'s in interpret mode."""
    route = ROUTES[tdp.get_problem(name).geometry][2]
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


@pytest.mark.parametrize("geometry", ["linear", "triangular", "grid"])
def test_route_sets_match_reference(geometry):
    assert tdp.backends.names(geometry) == jdp.backends.names(geometry)


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("size", [5, 40, 100])
def test_dispatch_order_matches_reference(monkeypatch, name, size):
    """The port's analytical ranking equals ``repro``'s (ref mode, CPU),
    route for route: at size 100 mcm reaches ``blocked_mcm``, and most
    linear problems ``companion_scan``."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    inst = _instances(name, count=1, size=size)[0]
    jspec = jdp.get_problem(name).encode(**inst)
    tspec = tdp.get_problem(name).encode(**inst)
    want = [b.name for b in jdp.backends.candidates(jspec)]
    got = [b.name for b in tdp.backends.candidates(tspec, torch.device("cpu"))]
    assert got == want
    for reconstruct in (False, True):
        assert (tdp.dispatch(tspec, reconstruct=reconstruct, device="cpu").name
                == jdp.dispatch(jspec, reconstruct=reconstruct).name)


@pytest.mark.parametrize("size", [40, 100])
def test_default_dispatch_value_bit_equal_to_reference(monkeypatch, size):
    """Weighted max-plus knapsack: both packages dispatch to
    ``companion_scan`` and agree bit for bit (``repro``'s own ``blocked``
    route differs from its ``companion_scan`` by up to 4.6e-5 here,
    ROADMAP queue 3)."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    name = "unbounded_knapsack"
    inst = _instances(name, count=1, size=size)[0]
    want = jdp.solve(name, **inst)
    got = tdp.solve(name, device="cpu", **inst)
    assert np.float32(got) == np.float32(want), (got, want)
    spec = tdp.get_problem(name).encode(**inst)
    assert tdp.dispatch(spec, device="cpu").name == "companion_scan"


@pytest.fixture
def card(monkeypatch):
    """A CUDA device for ranking only (nothing runs): the on-chip budget is
    stubbed to an H100's L2 size."""
    from repro_torch import kernels

    monkeypatch.setattr(kernels, "on_chip_budget",
                        lambda device: L2_BYTES if device.type == "cuda" else None)
    return torch.device("cuda")


def _first(spec, device, reconstruct=False):
    return tdp.routing._best(spec, device, reconstruct).name


def test_kernel_routes_win_on_the_card(card):
    """On a CUDA device the kernel routes rank first, and the L2 gate
    sends the resident kernels' instances past 50 MiB to the streaming
    ones: MCM n = 1024 (a 2.1 GB weight table) to ``kernel_tiled_wavefront``,
    n = 256 (34 MB) stays on ``kernel_wavefront`` (ranking only; nothing
    runs)."""
    cuda = card
    sdp = tdp.LinearSpec(offsets=tuple(range(2048, 1024, -1)), op="min",
                         n=2 ** 20, init=np.zeros(2048, np.float32))
    assert tdp.backends.candidates(sdp, cuda)[0].name == "kernel_blocked"
    assert tdp.backends.candidates(sdp, torch.device("cpu"))[0].name != "kernel_blocked"
    tri = tdp.TriangularSpec(n=1024, weights=np.zeros((1, 1), np.float32))
    assert tdp.backends.candidates(tri, cuda)[0].name == "kernel_tiled_wavefront"
    assert tdp.backends.candidates(tri, torch.device("cpu"))[0].name == "wavefront"
    tri = tdp.TriangularSpec(n=256, weights=np.zeros((1, 1), np.float32))
    assert tdp.backends.candidates(tri, cuda)[0].name == "kernel_wavefront"
    gotoh = tdp.GridSpec.from_shape_key(("grid", "antidiag", "max", 3, 4097, 4097,
                                         tdp.zoo._GOTOH_MOVES, ()))
    cky = tdp.GridSpec.from_shape_key(("grid", "spandiag", "max", 32, 64, 64,
                                       (), ((0, 1, 2),) * 1024))
    for grid in (gotoh, cky):
        assert tdp.backends.candidates(grid, cuda)[0].name == "kernel_grid"
        assert tdp.backends.candidates(grid, torch.device("cpu"))[0].name == "grid_wavefront"


def _edit_spec(m):
    """edit_distance on two m-long strings, as the zoo encodes it (B = 1,
    k = 3, weighted)."""
    W = m + 1
    n = W * W
    return tdp.LinearSpec(offsets=(W + 1, W, 1), op="min", n=n,
                          init=np.zeros(W + 1, np.float32),
                          weights=np.zeros((1, 1), np.float32))


@pytest.mark.parametrize("m,route", [(512, "kernel_blocked"),
                                     (2048, "kernel_tiled")])
def test_one_cell_steps_dispatch_to_a_kernel_on_the_card(card, m, route):
    """edit_distance without reconstruction: one cell per step (B = 1),
    where the host-looped ``pipeline`` route used to win on the step count;
    512² (5.3 MB) stays resident, 2048² (84 MB) streams."""
    spec = _edit_spec(m)
    assert _first(spec, card) == route
    assert _first(spec, card, reconstruct=True) == route
    # the CPU keeps repro's order: the plain pipeline loop wins there
    assert _first(spec, torch.device("cpu")) == "pipeline"


@pytest.mark.parametrize("reconstruct", [False, True])
def test_window_too_large_to_stream_stays_on_the_resident_kernel(card,
                                                                  reconstruct):
    """A horizon of 60000 cells is past the 227 KB of shared memory
    ``kernel_tiled``'s ring may take; at n = 2^23 (a 67 MB working set,
    past the budget) ``kernel_blocked`` keeps the spec, so it never falls
    to a host-looped route. Below the cap the budget decides as before."""
    spec = tdp.LinearSpec(offsets=(60000, 1), op="min", n=2 ** 23,
                          init=np.zeros(60000, np.float32))
    assert kernels._linear_vmem_bytes(spec) > L2_BYTES
    assert not tdp.backends.get("kernel_tiled").supports(spec, card)
    assert _first(spec, card, reconstruct) == "kernel_blocked"
    streams = tdp.LinearSpec(offsets=(50000, 1), op="min", n=2 ** 23,
                             init=np.zeros(50000, np.float32))
    assert not tdp.backends.get("kernel_blocked").supports(streams, card)
    assert _first(streams, card, reconstruct) == "kernel_tiled"


@pytest.mark.parametrize("name", ["edit_distance", "lcs", "viterbi",
                                  "unbounded_knapsack"])
@pytest.mark.parametrize("size", [5, 40, 300])
def test_no_one_cell_problem_dispatches_to_a_host_loop_on_the_card(card, name,
                                                                   size):
    spec = tdp.get_problem(name).encode(**_instances(name, 1, size)[0])
    assert int(spec.offsets[-1]) == 1           # B = 1: one cell per step
    for reconstruct in (False, True):
        assert tdp.routing._best(spec, card, reconstruct).kernel, (name, size)
    # the plain routes stay reachable by name
    assert tdp.routing.resolve_backend(spec, "pipeline", device="cpu").name == "pipeline"


def _ranking_specs():
    """Linear and triangular specs on both sides of two budgets: ``(label,
    budget, repro spec, port spec)``."""
    cases = []
    for budget in (2 ** 20, L2_BYTES):
        for n in (2 ** 14, 2 ** 16, 2 ** 20, 2 ** 23):
            for weighted in (False, True):
                offs = (1030, 1029, 1025) if weighted else tuple(range(2048, 1024, -1))
                kw = dict(offsets=offs, op="min", n=n,
                          init=np.zeros(offs[0], np.float32),
                          weights=np.zeros((1, 1), np.float32) if weighted else None)
                cases.append((f"linear-{n}-{weighted}-{budget}", budget,
                              jdp.LinearSpec(**kw), tdp.LinearSpec(**kw)))
        for n in (8, 40, 80, 160, 256, 290, 297, 1024):
            w = np.zeros((1, 1), np.float32)
            cases.append((f"triangular-{n}-{budget}", budget,
                          jdp.TriangularSpec(n=n, weights=w),
                          tdp.TriangularSpec(n=n, weights=w)))
    return cases


@pytest.mark.parametrize("label,budget,jspec,tspec",
                         [pytest.param(*c, id=c[0]) for c in _ranking_specs()])
def test_kernel_ranking_matches_reference_pallas_mode(monkeypatch, label,
                                                      budget, jspec, tspec):
    """Among the four kernel routes, the port's ranking on a card whose L2
    holds ``budget`` bytes equals ``repro``'s with ``REPRO_KERNELS=pallas``
    and ``REPRO_VMEM_BUDGET`` at the same bytes (ranking only)."""
    from repro_torch import kernels

    monkeypatch.setenv("REPRO_KERNELS", "pallas")
    monkeypatch.setenv("REPRO_VMEM_BUDGET", str(budget))
    monkeypatch.setattr(kernels, "on_chip_budget", lambda device: budget)
    want = [b.name for b in jdp.backends.candidates(jspec)
            if b.name in KERNEL_ROUTES]
    got = [b.name for b in tdp.backends.candidates(tspec, torch.device("cuda"))
           if b.name in KERNEL_ROUTES]
    assert got == want
    assert len(got) in (1, 2)


@pytest.mark.parametrize("n", [40, 64, 100])
def test_blocked_mcm_ranks_as_in_reference_pallas_mode(monkeypatch, n):
    """On the card ``blocked_mcm`` (not a kernel route: it loops on the
    host over its boundary steps) ranks behind the kernel routes and, from
    n = 64 on (a cost tie broken by name), ahead of ``wavefront`` —
    ``repro``'s whole triangular ranking under ``REPRO_KERNELS=pallas``
    (ranking only)."""
    from repro_torch import kernels

    monkeypatch.setenv("REPRO_KERNELS", "pallas")
    monkeypatch.setenv("REPRO_VMEM_BUDGET", str(L2_BYTES))
    monkeypatch.setattr(kernels, "on_chip_budget", lambda device: L2_BYTES)
    inst = _instances("mcm", count=1, size=n)[0]
    jspec = jdp.get_problem("mcm").encode(**inst)
    tspec = tdp.get_problem("mcm").encode(**inst)
    want = [b.name for b in jdp.backends.candidates(jspec)]
    got = [b.name for b in tdp.backends.candidates(tspec, torch.device("cuda"))]
    assert got == want
    plain = [name for name in got if not tdp.backends.get(name).kernel]
    assert plain[0] == ("blocked_mcm" if n >= 64 else "wavefront")


def test_on_chip_budget_is_no_gate_on_the_cpu():
    from repro_torch import kernels

    assert kernels.on_chip_budget(torch.device("cpu")) is None
    big = tdp.TriangularSpec(n=4096, weights=np.zeros((1, 1), np.float32))
    assert tdp.backends.get("kernel_wavefront").supports(big, torch.device("cpu"))


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.solve("mcm", dims=[3, 4, 5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.batch_solve("mcm", [{"dims": [3, 4, 5]}], device="cuda")
    assert tdp.solve("mcm", dims=[3, 4, 5], device="cpu") == 60.0


def _antidiag_spec(moves_count: int, planes: int = 8, rows: int = 4,
                   cols: int = 4):
    """An alignment-shaped spec whose move table is ``moves_count`` long
    (the table of ``test_torch_grid.py``'s shared-memory refusal)."""
    moves = tuple((p % 8, (p * 3) % 8, 1, p % 2) for p in range(moves_count))
    mask = np.zeros((planes, rows, cols), bool)
    mask[:, 0, :] = mask[:, :, 0] = True
    spec = tdp.GridSpec(rows=rows, cols=cols, op="max", schedule="antidiag",
                        planes=planes, moves=moves,
                        weights=np.zeros((moves_count, rows, cols), np.float32),
                        init=np.zeros((planes, rows, cols), np.float32),
                        init_mask=mask)
    spec.validate()
    return spec


def _spandiag_spec(rules_count: int, planes: int = 4, n: int = 3):
    rules = tuple((r % planes, (r * 3) % planes, (r * 5 + 1) % planes)
                  for r in range(rules_count))
    spec = tdp.GridSpec(rows=n, cols=n, op="max", schedule="spandiag",
                        planes=planes, rules=rules,
                        rule_weights=np.zeros(rules_count, np.float32),
                        init=np.zeros((planes, n), np.float32))
    spec.validate()
    return spec


@pytest.mark.parametrize("reconstruct", [False, True])
def test_grid_specs_k6_cannot_launch_go_to_the_plain_route(card, reconstruct):
    """``kernel_grid`` admits on the card only what K6's launchers take: a
    move table past shared memory (no tile plan at L = 9700, in both arg
    modes) or a rule table past it goes to ``grid_wavefront``, as
    ``repro`` falls back through its gate; L = 9000 still has a plan and
    stays on the kernel. On the CPU every spec stays admitted."""
    from repro_torch.kernels import grid_pipeline as tk6

    fits, past = _antidiag_spec(9000), _antidiag_spec(9700)
    assert all(tk6.tile_plan(8, fits.moves, a) is not None for a in (False, True))
    assert all(tk6.tile_plan(8, past.moves, a) is None for a in (False, True))
    chart = _spandiag_spec(15000)
    assert tk6.spandiag_smem_bytes(4, 15000) > 232448
    k6 = tdp.backends.get("kernel_grid")
    for spec in (past, chart):
        assert not k6.supports(spec, card)
        assert k6.supports(spec, torch.device("cpu"))
        assert _first(spec, card, reconstruct) == "grid_wavefront"
    assert k6.supports(fits, card)
    assert _first(fits, card, reconstruct) == "kernel_grid"
    assert _first(_spandiag_spec(1024), card, reconstruct) == "kernel_grid"
