"""The port's calibration layer against ``repro.dp``'s on the CPU.

Identical synthetic observations in both tables give identical ``rank`` /
``rank_batch`` orders and ``routing_report`` rows; an empty table gives
today's ranking on the CPU and on a stubbed card; a measured rank only
reorders routes that ``supports(spec, device)`` admitted; tables
round-trip through JSON, and a corrupt file degrades to the analytical
model with a warning.
"""
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import dp as jdp  # noqa: E402
from repro.dp import autotune as jautotune  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.dp import backends as tbackends  # noqa: E402

CPU = torch.device("cpu")
CARD = torch.device("cuda")
L2_BYTES = 50 * 2 ** 20
PROBLEMS = ("sdp", "edit_distance", "lcs", "viterbi", "unbounded_knapsack",
            "mcm", "optimal_bst", "polygon_triangulation", "needleman_wunsch",
            "gotoh", "cky", "edit_distance_grid", "lcs_grid")


@pytest.fixture(autouse=True)
def _fresh_table():
    tautotune.reset()
    yield
    tautotune.reset()


@pytest.fixture
def card(monkeypatch):
    """A CUDA device for ranking only (nothing runs): the on-chip budget is
    an H100's L2 and the platform key a fixed name."""
    monkeypatch.setattr(kernels, "on_chip_budget",
                        lambda device: L2_BYTES if device.type == "cuda" else None)
    monkeypatch.setattr(tautotune, "platform",
                        lambda device=None: ("stub-card" if torch.device(device).type
                                             == "cuda" else "cpu"))
    return CARD


def _pair(name: str, size: int = 9):
    kw = tdp.get_problem(name).sample(np.random.default_rng(zlib.crc32(name.encode())),
                                      size)
    return tdp.get_problem(name).encode(**kw), jdp.get_problem(name).encode(**kw)


def _names(bs):
    return [b.name for b in bs]


def _observe_both(key, route_ms: dict):
    for name, ms in route_ms.items():
        tautotune.get_table().observe(name, key, ms, platform="cpu")
        jautotune.get_table().observe(name, key, ms)


@pytest.mark.parametrize("name", PROBLEMS)
def test_identical_observations_rank_identically(name):
    ts, js = _pair(name)
    tc, jc = tbackends.candidates(ts, CPU), jdp.backends.candidates(js)
    assert _names(tc) == _names(jc)
    # the slowest-looking route measures fastest; a middle one is unmeasured
    ms = {b.name: float(len(tc) - i) for i, b in enumerate(tc) if i != 1}
    for suffix in ((), ("batch",), ("reconstruct",)):
        _observe_both(ts.shape_key() + suffix, ms)
    assert _names(tautotune.rank(ts, tc, device=CPU)) == _names(jautotune.rank(js, jc))
    for reconstruct in (False, True):
        got = _names(tdp.routing.batch_candidates(ts, reconstruct, device=CPU))
        want = _names(jdp.routing.batch_candidates(js, reconstruct))
        assert got == want, reconstruct
    assert tdp.dispatch(ts, device="cpu").name == jdp.dispatch(js).name


def test_routing_report_rows_equal_the_reference():
    for name in ("sdp", "mcm", "needleman_wunsch"):
        ts, _ = _pair(name)
        cands = _names(tbackends.candidates(ts, CPU))
        for suffix in ((), ("batch",)):
            _observe_both(ts.shape_key() + suffix,
                          {n: 1.0 + 0.5 * i for i, n in enumerate(reversed(cands))})
    got = tdp.routing_report(device="cpu")
    want = jdp.routing_report()
    assert got["platform"] == "cpu"
    assert len(got["shapes"]) == len(want["shapes"]) == 6
    for g, w in zip(got["shapes"], want["shapes"]):
        for key in ("shape_key", "regime", "comparable", "measured_choice",
                    "analytical_choice", "agree", "analytical_regret",
                    "measured_ms"):
            assert g[key] == w[key], key
    for key in ("disagreements", "median_analytical_regret",
                "max_analytical_regret"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", PROBLEMS)
def test_empty_table_keeps_todays_ranking(name, card):
    ts, js = _pair(name)
    for device in (CPU, card):
        cands = tbackends.candidates(ts, device)
        assert _names(tautotune.rank(ts, cands, device=device)) == _names(cands)
        for reconstruct in (False, True):
            first = tdp.routing._best(ts, device, reconstruct)
            arg = [b for b in cands if b.run_with_args is not None]
            want = arg[0] if reconstruct and ts.supports_args() and arg else cands[0]
            assert first.name == want.name
    assert _names(tbackends.candidates(ts, CPU)) == _names(jdp.backends.candidates(js))


def test_measurements_only_reorder_admitted_routes(card):
    """A timing for a route the card does not admit for this spec (the
    resident K1 past its L2 gate) never brings it back."""
    spec = tdp.LinearSpec(offsets=(3, 1), op="min", n=2 ** 23,
                          init=np.zeros(3, np.float32))
    assert not tbackends.get("kernel_blocked").supports(spec, card)
    table = tautotune.get_table()
    table.record("kernel_blocked", spec.shape_key(), 0.001, platform="stub-card")
    table.record("blocked", spec.shape_key(), 0.002, platform="stub-card")
    table.record("kernel_tiled", spec.shape_key(), 50.0, platform="stub-card")
    ranked = _names(tautotune.rank(spec, tbackends.candidates(spec, card),
                                   device=card))
    assert "kernel_blocked" not in ranked
    assert ranked[0] == "blocked"           # measured, admitted: may lead
    assert tdp.routing._best(spec, card, False).name == "blocked"
    # other platforms' entries never leak onto the card
    tautotune.reset()
    tautotune.get_table().record("blocked", spec.shape_key(), 0.001,
                                 platform="cpu")
    assert tdp.routing._best(spec, card, False).name == "kernel_tiled"


def test_table_round_trips_to_disk(tmp_path):
    t = tautotune.get_table()
    key = ("linear", "min", (3, 2, 1), 24, False)
    t.record("pipeline", key, 0.5, platform="cpu")
    t.observe("blocked", key + ("batch",), 0.25, platform="cpu")
    path = tmp_path / "calib.json"
    t.save(str(path))
    raw = json.loads(path.read_text())
    assert raw["version"] == 1 and {r["platform"] for r in raw["entries"]} == {"cpu"}
    loaded = tautotune.load(str(path))
    assert loaded is tautotune.get_table() and len(loaded) == 2
    assert loaded.lookup("pipeline", key, platform="cpu").ms == 0.5
    e = loaded.lookup("blocked", key + ("batch",), platform="cpu")
    assert (e.ms, e.source) == (0.25, "online")


def test_corrupt_table_falls_back_to_analytical(tmp_path, caplog):
    ts, _ = _pair("sdp")
    analytic_first = tbackends.candidates(ts, CPU)[0].name
    for content in ("{definitely not json", json.dumps({"version": 99}),
                    json.dumps({"version": 1, "entries": [{"bad": "row"}]})):
        path = tmp_path / "corrupt.json"
        path.write_text(content)
        with caplog.at_level("WARNING", logger="repro_torch.dp.autotune"):
            caplog.clear()
            table = tautotune.CalibrationTable.load(str(path))
        assert any("corrupt calibration table" in r.getMessage()
                   for r in caplog.records)
        assert len(table) == 0
        tautotune.set_table(table)
        assert tdp.dispatch(ts, device="cpu").name == analytic_first
    assert len(tautotune.CalibrationTable.load(str(tmp_path / "absent.json"))) == 0


def test_nearest_shape_interpolation_matches_the_reference():
    t24 = tdp.LinearSpec(offsets=(3, 2, 1), op="min", n=24,
                         init=np.zeros(3, np.float32))
    t40 = tdp.LinearSpec(offsets=(3, 2, 1), op="min", n=40,
                         init=np.zeros(3, np.float32))
    j40 = jdp.LinearSpec(offsets=(3, 2, 1), op="min", n=40,
                         init=np.zeros(3, np.float32))
    _observe_both(t24.shape_key(), {"pipeline": 2.0})
    got = tautotune.measured_ms(tbackends.get("pipeline"), t40, device=CPU)
    want = jautotune.measured_ms(jdp.backends.get("pipeline"), j40)
    assert got == pytest.approx(want) and got != 2.0
    far = tdp.LinearSpec(offsets=(3, 2, 1), op="min", n=400,
                         init=np.zeros(3, np.float32))
    assert tautotune.measured_ms(tbackends.get("pipeline"), far, device=CPU) is None


def test_shape_key_helpers_equal_the_reference():
    keys = [("linear", "min", (3, 2, 1), 24, False),
            ("linear", "min", (3, 2, 1), 40, False),
            ("linear", "max", (3, 2, 1), 40, False),
            ("linear", "min", (3, 2, 1), 40, False, "batch"),
            ("triangular", 9), ("triangular", 30, "reconstruct"),
            ("triangular", 12, "extend")]
    for a in keys:
        assert tbackends.split_shape_key(a) == jdp.backends.split_shape_key(a)
        assert tbackends.shape_key_size(a) == jdp.backends.shape_key_size(a)
        assert tbackends.spec_from_shape_key(a).shape_key() == \
            jdp.backends.spec_from_shape_key(a).shape_key()
        for b in keys:
            assert tbackends.shape_key_distance(a, b) == \
                jdp.backends.shape_key_distance(a, b), (a, b)
    assert tbackends.SHAPE_KEY_REGIMES == jdp.backends.SHAPE_KEY_REGIMES


def test_calibrate_populates_table_and_report(tmp_path):
    path = str(tmp_path / "calib.json")
    table = tdp.calibrate(problems=["sdp"], sizes=(8,), repeats=1, path=path,
                          device="cpu")
    assert len(table) >= 2
    report = tdp.routing_report(device="cpu")
    row = report["shapes"][0]
    assert row["analytical_regret"] >= 1.0 and row["comparable"]
    spec = tbackends.spec_from_shape_key(row["shape_key"])
    assert tdp.dispatch(spec, device="cpu").name == row["measured_choice"]
    assert tautotune.CalibrationTable.load(path).lookup(
        row["measured_choice"], row["shape_key"], platform="cpu") is not None


def test_platform_is_the_device_name():
    assert tautotune.platform("cpu") == "cpu"
