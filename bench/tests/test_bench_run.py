"""A whole run of a tiny cell on the CPU: the result line's keys, the
metrics found by name, a cell added as files only, the isolation from JAX
and from ``benchmarks/``."""
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.tests.conftest import ROOT, make_tree

CPU = torch.device("cpu")
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(tree: Path, trace: bool, seconds: float = 1.0, seed: int = 2 ** 31 + 11):
    return harness.run_cell("tiny.t", seed, seconds, trace, time.perf_counter(),
                            device=CPU, root=tree, bench=tree / "bench")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(tiny_tree, trace):
    result, lines = run(tiny_tree, trace)
    extra = ["breakdown"] if trace else []
    assert list(result) == CONTRACT_KEYS + extra + ["check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float | int)
    for name, c in result["check"].items():
        assert c["value"] <= c["limit"]
    assert lines[-len(result["check"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in result["check"].items()]
    json.dumps(result)


def test_every_metric_of_the_cell_is_read(tiny_tree):
    man = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    e2e, _ = run(tiny_tree, False)
    assert set(e2e["metrics"]) == {m["name"] for m in man["end_to_end"]}
    traced, _ = run(tiny_tree, True)
    # no card, so nothing to read for the kernels' rooflines on the CPU
    want = {m["name"] for m in man["per_layer"] if "tiny.t" in m.get("workloads", ["tiny.t"])}
    assert set(traced["metrics"]) == want - {"sdp_pipeline_roofline"}


def test_metrics_split_by_what_they_move_share_a_reader(tiny_tree):
    """``step_ms.single`` and ``step_ms.batched`` are read by
    ``metrics/step_ms.py``; a reader of the whole name comes first."""
    from bench import manifest

    man = manifest.Manifest(tiny_tree, tiny_tree / "bench")
    assert man.reader("step_ms.single").__file__ == man.reader("step_ms.batched").__file__
    assert man.reader("step_ms.batched").__file__.endswith("step_ms.py")
    (tiny_tree / "bench/metrics/step_ms.batched.py").write_text("def read(obs):\n    return 1\n")
    assert man.reader("step_ms.batched").__file__.endswith("step_ms.batched.py")
    with pytest.raises(FileNotFoundError):
        man.reader("no_such.metric")


def test_a_loop_the_harness_does_not_run_is_refused(tmp_path):
    tree = make_tree(tmp_path)
    (tree / "bench/traffic/tiny.json").write_text(
        json.dumps({"loop": "open", "rate": 10, "clients": 8, "sample": 4}))
    with pytest.raises(ValueError, match="open"):
        run(tree, False)


def test_four_slots_on_the_cpu(tmp_path):
    tree = make_tree(tmp_path, chips=4, clients=32)
    result, _ = run(tree, False)
    assert result["correct"] is True and result["device"]["count"] == 4


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_runs_with_no_edit(tmp_path):
    tree = make_tree(tmp_path)
    before = _digests(tree)
    (tree / "bench/traffic/tiny_pair.json").write_text(
        json.dumps({"loop": "closed", "clients": 2, "sample": 4}))
    (tree / "bench/metrics/answers_in_window.py").write_text(
        "def read(obs):\n    return len(obs.latencies_ms)\n")
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny.pair", "config": "tiny", "traffic": "tiny_pair",
                             "chips": 1, "why": "added by files alone"})
    man["end_to_end"].append({"name": "answers_in_window", "unit": "answers", "better": "higher",
                              "bound": 0.25, "source": "host_clock", "workloads": ["tiny.pair"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(man))
    result, _ = harness.run_cell("tiny.pair", 5, 1.0, False, time.perf_counter(), device=CPU,
                                 root=tree, bench=tree / "bench")
    assert result["correct"] is True
    assert result["metrics"]["answers_in_window"]["value"] > 0
    after = _digests(tree)
    changed = [p for p, h in before.items() if p.name != "BENCHMARK.json" and after[p] != h]
    assert changed == []


def test_no_jax_and_no_reference_package_after_a_run(tmp_path):
    """A run in a fresh process leaves no module whose top-level name is
    ``jax``, ``jaxlib``, ``flax`` or ``repro`` (whole names: the port's
    ``repro_torch`` begins with ``repro``)."""
    tree = make_tree(tmp_path)
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import harness\n"
        f"res, _ = harness.run_cell('tiny.t', 3, 1.0, True, time.perf_counter(), "
        f"device=torch.device('cpu'), root={str(tree)!r}, bench={str(tree / 'bench')!r})\n"
        "assert res['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = eval(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_the_check_counts_whole_names_only():
    sys.modules.setdefault("repro_torch_lookalike_for_test", type(sys)("x"))
    try:
        assert "repro_torch_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)


def test_nothing_the_harness_runs_reads_benchmarks():
    """No file the harness runs or reads names the JAX benchmarks' folder
    or imports JAX or the JAX package."""
    for path in (ROOT / "bench").rglob("*"):
        if "tests" in path.parts or not path.is_file() or path.suffix not in (".py", ".json"):
            continue
        text = path.read_text()
        assert "benchmarks" not in text, path
        for line in text.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in harness.FORBIDDEN, (path, line)
