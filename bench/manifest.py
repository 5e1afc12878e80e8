"""The benchmark's pieces, found by the names in ``BENCHMARK.json``.

A cell names its configuration and its traffic mix; each lives in a file
of its own (``bench/configs/<config>.json``, ``bench/traffic/<mix>.json``),
a configuration's problem in ``bench/problems/<problem>.py`` and each
metric's reader in ``bench/metrics/<metric>.py``. A metric split by the
end-to-end metric it moves (``step_ms.single``, ``step_ms.batched``) may
share one reader, ``bench/metrics/step_ms.py``: a name with dots falls
back to its shorter prefixes. Adding a cell, a configuration, a mix or a
metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent


class Manifest:
    """``BENCHMARK.json`` at ``root``, with the files it names under
    ``bench``."""

    def __init__(self, root: Path, bench: Path = BENCH):
        self.root, self.bench = Path(root), Path(bench)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def problem(self, name: str):
        return load_module(self.bench / "problems" / f"{name}.py")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` reports, with their modules: the
        end-to-end ones without a trace, the per-layer ones with it. A
        metric without ``workloads`` belongs to every cell; a per-layer one
        without it, to every cell that reports the metric it moves."""
        e2e = [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            chosen = e2e
        else:
            moved = {m["name"] for m in e2e}
            chosen = [m for m in self.data["per_layer"]
                      if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
        return [(m, self.reader(m["name"])) for m in chosen]

    def reader(self, metric: str):
        """The module that reads ``metric``: ``metrics/<metric>.py``, else
        that of the longest prefix of the name before a dot."""
        parts = metric.split(".")
        for i in range(len(parts), 0, -1):
            path = self.bench / "metrics" / (".".join(parts[:i]) + ".py")
            if path.is_file():
                return load_module(path)
        raise FileNotFoundError(f"no reader for metric {metric!r} under {self.bench / 'metrics'}")


def load_module(path: Path):
    """The module in ``path`` (a metric's name may hold dots, so it is
    loaded by its path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(f"bench_piece_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
