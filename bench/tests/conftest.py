"""Fixtures of the benchmark's tests: a copy of ``bench/`` beside a
``BENCHMARK.json`` that adds a tiny S-DP cell, so a whole run fits the
CPU in a few seconds."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the tiny configuration: Table I's offsets at k = 16, n = 4096
TINY = {"n": 4096, "k": 16, "lanes_per_chip": 4}


def make_tree(where: Path, chips: int = 1, clients: int = 8, sample: int = 1000) -> Path:
    """A checkout-like tree at ``where``: ``bench/`` copied, a tiny
    configuration, mix and cell added as new files and entries."""
    shutil.copytree(ROOT / "bench", where / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/sdp_onchip.json").read_text())
    cfg.update(name="tiny", **TINY)
    (where / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    (where / "bench/traffic/tiny.json").write_text(
        json.dumps({"loop": "closed", "clients": clients, "sample": sample}))
    man["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2008.01938",
                           "file": "bench/configs/tiny.json", "reduced": ["k", "n"],
                           "why": "a size the CPU runs in seconds"})
    man["workloads"].append({"name": "tiny.t", "config": "tiny", "traffic": "tiny",
                             "chips": chips, "why": "the tests' cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m and "sdp_onchip.batched" in m["workloads"]:
            m["workloads"].append("tiny.t")
    (where / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return where


@pytest.fixture
def tiny_tree(tmp_path):
    return make_tree(tmp_path)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
