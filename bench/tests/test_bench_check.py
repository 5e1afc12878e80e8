"""The check that decides ``correct``: sound runs pass, and the control
and each fault the cells can have fail it.

The control is the reference put in the program's place one precision
below the configuration's float32: bfloat16. The faults are planted under
the timed path of a whole CPU run: a solve that hands back its table as it
began, half of a batch answered from the other half, the shares of the
other slots left out of the gather, and one cell of every answer altered
where it is produced."""
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests.conftest import TINY, make_tree

CPU = torch.device("cpu")
LIMITS = {"table_gap": 0.0, "path_diffs": 0}


def run(tree, seed=2 ** 32 + 5):
    return harness.run_cell("tiny.t", seed, 1.0, False, time.perf_counter(), device=CPU,
                            root=tree, bench=tree / "bench")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(tiny_tree, seed):
    from bench import control

    r = control.readings("tiny.t", seed, CPU, root=tiny_tree, bench=tiny_tree / "bench")
    assert r["compared"] == 1000
    assert r["numbers"]["table_gap"] > r["limits"]["table_gap"]
    assert r["wrong"] > 0


def _faulty(monkeypatch, alter):
    """Wrap the port's batched solve with arguments so that ``alter``
    changes its tables (a list of numpy arrays) and args tensor."""
    from repro_torch.dp import routing

    orig = routing.run_batch_with_args

    def broken(*a, **k):
        tables, args, source, paths = orig(*a, **k)
        tables = [np.array(t) for t in tables]
        args = args.clone() if isinstance(args, torch.Tensor) else args
        alter(tables, args)
        return tables, args, source, paths

    monkeypatch.setattr(routing, "run_batch_with_args", broken)


def unchanged(tables, args):
    a1 = 2 * TINY["k"]
    for t in tables:
        t[a1:] = 0.0


def half_left_out(tables, args):
    half = len(tables) // 2
    for i in range(half, 2 * half):
        tables[i] = tables[i - half].copy()
        args[i] = args[i - half]


def altered(tables, args):
    for t in tables:
        t[len(t) // 2] += 1.0


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_fault_under_the_timed_path_fails(tmp_path, monkeypatch, fault):
    tree = make_tree(tmp_path)
    _faulty(monkeypatch, fault)
    result, lines = run(tree)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["check"]["table_gap"]["value"] > 0


def test_the_exchange_left_out_fails(tmp_path, monkeypatch):
    """Four slots: every share but the first slot's comes back as zeros."""
    from repro_torch.dp import sharding

    orig = sharding._gather

    def zeros_like(x):
        if isinstance(x, (tuple, list)):
            return type(x)(zeros_like(y) for y in x)
        return torch.zeros_like(x)

    monkeypatch.setattr(sharding, "_gather",
                        lambda outs, slots, home: orig([outs[0]] + [zeros_like(o) for o in outs[1:]],
                                                       slots, home))
    tree = make_tree(tmp_path, chips=4, clients=32)
    result, _ = run(tree)
    assert result["correct"] is False


def test_a_sound_run_passes_on_several_seeds(tiny_tree):
    for seed in (0, 17, 2 ** 31 + 3):
        result, _ = run(tiny_tree, seed)
        assert result["correct"] is True
        assert all(c["value"] == 0 for c in result["check"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["sdp_stream.single", "sdp_onchip.batched"])
def test_the_control_fails_at_the_cells_sizes(cuda, workload):
    """On the card, at the cell's own size and sample, on three seeds."""
    from bench import control

    for seed in (1, 2, 3):
        r = control.readings(workload, seed, cuda)
        assert r["numbers"]["table_gap"] > r["limits"]["table_gap"]
