"""The plain reference against the port on tiny S-DP instances, and
against the recurrence written out cell by cell. The comparison lives
here: the reference never calls the port."""
import numpy as np
import pytest
import torch

from bench.problems import sdp

CPU = torch.device("cpu")


def recurrence(init, offs, op, n):
    """Definition 1 cell by cell, in float64."""
    st = list(np.asarray(init, np.float64)) + [0.0] * (n - len(init))
    fold = min if op == "min" else max
    for i in range(len(init), n):
        st[i] = fold(st[i - a] for a in offs)
    return np.asarray(st)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("offs,n", [((8, 7, 6, 5), 300), ((12, 9, 4, 1), 257), ((5,), 40)])
def test_reference_is_the_recurrence(op, offs, n):
    rng = np.random.default_rng(7)
    inits = rng.standard_normal((3, offs[0]), dtype=np.float32)
    got = sdp.reference_tables(inits, offs, op, n, CPU).numpy()
    for row, init in zip(got, inits):
        np.testing.assert_array_equal(row, recurrence(init, offs, op, n))


@pytest.mark.parametrize("k,n,batch", [(4, 200, 3), (16, 4096, 4), (33, 2000, 2)])
def test_reference_agrees_with_the_port_table_and_path(k, n, batch):
    """Through ``DPService(device="cpu")`` with ``reconstruct=True``: every
    table bit for bit, every witness chain (cells, offsets taken, terminal)
    equal."""
    from repro_torch import dp

    config = {"n": n, "k": k, "op": "min"}
    offs = sdp.offsets(config)
    payloads = sdp.draw(config, np.random.default_rng(k), batch)
    svc = dp.DPService(max_batch=batch, mesh=None, feedback=False, device="cpu")
    tids = [svc.submit("sdp", reconstruct=True, **p) for p in payloads]
    results = svc.run()
    inits = np.stack([p["init"] for p in payloads])
    ref = sdp.reference_tables(inits, offs, "min", n, CPU).numpy()
    for tid, want in zip(tids, ref):
        res = results[tid]
        np.testing.assert_array_equal(res.answer, want)
        assert res.solution.solution == sdp.walk(want, offs, "min")
    samples = [(p, results[t].answer, results[t].solution.solution)
               for p, t in zip(payloads, tids)]
    limits = {"table_gap": 0.0, "path_diffs": 0}
    assert sdp.compare(samples, config, CPU, limits) == {"table_gap": 0.0, "path_diffs": 0, "wrong": 0}


def test_walk_takes_the_first_offset_that_attains_the_optimum():
    offs = (4, 3)
    table = np.array([1.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0], np.float32)
    # cell 6 reads cells 2 and 3; cell 2 (offset 4) holds the minimum
    assert sdp.walk(table, offs, "min") == {"cells": [6], "offsets_taken": [4], "terminal": 2}
    table[2] = 0.0
    table[3] = 0.0
    # a tie: the first offset, the largest, wins
    assert sdp.walk(table, offs, "min")["offsets_taken"] == [4]


def test_draw_is_the_seed_and_distinct():
    config = {"n": 100, "k": 8, "op": "min"}
    a = sdp.draw(config, np.random.default_rng([5, 0, 0]), 4)
    b = sdp.draw(config, np.random.default_rng([5, 0, 0]), 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["init"], y["init"])
        assert x["init"].dtype == np.float32 and x["init"].shape == (16,)
    assert len({x["init"].tobytes() for x in a}) == 4
