"""The port's planners (``repro_torch.core.planner``, numpy) against
``repro.core.planner``: the same plans, and a chain contracted on tensors
in the planned order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as jplanner  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402

CHAINS = [[(10, 100), (100, 5), (5, 50)],
          [(100, 10), (10, 100), (100, 10)],
          [(64, 512), (512, 16), (16, 256), (256, 32)],
          [(8, 32), (32, 4), (4, 64), (64, 16), (16, 3)]]


@pytest.mark.parametrize("shapes", CHAINS)
def test_plan_chain_equals_the_reference(shapes):
    got, want = tplanner.plan_chain(shapes), jplanner.plan_chain(shapes)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.flops <= got.naive_flops


def test_plan_chain_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="chain mismatch"):
        tplanner.plan_chain([(2, 3), (4, 5)])


def test_contract_chain_matches_direct_product():
    rng = np.random.default_rng(0)
    shapes = CHAINS[3]
    mats = [torch.tensor(rng.normal(size=s), dtype=torch.float64) for s in shapes]
    out = tplanner.contract_chain(mats, tplanner.plan_chain(shapes))
    direct = mats[0] @ mats[1] @ mats[2] @ mats[3] @ mats[4]
    torch.testing.assert_close(out, direct, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("costs,stages", [([1, 1, 1, 9, 1, 1, 1, 9], 2),
                                          ([1, 1, 1, 9, 1, 1, 1, 9], 4),
                                          ([3, 4, 5], 1),
                                          ([5, 1, 7, 2, 2, 8, 1], 3)])
def test_partition_stages_equals_the_reference(costs, stages):
    assert tplanner.partition_stages(costs, stages) == \
        jplanner.partition_stages(costs, stages)


def test_plan_remat_equals_the_reference():
    act, rec = [100.0, 100.0, 100.0, 100.0], [1.0, 50.0, 2.0, 50.0]
    mask, stored, extra = tplanner.plan_remat(act, rec, budget=250.0)
    jmask, jstored, jextra = jplanner.plan_remat(act, rec, budget=250.0)
    np.testing.assert_array_equal(mask, jmask)
    assert (stored, extra) == (jstored, jextra) == (200.0, 3.0)
