"""The port's schedule models against ``repro``'s: the families' dependency
models on every probe, the plain routes' schedule models field by field,
and the skewed pipeline schedule."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.schedule import SkewedSchedule as RefSkewed  # noqa: E402
from repro.dp import backends as ref_backends  # noqa: E402
from repro.dp import schedule as ref_schedule  # noqa: E402
from repro.dp.problem import FAMILIES as REF_FAMILIES  # noqa: E402

from repro_torch.core.schedule import SkewedSchedule  # noqa: E402
from repro_torch.dp import backends  # noqa: E402
from repro_torch.dp import schedule as S  # noqa: E402
from repro_torch.dp.problem import FAMILIES  # noqa: E402

CPU = torch.device("cpu")
#: the routes whose schedules are the reference's (the kernel routes
#: describe the Hopper kernels instead, tests/test_torch_analysis.py)
PLAIN_ROUTES = {
    "linear": ("sequential", "tournament", "pipeline", "blocked", "companion_scan"),
    "triangular": ("wavefront", "mcm_pipeline", "blocked_mcm"),
    "grid": ("grid_wavefront",),
}


def _probe_pairs(family: str) -> list:
    ours, theirs = FAMILIES[family].probe_specs(), REF_FAMILIES[family].probe_specs()
    assert len(ours) == len(theirs)
    return list(zip(ours, theirs))


def _fields(model) -> dict:
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}


@pytest.mark.parametrize("family", sorted(PLAIN_ROUTES))
def test_probe_dependency_models_equal_the_reference(family):
    for ours, theirs in _probe_pairs(family):
        assert ours.shape_key() == theirs.shape_key()
        a, b = ours.schedule_model(), theirs.schedule_model()
        assert (a.label, a.cells, a.preset, a.candidates) == \
            (b.label, b.cells, b.preset, b.candidates)


@pytest.mark.parametrize("family,route", [(f, r) for f, rs in sorted(PLAIN_ROUTES.items())
                                          for r in rs])
def test_plain_route_schedules_equal_the_reference(family, route):
    """Field by field, on every probe both sides' routes support."""
    ours_b, theirs_b = backends.get(route), ref_backends.get(route)
    compared = 0
    for ours, theirs in _probe_pairs(family):
        if not (ours_b.supports(ours, CPU) and theirs_b.supports(theirs)):
            assert ours_b.supports(ours, CPU) == theirs_b.supports(theirs)
            continue
        (model,) = ours_b.schedule(ours, CPU)
        assert _fields(model) == _fields(theirs_b.schedule(theirs)), (route, ours.shape_key())
        compared += 1
    assert compared, f"no probe exercises {route}"


@pytest.mark.parametrize("n", [4, 5, 6])
@pytest.mark.parametrize("order", ["paper", "safe"])
def test_mcm_pipeline_both_orders_equal_the_reference(n, order):
    from repro_torch.core.mcm import mcm_weight_fn, weight_table
    from repro.core import mcm as ref_mcm
    from repro.dp.problem import TriangularSpec as RefTri
    from repro_torch.dp.problem import TriangularSpec

    dims = np.arange(1.0, n + 2.0)
    ours = TriangularSpec(n=n, weights=weight_table(n, mcm_weight_fn(dims)), dims=dims)
    theirs = RefTri(n=n, weights=ref_mcm.weight_table(n, ref_mcm.mcm_weight_fn(dims)),
                    dims=dims)
    assert _fields(S.mcm_pipeline_schedule(ours, order=order)) == \
        _fields(ref_schedule.mcm_pipeline_schedule(theirs, order=order))


@pytest.mark.parametrize("items,stages", [(1, 1), (5, 3), (3, 5), (64, 8), (8, 64)])
def test_skewed_schedule_equals_the_reference(items, stages):
    ours, theirs = SkewedSchedule(items, stages), RefSkewed(items, stages)
    assert ours.num_steps == theirs.num_steps
    np.testing.assert_array_equal(ours.occupancy(), theirs.occupancy())
    assert ours.utilization() == theirs.utilization()
    for step in (0, stages - 1, ours.num_steps - 1):
        np.testing.assert_array_equal(ours.items_at(step).numpy(),
                                      np.asarray(theirs.items_at(step)))
        np.testing.assert_array_equal(ours.active_at(step).numpy(),
                                      np.asarray(theirs.active_at(step)))
        np.testing.assert_array_equal(ours.np_active_at(step), theirs.np_active_at(step))
