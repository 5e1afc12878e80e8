"""The frozen work count: a function of the instance alone."""
import inspect
import json

import numpy as np
import pytest

from bench import readers, roofline
from bench.problems import sdp
from bench.tests.conftest import ROOT


def test_work_depends_only_on_the_spec():
    params = list(inspect.signature(roofline.sdp_work).parameters)
    assert params == ["n", "offsets", "weighted", "with_args"]


@pytest.mark.parametrize("n,k", [(2 ** 20, 8192), (2 ** 23, 8192), (2 ** 20, 1024), (4096, 16)])
def test_work_by_hand(n, k):
    offs = sdp.offsets({"k": k})
    nbytes, ops = roofline.sdp_work(n, offs, False, True)
    assert nbytes == 4 * (2 * k + k + 2 * n)
    assert ops == (n - 2 * k) * (k - 1)
    assert roofline.sdp_work(n, offs, False, False)[0] == 4 * (3 * k + n)
    wb, wo = roofline.sdp_work(n, offs, True, True)
    assert wb == nbytes + 4 * n * k and wo == ops + (n - 2 * k) * k


def test_the_cells_are_bound_by_operations():
    for name in ("sdp_onchip", "sdp_stream"):
        config = json.loads((ROOT / "bench/configs" / f"{name}.json").read_text())
        nbytes, ops = sdp.work(config)
        secs, which = roofline.bound_s(nbytes, ops)
        assert which == "operations" and secs == pytest.approx(ops / 67e12)
    assert roofline.bound_s(3.35e12, 1.0) == (1.0, "bytes")


def test_same_instance_same_work_on_every_route():
    """Two routes of the port solve the same instance to the same table;
    the work counted for it cannot tell them apart."""
    from repro_torch import dp

    config = {"n": 512, "k": 8, "op": "min"}
    (p,) = sdp.draw(config, np.random.default_rng(1), 1)
    tables = [dp.solve("sdp", backend=b, device="cpu", **p) for b in ("blocked", "sequential")]
    np.testing.assert_array_equal(tables[0], tables[1])
    assert sdp.work(config) == roofline.sdp_work(512, p["offsets"], False, True)


@pytest.mark.parametrize("name,kernel", [
    ("void sdp_walk::walk_kernel<0, false, true, true>(sdp_walk::Args)", "sdp_chunked"),
    ("void sdp_walk::walk_kernel<0, false, true, false>(sdp_walk::Args)", "sdp_pipeline"),
    ("walk_kernel<1,true,false,false>", "sdp_pipeline"),
    ("void at::native::elementwise_kernel<128, 2>(int)", None),
    ("Memcpy DtoH (Device -> Pageable)", None),
])
def test_kernel_names(name, kernel):
    assert readers.kernel_of(name) == kernel
