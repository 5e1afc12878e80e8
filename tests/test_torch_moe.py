"""The port's MoE block (``repro_torch.models.moe``) against ``repro``'s on the
same inputs and weights (CPU, float32, the reduced granite-moe and arctic
configs).

Three regimes: drop-free (``capacity_factor = n_experts``), heavy drops
(``capacity_factor = 0.05``: the same (token, k) assignments are dropped,
so the same rows are zeroed), and a router whose columns are equal in pairs,
so that every token's probabilities tie exactly and the experts chosen must
be ``lax.top_k``'s (the lower expert first). Outputs agree within
``OUT_TOL`` = 1e-5 and ``aux`` within 1e-6.

Routing is discrete: where a seed's router put two experts' probabilities
within ``MARGIN`` = 1e-5 of each other at the top-k boundary, a last-bit
difference in the router product could pick another expert. The tests
assert that margin (and report it) instead of changing the seed.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

OUT_TOL, AUX_TOL, MARGIN = 1e-5, 1e-6, 1e-5
ARCHS = ("granite-moe-3b-a800m", "arctic-480b")


def _cfgs(arch, capacity_factor=None):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _params(jcfg, rng, tied: bool) -> dict:
    """numpy weights by ``moe_defs``' shapes. ``tied``: small integers in the
    router and the tokens, so the router product is exact, and the router's
    columns equal in pairs (expert 2i and 2i + 1)."""
    out = {}
    for name, d in jmoe.moe_defs(jcfg).items():
        out[name] = (rng.normal(size=d.shape) * 0.1).astype(np.float32)
    if tied:
        r = rng.integers(-2, 3, size=out["router"].shape).astype(np.float32)
        r[:, 1::2] = r[:, 0::2]
        out["router"] = r * 0.25
    return out


def _run(arch, regime, b=2, t=13, seed=0):
    cf = {"dropfree": None, "drops": 0.05, "tied": None}[regime]
    jcfg, tcfg = _cfgs(arch, cf)
    if regime == "dropfree":
        jcfg, tcfg = _cfgs(arch, float(jcfg.moe.n_experts))
    rng = np.random.default_rng(seed)
    p = _params(jcfg, rng, tied=regime == "tied")
    if regime == "tied":
        x = rng.integers(-3, 4, size=(b, t, jcfg.d_model)).astype(np.float32)
    else:
        x = (rng.normal(size=(b, t, jcfg.d_model)) * 0.5).astype(np.float32)
    want, want_aux = jax.jit(functools.partial(jmoe.moe_forward, cfg=jcfg))(
        {k: jnp.asarray(v) for k, v in p.items()}, x=jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, got_aux = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    return jcfg, p, x, (np.asarray(want), float(want_aux)), (got.numpy(), float(got_aux))


def _probs(p, x):
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ p["router"].astype(np.float64)
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return z / z.sum(-1, keepdims=True)


def _top_k_margin(probs, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th probability of a token."""
    s = -np.sort(-probs, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if probs.shape[-1] > k else np.inf


@pytest.mark.parametrize("b,t", [(2, 13), (1, 40), (5, 1)])
@pytest.mark.parametrize("regime", ["dropfree", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, regime, b, t):
    jcfg, p, x, (want, want_aux), (got, got_aux) = _run(arch, regime, b, t, seed=b * t)
    margin = _top_k_margin(_probs(p, x), jcfg.moe.top_k)
    assert margin > MARGIN, f"seed's router ties within {margin} at the top-k boundary"
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    assert abs(got_aux - want_aux) <= AUX_TOL
    if regime == "drops" and not jcfg.moe.dense_residual:
        # every assignment of a zeroed row was dropped: the same rows
        zero_got = np.flatnonzero(~got.reshape(-1, x.shape[-1]).any(-1))
        zero_want = np.flatnonzero(~want.reshape(-1, x.shape[-1]).any(-1))
        assert zero_got.tolist() == zero_want.tolist()
        n = b * t
        if n * jcfg.moe.top_k > tmoe.capacity(n, jcfg) * jcfg.moe.n_experts:
            assert len(zero_got) > 0        # capacity cannot hold every assignment


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_tied_router_picks_the_lower_expert(arch):
    """Equal router columns: every token's probabilities tie in pairs,
    exactly; the experts chosen (hence the outputs) are ``lax.top_k``'s."""
    jcfg, p, x, (want, want_aux), (got, got_aux) = _run(arch, "tied", seed=3)
    probs = _probs(p, x)
    np.testing.assert_array_equal(probs[:, 0::2], probs[:, 1::2])
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    assert abs(got_aux - want_aux) <= AUX_TOL
    tp32 = torch.from_numpy(probs.astype(np.float32))
    _, want_e = jax.lax.top_k(jnp.asarray(probs.astype(np.float32)), jcfg.moe.top_k)
    _, got_e = tmoe.top_k(tp32, jcfg.moe.top_k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert (got_e[:, 0] % 2 == 0).all()        # the lower of each tied pair


@pytest.mark.parametrize("row,k", [
    ([0.1, .3, .3, .3, 0, .3], 3), ([0.5, 0.5, 0.5, 0.5], 2), ([1.0, 2.0, 2.0, 1.0], 3),
    ([0.0, 0.0, 0.0], 1), ([0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1], 8)])
def test_top_k_orders_ties_as_lax_top_k(row, k):
    a = np.asarray(row, np.float32)[None]
    want_v, want_i = jax.lax.top_k(jnp.asarray(a), k)
    got_v, got_i = tmoe.top_k(torch.from_numpy(a), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_capacity_matches_reference():
    for arch in (*ARCHS, "jamba-1.5-large-398b"):
        for cf in (None, 0.05, 1.0, 16.0):
            for full in (True, False):
                jcfg, tcfg = _cfgs(arch, cf)
                if full:
                    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
                        c.moe, **({} if cf is None else {"capacity_factor": cf})))
                        for c in (jconfigs.get_config(arch), tconfigs.get_config(arch)))
                for n in (1, 4, 7, 64, 300, 2000, 4096):
                    assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg), (arch, cf, n)


def test_decode_capacity_counts_every_slot():
    """A decode batch of 16 rows that all route alike (one token repeated):
    capacity counts all 16 (idle engine slots take capacity too), so at
    ``capacity_factor = 0.05`` an expert keeps 8 of them and the other 8
    rows lose that assignment, as in the reference."""
    arch = "granite-moe-3b-a800m"
    jcfg, tcfg = _cfgs(arch, 0.05)
    rng = np.random.default_rng(11)
    p = _params(jcfg, rng, tied=False)
    row = (rng.normal(size=(1, 1, jcfg.d_model)) * 0.5).astype(np.float32)
    x = np.repeat(row, 16, axis=0)                     # (16, 1, d): one decode step
    assert tmoe.capacity(16, tcfg) == 8
    want, _ = jax.jit(functools.partial(jmoe.moe_forward, cfg=jcfg))(
        {k: jnp.asarray(v) for k, v in p.items()}, x=jnp.asarray(x))
    stats = {}
    got, _ = tmoe.moe_forward({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                              torch.from_numpy(x), stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)
    assert stats["assigned"] == 16 * tcfg.moe.top_k
    assert int(stats["dropped"]) == 8 * tcfg.moe.top_k
    out = got.numpy()[:, 0]
    assert not out[8:].any() and out[:8].any()         # rows 8..15 lost both


def test_defs_match_reference():
    for arch in ARCHS + ("jamba-1.5-large-398b",):
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        want, got = jmoe.moe_defs(jcfg), tmoe.moe_defs(tcfg)
        assert list(got) == list(want)
        for name, d in want.items():
            assert (got[name].shape, got[name].init, got[name].scale) == (d.shape, d.init, d.scale)


def test_combine_is_the_in_order_sum_in_the_compute_dtype():
    """bf16 compute: the combine rounds after each of a token's k adds, from
    zeros, as the reference's scatter-add; two calls give equal bits."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(5)
    p = _params(jcfg, rng, tied=False)
    x = (rng.normal(size=(2, 9, jcfg.d_model)) * 0.5).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    a, _ = tmoe.moe_forward(tp, tcfg, tx)
    b, _ = tmoe.moe_forward(tp, tcfg, tx)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    want, _ = jax.jit(functools.partial(jmoe.moe_forward, cfg=jcfg))(
        {k: jnp.asarray(v) for k, v in p.items()}, x=jnp.asarray(x, jnp.bfloat16))
    # bf16 products on two libraries round apart by a unit or two
    np.testing.assert_allclose(a.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)
