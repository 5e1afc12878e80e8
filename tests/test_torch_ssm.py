"""The port's SSM mixers (``repro_torch.models.ssm``) against ``repro``'s on
the same inputs (CPU, float32).

``chunked_gla`` is held against ``jax.jit`` of the reference's
``chunked_gla`` and the port's step-by-step ``gla_reference`` against both
of the reference's functions, within the reference's own bound (atol and
rtol 1e-4, ``tests/test_models.py``). Where a chunk's cumulative log decay
passes -30 the reference's clamp moves its ``chunked_gla`` off its own
oracle; the port computes the decay pairwise and stays with the oracle
(``test_chunked_gla_exact_where_the_reference_clamp_bites``). The mixers,
with the states they return, agree within ``MIXER_TOL`` = 1e-5 (float32,
sums in another order; measured under 1e-6).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

GLA_TOL, MIXER_TOL = 1e-4, 1e-5

_jit_gla = jax.jit(jssm.chunked_gla, static_argnames=("chunk", "mode"))
_jit_gla_ref = jax.jit(jssm.gla_reference, static_argnames=("mode",))


def _pair(a):
    """numpy float32 -> (jnp array, torch tensor) holding the same values."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _gla_inputs(t, scalar, seed):
    rng = np.random.default_rng(seed)
    b, h, k, v = 2, 3, 8, 5
    q = rng.normal(size=(b, t, h, k))
    kk = rng.normal(size=(b, t, h, k))
    vv = rng.normal(size=(b, t, h, v))
    ld = -np.abs(rng.normal(size=(b, t, h) if scalar else (b, t, h, k))) * 0.7
    h0 = rng.normal(size=(b, h, k, v)) * 0.3
    u = np.abs(rng.normal(size=(h, k))) * 0.5
    return [_pair(a) for a in (q, kk, vv, ld, h0, u)]


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "vector"])
@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("t", [1, 7, 16, 33])
def test_chunked_gla_matches_reference(t, chunk, scalar, mode):
    args = _gla_inputs(t, scalar, seed=1000 * t + 10 * chunk + scalar)
    (jq, tq), (jk, tk), (jv, tv), (jl, tl), (jh, th), (ju, tu) = args
    want_y, want_h = _jit_gla(jq, jk, jv, jl, jh, chunk=chunk, mode=mode, u=ju)
    ref_y, ref_h = _jit_gla_ref(jq, jk, jv, jl, jh, mode=mode, u=ju)
    got_y, got_h = tssm.chunked_gla(tq, tk, tv, tl, th, chunk=chunk, mode=mode, u=tu)
    assert got_y.shape == (2, t, 3, 5) and got_h.shape == (2, 3, 8, 5)
    _close(got_y, want_y, GLA_TOL)
    _close(got_h, want_h, GLA_TOL)
    step_y, step_h = tssm.gla_reference(tq, tk, tv, tl, th, mode=mode, u=tu)
    for want in ((ref_y, ref_h), (want_y, want_h)):
        _close(step_y, want[0], GLA_TOL)
        _close(step_h, want[1], GLA_TOL)


@pytest.mark.parametrize("case", ["rwkv6-init", "fast-scalar"])
def test_chunked_gla_exact_where_the_reference_clamp_bites(case):
    """A chunk whose cumulative log decay passes -30: the reference clamps
    ``-L`` at 30 (``ssm.py:80``) and its ``chunked_gla`` leaves its own
    step-by-step oracle at the chunk's last positions; the port's stays
    with the oracle (no clamp: pairwise decay differences). Where the clamp
    is idle, the port equals the reference's ``chunked_gla``."""
    rng = np.random.default_rng(3)
    if case == "rwkv6-init":      # w = exp(-exp(ŵ)), ŵ ~ 0.09·N: ~-1 a step
        b, t, h, k, v, chunk, mode = 1, 96, 2, 8, 8, 32, "bonus"
        ld = -np.exp(rng.normal(size=(b, t, h, k)) * 0.09)
    else:
        b, t, h, k, v, chunk, mode = 1, 16, 2, 4, 3, 8, "inclusive"
        ld = np.full((b, t, h), -6.0)
    args = [rng.normal(size=s) * 0.3 for s in ((b, t, h, k), (b, t, h, k))]
    args += [rng.normal(size=(b, t, h, v)), ld, rng.normal(size=(b, h, k, v)),
             rng.normal(size=(h, k)) * 0.5]
    (jq, tq), (jk, tk), (jv, tv), (jl, tl), (jh, th), (ju, tu) = [_pair(a) for a in args]
    ref_y, _ = _jit_gla(jq, jk, jv, jl, jh, chunk=chunk, mode=mode, u=ju)
    oracle_y, oracle_h = _jit_gla_ref(jq, jk, jv, jl, jh, mode=mode, u=ju)
    got_y, got_h = tssm.chunked_gla(tq, tk, tv, tl, th, chunk=chunk, mode=mode, u=tu)
    _close(got_y, oracle_y, GLA_TOL)
    _close(got_h, oracle_h, GLA_TOL)
    ref_err = np.abs(np.asarray(ref_y) - np.asarray(oracle_y)).max(axis=(0, 2, 3))
    assert ref_err.max() > 0.05 * np.abs(np.asarray(oracle_y)).max()   # the clamp shows
    # positions whose in-chunk cumulative log decay stays above -30 (exclusive
    # for bonus mode): the clamp is idle there
    L = np.cumsum(ld.reshape(b, t // chunk, chunk, *ld.shape[2:]), axis=2).reshape(ld.shape)
    if mode == "bonus":
        L = np.concatenate([np.zeros_like(L[:, :1]), L[:, :-1]], axis=1)
        L[:, ::chunk] = 0.0
    idle = (L.reshape(b, t, -1).min(axis=(0, 2)) > -29.0)
    assert idle.any() and not idle.all()
    _close(got_y[:, idle], np.asarray(ref_y)[:, idle], GLA_TOL)


# ---------------------------------------------------------------------------
# the mixers with their states
# ---------------------------------------------------------------------------
def _random_params(defs, rng) -> dict:
    """Values for a defs dict of either package, seeded: ``ones`` near 1,
    everything else normal at its scale (zeros at 0.3, so the mixes,
    biases and ``a_log`` are not all 0)."""
    out = {}
    for name, d in defs.items():
        if d.init == "ones":
            out[name] = 1.0 + 0.1 * rng.normal(size=d.shape)
        else:
            out[name] = rng.normal(size=d.shape) * (0.3 if d.init == "zeros" else d.scale * 4)
    return out


def _mixer_case(arch, which, seed):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    defs = {"mamba": jssm.mamba_defs, "rwkv6": jssm.rwkv_defs,
            "rwkv_cm": jssm.rwkv_cm_defs}[which](jcfg)
    raw = _random_params(defs, np.random.default_rng(seed))
    pairs = {k: _pair(v) for k, v in raw.items()}
    return (jcfg, {k: j for k, (j, _) in pairs.items()},
            tcfg, {k: t for k, (_, t) in pairs.items()})


def _state_pair(cfg, which, b, rng):
    s = cfg.ssm
    h = rng.normal(size=(b, s.n_heads, s.d_state, s.d_head)) * 0.3
    state = {"h": h}
    if which == "rwkv6":
        state["x_prev"] = rng.normal(size=(b, 1, cfg.d_model))
    pairs = {k: _pair(v) for k, v in state.items()}
    return {k: j for k, (j, _) in pairs.items()}, {k: t for k, (_, t) in pairs.items()}


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "carried"])
@pytest.mark.parametrize("t", [1, 5, 19])
@pytest.mark.parametrize("arch,which", [("jamba-1.5-large-398b", "mamba"),
                                        ("rwkv6-1.6b", "rwkv6")])
def test_mixer_and_new_state_match_reference(arch, which, t, with_state):
    jcfg, jp, tcfg, tp = _mixer_case(arch, which, seed=t)
    rng = np.random.default_rng(100 + t)
    jx, tx = _pair(rng.normal(size=(2, t, jcfg.d_model)))
    jstate, tstate = _state_pair(jcfg, which, 2, rng) if with_state else (None, None)
    jf = {"mamba": jssm.mamba_forward, "rwkv6": jssm.rwkv_forward}[which]
    tf = {"mamba": tssm.mamba_forward, "rwkv6": tssm.rwkv_forward}[which]
    want, want_state = jax.jit(functools.partial(jf, cfg=jcfg))(jp, x=jx, state=jstate)
    got, got_state = tf(tp, tcfg, tx, tstate)
    _close(got, want, MIXER_TOL)
    assert sorted(got_state) == sorted(want_state)
    for name in want_state:
        assert got_state[name].shape == want_state[name].shape
        _close(got_state[name], want_state[name], MIXER_TOL)


@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_channel_mix_matches_reference(t, carried):
    jcfg, jp, tcfg, tp = _mixer_case("rwkv6-1.6b", "rwkv_cm", seed=7 + t)
    rng = np.random.default_rng(t)
    jx, tx = _pair(rng.normal(size=(3, t, jcfg.d_model)))
    jprev, tprev = _pair(rng.normal(size=(3, 1, jcfg.d_model))) if carried else (None, None)
    want, want_prev = jax.jit(functools.partial(jssm.rwkv_cm_forward, cfg=jcfg))(
        jp, x=jx, x_prev=jprev)
    got, got_prev = tssm.rwkv_cm_forward(tp, tcfg, tx, tprev)
    _close(got, want, MIXER_TOL)
    _close(got_prev, want_prev, 0.0)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-1.6b"])
def test_empty_states_match_reference(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jf = {"mamba": jssm.mamba_empty_state, "rwkv6": jssm.rwkv_empty_state}[jcfg.ssm.kind]
    tf = {"mamba": tssm.mamba_empty_state, "rwkv6": tssm.rwkv_empty_state}[tcfg.ssm.kind]
    want, got = jf(jcfg, 3), tf(tcfg, 3)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).replace("torch.", "") == str(want[name].dtype)
        assert not got[name].any()


def test_defs_match_reference():
    for arch, fns in (("jamba-1.5-large-398b", ("mamba_defs",)),
                      ("rwkv6-1.6b", ("rwkv_defs", "rwkv_cm_defs"))):
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for fn in fns:
            want, got = getattr(jssm, fn)(jcfg), getattr(tssm, fn)(tcfg)
            assert list(got) == list(want)
            for name, d in want.items():
                g = got[name]
                assert (g.shape, g.init, g.scale) == (d.shape, d.init, d.scale), (fn, name)


def test_bf16_mixer_state_dtypes():
    """In bf16 compute the states keep the reference's dtypes: h float32,
    x_prev in the compute dtype; the output in the compute dtype."""
    cfg = dataclasses.replace(tconfigs.get_config("rwkv6-1.6b").reduced(),
                              compute_dtype=torch.bfloat16)
    _, _, _, tp = _mixer_case("rwkv6-1.6b", "rwkv6", seed=0)
    x = torch.randn((1, 9, cfg.d_model), generator=torch.Generator().manual_seed(0))
    out, st = tssm.rwkv_forward(tp, cfg, x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and st["x_prev"].dtype == torch.bfloat16
    assert st["h"].dtype == torch.float32 and torch.isfinite(out.float()).all()
