"""K7's gradient on the CPU: the plain backward
(``flash_attention_backward_plain``, K7b's function) and the
``FlashAttention`` autograd Function against ``jax.grad`` of
``repro.kernels.ops.flash_attention`` (on the CPU its path is
``_flash_ref_chunked``, an online softmax over KV chunks differentiated by
JAX), the log-sum-exp contract, and ``gradcheck`` in float64.

Float32 gradients agree within ``GRAD_TOL`` = 1e-5 of each gradient's max
|value| (taken as at least 1): the same function, float32 sums in another
order (measured ~1e-6). The log-sum-exp within 1e-5 absolute of
``torch.logsumexp`` over the masked, scaled logits in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

GRAD_TOL, LSE_TOL = 1e-5, 1e-5


def _inputs(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal):
    f = lambda q, k, v: jnp.sum(jops.flash_attention(q, k, v, causal=causal) * do)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= GRAD_TOL * scale, (err, scale)


CASES = [(hq, hkv, sq, sk, causal)
         for hq, hkv in ((2, 2), (4, 2), (4, 1))
         for sq, sk in ((1, 1), (37, 37), (130, 130), (1, 37), (37, 130))
         for causal in (True, False)]


@pytest.mark.parametrize("hq,hkv,sq,sk,causal", CASES)
def test_plain_backward_and_autograd_match_jax_grad(hq, hkv, sq, sk, causal):
    """GQA 1, 2 and 4; S 1, 37, 130 with Sq <= Sk; causal and not: the
    plain backward on the plain forward's (o, lse), and the gradients that
    autograd takes through ``ops.flash_attention``, against JAX's."""
    q, k, v, do = _inputs(2, hq, hkv, sq, sk, 16, seed=hq * 1000 + sq + sk)
    want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = k7.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    for got, w in zip(k7.flash_attention_backward_plain(tq, tk, tv, o, lse, tdo, causal), want):
        _close(got, w)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), o.numpy(), rtol=0, atol=0)
    for got, w in zip(torch.autograd.grad(out, leaves, tdo), want):
        _close(got, w)


@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (37, 37, True), (20, 130, True),
                                          (37, 600, False), (600, 600, True)])
def test_log_sum_exp_contract(sq, sk, causal):
    """``lse[b, h, i] = log Σ_j exp(q_i·k_j / sqrt(D))`` in natural log over
    the keys row i sees (float32, (B, Hq, Sq)); its KV chunks of 512 (600
    keys: a ragged second chunk) do not change ``o``."""
    q, k, v, _ = _inputs(1, 4, 2, sq, sk, 24, seed=sq + sk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = k7.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 4, sq)
    assert torch.equal(o, k7.flash_attention_plain(tq, tk, tv, causal=causal))
    ke = k7.gqa_broadcast(tk, 4).double()
    logits = tq.double() @ ke.transpose(-1, -2) / np.sqrt(24)
    if causal:
        mask = torch.arange(sq)[:, None] + (sk - sq) >= torch.arange(sk)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    want = torch.logsumexp(logits, dim=-1)
    assert float((lse.double() - want).abs().max()) <= LSE_TOL


def test_gradcheck_float64():
    """``torch.autograd.gradcheck`` through ``FlashAttention`` on a tiny
    GQA case in float64 (the plain versions keep float64), causal with
    Sq < Sk and not."""
    rng = np.random.default_rng(0)
    for causal, sq in ((True, 5), (False, 7)):
        q = torch.from_numpy(rng.standard_normal((1, 4, sq, 3))).requires_grad_()
        k = torch.from_numpy(rng.standard_normal((1, 2, 7, 3))).requires_grad_()
        v = torch.from_numpy(rng.standard_normal((1, 2, 7, 3))).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda q, k, v: k7.FlashAttention.apply(q, k, v, causal), (q, k, v))


def test_serving_calls_skip_the_autograd_function(monkeypatch):
    """Without a gradient to take (no input requires one, or under
    ``no_grad``) ``flash_attention`` is the serving call: no
    ``FlashAttention``, no log-sum-exp."""
    def refuse(*args):
        raise AssertionError("FlashAttention on a serving call")

    monkeypatch.setattr(k7.FlashAttention, "apply", refuse)
    q, k, v, _ = _inputs(1, 2, 1, 9, 9, 8, seed=0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = k7.flash_attention_plain(tq, tk, tv)
    assert torch.equal(ops.flash_attention(tq, tk, tv), want)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(tq.requires_grad_(), tk, tv), want)


def test_backward_launcher_checks_before_building():
    """K7b's launcher refuses what its kernels do not take before any
    build: a head dim past ``MAX_BWD_HEAD_DIM``, an o of another shape, a
    non-contiguous log-sum-exp."""
    q = torch.zeros((1, 2, 8, 200))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="head dim 200"):
        k7._launch_backward(q, q, q, q, lse, q, True)
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="must have q's shape"):
        k7._launch_backward(q, q, q, q[:, :, :4], lse, q, True)
    with pytest.raises(ValueError, match="contiguous float32"):
        k7._launch_backward(q, q, q, q, torch.zeros((1, 8, 2)).transpose(1, 2), q, True)


@pytest.mark.parametrize("scale", [None, 0.3, 1.0])
def test_attention_ref_scale_matches_reference(scale):
    """``ref.attention_ref(scale=)`` against the reference's oracle (its
    default scale divides by sqrt(D))."""
    q, k, v, _ = _inputs(1, 2, 2, 11, 11, 8, seed=5)
    got = tref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, scale=scale)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
