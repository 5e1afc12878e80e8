"""The port's training path against ``repro`` on the same weights and
inputs (CPU, reduced configs, float32): ``loss_fn`` and its gradients
through every block kind (K7's gradient by its plain backward), the
chunked cross-entropy, the frontend stubs, and the train step.

Weights are the reference's ``init_params`` carried across by
``params_from_reference``; batches are numpy arrays handed to both. The
loss agrees within ``LOSS_RTOL`` = 1e-5 relative, each gradient within
``GRAD_TOL`` = 1e-4 of its own max |value| (float32 sums in another order,
the attention's gradient by the explicit backward against JAX's autodiff
of the chunked online softmax). Three ``build_step`` steps give losses
within ``STEP_RTOL`` = 1e-4 relative (AdamW's update rounds per
parameter; XLA contracts some of its products into FMAs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_flat  # noqa: E402

LOSS_RTOL, GRAD_TOL, STEP_RTOL = 1e-5, 1e-4, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b: int, t: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_frontend_tokens:
        out["frontend"] = (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                           .astype(np.float32) * 0.1)
    return out


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_loss_and_gradients_match_reference(arch):
    """Every reduced config: ``loss_fn`` and every parameter's gradient
    against ``jax.value_and_grad(repro.models.model.loss_fn)`` (remat on in
    both, the MoE aux loss included)."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(tcfg, 2, 16, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_reference(_np(params), tcfg, "cpu")
    own = dict(model.named_parameters())
    for p in own.values():
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(model, to_device(batch, "cpu"))
    grads = dict(zip(own, torch.autograd.grad(loss, list(own.values()))))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(metrics["aux"]) == pytest.approx(float(jm["aux"]), rel=LOSS_RTOL, abs=1e-7)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    want = reference_flat(_np(jgrads), tcfg)
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = np.asarray(want[name], np.float32)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= GRAD_TOL * scale, f"{arch} {name}: {err} vs max {scale}"


@pytest.mark.parametrize("t,chunk", [(32, 8), (24, 24), (16, 64)])
def test_chunked_xent_matches_reference_on_ragged_masks(t, chunk):
    """``chunked_xent`` (sum and count) against the reference's, masks
    with ragged runs of zeros, and its gradients through the checkpointed
    chunks against JAX's."""
    rng = np.random.default_rng(t)
    b, d, v = 2, 12, 40
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32) * 0.3
    labels = rng.integers(0, v, size=(b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.3).astype(np.float32)
    mask[0, t // 2:] = 0.0
    jf = lambda h, ww: jmodel.chunked_xent(h, ww, jnp.asarray(labels), jnp.asarray(mask), chunk)
    (jtot, jcnt) = jf(jnp.asarray(hidden), jnp.asarray(w))
    jgh, jgw = jax.grad(lambda h, ww: jf(h, ww)[0], argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tot, cnt = tmodel.chunked_xent(th, tw, torch.from_numpy(labels).long(),
                                   torch.from_numpy(mask), chunk)
    assert float(tot) == pytest.approx(float(jtot), rel=1e-6)
    assert float(cnt) == float(jcnt) == float(mask.sum())
    gh, gw = torch.autograd.grad(tot, (th, tw))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["internvl2-76b", "musicgen-large"])
def test_frontend_replaces_prefix_and_masks_loss(arch):
    """The reference's test on the port: the frontend embeddings overwrite
    the first ``n_frontend_tokens`` positions (prefill logits depend on
    them, equal to the reference's), and the default loss mask drops them."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_reference(_np(params), tcfg, "cpu")
    b, t = 2, 24
    batch = _batch(tcfg, b, t, seed=3)
    loss, metrics = tmodel.loss_fn(model, to_device(batch, "cpu"))
    assert np.isfinite(float(loss))
    assert float(metrics["tokens"]) == b * (t - tcfg.n_frontend_tokens)
    toks = torch.from_numpy(batch["tokens"]).long()
    fe = torch.from_numpy(batch["frontend"])
    x = model.embed_tokens(toks, fe)
    assert torch.equal(x[:, :tcfg.n_frontend_tokens], fe)
    assert torch.equal(x[:, tcfg.n_frontend_tokens:], model.embed_tokens(toks)[:, tcfg.n_frontend_tokens:])
    got, _ = model.prefill(toks, frontend=fe, cache_dtype=torch.float32)
    want, _ = jmodel.prefill(params, jcfg, jnp.asarray(batch["tokens"]),
                             frontend=jnp.asarray(batch["frontend"]), cache_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain, _ = model.prefill(toks, cache_dtype=torch.float32)
    assert not torch.allclose(plain, got)


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m"])
def test_build_step_matches_reference_for_three_steps(arch):
    """Three ``build_step`` steps (AdamW, warmup-cosine) from the same
    weights on the same batches: every step's loss, xent, grad norm and lr
    within ``STEP_RTOL`` of the reference's jitted step."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jstep = jtrain.build_step(jcfg, 1e-3, 20)
    jstate = (params, jadamw.init(params))
    model = params_from_reference(_np(params), tcfg, "cpu")
    tstep = ttrain.build_step(model, tcfg, 1e-3, 20)
    tstate = ttrain.init_state(model)
    for i in range(3):
        batch = _batch(tcfg, 2, 16, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, to_device(batch, "cpu"))
        for key in ("loss", "xent", "grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=STEP_RTOL), (i, key)
    assert int(tstate[1]["step"]) == 3


def test_train_mode_launches_k7_twice_a_layer_under_remat(monkeypatch):
    """With ``cfg.remat`` the forward and the recompute each call K7's
    forward once a layer and the backward calls K7b once; without remat the
    forward alone does (counted through the autograd Function's hooks)."""
    from repro_torch.kernels import flash_attention as k7

    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = k7.flash_attention_plain, k7.flash_attention_backward_plain

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return plain_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return plain_bwd(*a, **kw)

    monkeypatch.setattr(k7, "flash_attention_plain", fwd)
    monkeypatch.setattr(k7, "flash_attention_backward_plain", bwd)
    base = tconfigs.get_config("phi3-mini-3.8b").reduced()
    for remat, want_fwd in ((True, 2), (False, 1)):
        cfg = dataclasses.replace(base, remat=remat)
        model = tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu")
        state = ttrain.init_state(model)
        calls.update(fwd=0, bwd=0)
        ttrain.build_step(model, cfg, 1e-3, 10)(state, to_device(_batch(cfg, 2, 16, 0), "cpu"))
        assert calls == {"fwd": want_fwd * cfg.n_layers, "bwd": cfg.n_layers}, remat
