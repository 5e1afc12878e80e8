"""What the sharded train step's tests share (``tests/test_torch_sharded_train*.py``):
the bounds, the meshes, the batches and the comparisons, and the body of
``test_sharded_step_matches_single``, whose cases are split by mesh into
files of their own (``test_torch_sharded_train_{1x4,2x2,1x3}.py``) so that
``pytest --dist loadfile`` spreads them over workers.

Bounds are the training test's (``tests/test_torch_train.py``): the loss
within ``LOSS_RTOL`` = 1e-5 relative, each gathered gradient within
``GRAD_TOL`` = 1e-4 of its own max |value| (float32; the sharded sums run
over the slots in another order: measured up to ~4e-6 of max |grad|), the
steps' loss, grad norm and lr within ``STEP_RTOL`` = 1e-4 relative, and
the parameters after two AdamW steps within ``STEP_RTOL`` of max |value|
of each. AdamW's first steps move an element by about lr whatever the
size of its gradient, so where a gradient lies within the sums' noise
(|g| at most ``GRAD_TOL`` of max |g| at either step) its sign, and so its
step, is not determined: those elements are held to the two steps' size
instead, ``NOISE_STEPS`` lr each (one element of ~10⁵ in a run, measured).

It imports ``torch`` and ``repro_torch`` only (no ``jax``, no ``repro``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tschedules

LOSS_RTOL, GRAD_TOL, STEP_RTOL = 1e-5, 1e-4, 1e-4
#: the most an element whose gradient is noise moves apart in one AdamW
#: step, in lr (one step of each sign, |m̂ / sqrt(v̂)| <= 1 on the first
#: steps)
NOISE_STEPS = 2.0
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "1x3": (1, 3)}
#: one config of each family, against the reference
FAMILIES = {"dense": "qwen3-14b", "moe": "granite-moe-3b-a800m", "ssm": "rwkv6-1.6b",
            "hybrid": "jamba-1.5-large-398b", "vlm": "internvl2-76b", "audio": "musicgen-large"}
B, T, LR, TOTAL = 4, 16, 1e-3, 20


def _mesh(data: int, model: int):
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


def _batch(cfg, seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, T + 1)).astype(np.int64)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_frontend_tokens:
        out["frontend"] = (rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
                           .astype(np.float32) * 0.1)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _opt_cfg(moment_dtype=torch.float32):
    return tadamw.AdamWConfig(lr=tschedules.warmup_cosine(LR, max(10, TOTAL // 20), TOTAL),
                              moment_dtype=moment_dtype)


def _single_grads(model, batch: dict) -> tuple:
    own = dict(model.named_parameters())
    for p in own.values():
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(own.values()), allow_unused=True)
    return float(loss), {n: torch.zeros_like(p) if g is None else g
                         for (n, p), g in zip(own.items(), grads)}


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w, np.float32)) if not isinstance(w, torch.Tensor) else w
        g = got[name].detach().float()
        assert g.shape == w.shape, (what, name)
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w.float()).abs().max())
        assert err <= tol * scale, f"{what} {name}: {err} vs max {scale}"


def _quiet(grads: dict, noise: dict) -> None:
    """Mark in ``noise`` each element whose gradient lies within the sums'
    noise (at most ``GRAD_TOL`` of max |g|)."""
    for n, g in grads.items():
        g = torch.as_tensor(np.asarray(g, np.float32)) if not isinstance(g, torch.Tensor) else g
        quiet = g.abs() <= GRAD_TOL * g.abs().max()
        noise[n] = quiet | noise[n] if n in noise else quiet


def _close_params(got: dict, want: dict, noise: dict, lrs: float) -> None:
    """Parameters after the steps: within ``STEP_RTOL`` of max |value|,
    the elements whose gradient was noise within ``NOISE_STEPS`` lr of
    each step."""
    assert set(got) == set(want)
    for n, w in want.items():
        w = torch.as_tensor(np.asarray(w, np.float32)) if not isinstance(w, torch.Tensor) else w
        err = (got[n].detach().float() - w.float()).abs()
        scale = float(w.abs().max())
        assert float(torch.where(noise[n], 0.0, err).max()) <= STEP_RTOL * scale, n
        assert float(torch.where(noise[n], err, 0.0).max()) <= NOISE_STEPS * lrs, n


def _model(arch: str, **fields):
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **fields)
    return cfg, tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu")



def step_matches_single(arch: str, mesh: str) -> None:
    """A reduced config over the ``mesh`` slots: the loss and every gathered
    gradient against the unsharded port's, then two AdamW steps against
    ``build_step``'s, the parameters gathered (the body of the
    ``test_sharded_step_matches_single`` of each mesh's file)."""
    cfg, model = _model(arch)
    sharded = model.place(_mesh(*MESHES[mesh]))
    batch = _torch(_batch(cfg, 1))
    loss, want = _single_grads(model, batch)
    grads, metrics = sharded.grads(batch)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    _close(grads, want, GRAD_TOL, "grad")
    step = ttrain.build_step(model, cfg, LR, TOTAL)
    state = ttrain.init_state(model)
    opt = sharded.init_opt(_opt_cfg())
    noise, lrs = {}, 0.0
    for i in range(2):
        b = _torch(_batch(cfg, 10 + i))
        _quiet(_single_grads(model, b)[1], noise)
        state, single = step(state, b)
        got = sharded.train_step(_opt_cfg(), opt, b)
        for key in ("loss", "grad_norm", "lr"):
            assert float(got[key]) == pytest.approx(float(single[key]), rel=STEP_RTOL), (i, key)
        lrs += float(single["lr"])
    _close_params(sharded.gather_params(), {n: p.detach() for n, p in model.named_parameters()},
                  noise, lrs)
    assert all(int(opt[idx]["step"]) == 2 for idx in np.ndindex(opt.shape))
