"""The LM serving path of the port — configs, layers, the model (dense,
MoE, Mamba and RWKV6 blocks), the weight conversion, the engine and
scheduler — against ``repro`` on the same inputs and weights (CPU, reduced
configs, float32).

Weights are the reference's ``init_params`` carried across by
``params_from_reference``. Prefill and decode logits agree within
``LOGIT_TOL`` = 1e-5 (float32, sums in another order: measured ~2e-7,
~3e-7 for jamba's hybrid stack); float32 caches, the SSM states among
them, within ``LOGIT_TOL`` too (measured under 5e-7). With an int8 cache a value that a
last-bit difference puts on the other side of a rounding boundary
quantizes one code apart, so int8 codes agree within one step and the
decode logits within ``INT8_LOGIT_TOL`` = 5e-4. The engines must give the
same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import cache_from_reference, params_from_reference  # noqa: E402
from repro_torch.models.model import CausalLM, param_defs  # noqa: E402

LOGIT_TOL, INT8_LOGIT_TOL = 1e-5, 5e-4
DENSE = ("qwen3-14b", "phi3-mini-3.8b", "granite-20b", "stablelm-12b")
#: the MoE, hybrid and SSM families
MOE_SSM = ("granite-moe-3b-a800m", "arctic-480b", "jamba-1.5-large-398b", "rwkv6-1.6b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    for k in ("param_dtype", "compute_dtype"):
        out[k] = str(np.dtype(out[k]) if not isinstance(out[k], torch.dtype)
                     else out[k]).replace("torch.", "")
    return out


#: arch -> (the reference's ``source`` label, the port's)
RELABELLED = {
    "qwen3-14b": ("hf:Qwen/Qwen3-8B; hf", "hf:Qwen/Qwen3-14B; hf"),
    "stablelm-12b": ("hf:stabilityai/stablelm-2-1_6b; hf", "hf:stabilityai/stablelm-2-12b; hf"),
    "granite-moe-3b-a800m": ("hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
                             "hf:ibm-granite/granite-3.0-3b-a800m-base; hf"),
}


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_match_reference(arch):
    """Every field of every config and of its reduced variant equals the
    reference's (dtypes by name); only the ``source`` labels of qwen3-14b,
    stablelm-12b and granite-moe-3b-a800m differ: the port's name the
    model whose numbers the config holds."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.cells(arch) == jconfigs.cells(arch)
    for j, t in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                 (jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced())):
        jf, tf = _fields(j), _fields(t)
        if arch in RELABELLED:
            assert (jf.pop("source"), tf.pop("source")) == RELABELLED[arch]
        assert jf == tf
        assert (t.hd, t.scan_period, t.n_groups) == (j.hd, j.scan_period, j.n_groups)
        assert [t.mixer_of(i) for i in range(t.n_layers)] == [j.mixer_of(i) for i in range(j.n_layers)]
        assert [t.mlp_of(i) for i in range(t.n_layers)] == [j.mlp_of(i) for i in range(j.n_layers)]


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_param_count_matches_reference_or_names_the_roadmap(arch):
    """Every block kind is ported: both counts equal the reference's for
    every arch, at full size and reduced."""
    for cfg, ref in ((tconfigs.get_config(arch), jconfigs.get_config(arch)),
                     (tconfigs.get_config(arch).reduced(), jconfigs.get_config(arch).reduced())):
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()


def test_moe_and_ssm_sizes_fit_the_card_as_planned():
    """The sizes that decide what runs whole on one 80 GB card in bf16:
    granite-moe and rwkv6 whole, arctic two layers, jamba not one period."""
    get = tconfigs.get_config
    assert get("granite-moe-3b-a800m").param_count() == 3_374_295_552
    assert get("granite-moe-3b-a800m").active_param_count() == 958_376_448
    assert get("rwkv6-1.6b").param_count() == 1_678_313_472
    arctic = get("arctic-480b")
    per_layer = (arctic.param_count() - 2 * arctic.vocab_size * arctic.d_model) / arctic.n_layers
    assert 25.3 < 2 * per_layer / 2 ** 30 < 25.4
    jamba = get("jamba-1.5-large-398b")
    period = dataclasses.replace(jamba, n_layers=jamba.scan_period).param_count()
    assert 2 * period / 2 ** 30 > 80


def test_full_qwen3_14b_is_14_8b_parameters():
    n = tconfigs.get_config("qwen3-14b").param_count()
    assert n == 14_768_307_200 and 2 * n < 30e9   # bf16 weights on one 80 GB card


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(7)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5   # float32: sums in another order

    def pair(*shape):
        j = jnp.asarray(rng.normal(size=shape), getattr(jnp, dtype))
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))

    def close(got, want):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)

    jx, tx = pair(2, 5, 3, 16)
    js, ts = pair(16)
    close(tlayers.rmsnorm(tx, ts, 1e-6), jlayers.rmsnorm(jx, js, 1e-6))
    pos = np.array([[0, 1, 2, 7, 100], [3, 4, 5, 6, 9999]])
    close(tlayers.rope(tx, torch.from_numpy(pos), 1e6),
          jlayers.rope(jx, jnp.asarray(pos), 1e6))
    jh, th = pair(2, 5, 16)
    (jg, tg), (ju, tu), (jd, td) = pair(16, 24), pair(16, 24), pair(24, 16)
    cd = getattr(jnp, dtype)
    close(tlayers.swiglu(th, tg, tu, td, getattr(torch, dtype)),
          jlayers.swiglu(jh, jg, ju, jd, cd))


def test_rope_rotates_halves():
    """The reference's code (not its docstring) pairs x[i] with x[i + D/2]."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = tlayers.rope(x, torch.tensor([[1]]), theta=1e4)
    assert out[..., 4].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[..., 1].item() == 0.0


def test_from_seed_is_deterministic_and_follows_the_defs():
    cfg = tconfigs.get_config("qwen3-14b").reduced()
    a = CausalLM.from_seed(cfg, seed=0, device="cpu")
    b = CausalLM.from_seed(cfg, seed=0, device="cpu")
    c = CausalLM.from_seed(cfg, seed=1, device="cpu")
    defs = param_defs(cfg)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert tuple(pa.shape) == defs[name].shape and pa.dtype == torch.float32
        assert torch.equal(pa, pb)
        if defs[name].init == "ones":
            assert torch.equal(pa, torch.ones_like(pa))
        else:
            assert not torch.equal(pa, pc) and 0.015 < float(pa.std()) < 0.025


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("qwen3-14b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CausalLM.from_seed(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM.from_seed(cfg, device="cuda")


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("arch", DENSE + MOE_SSM)
def test_prefill_cache_and_decode_match_reference(arch, cache):
    """Prefill logits, every cache entry (KV, int8 codes and scales, the
    Mamba and RWKV states, ``x_cm``) and three decode steps."""
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = tconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_reference(_np(params), cfg, "cpu")
    toks = np.random.default_rng(len(arch)).integers(
        0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jmodel.prefill(params, jcfg, jnp.asarray(toks), max_len=20,
                            cache_dtype=getattr(jnp, cache))
    tl, tc = model.prefill(torch.from_numpy(toks).long(), max_len=20,
                           cache_dtype=getattr(torch, cache))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    want_cache = cache_from_reference(_np(jc), cfg, "cpu")
    assert len(tc) == cfg.n_layers
    for got, want in zip(tc, want_cache):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape
            diff = (got[name].float() - want[name].float()).abs().max().item()
            assert diff <= (1 if got[name].dtype == torch.int8 else LOGIT_TOL), name
    tol = INT8_LOGIT_TOL if cache == "int8" else LOGIT_TOL
    tok, pos = np.array(jnp.argmax(jl, -1), np.int32)[:, None], 13
    for _ in range(3):
        jl, jc = jmodel.decode_step(params, jcfg, jnp.asarray(tok), jc, pos)
        tl, tc = model.decode_step(torch.from_numpy(tok).long(), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
        tok, pos = np.array(jnp.argmax(jl, -1), np.int32)[:, None], pos + 1


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_every_reduced_config_prefills_and_decodes(arch):
    """``CausalLM`` builds, prefills and decodes every config's reduced
    variant from a seed on the CPU; mode "train" (no cache) gives finite
    hidden states and a float32 aux loss, and an unknown mode raises."""
    cfg = tconfigs.get_config(arch).reduced()
    model = CausalLM.from_seed(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    logits, cache = model.prefill(toks, max_len=12)
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
    logits, cache = model.decode_step(logits.argmax(-1, keepdim=True), cache, 9)
    assert torch.isfinite(logits).all()
    hidden, aux = model.forward(toks, mode="train")
    assert hidden.shape == (2, 9, cfg.d_model) and torch.isfinite(hidden).all()
    assert aux.dtype == torch.float32 and torch.isfinite(aux)
    with pytest.raises(ValueError, match="unknown mode"):
        model.forward(toks, mode="score", cache=cache)


def test_engine_scatters_state_caches_into_the_slot():
    """``admit`` writes a request's states into its slot (axis 0) and the
    decode step advances the states of every slot, idle ones too, as the
    reference's engine does."""
    cfg = tconfigs.get_config("rwkv6-1.6b").reduced()
    model = CausalLM.from_seed(cfg, seed=0, device="cpu")
    engine = tserving.Engine(model, max_batch=3, max_len=32)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=6).astype(np.int32)
    engine.admit(tserving.Request(rid=0, prompt=prompt, max_new_tokens=4))
    _, one = model.prefill(torch.from_numpy(prompt).long()[None], max_len=32)
    for big, small in zip(engine.cache, one):
        assert sorted(big) == ["h", "x_cm", "x_prev"]
        for name in big:
            assert torch.equal(big[name][0], small[name][0])
            assert not big[name][1:].any()
    idle = [c["h"][1:].clone() for c in engine.cache]
    engine.step()
    assert all(not torch.equal(c["h"][1:], h) for c, h in zip(engine.cache, idle))


# ---------------------------------------------------------------------------
# serving: the three scenarios of tests/test_serving.py through both engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.get_config("qwen3-14b").reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_reference(_np(params), tconfigs.get_config("qwen3-14b").reduced(),
                                  "cpu")
    return (jcfg, params), model


def _scenario(pkg, setup, name):
    """Run one scenario of ``tests/test_serving.py`` on ``pkg``'s engine;
    returns the tokens of every request by rid, and the engine steps."""
    rng = np.random.default_rng({"batch": 1, "recycle": 2, "interleave": 3}[name])
    if pkg is jserving:
        (cfg, params), f32 = setup, jnp.float32
        make = lambda b, s, **kw: jserving.Engine(params, cfg, max_batch=b, max_len=s, **kw)  # noqa: E731
    else:
        model, f32 = setup, torch.float32
        cfg = model.cfg
        make = lambda b, s, **kw: tserving.Engine(model, max_batch=b, max_len=s, **kw)  # noqa: E731
    if name == "batch":
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 7)]
        engine = make(3, 64, cache_dtype=f32)
        sched = pkg.Scheduler(engine)
        for i, p in enumerate(prompts):
            sched.submit(pkg.Request(rid=i, prompt=p, max_new_tokens=6))
        done = sched.run()
    elif name == "recycle":
        engine = make(2, 48)
        sched = pkg.Scheduler(engine)
        for i in range(7):
            sched.submit(pkg.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=4)
                                     .astype(np.int32), max_new_tokens=3 + (i % 3)))
        done = sched.run()
    else:
        p0 = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
        p1 = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
        engine = make(2, 64, cache_dtype=f32)
        r0 = pkg.Request(rid=0, prompt=p0, max_new_tokens=8)
        engine.admit(r0)
        engine.step()
        engine.step()
        r1 = pkg.Request(rid=1, prompt=p1, max_new_tokens=3)
        engine.admit(r1)
        done = []
        for _ in range(20):
            done += engine.step()
            if len(done) == 2:
                break
    return {r.rid: list(r.out) for r in done}, engine.steps_run


@pytest.mark.parametrize("name", ["batch", "recycle", "interleave"])
def test_engine_tokens_equal_reference_engine(served, name):
    ref_setup, model = served
    want, want_steps = _scenario(jserving, ref_setup, name)
    got, got_steps = _scenario(tserving, model, name)
    assert got == want and got_steps == want_steps
    assert len(got) == {"batch": 3, "recycle": 7, "interleave": 2}[name]


@pytest.mark.parametrize("name", ["batch", "recycle", "interleave"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-1.6b"])
def test_moe_and_ssm_engine_tokens_equal_reference_engine(arch, name):
    """The three scenarios on an MoE and an SSM config: MoE capacity in
    decode counts every slot, SSM states ride in the slots."""
    jcfg = jconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_reference(_np(params), tconfigs.get_config(arch).reduced(), "cpu")
    want, want_steps = _scenario(jserving, (jcfg, params), name)
    got, got_steps = _scenario(tserving, model, name)
    assert got == want and got_steps == want_steps
    assert len(got) == {"batch": 3, "recycle": 7, "interleave": 2}[name]


def test_engine_finishes_at_budget_eos_and_max_len(served):
    _, model = served
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, model.cfg.vocab_size, size=5).astype(np.int32)
    engine = tserving.Engine(model, max_batch=2, max_len=9)
    probe = tserving.Request(rid=0, prompt=prompt, max_new_tokens=20)
    sched = tserving.Scheduler(engine)
    sched.submit(probe)
    done = sched.run()
    assert done == [probe] and len(probe.out) == 9 - 1 - 5 + 1   # stops at pos = max_len - 1
    eos = tserving.Request(rid=1, prompt=prompt, max_new_tokens=20, eos_id=probe.out[1])
    sched = tserving.Scheduler(tserving.Engine(model, max_batch=2, max_len=64))
    sched.submit(eos)
    assert sched.run() == [eos] and eos.out == probe.out[:2]
    one = tserving.Request(rid=2, prompt=prompt, max_new_tokens=1)
    engine = tserving.Engine(model, max_batch=1, max_len=64)
    assert engine.admit(one) is one and engine.free_slots() == [0]
