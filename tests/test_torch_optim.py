"""The port's optimizer substrate against ``repro.optim`` on the same
numpy inputs (CPU): AdamW over several steps (float32 and bf16 moments,
float32 and bf16 parameters, clipping), the schedules, and the gradient
compression (``test_substrates.py``'s cases).

Tolerances: the reference runs eagerly, one XLA op at a time, so the
port's float32 update rounds the same way but for ``pow`` and ``sqrt``'s
last bit: float32 parameters and moments within ``ADAM_RTOL`` = 1e-6
relative (bf16 ones within one bf16 step, 2^-8 relative); the schedules
within 1e-6 relative; quantization codes and scales equal.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch.optim import adamw, grad_compress, schedules  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

ADAM_RTOL, BF16_RTOL = 1e-6, 2.0 ** -8


def _jdt(dt):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dt]


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("param_dt,moment_dt,clip", [
    (torch.float32, torch.float32, 1.0), (torch.float32, torch.bfloat16, 1.0),
    (torch.bfloat16, torch.float32, 1.0), (torch.float32, torch.float32, 1e3)])
def test_adamw_steps_match_reference(param_dt, moment_dt, clip):
    """Six steps of AdamW on two parameters with seeded gradients (norms
    past the clip and under it): parameters, moments, step, grad norm and
    lr against ``repro.optim.adamw.apply``."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jcfg = jadamw.AdamWConfig(lr=jsched.warmup_cosine(0.05, 2, 6), clip_norm=clip,
                              moment_dtype=_jdt(moment_dt))
    tcfg = adamw.AdamWConfig(lr=schedules.warmup_cosine(0.05, 2, 6), clip_norm=clip)
    jp = {k: jnp.asarray(v).astype(_jdt(param_dt)) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(param_dt) for k, v in p0.items()}
    js, ts = jadamw.init(jp, _jdt(moment_dt)), adamw.init(tp, moment_dt)
    rtol = BF16_RTOL if torch.bfloat16 in (param_dt, moment_dt) else ADAM_RTOL
    for i in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32) * (3.0 if i % 2 else 0.01)
             for k, s in shapes.items()}
        jp, js, jm = jadamw.apply(jcfg, {k: jnp.asarray(v).astype(_jdt(param_dt))
                                         for k, v in g.items()}, js, jp)
        tp, ts, tm = adamw.apply(tcfg, {k: torch.from_numpy(v).to(param_dt)
                                        for k, v in g.items()}, ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]), (ts["v"][k], js["v"][k])):
                np.testing.assert_allclose(_to_np(got), np.asarray(want, np.float32),
                                           rtol=rtol, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 6


def test_adamw_clip_norm_and_quadratic():
    """The reference's two AdamW checks on the port: the reported norm is
    the pre-clip norm, and a quadratic converges."""
    p = {"w": torch.zeros(4)}
    _, _, om = adamw.apply(adamw.AdamWConfig(lr=schedules.constant(0.1)),
                           {"w": torch.full((4,), 100.0)}, adamw.init(p), p)
    assert float(om["grad_norm"]) == pytest.approx(200.0)
    cfg = adamw.AdamWConfig(lr=schedules.constant(0.05), weight_decay=0.0)
    p = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = adamw.init(p)
    for _ in range(200):
        p, state, _ = adamw.apply(cfg, {"w": 2 * p["w"]}, state, p)
    assert float((p["w"] ** 2).sum()) < 1e-3


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (7, 7), (3, 40)])
def test_schedules_match_reference(warmup, total):
    tw, jw = schedules.warmup_cosine(1e-3, warmup, total), jsched.warmup_cosine(1e-3, warmup, total)
    for step in range(0, total + 5):
        assert float(tw(step)) == pytest.approx(float(jw(step)), rel=1e-6, abs=1e-12), step
        assert float(tw(torch.tensor(step, dtype=torch.int32))) == float(tw(step))
    assert float(schedules.constant(0.3)(5)) == float(jsched.constant(0.3)(5))


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(1)
    arrs = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    t = {"a": torch.from_numpy(arrs["a"]), "b": {"c": torch.from_numpy(arrs["b"]["c"]).bfloat16()}}
    j = {"a": jnp.asarray(arrs["a"]), "b": {"c": jnp.asarray(arrs["b"]["c"]).astype(jnp.bfloat16)}}
    assert float(tree.global_norm(t)) == pytest.approx(float(jtree.global_norm(j)), rel=1e-6)
    assert tree.count_params(t) == jtree.count_params(j) == 17
    assert tree.tree_bytes(t) == jtree.tree_bytes(j) == 12 * 4 + 5 * 2


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_topk_match_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64,)) * 10.0 ** (seed - 1)).astype(np.float32)
    q, s = grad_compress.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(grad_compress.compress_decompress(torch.from_numpy(x)).numpy(),
                                  np.asarray(jgc.compress_decompress(jnp.asarray(x))))
    for frac in (0.05, 0.3):
        np.testing.assert_array_equal(grad_compress.topk_sparsify(torch.from_numpy(x), frac).numpy(),
                                      np.asarray(jgc.topk_sparsify(jnp.asarray(x), frac)))


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_error_feedback_matches_reference(mode):
    rng = np.random.default_rng(3)
    g = {"g": rng.standard_normal(128).astype(np.float32)}
    tr, jr = {"g": torch.zeros(128)}, {"g": jnp.zeros(128)}
    for _ in range(5):
        tc, tr = grad_compress.ef_compress_grads({"g": torch.from_numpy(g["g"])}, tr,
                                                 mode=mode, topk_frac=0.1)
        jc, jr = jgc.ef_compress_grads({"g": jnp.asarray(g["g"])}, jr, mode=mode, topk_frac=0.1)
        np.testing.assert_allclose(tc["g"].numpy(), np.asarray(jc["g"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tr["g"].numpy(), np.asarray(jr["g"]), rtol=1e-6, atol=1e-7)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10**6), scale=st.floats(1e-3, 1e3))
def test_property_int8_quantization_error(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(64,)) * scale).astype(np.float32))
    err = float((x - grad_compress.compress_decompress(x)).abs().max())
    assert err <= float(x.abs().max()) / 127.0 * 0.51 + 1e-9


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    residual, acc = {"g": torch.zeros(128)}, torch.zeros(128)
    for _ in range(50):
        comp, residual = grad_compress.ef_compress_grads({"g": g_true}, residual,
                                                         mode="topk", topk_frac=0.1)
        acc = acc + comp["g"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), atol=0.25)


def test_topk_sparsify_keeps_largest():
    y = grad_compress.topk_sparsify(torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05, 0.0]), frac=2 / 6)
    assert float(y[1]) == -5.0 and float(y[3]) == 3.0
    assert float(y.abs().sum()) == 8.0
