"""The LM over a mesh of slots (``CausalLM.place`` → ``ShardedLM``): the
per-rank program on CPU slots, one thread a slot, against the unsharded
port and the reference's unsharded model, and the placement on the
reference's production meshes against its ``spec_for`` and
``NamedSharding`` (``meta`` slots: nothing allocated).

Bounds: the sharded logits within ``SHARD_REL`` = 1e-5 of max|logit| of
the unsharded port's (float32, sums over ``model`` in another order:
measured ~3e-7), the reference's within the LM test's ``LOGIT_TOL`` =
1e-5; float32 caches within ``SHARD_REL`` of max|·|, int8 codes within one
step and int8 decode logits within ``INT8_LOGIT_TOL`` = 5e-4 (the LM
test's bounds).
"""
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.transformer import cache_axes  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402

SHARD_REL, LOGIT_TOL, INT8_LOGIT_TOL = 1e-5, 1e-5, 5e-4
ARCHS = jconfigs.list_archs()
#: (data, model): FSDP and tensor parallelism; kv heads in halves; on 3
#: slots nothing divides, so the weights are replicated and attention takes
#: the ``act_seq_attn`` fallback (query rows against the key prefix)
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "1x3": (1, 3)}
B, T, MAX_LEN, STEPS = 2, 12, 24, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(data: int, model: int):
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


def _reduced(arch: str, n_experts=None) -> tuple:
    jcfg, cfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    if n_experts:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_experts=n_experts))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
    return jcfg, cfg


def _reference_params(model, jcfg) -> dict:
    """The port's weights as the reference's stacked tree (each period
    position's layers stacked over the groups); drawing the reference's own
    ``init_params`` eagerly takes seconds a config."""
    flat = {n: p.detach().numpy() for n, p in model.named_parameters()}
    period = jcfg.scan_period

    def stack(node, prefix, j):
        return {k: (stack(v, f"{prefix}{k}.", j) if isinstance(v, dict) else jnp.asarray(
            np.stack([flat[f"layers.{g * period + j}.{prefix}{k}"] for g in range(jcfg.n_groups)])))
            for k, v in node.items()}

    defs = jmodel.param_defs(jcfg)
    tree = {k: jnp.asarray(flat[k]) for k in ("embed", "ln_f", "lm_head") if k in defs}
    tree["groups"] = {f"b{j}": stack(defs["groups"][f"b{j}"], "", j) for j in range(period)}
    return tree


@functools.lru_cache(maxsize=None)
def _reference(arch: str, n_experts=None, batch: int = B, t: int = T) -> tuple:
    """(the port's model, carried into the reference's tree and back by
    ``params_from_reference``, tokens, frontend, the teacher-forced decode
    tokens, the reference's logits at prefill and each decode step), float32
    cache."""
    jcfg, cfg = _reduced(arch, n_experts)
    params = _reference_params(tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu"), jcfg)
    model = params_from_reference(_np(params), cfg, "cpu")
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab_size, (batch, t)).astype(np.int32)
    fr = (rng.normal(size=(batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
          if cfg.n_frontend_tokens else None)
    prefill = jax.jit(jmodel.prefill, static_argnums=(1,),
                      static_argnames=("max_len", "cache_dtype"))
    decode = jax.jit(jmodel.decode_step, static_argnums=(1,))
    jl, jc = prefill(params, jcfg, jnp.asarray(toks), max_len=MAX_LEN,
                     frontend=None if fr is None else jnp.asarray(fr),
                     cache_dtype=jnp.float32)
    want, feed = [np.asarray(jl)], []
    for step in range(STEPS):
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        feed.append(tok)
        jl, jc = decode(params, jcfg, jnp.asarray(tok), jc, t + step)
        want.append(np.asarray(jl))
    return model, toks, fr, feed, want


def _close(got, single, tol=SHARD_REL):
    assert got.shape == single.shape and torch.isfinite(got).all()
    scale = float(single.float().abs().max())
    err = float((got.float() - single.float()).abs().max())
    assert err <= tol * max(scale, 1.0), (err, scale)


def _same_cache(sharded, cache, single):
    got = sharded.gather_cache(cache)
    assert len(got) == len(single)
    for g, s in zip(got, single):
        assert sorted(g) == sorted(s)
        for name in s:
            assert g[name].dtype == s[name].dtype and g[name].shape == s[name].shape
            if s[name].dtype == torch.int8:
                assert int((g[name].int() - s[name].int()).abs().max()) <= 1, name
            else:
                _close(g[name], s[name])


def _run_both(arch, mesh, n_experts=None, cache_dtype=torch.float32, check_ref=True):
    """Prefill and STEPS decode steps through the sharded and the unsharded
    port (teacher-forced by the reference's tokens); returns the sharded
    model."""
    model, toks, fr, feed, want = _reference(arch, n_experts)
    sharded = model.place(_mesh(*mesh))
    tt = torch.from_numpy(toks).long()
    tf = None if fr is None else torch.from_numpy(fr)
    ls, cs = model.prefill(tt, max_len=MAX_LEN, cache_dtype=cache_dtype, frontend=tf)
    lg, cg = sharded.prefill(tt, max_len=MAX_LEN, cache_dtype=cache_dtype, frontend=tf)
    _close(lg, ls)
    _same_cache(sharded, cg, cs)
    quant = cache_dtype == torch.int8
    if check_ref:
        np.testing.assert_allclose(lg.numpy(), want[0], rtol=0, atol=LOGIT_TOL)
    for step, tok in enumerate(feed):
        t_tok = torch.from_numpy(tok).long()
        ls, cs = model.decode_step(t_tok, cs, T + step)
        lg, cg = sharded.decode_step(t_tok, cg, T + step)
        _close(lg, ls, INT8_LOGIT_TOL if quant else SHARD_REL)
        if check_ref and not quant:
            np.testing.assert_allclose(lg.numpy(), want[step + 1], rtol=0, atol=LOGIT_TOL)
    _same_cache(sharded, cg, cs)
    return sharded


# ---------------------------------------------------------------------------
# the axes and the placement
# ---------------------------------------------------------------------------
def _reference_flat_defs(jcfg) -> dict:
    """``{port parameter name: (shape, axes, init, scale)}`` of the
    reference's stacked defs, the leading ``layers`` entry dropped."""
    defs = jmodel.param_defs(jcfg)
    out = {k: defs[k] for k in ("embed", "ln_f", "lm_head") if k in defs}
    out = {k: (d.shape, d.axes, d.init, d.scale) for k, d in out.items()}

    def walk(node, prefix, j):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.", j)
            else:
                assert val.axes[0] == "layers"
                for g in range(val.shape[0]):
                    out[f"layers.{g * jcfg.scan_period + j}.{prefix}{key}"] = (
                        val.shape[1:], val.axes[1:], val.init, val.scale)

    for name, sub in defs["groups"].items():
        walk(sub, "", int(name[1:]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_axes_equal_reference(arch):
    """Every ParamDef's shape, axes, init and scale, and every layer's
    cache axes, equal the reference's (its stacked ``layers`` axis
    dropped)."""
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = _reference_flat_defs(jcfg)
    got = {n: (d.shape, d.axes, d.init, d.scale) for n, d in tmodel.param_defs(cfg).items()}
    assert got == want
    jaxes = jtransformer.cache_axes(jcfg)
    for i, layer in enumerate(cache_axes(cfg)):
        ref = jaxes[f"b{i % cfg.scan_period}"]
        assert layer == {k: v[1:] for k, v in ref.items()}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_production_mesh_slot0_holds_the_reference_shards(arch, multi_pod):
    """On the 16 x 16 and 2 x 16 x 16 meshes of ``meta`` slots, slot 0's
    share of every parameter, of the decode cells' caches and of their
    token batches has the shape of the reference's ``NamedSharding`` shard
    under its ``spec_for``; nothing is allocated."""
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules, jrules = rt.make_rules(multi_pod), jsharding.make_rules(multi_pod)
    sizes = mesh.shape
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    idx = (0,) * len(sizes)
    coord = dict(zip(mesh.axis_names, idx))

    def ref_shard(shape, axes) -> tuple:
        spec = jsharding.spec_for(shape, axes, jrules, sizes)
        return tuple(NamedSharding(amesh, spec).shard_shape(tuple(shape)))

    model = tmodel.CausalLM(cfg, device="meta")
    mine = tmodel.place_params(dict(model.named_parameters()), cfg, mesh, rules, idx)
    defs = _reference_flat_defs(jcfg)
    assert set(mine) == set(defs)
    for name, t in mine.items():
        assert t.device.type == "meta"
        shape, axes, _, _ = defs[name]
        layered = name.startswith("layers.")
        want = ref_shard(((1,) if layered else ()) + shape,
                         (("layers",) if layered else ()) + axes)[int(layered):]
        assert tuple(t.shape) == want, name
    for cell in jconfigs.cells(arch):
        shape_cell = jconfigs.SHAPES[cell]
        if shape_cell.kind != "decode":
            continue
        b, s = shape_cell.global_batch, shape_cell.seq_len
        shards = tmodel.place_cache(cfg, b, s, torch.bfloat16, mesh, rules, idx)
        jshapes = jax.eval_shape(lambda: jtransformer.empty_cache(jcfg, b, s, jnp.bfloat16))
        jaxes = jtransformer.cache_axes(jcfg)
        for i, layer in enumerate(shards):
            pos = f"b{i % cfg.scan_period}"
            assert sorted(layer) == sorted(jshapes[pos])
            for name, t in layer.items():
                assert t.device.type == "meta"
                want = ref_shard(jshapes[pos][name].shape, jaxes[pos][name])[1:]
                assert tuple(t.shape) == want, (cell, i, name)
        tok_axes = ("act_batch", "act_seq")
        tok = rt.piece(torch.empty((b, 1), device="meta"),
                       rt.spec_for((b, 1), tok_axes, rules, sizes), coord, sizes)
        assert tuple(tok.shape) == ref_shard((b, 1), tok_axes)


def test_production_meshes_have_the_reference_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert all(s.device.type == "meta" and s.stream is None for s in m.slots.flat)


def test_placement_inverts_bit_for_bit_with_whole_heads_of_each_part():
    """``gather_params`` gives every weight back bit for bit; mamba's w_in
    (x | z) puts each slot's quarter of x's heads beside the same quarter
    of z's, and w_bc (B | C) likewise."""
    cfg = tconfigs.get_config("jamba-1.5-large-398b").reduced()
    model = tmodel.CausalLM.from_seed(cfg, seed=3, device="cpu")
    sharded = model.place(_mesh(1, 4))
    back = sharded.gather_params()
    for name, p in model.named_parameters():
        assert torch.equal(back[name], p), name
    mamba = next(i for i in range(cfg.n_layers) if cfg.mixer_of(i) == "mamba")
    for w in ("w_in", "w_bc"):
        full = dict(model.named_parameters())[f"layers.{mamba}.mixer.{w}"]
        half = full.shape[1] // 2
        for j in range(4):
            local = sharded.params[0, j][f"layers.{mamba}.mixer.{w}"]
            q = half // 4
            want = torch.cat([full[:, j * q:(j + 1) * q],
                              full[:, half + j * q:half + (j + 1) * q]], 1)
            assert torch.equal(local, want)


# ---------------------------------------------------------------------------
# the per-rank program against the unsharded port and the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_single_and_reference(arch, mesh):
    """Prefill logits, the whole float32 cache and two decode steps of each
    reduced config over (1, 4), (2, 2) and (1, 3) slots."""
    _run_both(arch, MESHES[mesh])


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_heads_that_do_not_divide_the_model_axis(arch):
    """On 8 slots the 4 heads do not divide ``model`` while their columns
    do: attention gathers q, k and v and takes the query rows, the SSM
    mixers gather their weights and run whole."""
    sharded = _run_both(arch, (1, 8))
    assert sharded.specs["layers.0.mixer.w_out" if arch == "rwkv6-1.6b"
                         else "layers.0.mlp.w_down"][0] == "model"


def test_six_experts_on_four_slots_shard_the_expert_ffn():
    """Experts that do not divide ``model`` fall back to ``expert_ffn``
    (granite-moe's 40 on 16), as ``spec_for`` places them."""
    sharded = _run_both("granite-moe-3b-a800m", (1, 4), n_experts=6)
    assert sharded.specs["layers.0.mlp.w_gate"] == (None, "data", "model")
    assert sharded.specs["layers.0.mlp.w_down"] == (None, "model", "data")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_moe_capacity_drops_are_counted_under_a_mesh(mesh):
    """A sharded model's MoE layers count the whole batch's (token, k)
    assignments and capacity drops, as the unsharded blocks do (summed over
    the layers); the prompt drops some."""
    cfg = tconfigs.get_config("arctic-480b").reduced()
    model = tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu")
    sharded = model.place(_mesh(*MESHES[mesh]))
    for blk in model.layers:
        blk.moe_stats = {}
    sharded.moe_stats = {}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10)))
    for m in (model, sharded):
        logits, cache = m.prefill(toks, max_len=16)
        m.decode_step(logits.argmax(-1, keepdim=True), cache, 10)
    for mode in ("prefill", "decode"):
        want = [b.moe_stats[mode] for b in model.layers if mode in b.moe_stats]
        got = sharded.moe_stats[mode]
        assert got["assigned"] == sum(w["assigned"] for w in want)
        assert int(got["dropped"]) == sum(int(w["dropped"]) for w in want)
    assert int(sharded.moe_stats["prefill"]["dropped"]) > 0


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-20b", "jamba-1.5-large-398b"])
def test_int8_cache(arch, mesh):
    _run_both(arch, MESHES[mesh], cache_dtype=torch.int8, check_ref=False)


def test_batch1_cache_spreads_over_both_axes_and_a_shard_past_pos_adds_nothing():
    """A batch-1 prefill on (2, 2): the cache's sequence shards over both
    axes (6 positions a slot), so three shards lie wholly past ``pos`` at
    the first decode steps; the logits stay finite and equal the
    unsharded port's."""
    cfg = tconfigs.get_config("granite-20b").reduced()
    model = tmodel.CausalLM.from_seed(cfg, seed=1, device="cpu")
    sharded = model.place(_mesh(2, 2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 5)))
    ls, cs = model.prefill(toks, max_len=MAX_LEN, cache_dtype=torch.float32)
    lg, cg = sharded.prefill(toks, max_len=MAX_LEN, cache_dtype=torch.float32)
    assert cg.specs[0]["k"] == (None, ("data", "model"), None, None)
    assert cg.shards[0, 1][0]["k"].shape[1] == MAX_LEN // 4
    _close(lg, ls)
    tok = ls.argmax(-1, keepdim=True)
    for pos in range(5, 9):
        ls, cs = model.decode_step(tok, cs, pos)
        lg, cg = sharded.decode_step(tok, cg, pos)
        _close(lg, ls)
        tok = ls.argmax(-1, keepdim=True)
    _same_cache(sharded, cg, cs)
    assert not cg.shards[1, 1][0]["k"].any()


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m", "rwkv6-1.6b"])
def test_sharded_engine_tokens_equal_single_engine(arch):
    """The engine serves a sharded model unchanged: five requests through
    four engine slots on a (2, 2) mesh (the batch-1 prefill cache re-placed
    into the engine's), the same tokens as the single engine."""
    cfg = tconfigs.get_config(arch).reduced()
    model = tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 7, 11, 6)]
    outs = []
    for m in (model, model.place(_mesh(2, 2))):
        engine = tserving.Engine(m, max_batch=4, max_len=32)
        sched = tserving.Scheduler(engine)
        for i, p in enumerate(prompts):
            sched.submit(tserving.Request(rid=i, prompt=p, max_new_tokens=5))
        outs.append(({r.rid: list(r.out) for r in sched.run()}, engine.steps_run))
    assert outs[0] == outs[1] and len(outs[0][0]) == 5


# ---------------------------------------------------------------------------
# the runner, the collectives and hint
# ---------------------------------------------------------------------------
def test_collectives_combine_in_slot_order():
    mesh = _mesh(2, 3)
    vals = np.float32([1e8, 1.0, -1e8, 3.0, 0.5, 7.0])

    def fn(comm):
        x = torch.tensor([vals[comm.rank]])
        return (comm.all_reduce(x, "model"), comm.all_reduce(x, ("data", "model")),
                comm.all_gather(x, "data", 0),
                comm.all_to_all([torch.tensor([comm.rank * 10 + k]) for k in range(3)], "model", 0),
                comm.all_gather(torch.tensor([comm.rank, 100 + comm.rank]), "model", 0, parts=2))

    out = rt.run(mesh, fn)

    def fold(vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = np.float32(acc + v)
        return acc

    for d, m in np.ndindex(2, 3):
        row, both, col, a2a, parts = out[d, m]
        assert row.item() == fold(vals[3 * d:3 * d + 3]) and both.item() == fold(vals)
        assert col.tolist() == [vals[m], vals[3 + m]]
        assert a2a.tolist() == [(3 * d + k) * 10 + m for k in range(3)]
        r = [3 * d + k for k in range(3)]
        assert parts.tolist() == r + [100 + x for x in r]


def _slot_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("slot")]


def test_a_slot_that_raises_fails_the_call_and_nothing_hangs(monkeypatch):
    mesh = _mesh(1, 4)

    def fn(comm):
        if comm.rank == 2:
            raise ValueError("slot 2 fails")
        for _ in range(3):
            comm.all_reduce(torch.ones(1), "model")
        return comm.rank

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="slot 2 fails"):
        rt.run(mesh, fn)
    assert time.monotonic() - t0 < 30 and not _slot_threads()

    def late(comm):
        if comm.rank == 0:
            time.sleep(1.0)
        return comm.all_reduce(torch.ones(1), "model")

    monkeypatch.setattr(rt, "COLLECTIVE_TIMEOUT_S", 0.2)
    with pytest.raises(RuntimeError, match="waited past"):
        rt.run(mesh, late)
    assert not _slot_threads()

    cfg = tconfigs.get_config("qwen3-14b").reduced()
    sharded = tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu").place(mesh)
    real = tmodel.block_forward

    def failing(p, cfg_, i, *args, comm, **kw):
        if comm.rank == 1 and i == cfg_.n_layers - 1:
            raise RuntimeError("a kernel failed on slot 1")
        return real(p, cfg_, i, *args, comm=comm, **kw)

    monkeypatch.setattr(tmodel, "block_forward", failing)
    toks = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="slot 1"):
        sharded.prefill(toks, max_len=8)
    assert not _slot_threads()


def test_hint_is_the_identity_outside_activate_and_replaces_inside():
    x = torch.arange(24.0).reshape(4, 6)
    assert rt.hint(x, ("act_batch", None)) is x
    mesh = _mesh(2, 2)
    outside = rt.run(mesh, lambda comm: rt.hint(x, ("act_batch", None)))
    assert all(o is x for o in outside.flat)
    with rt.activate(mesh, rt.make_rules()):
        rt.hint(x, ("act_batch", None))                    # controller thread: unchanged
        inside = rt.run(mesh, lambda comm: (rt.hint(x, ("act_batch", "act_ffn")),
                                            rt.hint(rt.hint(x, ("act_batch", "act_ffn")),
                                                    (None, None), src=("data", "model"))))
    for (d, m), (shard, back) in ((idx, inside[idx]) for idx in np.ndindex(2, 2)):
        assert torch.equal(shard, x[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        assert torch.equal(back, x)


def test_sdp_pipeline_ref_matches_reference():
    rng = np.random.default_rng(5)
    offsets, n, block = (3, 2, 1), 200, 16
    st0 = rng.normal(size=n).astype(np.float32)
    for op in ("min", "max"):
        want = np.asarray(jax.jit(jref.sdp_pipeline_ref, static_argnums=(1, 2, 3, 4))(
            jnp.asarray(st0), offsets, op, n, block))
        got = tref.sdp_pipeline_ref(torch.from_numpy(st0), offsets, op, n, block)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
