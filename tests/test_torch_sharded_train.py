"""The sharded train step (``ShardedLM.train_step``): the per-rank program
of ``loss_fn`` and its gradient on CPU slots, one thread a slot, its
collectives differentiated by the slot's ``Tape``, and AdamW on each slot's
shards, against the unsharded port and the reference.

The bounds and the helpers are ``torch_sharded_train_common``'s (its
docstring says why each bound is what it is); every config against the
unsharded port on each mesh is in ``test_torch_sharded_train_{1x4,2x2,
1x3}.py``.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from torch_sharded_train_common import (  # noqa: E402
    B, FAMILIES, GRAD_TOL, LOSS_RTOL, LR, MESHES, STEP_RTOL, T, TOTAL, _batch, _close,
    _close_params, _mesh, _model, _opt_cfg, _quiet, _single_grads, _torch)
import torch_rank_programs as programs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_reference, reference_flat  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.runtime import distributed  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402
from repro_torch.utils import tree as ttree  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_heads_that_do_not_divide_the_model_axis(arch):
    """On (1, 8) slots the 4 heads do not divide ``model``: attention's
    gathered q, k, v on each slot's query rows and the SSM mixers'
    gathered weights (run whole) train as the single slot does."""
    cfg, model = _model(arch)
    batch = _torch(_batch(cfg, 6, b=2))
    loss, want = _single_grads(model, batch)
    grads, metrics = model.place(_mesh(1, 8)).grads(batch)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    _close(grads, want, GRAD_TOL, "grad")


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m", "jamba-1.5-large-398b"])
def test_microbatches_two_against_one_each(arch):
    """Two microbatches on (2, 2): the reference's accumulation (each half
    of the batch's gradient, summed in float32, halved), against the
    unsharded port's gradients of the two halves averaged; the loss is the
    halves' mean."""
    cfg, model = _model(arch)
    sharded = model.place(_mesh(2, 2))
    batch = _torch(_batch(cfg, 2, b=8))
    halves = [_single_grads(model, {k: v[j * 4:(j + 1) * 4] for k, v in batch.items()})
              for j in range(2)]
    want = {n: (halves[0][1][n] + halves[1][1][n]) / 2 for n in halves[0][1]}
    grads, metrics = sharded.grads(batch, microbatches=2)
    assert float(metrics["loss"]) == pytest.approx((halves[0][0] + halves[1][0]) / 2,
                                                   rel=LOSS_RTOL)
    _close(grads, want, GRAD_TOL, "grad")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_bf16_moments(mesh):
    """bf16 moments (the reference's rule past 1e11 parameters): two steps
    over the mesh against the unsharded port's ``adamw.apply`` on
    ``adamw.init(..., bfloat16)`` moments; the moments stay bf16."""
    cfg, model = _model("qwen3-14b")
    sharded = model.place(_mesh(*MESHES[mesh]))
    params = dict(model.named_parameters())
    state = tadamw.init(params, torch.bfloat16)
    opt = sharded.init_opt(_opt_cfg(torch.bfloat16))
    noise, lrs = {}, 0.0
    for i in range(2):
        b = _torch(_batch(cfg, 20 + i))
        _, grads = _single_grads(model, b)
        _quiet(grads, noise)
        _, _, om = tadamw.apply(_opt_cfg(torch.bfloat16), grads, state, params)
        sharded.train_step(_opt_cfg(torch.bfloat16), opt, b)
        lrs += float(om["lr"])
    assert all(m.dtype == torch.bfloat16 for m in opt[0, 0]["m"].values())
    _close_params(sharded.gather_params(), {n: p.detach() for n, p in params.items()},
                  noise, lrs)


#: a bf16 model's embedding gradient against float32 compute on the same
#: weights, a share of max|g| (reduced phi3-mini-3.8b, a Zipf batch whose
#: commonest token comes 274 times: 3.0e-3 single and over (2, 2); with the
#: lookup's gradient summed in bf16, 2.3e-2 single and 3.4e-2 between the
#: two)
BF16_EMBED_TOL = 1e-2


def test_bf16_embedding_gradient_sums_a_repeated_token_in_float32():
    """A bf16 model's embedding gradient, single and over (2, 2) slots,
    within ``BF16_EMBED_TOL`` of max|g| of float32 compute on the same
    weights: the lookup's gradient sums a repeated token's rows in float32
    and rounds once."""
    cfg, model = _model("phi3-mini-3.8b", param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)
    toks = np.random.default_rng(0).zipf(1.3, size=(B, 257)) % cfg.vocab_size
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    assert np.bincount(toks[:, :-1].ravel()).max() > 200
    wide = tmodel.CausalLM(dataclasses.replace(cfg, param_dtype=torch.float32,
                                               compute_dtype=torch.float32), device="cpu")
    wide.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    truth = _single_grads(wide, batch)[1]["embed"]
    single = _single_grads(model, batch)[1]["embed"]
    sharded = model.place(_mesh(2, 2)).grads(batch)[0]["embed"]
    assert single.dtype == sharded.dtype == torch.bfloat16
    for got in (single, sharded):
        err = float((got.float() - truth).abs().max())
        assert err <= BF16_EMBED_TOL * float(truth.abs().max())


def test_two_runs_are_bit_equal():
    """The same step from the same weights twice: equal bits in every
    parameter, moment and metric (the slots' sums in slot order)."""
    runs = []
    for _ in range(2):
        cfg, model = _model("granite-moe-3b-a800m")
        sharded = model.place(_mesh(2, 2))
        opt = sharded.init_opt(_opt_cfg())
        metrics = [sharded.train_step(_opt_cfg(), opt, _torch(_batch(cfg, 30 + i)))
                   for i in range(2)]
        runs.append((sharded.gather_params(), opt[1, 1]["v"], metrics))
    (p0, v0, m0), (p1, v1, m1) = runs
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert all(torch.equal(v0[n], v1[n]) for n in v0)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)


@pytest.mark.parametrize("arch", ["stablelm-12b", "granite-moe-3b-a800m", "jamba-1.5-large-398b"])
def test_without_remat_and_with_a_sequence_sharded_residual(arch):
    """``cfg.remat`` off (no remat regions), and the sequence-parallel
    residual (``act_seq`` on ``model``: each layer gathers the sequence it
    was handed split): the same loss and gradients, and the same prefill
    logits."""
    rules = rt.make_rules()
    rules["act_seq"] = ["model"]
    for fields, rule in (({"remat": False}, None), ({}, rules)):
        cfg, model = _model(arch, **fields)
        batch = _torch(_batch(cfg, 3))
        loss, want = _single_grads(model, batch)
        sharded = model.place(_mesh(2, 2), rule)
        grads, metrics = sharded.grads(batch)
        assert float(metrics["loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
        _close(grads, want, GRAD_TOL, "grad")
        with torch.no_grad():
            logits, _ = sharded.prefill(batch["tokens"], cache_dtype=torch.float32)
            single, _ = model.prefill(batch["tokens"], cache_dtype=torch.float32)
        _close({"logits": logits}, {"logits": single}, GRAD_TOL, "logits")


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_matches_reference(family):
    """One config of each family on (2, 2): the loss and every gradient
    against ``jax.value_and_grad(repro.models.model.loss_fn)``, then two
    steps against ``repro.optim.adamw.apply``, from the reference's
    ``init_params``."""
    arch = FAMILIES[family]
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    sharded = model.place(_mesh(2, 2))
    jopt = jadamw.AdamWConfig(lr=jschedules.warmup_cosine(LR, max(10, TOTAL // 20), TOTAL))
    jstate = jadamw.init(params)
    opt = sharded.init_opt(_opt_cfg())
    vg = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True), static_argnums=(1,))
    noise, lrs = {}, 0.0
    for i in range(2):
        batch = _batch(tcfg, 40 + i)
        (jloss, jm), jgrads = vg(params, jcfg, {k: jnp.asarray(v.astype(np.int32)
                                                               if v.dtype == np.int64 else v)
                                                for k, v in batch.items()})
        if i == 0:
            grads, metrics = sharded.grads(_torch(batch))
            assert float(metrics["loss"]) == pytest.approx(float(jloss), rel=LOSS_RTOL)
            assert float(metrics["aux"]) == pytest.approx(float(jm["aux"]), rel=LOSS_RTOL,
                                                          abs=1e-7)
            _close(grads, reference_flat(jax.tree.map(np.asarray, jgrads), tcfg),
                   GRAD_TOL, "grad")
        _quiet(reference_flat(jax.tree.map(np.asarray, jgrads), tcfg), noise)
        params, jstate, jom = jadamw.apply(jopt, jgrads, jstate, params)
        got = sharded.train_step(_opt_cfg(), opt, _torch(batch))
        assert float(got["grad_norm"]) == pytest.approx(float(jom["grad_norm"]), rel=STEP_RTOL)
        lrs += float(jom["lr"])
    _close_params(sharded.gather_params(),
                  reference_flat(jax.tree.map(np.asarray, params), tcfg), noise, lrs)


def test_tree_helpers_and_abstract_state_match_reference():
    """``tree_cast``, ``tree_zeros_like`` and ``adamw.abstract_state``
    give the reference's shapes and dtypes (and zeros)."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32), np.arange(6, dtype=np.int32)]}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = ttree.tree_map(torch.from_numpy, tree)
    for jfn, tfn in ((lambda t: jtree.tree_cast(t, jnp.bfloat16),
                      lambda t: ttree.tree_cast(t, torch.bfloat16)),
                     (jtree.tree_zeros_like, ttree.tree_zeros_like),
                     (lambda t: jtree.tree_zeros_like(t, jnp.float32),
                      lambda t: ttree.tree_zeros_like(t, torch.float32))):
        want, got = jax.tree.leaves(jfn(jt)), ttree.leaves(tfn(tt))
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert tuple(w.shape) == tuple(g.shape) and str(w.dtype) == str(g.dtype).split(".")[1]
            np.testing.assert_array_equal(np.asarray(w.astype(jnp.float32)),
                                          g.float().numpy())
    params = {"w": torch.empty((4, 8), device="meta"), "b": torch.empty(8, device="meta")}
    jparams = {"w": jax.ShapeDtypeStruct((4, 8), jnp.float32),
               "b": jax.ShapeDtypeStruct((8,), jnp.float32)}
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got, want = tadamw.abstract_state(params, tdt), jadamw.abstract_state(jparams, jdt)
        assert got["step"].dtype == torch.int32 and got["step"].device.type == "meta"
        for part in ("m", "v"):
            for name in params:
                assert tuple(got[part][name].shape) == want[part][name].shape
                assert got[part][name].dtype == tdt and got[part][name].device.type == "meta"


# ---------------------------------------------------------------------------
# the collectives' adjoints and the recording communicator
# ---------------------------------------------------------------------------
def test_collective_adjoints_on_a_tape():
    """Each collective's adjoint against autograd of the same function
    written whole: all-reduce, all-gather (with parts), the tuple
    all-gather, all-to-all, and a remat region holding collectives."""
    mesh = _mesh(2, 3)
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.standard_normal((6, 4, 6)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((6, 6)).astype(np.float32))

    def program(comm, x, w, remat):
        y = comm.all_reduce(x * w, "model")                              # (4, 6)
        z = comm.all_gather(y.sin(), "data", 0, parts=2)                 # (8, 6)
        a, b = comm.all_gather((z[:, :3], z[:, 3:] * 2), "model", (1, 1))

        def region(a, b):
            return (comm.all_to_all(list(torch.chunk(a * b, 3, dim=1)), "model", 1).cos(),)

        (c,) = comm.tape.remat(region, (a, b)) if remat else region(a, b)
        return (c * c).sum() + comm.all_reduce(z.sum(), ("data", "model"))

    def rank(comm, remat):
        x = xs[comm.rank].clone().requires_grad_()
        w = ws[comm.rank].clone().requires_grad_()
        tape = rt.Tape(comm)
        comm.tape = tape
        with tape:
            loss = program(comm, x, w, remat)
        tape.backward((loss,), (torch.ones(()),))
        return tape.grad(x), tape.grad(w)

    # the same program on the whole mesh at once: every slot's inputs leaves
    # of one graph, the collectives written as sums and concatenations
    x_all = xs.clone().requires_grad_()
    w_all = ws.clone().requires_grad_()
    total = 0
    ys = {}
    for d in range(2):
        ys[d] = sum(x_all[3 * d + m] * w_all[3 * d + m] for m in range(3))
    zs = {d: torch.cat([torch.chunk(ys[dd].sin(), 2, dim=0)[p]
                        for p in range(2) for dd in range(2)])
          for d in range(2)}
    for d in range(2):
        z = zs[d]
        a = torch.cat([z[:, :3]] * 3, dim=1)
        b = torch.cat([z[:, 3:] * 2] * 3, dim=1)
        for m in range(3):
            c = torch.cat([torch.chunk(a * b, 3, dim=1)[m]] * 3, dim=1).cos()
            total = total + (c * c).sum() + sum(zs[dd].sum() for dd in range(2) for _ in range(3))
    gx, gw = torch.autograd.grad(total, (x_all, w_all))
    for remat in (False, True):
        out = rt.run(mesh, lambda comm: rank(comm, remat))
        for idx in np.ndindex(2, 3):
            r = int(np.ravel_multi_index(idx, (2, 3)))
            torch.testing.assert_close(out[idx][0], gx[r], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(out[idx][1], gw[r], rtol=1e-5, atol=1e-5)


def _step_log(sharded, batch, kind: str):
    """Slot 0's (kind, bytes) list on the real mesh for one train or
    decode step."""
    if kind == "train":
        shards, b = sharded.split_batch(batch)

        def fn(comm):
            if comm.rank == 0:
                comm.log = []
            sharded.rank_grads(comm, shards[comm.index], b)
            return comm.log
    else:
        cache = sharded.empty_cache(B, 2 * T, dtype=torch.float32)
        tok = batch["tokens"][:, :1]
        pos = torch.full((B,), 3, dtype=torch.int64)

        def fn(comm):
            if comm.rank == 0:
                comm.log = []
            with torch.no_grad():
                sharded._forward_rank(comm, tok, "decode", cache, pos, None)
            return comm.log

    with rt.activate(sharded.mesh, sharded.rules):
        return rt.run(sharded.mesh, fn)[0, 0]


LOGGED_ARCHS = ("qwen3-14b", "granite-moe-3b-a800m", "jamba-1.5-large-398b")


@functools.lru_cache(maxsize=None)
def _process_logs() -> dict:
    """{(arch, kind): rank 0's log} of each step of
    ``test_recording_comm_equals_the_real_comm`` one process a rank: four
    gloo ranks of a (2, 2) mesh on the CPU, one launch for all of them."""
    jobs, keys = [], []
    for arch in LOGGED_ARCHS:
        cfg = _model(arch)[0]
        for kind in ("train", "decode"):
            jobs.append((programs.step_log, {"cfg": cfg, "batch": _batch(cfg, 5), "kind": kind,
                                          "cache_len": 2 * T, "pos": 3}))
            keys.append((arch, kind))
    with tempfile.TemporaryDirectory() as tmp:
        got = distributed.launch(ranks.sequence, (2, 2), ("data", "model"), ["cpu"] * 4,
                                 args=(jobs,), init_method=f"file://{tmp}/rendezvous")
    return {key: job["result"] for key, job in zip(keys, got.result)}


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", LOGGED_ARCHS)
def test_recording_comm_equals_the_real_comm(arch, kind):
    """Rank 0 of a (2, 2) mesh traced alone on ``meta`` with the recording
    communicator: the same (kind, bytes) list, in order, as the real
    ``Comm`` carried on CPU slots for a train step and a decode step, and
    as rank 0's ``ProcessComm`` for the same step one process a rank."""
    cfg, model = _model(arch)
    sharded = model.place(_mesh(2, 2))
    batch = _torch(_batch(cfg, 5))
    want = _step_log(sharded, batch, kind)
    grid = np.empty((2, 2), dtype=object)
    grid[...] = torch.device("meta")
    mesh = rt.Mesh(grid, ("data", "model"))
    rules = rt.make_rules(multi_pod=False)
    meta = tmodel.ShardedLM.of_shards(cfg, mesh, rules,
                                      {(0, 0): tdryrun.abstract_params(cfg, mesh, rules)})
    comm = rt.RecordingComm(mesh, (0, 0))
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    with rt.activate(mesh, meta.rules), rt.acting_as(comm):
        if kind == "train":
            shards, b = meta.split_batch(meta_batch)
            meta.rank_grads(comm, shards[0, 0], b)
        else:
            cache = meta.empty_cache(B, 2 * T, dtype=torch.float32)
            with torch.no_grad():
                meta._forward_rank(comm, meta_batch["tokens"][:, :1], "decode", cache,
                                   torch.full((B,), 3, dtype=torch.int64, device="meta"), None)
    assert comm.log == want and len(want) > 4
    assert {k for k, _ in want} <= set(rt.COLLECTIVES)
    assert _process_logs()[arch, kind] == want
