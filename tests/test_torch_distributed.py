"""The per-rank program one process a rank (``runtime/distributed.py``):
four ``gloo`` processes on the CPU, a ``file://`` rendezvous under the
test's ``tmp_path``, against the threaded ``Comm`` and ``ShardedLM`` of
``runtime.sharding.run`` on four CPU slots.

Every check against the threads is bit for bit (``torch.equal``) with
equal collective logs: ``ProcessComm`` adds each element's terms in
``Comm``'s group order. A CPU rank runs one intra-op thread; at these
shapes the threads' CPU ops give the same bits on one thread as on the
caller's, which the checks hold. The reduced qwen3-14b's logits are also held within the LM
test's ``LOGIT_TOL`` = 1e-5 (absolute) of the reference's, teacher-forced
by its tokens as ``tests/test_torch_lm_sharding.py`` holds the threads.

The ranks are spawned once a mesh for the whole module (:func:`launched`:
the collectives, the three served models, the two trained ones and, on
(2, 2), the engine in one launch), and once more for the raising rank:
each launch starts four interpreters that import torch, and the suite
runs beside other workers on the same cores. The rank programs only the
tests run live in ``torch_rank_programs`` (no jax, no test file).
"""
import multiprocessing
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_rank_programs as programs  # noqa: E402
from test_torch_lm_sharding import LOGIT_TOL, MAX_LEN, STEPS, T  # noqa: E402
from test_torch_lm_sharding import _reference as lm_reference  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.runtime import distributed  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
SERVED = ("qwen3-14b", "granite-moe-3b-a800m", "rwkv6-1.6b")
TRAINED = ("phi3-mini-3.8b", "granite-moe-3b-a800m")
LR, WARMUP, TOTAL = 1e-3, 10, 20


def _launch(tmp_path, fn, shape, *args, **kw):
    got = distributed.launch(fn, shape, ("data", "model"), ["cpu"] * 4, args=args,
                             init_method=f"file://{tmp_path / 'rendezvous'}", **kw)
    assert got.backend == "gloo"
    for rep in got.reports:
        assert rep.foreign == [], rep.foreign   # no rank loads jax or repro
    return got


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * 4)


def _same(got, want, path="") -> None:
    """``got`` equal to ``want`` bit for bit: tensors by dtype, shape and
    values, the containers element by element."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _indices(shape) -> list:
    return [tuple(int(i) for i in idx) for idx in np.ndindex(shape)]


# ---------------------------------------------------------------------------
# the backend rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices, backend, staged", [
    (["cpu"] * 4, "gloo", [False] * 4),
    (["cuda:0"] * 4, "gloo", [True] * 4),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl", [False] * 4),
    (["cuda:0", "cuda:1", "cuda:1", "cuda:2"], "gloo", [True] * 4),
    (["cpu", "cuda:1"], "gloo", [False, True]),
    (["cuda:3", "cuda:0"], "nccl", [False, False]),
], ids=["cpu", "one-card", "four-cards", "a-shared-card", "mixed", "two-cards"])
def test_backend_rule(devices, backend, staged):
    """NCCL only where every rank has a card of its own; gloo otherwise,
    with a rank on a card staging through host memory. A pure rule on the
    devices: nothing is tried."""
    assert distributed.backend_for(devices) == backend
    assert [distributed.stages(backend, d) for d in devices] == staged


# ---------------------------------------------------------------------------
# one launch a mesh
# ---------------------------------------------------------------------------
def _collective_inputs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        b = torch.from_numpy(rng.standard_normal((4, 6, 5)).astype(np.float32))
        out.append({"x": rng.standard_normal((4, 6, 5)).astype(np.float32),
                    "y": rng.integers(-9, 9, 7).astype(np.int64),
                    "b": b.bfloat16().view(torch.int16).numpy(),
                    "w": rng.standard_normal((24, 3)).astype(np.float32)})
    return out


def _served(arch: str) -> tuple:
    """(the model, ``programs.forward``'s arguments): qwen3-14b at the LM
    test's weights (seed 0's, carried through the reference's tree), batch
    and reference tokens, the others from seed 0 at a batch of their own,
    greedy."""
    if arch == "qwen3-14b":
        model, toks, fr, feed, _ = lm_reference(arch)
        return model, {"cfg": model.cfg, "tokens": toks, "steps": STEPS, "forced": feed,
                       "max_len": MAX_LEN, "frontend": fr}
    cfg = tconfigs.get_config(arch).reduced()
    toks = np.random.default_rng(len(arch)).integers(0, cfg.vocab_size, (2, T))
    return (tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu"),
            {"cfg": cfg, "tokens": toks, "steps": STEPS, "max_len": MAX_LEN})


def _engine_job() -> dict:
    """``ranks.serve``'s arguments: four prompts of different lengths on
    reduced qwen3-14b, 3 new tokens each."""
    cfg = tconfigs.get_config("qwen3-14b").reduced()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3, 12)]
    return {"cfg": cfg, "prompts": prompts, "max_new": 3, "max_len": 20}


def _train_batch(cfg, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 17))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jobs(shape: tuple) -> dict:
    """{name: (rank program, its arguments)} of the launch on a ``shape``
    mesh: the collectives, each served model's prefill and decode, each
    trained model's step, and on (2, 2) the engine."""
    jobs = {"collectives": (programs.collectives, {"inputs": _collective_inputs(3)})}
    for arch in SERVED:
        jobs[f"forward {arch}"] = (programs.forward, _served(arch)[1])
    for arch in TRAINED:
        cfg = tconfigs.get_config(arch).reduced()
        jobs[f"train {arch}"] = (ranks.train, {"cfg": cfg, "batch": _train_batch(cfg, 3),
                                               "lr": LR, "warmup": WARMUP, "total": TOTAL})
    if shape == (2, 2):
        jobs["serve"] = (ranks.serve, _engine_job())
    return jobs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``launched(mesh)``: {job name: each rank's result, in rank order} of
    one launch of every job of :func:`_jobs` on that mesh, made at its
    first use and kept for the module."""
    done: dict = {}

    def get(mesh: str) -> dict:
        if mesh not in done:
            shape = MESHES[mesh]
            jobs = _jobs(shape)
            got = _launch(tmp_path_factory.mktemp(f"ranks-{mesh}"), ranks.sequence, shape,
                          list(jobs.values()))
            done[mesh] = {name: [rep[j]["result"] for rep in got.results]
                          for j, name in enumerate(jobs)}
        return done[mesh]

    return get


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_bit_equal_to_threads(launched, mesh):
    """Every collective of ``ProcessComm`` over every set of the mesh's axes
    (and all axes in reverse order: a group not in world-rank order): a
    float32 and a tuple all-reduce (int64 and a 0-dim member), an
    all-max, all-gathers (``parts=2``, a tuple with a bf16 member), a
    reduce-scatter, a ragged all-to-all and an exchange of a nested
    payload; then a gradient through them under a ``Tape``. Each rank's
    results, gradient and log equal the threaded ``Comm``'s slot's."""
    shape = MESHES[mesh]
    inputs = _collective_inputs(3)
    want = rt.run(_mesh(shape), lambda comm: programs.collectives(comm, inputs))
    got = launched(mesh)["collectives"]
    for r, idx in enumerate(_indices(shape)):
        _same(got[r], want[idx], f"rank {r}")
    log = got[0]["log"]
    assert len(log) > 20 and {k for k, _ in log} == {"all-reduce", "all-gather",
                                                    "reduce-scatter", "all-to-all"}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_and_decode_bit_equal_to_threads(launched, mesh):
    """Reduced qwen3-14b, granite-moe-3b-a800m and rwkv6-1.6b: each rank's
    logits of a prefill and two decode steps and its cache shards
    bit-equal to the threaded ``ShardedLM``'s; qwen3-14b's logits within
    ``LOGIT_TOL`` of the reference's."""
    shape = MESHES[mesh]
    for arch in SERVED:
        model, kw = _served(arch)
        logits, cache = programs.prefill_and_decode(
            model.place(_mesh(shape)), kw["tokens"], kw["steps"], kw.get("forced"),
            kw["max_len"], frontend=kw.get("frontend"))
        got = launched(mesh)[f"forward {arch}"]
        for r, idx in enumerate(_indices(shape)):
            _same(got[r]["logits"], logits, f"{arch} rank {r} logits")
            _same(got[r]["cache"], cache.shards[idx], f"{arch} rank {r} cache")
        if arch == "qwen3-14b":
            for mine, want in zip(got[0]["logits"], lm_reference(arch)[4]):
                np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=LOGIT_TOL)


def test_engine_serving_bit_equal_to_threads(launched):
    """``ranks.serve`` (the smoke's serving program): four prompts of
    different lengths through the engine on reduced qwen3-14b over (2, 2)
    (each admit a batch-1 prefill re-placed into the engine's cache):
    every rank's tokens, the logits and each rank's cache shards equal the
    threaded model's through ``ranks.serve_requests``."""
    kw = _engine_job()
    sharded = tmodel.CausalLM.from_seed(kw["cfg"], seed=0, device="cpu").place(_mesh((2, 2)))
    eng, want = ranks.serve_requests(sharded, kw["prompts"], kw["max_new"], kw["max_len"])
    assert len(want["logits"]) == 4 + 2 and all(len(t) == 3 for t in want["tokens"])
    got = launched("2x2")["serve"]
    for r, idx in enumerate(_indices((2, 2))):
        assert got[r]["tokens"] == want["tokens"]
        _same(got[r]["logits"], want["logits"], f"rank {r} logits")
        _same(got[r]["cache"], eng.cache.shards[idx], f"rank {r} cache")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_bit_equal_to_threads(launched, mesh):
    """Reduced phi3-mini-3.8b and granite-moe-3b-a800m in float32: each
    rank's gradient shards of one ``train_step``, its parameters after it
    and the step's metrics bit-equal to the threaded model's."""
    shape = MESHES[mesh]
    for arch in TRAINED:
        cfg = tconfigs.get_config(arch).reduced()
        sharded = tmodel.CausalLM.from_seed(cfg, seed=0, device="cpu").place(_mesh(shape))
        batch = {k: torch.as_tensor(v) for k, v in _train_batch(cfg, 3).items()}
        want = ranks.train_record(sharded, batch, ranks.opt_config(LR, WARMUP, TOTAL))
        got = launched(mesh)[f"train {arch}"]
        for r, idx in enumerate(_indices(shape)):
            _same(got[r]["grads"], want["grads"][idx], f"{arch} rank {r} grads")
            _same(got[r]["params"], want["params"][idx], f"{arch} rank {r} params")
            _same(got[r]["metrics"], want["metrics"], f"{arch} rank {r} metrics")


# ---------------------------------------------------------------------------
# a rank that raises
# ---------------------------------------------------------------------------
def _rank_children() -> list:
    """This process's live children that are rank processes (the
    ``spawn`` start method's; multiprocessing's resource tracker is not
    one)."""
    out = []
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            out += [int(p) for p in f.read().split()]
    ranks_ = []
    for pid in out:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except FileNotFoundError:
            continue
        if b"spawn_main" in cmd:
            ranks_.append(pid)
    return ranks_


def test_a_raising_rank_fails_the_call(tmp_path):
    """Rank 2's inputs lack a tensor: it raises KeyError at once while the
    others wait in their first collective. The call raises rank 2's
    KeyError (the others' failed collectives are not the cause) within a
    bounded time, and no rank process outlives it."""
    inputs = _collective_inputs(0)
    del inputs[2]["x"]
    t0 = time.monotonic()
    with pytest.raises(KeyError) as caught:
        _launch(tmp_path, programs.collectives, (2, 2), inputs, timeout=30.0)
    took = time.monotonic() - t0
    assert took < distributed.GRACE_S + 30.0, took
    assert any("rank 2 of 4" in note for note in caught.value.__notes__)
    assert multiprocessing.active_children() == []
    assert _rank_children() == []
