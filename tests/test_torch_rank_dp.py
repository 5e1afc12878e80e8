"""The reference's last ``shard_map`` programs one process a rank: four
``gloo`` processes on the CPU (``runtime/distributed.py``) running the
sharded DP engine's drains (``ShardedDPEngine(comm=...)``),
``pipeline_apply_rank`` over ``permute`` and ``compressed_psum_rank``,
against the threaded slots of ``runtime.sharding.run`` and against the
JAX reference.

Every check against the threads is bit for bit (``torch.equal``, equal
logs and decoded paths); the pipeline is also held within 2e-5 of the
reference's ``jnp.tanh(x @ W + b)`` applied stage after stage (the
tolerance of ``tests/test_torch_sharding.py``), and
``compressed_psum_rank`` bit for bit against the reference's collective
under ``jax.vmap``.

The ranks are spawned once for the whole module (:func:`launched`: every
check's rank program in one ``ranks.sequence`` launch over a (1, 4) mesh,
the programs re-meshing to (2, 2) where they need it), and once more for
the rank that skips a ``permute``: each launch starts four interpreters
that import torch.
"""
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_rank_programs as programs  # noqa: E402
from test_torch_distributed import (_collective_inputs, _launch, _mesh,  # noqa: E402
                                    _rank_children, _same)
from test_torch_sharding import _zoo_traffic  # noqa: E402

from repro import dp as jdp  # noqa: E402
from repro.optim.grad_compress import compressed_psum as jcompressed_psum  # noqa: E402
from repro_torch import dp as tdp  # noqa: E402
from repro_torch.dp import autotune as tautotune  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.optim.grad_compress import compressed_psum  # noqa: E402
from repro_torch.runtime import distributed  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402
from repro_torch.runtime.pipeline_parallel import pipeline_apply  # noqa: E402

LINE = (1, 4)
#: the reference's pipeline case (stages, microbatches, rows, width)
S, M, MB, D = 4, 6, 3, 8
#: ``test_compressed_psum_bit_equal_to_the_reference``'s cases that fit four
#: ranks: (shards, shape, scale), over the (2, 2) mesh's ``data`` axis or the
#: (1, 4) line
PSUM_CASES = {"2": (2, (33,), 1.0), "4": (4, (1000,), 50.0)}
#: the ragged bucket: MCM instances of size 7, five of them over four ranks
RAGGED = 5


@pytest.fixture(autouse=True)
def _fresh_tables():
    tautotune.reset()
    yield
    tautotune.reset()


def _zero_case() -> tuple:
    """(each stage's positive ``p`` (S, d), the microbatches (M, mb, d)) of
    the -0.0 pipeline."""
    rng = np.random.default_rng(1)
    return (rng.uniform(0.5, 2.0, size=(S, D)).astype(np.float32),
            rng.normal(size=(M, MB, D)).astype(np.float32))


def _pipeline_case() -> tuple:
    rng = np.random.default_rng(0)
    Ws = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    bs = (rng.normal(size=(S, D)) * 0.1).astype(np.float32)
    return Ws, bs, rng.normal(size=(M, MB, D)).astype(np.float32)


def _psum_case(k: int, shape: tuple, scale: float) -> np.ndarray:
    rng = np.random.default_rng(k)
    return (rng.standard_normal((k,) + shape) * scale
            * rng.uniform(0.5, 2, size=(k,) + (1,) * len(shape))).astype(np.float32)


def _ragged_traffic() -> list:
    rng = np.random.default_rng(7)
    return [("mcm", False, {"dims": rng.integers(1, 20, size=8).astype(np.float64)})
            for _ in range(RAGGED)]


def _psum_shards(k: int) -> list:
    """Each rank's shard for a case of ``k`` shards: a (2, 2) rank's by its
    ``data`` coordinate, a (1, 4) rank's by its rank."""
    xs = _psum_case(*PSUM_CASES[str(k)])
    return [xs[r // 2] for r in range(4)] if k == 2 else list(xs)


def _jobs() -> dict:
    Ws, bs, x = _pipeline_case()
    return {
        "sweep": (programs.dp_sweep, {"traffic": _zoo_traffic()}),
        "ragged": (programs.dp_sweep, {"traffic": _ragged_traffic()}),
        "feedback": (programs.dp_sweep, {"traffic": _zoo_traffic(), "rounds": 3,
                                         "feedback": True, "explore_every": 2}),
        "permutes": (programs.permutes, {"inputs": _collective_inputs(5), "mesh": (2, 2)}),
        "pipeline": (programs.pipeline_tanh, {"Ws": Ws, "bs": bs, "x": x}),
        "pipeline zero": (programs.pipeline_negzero, dict(zip(("ps", "x"), _zero_case()))),
        "psum 4": (ranks.compressed, {"shards": _psum_shards(4), "axis": "model"}),
        "psum 2": (ranks.compressed, {"shards": _psum_shards(2), "axis": "data",
                                      "mesh": (2, 2)}),
    }


@pytest.fixture(scope="module")
def launching(tmp_path_factory):
    """One launch of every job of :func:`_jobs` on a (1, 4) mesh of four CPU
    ranks (the (2, 2) jobs re-mesh), started in a thread of its own so that
    the ranks run while this process computes the reference's answers."""
    jobs = _jobs()
    pool = ThreadPoolExecutor(1)
    future = pool.submit(_launch, tmp_path_factory.mktemp("ranks-dp"), ranks.sequence, LINE,
                         list(jobs.values()))
    yield list(jobs), future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def launched(launching):
    """{job name: each rank's result, in rank order} of :func:`launching`."""
    names, future = launching
    got = future.result(timeout=600)
    return {name: [rep[j]["result"] for rep in got.results] for j, name in enumerate(names)}


@pytest.fixture(scope="module")
def threaded():
    """The same sweeps through the threaded ``ShardedDPEngine`` over four
    CPU slots: {name: (responses, stats, lanes)}."""
    out = {}
    for name, traffic in (("sweep", _zoo_traffic()), ("ragged", _ragged_traffic())):
        tautotune.reset()
        eng = tdp.ShardedDPEngine(mesh=tdp.default_mesh(devices=["cpu"] * 4), max_batch=16,
                                  feedback=False)
        rids = [eng.submit(n, reconstruct=r, **kw) for n, r, kw in traffic]
        got, lanes = {}, []
        while eng.pending():
            drained = eng.step()
            lanes.append(len(drained))
            got.update((r.rid, r) for r in drained)
        out[name] = ([ranks.response_record(got[r]) for r in rids], dict(eng.stats), lanes)
    tautotune.reset()
    return out


@pytest.fixture(scope="module")
def reference_zoo(launching):
    """The reference's unsharded engine over the sweep, in submission
    order (computed while :func:`launching`'s ranks run)."""
    traffic = _zoo_traffic()
    eng = jdp.DPEngine(max_batch=16, feedback=False)
    rids = [eng.submit(name, reconstruct=recon, **kw) for name, recon, kw in traffic]
    out = eng.run()
    return [out[r] for r in rids]


def _same_record(got: dict, want: dict, what: str) -> None:
    """Two ``ranks.response_record``\\ s equal bit for bit (their arrays'
    bytes)."""
    assert (got["rid"], got["backend"]) == (want["rid"], want["backend"]), what
    assert np.array_equal(np.atleast_1d(got["answer"]).view(np.uint8),
                          np.atleast_1d(want["answer"]).view(np.uint8)), what
    assert (got["solution"] is None) == (want["solution"] is None), what
    if want["solution"] is not None:
        g, w = got["solution"], want["solution"]
        for key in ("value", "table", "args"):
            assert np.array_equal(np.atleast_1d(g[key]).view(np.uint8),
                                  np.atleast_1d(w[key]).view(np.uint8)), (what, key)
        assert g["path"] == w["path"], what


# ---------------------------------------------------------------------------
# the sharded DP engine
# ---------------------------------------------------------------------------
def test_sharded_sweep_bit_equal_to_threads_and_the_reference(reference_zoo, threaded, launched):
    """The zoo sweep (13 problems, with and without reconstruct, three
    instances each at size 8) through a ``ShardedDPEngine`` rank in each of
    four processes: every rank's responses (answers, tables, args, decoded
    paths) equal the threaded engine's on four CPU slots bit for bit, and
    the reference's unsharded engine's; every drain ran sharded."""
    want, stats, lanes = threaded["sweep"]
    for r, got in enumerate(launched["sweep"]):
        assert got["stats"] == stats and got["lanes"] == lanes, r
        for i, (g, w) in enumerate(zip(got["responses"], want)):
            _same_record(g, w, f"rank {r} request {i}")
    assert stats["sharded_drains"] == stats["device_batches"] == len(lanes) > 0
    for i, (g, w) in enumerate(zip(launched["sweep"][0]["responses"], reference_zoo)):
        assert np.array_equal(np.float32(g["answer"]), np.float32(w.answer)), i
        assert (g["solution"] is None) == (w.solution is None), i
        if w.solution is not None:
            np.testing.assert_array_equal(g["solution"]["table"], w.solution.table)
            np.testing.assert_array_equal(g["solution"]["args"], w.solution.args)
            assert g["solution"]["path"] == w.solution.solution, i


def test_ragged_bucket_pads_as_the_threads_do(launched, threaded):
    """Five MCM instances over four ranks: three pad lanes, one sharded
    drain, on every rank as on the threads, and the answers equal."""
    want, stats, lanes = threaded["ragged"]
    assert stats["padded_lanes"] == 3 and stats["sharded_drains"] == 1
    for r, got in enumerate(launched["ragged"]):
        assert got["stats"]["padded_lanes"] == stats["padded_lanes"], r
        assert got["stats"]["sharded_drains"] == stats["sharded_drains"], r
        assert got["lanes"] == lanes == [RAGGED]
        for i, (g, w) in enumerate(zip(got["responses"], want)):
            _same_record(g, w, f"rank {r} request {i}")


def test_feedback_sweep_keeps_every_rank_table_equal(launched):
    """The sweep three times with ``feedback=True``, every second drain of a
    bucket exploring a route not yet measured: each
    drain's observed time is the slowest rank's, so every rank's
    calibration table is the same, entry for entry, and so are the routes
    and answers."""
    got = launched["feedback"]
    first = got[0]
    assert first["stats"]["feedback_observations"] > 0 and len(first["table"]) > 0
    assert first["stats"]["explore_dispatches"] > 0
    for r, other in enumerate(got[1:], 1):
        assert other["table"] == first["table"], r
        assert other["stats"] == first["stats"], r
        for i, (g, w) in enumerate(zip(other["responses"], first["responses"])):
            _same_record(g, w, f"rank {r} request {i}")


# ---------------------------------------------------------------------------
# permute and the pipeline
# ---------------------------------------------------------------------------
def test_permute_bit_equal_to_threads_and_recorded(launched):
    """``ProcessComm.permute`` (point to point, the shapes first) over every
    set of a (2, 2) mesh's axes and all axes in reverse order, by shifts
    1, 2 and -1, of a float32 tensor, an (int64, bf16) tuple and rows that
    differ by rank: each rank's results and log equal the threaded
    ``Comm``'s slot's; ``RecordingComm``'s log of the same calls on equal
    shapes equals the real one's."""
    inputs = _collective_inputs(5)
    want = rt.run(_mesh((2, 2)), lambda comm: programs.permutes(comm, inputs))
    got = launched["permutes"]
    for r, idx in enumerate(np.ndindex(2, 2)):
        _same(got[r], want[idx], f"rank {r}")
    log = got[0]["log"]
    assert {k for k, _ in log} == {"collective-permute"} and len(log) > 20
    mesh = _mesh((2, 2))
    for r, idx in enumerate(np.ndindex(2, 2)):
        rec = rt.RecordingComm(mesh, idx)
        recorded = programs.permutes(rec, inputs, ragged=False)["log"]
        real = rt.run(mesh, lambda comm: programs.permutes(comm, inputs, ragged=False))[idx]
        assert recorded == real["log"], r


def test_pipeline_rank_bit_equal_to_slots_and_within_the_reference(launched):
    """``pipeline_apply_rank`` of ``tanh(x @ W + b)`` over four ranks (S 4,
    M 6, mb 3, d 8): every rank's outputs equal the slot-loop
    ``pipeline_apply`` over four CPU slots bit for bit, and the reference's
    stages applied in sequence within 2e-5."""
    Ws, bs, x = _pipeline_case()
    params = [(torch.from_numpy(Ws[s]), torch.from_numpy(bs[s])) for s in range(S)]
    want = pipeline_apply(programs.tanh_stage, params, torch.from_numpy(x),
                          rt.Mesh(["cpu"] * S, ("stage",)))
    ref = jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ jnp.asarray(Ws[s]) + jnp.asarray(bs[s]))
    for r, got in enumerate(launched["pipeline"]):
        assert got.dtype == want.dtype and got.shape == (M, MB, D), r
        assert torch.equal(got, want), r
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_pipeline_keeps_negative_zero_bit_equal_to_the_sequence(launched):
    """The stages ``-|h|·0·p`` (S 4, M 6, mb 3, d 8): every output element
    is -0.0. Every rank's ``pipeline_apply_rank`` and the slots'
    ``pipeline_apply`` are bit-equal to the stages applied in sequence, all
    144 sign bits set (the outputs are summed over the stages as integers).
    The reference closes with a float ``psum`` over the stages' outputs,
    zeros but the last stage's, which turns -0.0 into +0.0: it is compared
    by values only (a difference on purpose, ``ROADMAP.md`` queue 3)."""
    ps, x = _zero_case()
    seq = torch.from_numpy(x)
    for s in range(S):
        seq = programs.negzero_stage(torch.from_numpy(ps[s]), seq)
    assert int(torch.signbit(seq).sum()) == M * MB * D == 144
    slots = pipeline_apply(programs.negzero_stage, [torch.from_numpy(p) for p in ps],
                           torch.from_numpy(x), rt.Mesh(["cpu"] * S, ("stage",)))
    ref_seq = jnp.asarray(x)
    for s in range(S):
        ref_seq = -jnp.abs(ref_seq) * 0.0 * jnp.asarray(ps[s])
    outs = jnp.stack([jnp.zeros_like(ref_seq)] * (S - 1) + [ref_seq])
    ref = np.asarray(jax.vmap(lambda o: jax.lax.psum(o, "i"), axis_name="i")(outs)[0])
    for r, got in enumerate([slots] + list(launched["pipeline zero"])):
        assert got.dtype == torch.float32 and got.shape == (M, MB, D), r
        assert torch.equal(got.view(torch.int32), seq.view(torch.int32)), r
        np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# compressed_psum_rank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(PSUM_CASES))
def test_compressed_psum_rank_bit_equal_to_the_reference_and_threads(launched, case):
    """``compressed_psum_rank`` over 4 ranks (the (1, 4) line) and over the
    2 ranks of each (2, 2) column: every rank's sum equals the reference's
    collective under ``jax.vmap(..., axis_name="i")`` on the same shards,
    and the threaded list form's, bit for bit."""
    k, shape, scale = PSUM_CASES[case]
    xs = _psum_case(k, shape, scale)
    want = np.asarray(jax.vmap(lambda a: jcompressed_psum(a, "i"), axis_name="i")(
        jnp.asarray(xs)))
    slots = compressed_psum([torch.from_numpy(a) for a in xs],
                            tdp.default_mesh("i", devices=["cpu"] * k))
    for r, got in enumerate(launched[f"psum {case}"]):
        shard = r // 2 if k == 2 else r
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), want[shard])
        assert torch.equal(got, slots[shard]), r


# ---------------------------------------------------------------------------
# a rank that skips a permute
# ---------------------------------------------------------------------------
def test_a_rank_that_skips_a_permute_fails_the_call(tmp_path):
    """Rank 2 calls one ``permute`` fewer than its peers (a pipeline stage
    that skipped an idle step): the call fails within a short collective
    timeout and the launcher's grace, as a failed collective, and no rank
    process outlives it."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a collective failed"):
        _launch(tmp_path, programs.skipped_permute, LINE, timeout=10.0)
    took = time.monotonic() - t0
    assert took < distributed.GRACE_S + 10.0 + 15.0, took
    assert multiprocessing.active_children() == []
    assert _rank_children() == []
