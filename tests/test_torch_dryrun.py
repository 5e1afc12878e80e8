"""The port's dry run (``repro_torch.launch.dryrun``) and its op-level
accounting (``launch/op_analysis.py``), against the reference's placements
and its HLO accounting, on the CPU (``meta`` tensors: nothing is computed).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so no test here imports it: the reference's batch placement is
restated from its ``input_specs`` (l.69-70) and its train step is
``repro.launch.train.build_step``.

FLOPs: on a (1, 1) mesh the port's step counts exactly the closed form
:func:`_closed_form` writes down (every matrix product four times under
remat: the graph-free forward, its recompute and the two products of the
backward; K7 and K7b by their tiles). Against ``hlo_analysis.analyze`` of
the reference's jitted step the attention terms differ by design (K7 skips
the causal tiles above the diagonal; ``_flash_ref_chunked`` computes dense,
remat'd KV chunks, as XLA keeps them), and the rest, the matrix products
outside attention, within ``REST_RTOL`` = 4e-2: XLA drops some of the
recomputed products that the port's remat runs (measured 2.3 % at T = 64
and 1.7 % at T = 128 for reduced phi3-mini-3.8b).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import sharding as rt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REST_RTOL = 4e-2
CELLS = [(arch, cell) for arch in jconfigs.list_archs() for cell in jconfigs.cells(arch)]
JDTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int32": 4, "int8": 1}


def _bytes(shape, dtype) -> int:
    return int(np.prod(shape)) * JDTYPE_BYTES[str(jnp.dtype(dtype))]


def _reference_shard_bytes(arch: str, cell_name: str, multi_pod: bool) -> dict:
    """Rank 0's bytes of the parameters, the moments (the reference's dtype
    rule) and each input, from ``NamedSharding(AbstractMesh).shard_shape``
    under the reference's ``spec_for``."""
    jcfg = jconfigs.get_config(arch)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(axes, shape))
    amesh = AbstractMesh(shape, axes)
    rules = jsharding.make_rules(multi_pod)

    def shard(shape_, spec) -> tuple:
        return tuple(NamedSharding(amesh, jax.sharding.PartitionSpec(*spec)).shard_shape(
            tuple(shape_)))

    def placed(shape_, ax) -> tuple:
        return shard(shape_, jsharding.spec_for(shape_, ax, rules, sizes))

    defs = jax.tree.leaves(jmodel.param_defs(jcfg),
                           is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "init"))
    params = sum(_bytes(placed(d.shape, d.axes), d.dtype or jcfg.param_dtype) for d in defs)
    moment = jnp.bfloat16 if jcfg.param_count() > dryrun.BF16_MOMENT_THRESHOLD else jnp.float32
    moments = 2 * sum(_bytes(placed(d.shape, d.axes), moment) for d in defs) + 4
    cell = jconfigs.SHAPES[cell_name]
    b, t = cell.global_batch, cell.seq_len
    ba = ("pod", "data") if multi_pod else ("data",)
    bspec = ba if b % int(np.prod([sizes[a] for a in ba])) == 0 else \
        ((ba[-1],) if b % sizes[ba[-1]] == 0 else None)
    bspec = None if bspec is None else (bspec if len(bspec) > 1 else bspec[0])
    inputs = 0
    if cell.kind in ("train", "prefill"):
        inputs += (2 if cell.kind == "train" else 1) * _bytes(shard((b, t), (bspec, None)),
                                                              jnp.int32)
        if jcfg.frontend != "none":
            inputs += _bytes(shard((b, jcfg.n_frontend_tokens, jcfg.d_model),
                                   (bspec, None, None)), jnp.bfloat16)
    else:
        inputs += _bytes(shard((b, 1), (bspec, None)), jnp.int32) + 4
    return {"params": params, "moments": moments, "inputs": inputs,
            "moment_dtype": str(jnp.dtype(moment))}


def _reference_cache_bytes(arch: str, cell_name: str, multi_pod: bool, dtype) -> int:
    jcfg = jconfigs.get_config(arch)
    cell = jconfigs.SHAPES[cell_name]
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(axes, shape))
    amesh = AbstractMesh(shape, axes)
    rules = jsharding.make_rules(multi_pod)
    shapes = jax.eval_shape(lambda: jtransformer.empty_cache(jcfg, cell.global_batch,
                                                             cell.seq_len, dtype))
    jaxes = jtransformer.cache_axes(jcfg)
    total = 0
    for pos, layer in shapes.items():
        for name, s in layer.items():
            spec = jsharding.spec_for(s.shape, jaxes[pos][name], rules, sizes)
            total += _bytes(NamedSharding(amesh, jax.sharding.PartitionSpec(*spec))
                            .shard_shape(s.shape), s.dtype)
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,cell", CELLS)
def test_argument_bytes_equal_the_reference_shards(arch, cell, multi_pod):
    """Rank 0's parameter, moment and input shard bytes (and the decode
    cells' caches in both cache dtypes) equal the reference's
    ``NamedSharding(AbstractMesh).shard_shape`` bytes exactly."""
    cfg = tconfigs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rt.make_rules(multi_pod)
    want = _reference_shard_bytes(arch, cell, multi_pod)
    params = dryrun.abstract_params(cfg, mesh, rules)
    assert all(p.device.type == "meta" for p in params.values())
    assert dryrun.arg_bytes(params) == want["params"]
    moment = torch.bfloat16 if want["moment_dtype"] == "bfloat16" else torch.float32
    assert dryrun.arg_bytes(tadamw.abstract_state(params, moment)) == want["moments"]
    kind = jconfigs.SHAPES[cell].kind
    specs = dryrun.input_specs(cfg, cell, mesh, rules, multi_pod)
    if kind == "decode":
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
            specs = dryrun.input_specs(cfg, cell, mesh, rules, multi_pod, cache_dtype=tdt)
            assert dryrun.arg_bytes(specs["cache"]) == _reference_cache_bytes(
                arch, cell, multi_pod, jdt)
        specs = {k: v for k, v in specs.items() if k != "cache"}
    assert dryrun.arg_bytes(specs) == want["inputs"]


# ---------------------------------------------------------------------------
# K7 and K7b on meta
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_and_k7b_on_meta_allocate_what_the_launches_do(dtype):
    """On ``meta``: K7's forward returns o (and the float32 log-sum-exp
    with a gradient), K7b dq, dk, dv (and the Δ rows, the tensor-core
    body's padded scratch); their FLOPs are 4·D and 10·D a pair of the
    tiles the body computes; no launch is counted; a CPU call still runs
    the plain version."""
    b, hq, hkv, s, d = 2, 8, 2, 200, 64
    q = torch.empty((b, hq, s, d), dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty((b, hkv, s, d), dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty((b, hkv, s, d), dtype=dtype, device="meta", requires_grad=True)
    before = dict(k7.LAUNCHES)
    _, ops, flops = op_analysis.trace(lambda: torch.autograd.grad(
        k7.flash_attention(q, k, v).float().sum(), (q, k, v)))
    assert k7.LAUNCHES == before
    tc = dtype == torch.bfloat16
    fwd_tiles, bwd_tiles = ((128, 128), (128, 64)) if tc else ((64, 64), (64, 64))
    want = (4 * d * k7.tile_pairs(b, hq, s, s, fwd_tiles, True)
            + 10 * d * k7.tile_pairs(b, hq, s, s, bwd_tiles, True))
    counts = flops.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.flash_attention_meta] + \
        counts[torch.ops.repro_torch.flash_attention_bwd_meta] == want
    o, lse = torch.ops.repro_torch.flash_attention_meta(q, k, v, True, True)
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (b, hq, s)
    assert lse.dtype == torch.float32
    assert torch.ops.repro_torch.flash_attention_meta(q, k, v, True, False)[1].numel() == 0
    dq, dk, dv, delta = torch.ops.repro_torch.flash_attention_bwd_meta(q, k, v, o, lse, o, True)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert delta.shape == ((2, b, hq, 256) if tc else (b, hq, s))
    # 200 queries in tiles of 128 (64): causal pairs below the tile diagonal
    assert k7.tile_pairs(1, 1, 200, 200, (128, 128), True) == 128 * 128 + 128 * 256
    assert k7.tile_pairs(1, 1, 200, 200, (64, 64), False) == 256 * 256
    cpu = torch.randn((1, 2, 16, 8))
    torch.testing.assert_close(k7.flash_attention(cpu, cpu, cpu),
                               k7.flash_attention_plain(cpu, cpu, cpu), rtol=0, atol=0)


def test_op_trace_counts_traffic_and_peak_live_bytes():
    """The traffic model (operands and outputs of every op but views) and
    the peak of live bytes (arguments pinned, a view allocating nothing)
    on a function whose bytes are known."""
    x = torch.empty((256, 256), device="meta")          # 256 KiB

    def fn(x):
        y = x * 2                                        # +256 KiB live, 512 KiB moved
        z = y.t()                                        # a view: nothing
        w = z + y                                        # +256 KiB, 768 KiB moved
        del y, z
        return w.sum()                                   # 256 KiB + 4 moved

    out, ops, flops = op_analysis.trace(fn, x)
    kib = 1024
    assert [n for n, _ in ops.rows] == ["aten::mul", "aten::add", "aten::sum"]
    assert sum(b for _, b in ops.rows) == 512 * kib + 768 * kib + 256 * kib + 4
    assert ops.peak == 512 * kib
    rec = op_analysis.analyze(ops, flops, [("all-reduce", 8), ("all-gather", 32),
                                           ("all-reduce", 8)])
    assert rec["collective_counts"]["all-reduce"] == 2 and rec["collective_bytes_total"] == 48
    assert rec["unknown_trip_counts"] == 0 and rec["flops"] == 0.0
    assert op_analysis.top_contributors(ops, flops, [("all-gather", 32)], what="collective") \
        == [(32.0, 1, "all-gather")]


# ---------------------------------------------------------------------------
# FLOPs: the closed form, and the reference's HLO
# ---------------------------------------------------------------------------
def _one_slot_mesh():
    grid = np.empty((1, 1), dtype=object)
    grid[...] = torch.device("meta")
    return rt.Mesh(grid, ("data", "model"))


def _reduced_overrides(arch: str) -> dict:
    base, cfg = tconfigs.get_config(arch), tconfigs.get_config(arch).reduced()
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(base, f.name)}


def _closed_form(cfg, b: int, t: int) -> tuple:
    """(the port's train-step FLOPs on one slot, their K7 and K7b part):
    2·(tokens)·(weights) a product, four products of every matrix (the
    layers' and the unembedding) under remat; per attention layer K7's
    forward twice and K7b once, by the CUDA-core bodies' tiles (float32)."""
    from repro_torch.models.model import param_defs

    mats = sum(int(np.prod(d.shape)) for n, d in param_defs(cfg).items()
               if len(d.shape) == 2 and n != "embed")
    pairs = k7.tile_pairs(b, cfg.n_heads, t, t, (64, 64), True)
    attn = cfg.n_layers * (2 * 4 * cfg.hd * pairs + 10 * cfg.hd * pairs)
    return 4 * 2 * b * t * mats + attn, attn


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-14b"])
def test_flops_on_one_slot_equal_the_closed_form_and_the_reference(arch):
    """On a (1, 1) mesh of ``meta`` slots the port's train step counts the
    closed form exactly; against ``hlo_analysis.analyze`` of the
    reference's jitted step, the terms outside attention agree within
    ``REST_RTOL`` and the attention terms are each side's own (K7's tiles;
    the dense chunks of ``_flash_ref_chunked``, found by their op names)."""
    b, t = 2, 64
    over = _reduced_overrides(arch)
    cfg = dataclasses.replace(tconfigs.get_config(arch), **over)
    rec = dryrun.run_cell(arch, "flops", False, microbatches=1, cfg_overrides=over,
                          mesh=_one_slot_mesh(), shape=ShapeCell("flops", t, b, "train"))
    total, attn = _closed_form(cfg, b, t)
    assert rec["flops"] == total
    assert sum(rec["collective_counts"].values()) == 0
    jcfg = jconfigs.get_config(arch).reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((b, t), jnp.int32), "labels": jnp.zeros((b, t), jnp.int32)}
    text = jtrain.build_step(jcfg, 1e-3, 20).lower((params, jadamw.init(params)),
                                                   batch).compile().as_text()
    ref = hlo_analysis.analyze(text)["flops"]
    flash = sum(r[0] for r in hlo_analysis.top_contributors(text, n=10 ** 6, what="flops")
                if "_flash_ref_chunked" in r[4])
    dense = 2 * 2 * b * cfg.n_heads * t * t * cfg.hd          # one pass's two products
    assert flash >= dense * cfg.n_layers                        # dense: no tile skipped
    assert abs((ref - flash) - (total - attn)) <= REST_RTOL * (ref - flash)


# ---------------------------------------------------------------------------
# run_cell and the command line
# ---------------------------------------------------------------------------
def test_run_cell_escalates_and_keeps_the_reference_keys():
    """A decode cell of the production mesh: the record carries the
    reference's keys; a cache that does not fit escalates to int8."""
    rec = dryrun.run_cell("granite-20b", "decode_32k", False)
    for key in ("arch", "cell", "mesh", "devices", "moment_dtype", "microbatches",
                "cache_dtype", "hbm_per_device", "fits_hbm", "flops", "hbm_traffic_bytes",
                "collectives", "collective_bytes_total", "collective_counts",
                "unknown_trip_counts", "param_count", "active_param_count"):
        assert key in rec, key
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["cache_dtype"] in ("bfloat16", "int8")
    assert rec["hbm_per_device"] == rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    assert rec["collectives"]["all-gather"] > 0 and rec["unknown_trip_counts"] == 0


def test_main_writes_jsonl_without_a_card(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one cell, in a process
    of its own with no card: one record, then a second run skips it."""
    out = tmp_path / "dry.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "phi3-mini-3.8b",
           "--cell", "prefill_32k", "--mesh", "pod", "--out", str(out)]
    for skip in (False, True):
        run = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                             timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        assert ("[skip]" in run.stdout) == skip
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["cell"] == "prefill_32k" and recs[0]["fits_hbm"]


def test_perf_variants_and_roofline_terms(tmp_path):
    """``launch/perf.py``: each variant's overrides (no ``flash`` variant),
    one cell re-traced under two of them, and the H100 roofline terms of
    its record (``launch/roofline.py``)."""
    from repro_torch.launch import perf, roofline

    cfg_o, rule_o, kw = perf.variant_kwargs(
        "granite-moe-3b-a800m", ["seqpar", "xent128", "cap1", "noremat", "mb4"])
    assert rule_o == {"act_seq": ["model"]} and kw == {"microbatches": 4}
    assert cfg_o["xent_chunk"] == 128 and cfg_o["remat"] is False
    assert cfg_o["moe"].capacity_factor == 1.0
    assert perf.variant_kwargs("jamba-1.5-large-398b", ["gla32"])[0]["ssm"].chunk == 32
    with pytest.raises(SystemExit):
        perf.variant_kwargs("qwen3-14b", ["flash256"])
    out = tmp_path / "perf.jsonl"
    rec = perf.main(["--arch", "phi3-mini-3.8b", "--cell", "decode_32k",
                     "--variants", "seqpar", "--out", str(out)])
    assert json.loads(out.read_text())["tag"] == "seqpar"
    t = roofline.terms(rec)
    assert t["compute_s"] == rec["flops"] / 989e12
    assert t["memory_s"] == rec["hbm_traffic_bytes"] / 3.35e12
    coll = rec["collectives"]
    assert t["collective_s"] == (2 * coll["all-reduce"] + coll["all-gather"]
                                 + coll["reduce-scatter"]) / 450e9
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"], t["collective_s"])
    # useful FLOPs from the record's own cell shape (a cell's or run_cell's shape=)
    n = rec["active_param_count"]
    assert (rec["kind"], rec["global_batch"], rec["seq_len"]) == ("decode", 128, 32768)
    assert t["model_flops"] == 2.0 * n * 128
    assert roofline.model_flops({**rec, "kind": "train", "global_batch": 4,
                                 "seq_len": 1024}) == 6.0 * n * 4 * 1024
