"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and
``chip_kernel_floor.py`` import neither JAX nor the ``repro`` package (the
machine with the card has no JAX)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: an import statement of jax/jaxlib or of ``repro`` itself (``repro_torch``
#: is the port's own prefix and does not match)
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|repro)(?:\.|\s|,|$)"
    r"|from\s+(?:jax|jaxlib|repro)(?:\.|\s))", re.M)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch, repro_torch.dp, repro_torch.kernels.ops; "
            "import repro_torch.configs, repro_torch.models, repro_torch.serving; "
            "import repro_torch.models.convert, repro_torch.launch.serve; "
            "import repro_torch.models.moe, repro_torch.models.ssm; "
            "import repro_torch.core.planner; "
            "import repro_torch.launch.train, repro_torch.optim, repro_torch.data.pipeline; "
            "import repro_torch.checkpoint, repro_torch.runtime.fault_tolerance; "
            "import repro_torch.utils.tree; "
            "import repro_torch.dp.sharding, repro_torch.runtime.sharding; "
            "import repro_torch.runtime.elastic, repro_torch.runtime.pipeline_parallel; "
            "import repro_torch.launch.mesh; "
            "import repro_torch.launch.dryrun, repro_torch.launch.op_analysis; "
            "import repro_torch.launch.perf, repro_torch.launch.roofline; "
            "from repro_torch import dp; dp.backends.ensure_registered(); "
            "from repro_torch.dp import (DPEngine, DPRequest, DPResponse, "
            "DPService, ServiceResult, Session, AdmissionError, PrefixIndex, "
            "ResumeToken, resume_solve, Span, calibrate, routing_report, "
            "autotune, engine, service, streaming, telemetry); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_have_no_jax_or_repro_imports():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_kernel_floor.py"]
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(files) >= 15
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_lm_sources_are_scanned_on_their_own():
    """The LM slice's modules exist and hold no JAX or ``repro`` import."""
    lm = [PORT / p for p in (
        "configs/__init__.py", "configs/base.py", "configs/qwen3_14b.py",
        "models/layers.py", "models/attention.py", "models/transformer.py",
        "models/moe.py", "models/ssm.py",
        "models/model.py", "models/convert.py", "serving/engine.py",
        "serving/scheduler.py", "launch/serve.py", "kernels/flash_attention.py",
        "kernels/chunked_scan.py")]
    for f in lm + sorted((PORT / "configs").glob("*.py")):
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_scan_pattern_catches_forbidden_imports():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.dp import zoo", "import repro.core.sdp",
                "import repro", "    from repro import dp"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.dp import zoo",
               "import repro_torch.core.sdp", "# see repro.dp.zoo"):
        assert not FORBIDDEN.search(ok), ok


def test_serving_stack_and_examples_are_scanned_on_their_own():
    """The serving slice's modules and the port's examples exist and hold no
    JAX or ``repro`` import, and the port's ``dp`` and ``core`` packages
    read no environment variable."""
    serving = [PORT / "dp" / f"{m}.py" for m in (
        "telemetry", "autotune", "routing", "reconstruct", "engine",
        "streaming", "service")] + [PORT / "core" / "planner.py"]
    examples = [ROOT / "examples" / f"torch_{m}.py" for m in (
        "quickstart", "dp_zoo", "mcm_planner", "dp_service")]
    for f in serving + examples:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
    env = re.compile(r"os\.environ|getenv")
    for f in sorted((PORT / "dp").glob("*.py")) + sorted((PORT / "core").glob("*.py")):
        assert not env.search(f.read_text()), f.relative_to(ROOT)


def test_analysis_is_scanned_on_its_own():
    """The static schedule gate's modules and the kernel routes' schedule
    descriptors exist, import no JAX and no ``repro``, read no environment
    variable, and load neither when imported."""
    files = [PORT / "analysis" / f"{m}.py" for m in (
        "__init__", "__main__", "findings", "verifier", "extension", "linter")] + [
        PORT / "dp" / "schedule.py", PORT / "core" / "schedule.py",
        PORT / "kernels" / "schedule.py"]
    env = re.compile(r"os\.environ|getenv")
    for f in files + sorted((PORT / "analysis").glob("*.py")):
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f"{f.relative_to(ROOT)} imports JAX or repro"
        assert not env.search(text), f.relative_to(ROOT)
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.__main__; "
            "import repro_torch.core.schedule, repro_torch.kernels.schedule; "
            "from repro_torch.analysis import run_all; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env_vars, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_training_slice_is_scanned_on_its_own():
    """The training slice's modules and its example exist and hold no JAX
    or ``repro`` import."""
    files = [PORT / p for p in (
        "utils/tree.py", "optim/__init__.py", "optim/adamw.py", "optim/schedules.py",
        "optim/grad_compress.py", "data/pipeline.py", "checkpoint/checkpointer.py",
        "runtime/fault_tolerance.py", "launch/train.py", "models/model.py",
        "kernels/flash_attention.py")] + [ROOT / "examples" / "torch_train_lm.py"]
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
    assert (PORT / "csrc" / "flash_attention_bwd.cu").exists()


def test_sharding_slice_is_scanned_on_its_own():
    """The sharding slice's modules exist, import no JAX and no ``repro``,
    and read no environment variable."""
    files = [PORT / p for p in (
        "dp/sharding.py", "runtime/sharding.py", "runtime/elastic.py",
        "runtime/pipeline_parallel.py", "launch/mesh.py", "data/pipeline.py",
        "optim/grad_compress.py", "dp/service.py", "dp/backends.py")]
    env = re.compile(r"os\.environ|getenv")
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f"{f.relative_to(ROOT)} imports JAX or repro"
        assert not env.search(text), f.relative_to(ROOT)


def test_lm_sharding_slice_is_scanned_on_its_own():
    """The sharded LM's modules and the LM serving example exist, import no
    JAX and no ``repro`` (nor load them when imported), and read no
    environment variable."""
    files = [PORT / p for p in (
        "models/layers.py", "models/attention.py", "models/transformer.py",
        "models/moe.py", "models/ssm.py", "models/model.py", "serving/engine.py",
        "runtime/sharding.py", "launch/mesh.py", "kernels/ref.py", "kernels/_build.py",
        "kernels/flash_attention.py")] + [ROOT / "examples" / "torch_serve_lm.py"]
    env = re.compile(r"os\.environ|getenv")
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f"{f.relative_to(ROOT)} imports JAX or repro"
        assert not env.search(text), f.relative_to(ROOT)
    code = ("import sys; from repro_torch.models.model import ShardedLM, place_params; "
            "from repro_torch.runtime.sharding import activate, hint, run, Comm; "
            "from repro_torch.launch.mesh import make_production_mesh; "
            "from repro_torch.kernels.ref import sdp_pipeline_ref; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env_vars, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_distributed_slice_is_scanned_on_its_own():
    """The process-per-rank communicator and launcher and the rank programs
    (the port's, and the tests' own that a rank imports) exist, import no
    JAX and no ``repro`` (nor load them when imported), and read no
    environment variable."""
    files = [PORT / p for p in ("runtime/distributed.py", "launch/ranks.py")]
    files.append(ROOT / "tests" / "torch_rank_programs.py")
    env = re.compile(r"os\.environ|getenv")
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f"{f.relative_to(ROOT)} imports JAX or repro"
        assert not env.search(text), f.relative_to(ROOT)
    code = ("import sys; from repro_torch.runtime.distributed import ProcessComm, launch; "
            "from repro_torch.launch import ranks; "
            "sys.path.insert(0, 'tests'); import torch_rank_programs; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env_vars, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_rank_programs_of_the_dp_engine_pipeline_and_psum_are_scanned_on_their_own():
    """The per-rank forms of the sharded DP engine, the pipeline and the
    compressed all-reduce (``ShardedDPEngine(comm=...)``,
    ``pipeline_apply_rank``, ``compressed_psum_rank``) and their rank
    programs exist, import no JAX and no ``repro`` (nor load them when
    imported, nor when a rank runs them on a CPU mesh), and read no
    environment variable."""
    files = [PORT / p for p in (
        "dp/sharding.py", "dp/engine.py", "dp/backends.py", "runtime/pipeline_parallel.py",
        "optim/grad_compress.py", "runtime/sharding.py", "runtime/distributed.py",
        "launch/ranks.py", "models/model.py")]
    files.append(ROOT / "tests" / "torch_rank_programs.py")
    env = re.compile(r"os\.environ|getenv")
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f"{f.relative_to(ROOT)} imports JAX or repro"
        assert not env.search(text), f.relative_to(ROOT)
    code = ("import sys, numpy as np, torch; "
            "from repro_torch.dp.sharding import ShardedDPEngine, ShardContext; "
            "from repro_torch.runtime.pipeline_parallel import pipeline_apply_rank; "
            "from repro_torch.optim.grad_compress import compressed_psum_rank; "
            "from repro_torch.launch.ranks import dp_drains, pipeline, compressed; "
            "from repro_torch.runtime import sharding as rt; "
            "mesh = rt.Mesh(['cpu'] * 2, ('shard',)); "
            "rt.run(mesh, lambda c: ShardedDPEngine(comm=c, device='cpu', feedback=False)"
            ".submit('mcm', dims=np.arange(1.0, 6.0))); "
            "rt.run(mesh, lambda c: pipeline_apply_rank(lambda p, x: x + p, 1.0, "
            "torch.zeros(3, 2), c, 'shard')); "
            "rt.run(mesh, lambda c: compressed_psum_rank(torch.ones(4), c, 'shard')); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env_vars, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_service_rank_form_is_scanned_on_its_own():
    """The service one process a rank (``DPService(comm=...)``) and its rank
    program (``launch/ranks.py::dp_service``) import no JAX and no
    ``repro`` (nor load them when imported, nor when two threaded ranks
    serve a request and a session with it), and read no environment
    variable."""
    files = [PORT / p for p in ("dp/service.py", "dp/sharding.py", "launch/ranks.py")]
    env = re.compile(r"os\.environ|getenv")
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f"{f.relative_to(ROOT)} imports JAX or repro"
        assert not env.search(text), f.relative_to(ROOT)
    code = ("import sys, numpy as np; "
            "from repro_torch.dp import DPService; "
            "from repro_torch.launch.ranks import dp_service, serve_dp, host_seconds; "
            "from repro_torch.runtime import sharding as rt; "
            "mesh = rt.Mesh(['cpu'] * 2, ('shard',)); "
            "req = [('mcm', {'dims': np.arange(1.0, 6.0)}, True, 1, 50.0)]; "
            "ses = [('unbounded_knapsack', [dict(item_weights=np.array([2, 3]), "
            "item_values=np.array([1.0, 2.0]), capacity=c) for c in (7, 9)])]; "
            "got = rt.run(mesh, lambda c: dp_service(c, req, ses, max_batch=4, timing=True)); "
            "assert got[0]['records'] == got[1]['records'] and len(got[0]['records']) == 3; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env_vars, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
