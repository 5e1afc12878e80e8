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
