"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` at first use and bind
them through ctypes.

Each source compiles on its own into a shared library with a plain C
interface; the first :func:`load` starts one ``nvcc`` per source, all at
once, and waits for them together. Libraries land in the package's
``build/`` directory (git-ignored), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header never loads a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("sdp_pipeline", "mcm_pipeline", "grid_pipeline", "sdp_chunked",
           "mcm_tiled", "semiring_matmul", "flash_attention", "flash_attention_tc",
           "flash_attention_bwd", "flash_attention_bwd_tc", "chunked_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: dynamic shared memory a block may opt into on the target, sm_90a (227 KB)
SMEM_OPTIN_BYTES = 232448

#: source name -> {"seconds": wall time of its nvcc, "log": nvcc's output
#: (ptxas registers, shared memory, spills)} for the builds this process ran
BUILD_INFO: dict = {}
#: kernel libraries this process has loaded (each built first if missing):
#: a call that moves it paid a build or a first load, so its time says
#: nothing about the kernel (``repro_torch.dp.backends.build_count``)
LOADS = 0
_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all(names=SOURCES) -> None:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all started together. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, so, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, t0, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    global LOADS
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
            LOADS += 1
        return lib


#: guards the launch counters and geometry tables: the slots of a mesh
#: launch from threads of their own (``runtime.sharding.run``)
_COUNT_LOCK = threading.Lock()


def count(table: dict, *names: str) -> None:
    """Add one launch to each of ``names`` in a module's ``LAUNCHES``."""
    with _COUNT_LOCK:
        for name in names:
            table[name] += 1


def record(table: dict, name: str, shape: tuple, **geometry) -> None:
    """Keep the geometry a launch of kernel wrapper ``name`` ran with at
    ``shape`` in its module's ``GEOMETRY`` table (per shape, the last
    launch's). The static schedule gate holds it against the geometry its
    descriptors assume (``repro_torch.analysis.verifier.verify_launches``)."""
    with _COUNT_LOCK:
        table.setdefault(name, {})[shape] = geometry


#: cudaErrorCooperativeLaunchTooLarge: a cooperative grid larger than the
#: card keeps resident, refused before it runs
COOPERATIVE_TOO_LARGE = 720


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc == COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"{name}: the grid cannot be co-resident on the card; "
                           "the cooperative launch refused it")
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
