"""Gated linear scan ``h_t = decay_t ⊙ h_{t-1} + x_t``: CUDA kernel (K8) and
its plain PyTorch version.

Port of ``repro/kernels/chunked_scan.py`` (``chunked_scan_pallas``). x and
decay ``(T, D)``, h0 ``(D,)``; returns ``(h_all (T, D), h_last (D,))``.
Each step rounds ``decay·h + x`` once, as a fused multiply-add, in the
kernel (``__fmaf_rn``) and in the plain version (``core.semiring.fma_f32``)
alike: XLA's CPU compiler contracts the reference's ``d*h + x`` into one
FMA, so kernel, plain version and reference are bit-equal. A CPU tensor
goes through :func:`chunked_scan_plain`; a CUDA tensor launches
``csrc/chunked_scan.cu`` (float32), one launch per call, as :func:`plan`
lays it out: a CTA of two warps per group of neighbouring features, one
warp running the chains (one a lane, rows in order) while the other keeps
a ring of row tiles of ``x`` and ``decay`` in flight (TMA where the rows
are 16-byte aligned, 4-byte ``cp.async`` elsewhere). ``chunk`` is the
reference's chunk length; both versions walk the rows one at a time, so it
does not change the result and is only checked.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.semiring import fma_f32
from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"linear_scan": 0}

#: rows of one stage (``csrc/chunked_scan.cu::ROWS``)
STAGE_ROWS = 64
TMA, CP_ASYNC = "tma", "cp.async"


class Plan(NamedTuple):
    """One launch's layout: features a CTA, rows a stage, stages of the
    ring, and how a stage is filled (``"tma"`` or ``"cp.async"``)."""
    features: int
    rows: int
    stages: int
    mode: str


def plan(T: int, D: int, aligned: bool = True) -> Plan:
    """16 features a CTA up to D = 4096 (D = 2048 gives 128 CTAs, about
    one an SM), 32 past it; six stages of 16 (four of 32) so each CTA
    keeps 48 (64) KB of loads in flight; TMA staging where every row
    starts on 16 bytes (``D % 4 == 0`` and ``aligned``: the tensors' base
    addresses), 4-byte ``cp.async`` elsewhere."""
    features = 16 if D <= 4096 else 32
    stages = 6 if features == 16 else 4
    mode = TMA if D % 4 == 0 and aligned else CP_ASYNC
    return Plan(features, STAGE_ROWS, stages, mode)


def smem_bytes(p: Plan) -> int:
    """Dynamic shared memory of one CTA: a full and an empty mbarrier a
    stage (padded to 128 bytes), the x and decay rings and, in TMA mode,
    two tiles of h rows (``csrc/chunked_scan.cu::smem_bytes``)."""
    tile = 4 * p.rows * p.features
    bars = -(-16 * p.stages // 128) * 128
    return bars + 2 * p.stages * tile + (2 * tile if p.mode == TMA else 0)


def _check(x, decay, h0, chunk: int):
    if chunk < 1:
        raise ValueError(f"linear_scan: chunk must be positive, got {chunk}")
    if x.dim() != 2 or tuple(decay.shape) != tuple(x.shape) or \
            tuple(h0.shape) != (x.shape[1],):
        raise ValueError(f"linear_scan: x {tuple(x.shape)}, decay "
                         f"{tuple(decay.shape)}, h0 {tuple(h0.shape)}: expected "
                         "(T, D), (T, D), (D,)")


def chunked_scan_plain(x, decay, h0):
    """The kernel's loop over T in PyTorch, vectorized over D."""
    h_all = torch.empty_like(x)
    h = h0.to(x.dtype)
    for t in range(x.shape[0]):
        h = fma_f32(decay[t], h, x[t])
        h_all[t] = h
    return h_all, h


_FN = None


def _auto_plan(x, decay, h_all) -> Plan:
    """:func:`plan` for these tensors (their base addresses decide TMA)."""
    T, D = x.shape
    return plan(T, D, all(t.data_ptr() % 16 == 0 for t in (x, decay, h_all)))


def _lib():
    """The launcher, its argument types set once."""
    global _FN
    if _FN is None:
        fn = _build.load("chunked_scan").chunked_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(x, decay, h0, plan: Plan = None):
    """The kernel on CUDA tensors; ``plan`` overrides :func:`plan`."""
    name = "linear_scan"
    for t in (x, decay, h0):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: operands must be float32 on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    T, D = x.shape
    if max(T, D) >= 2 ** 31:
        raise ValueError(f"{name}: T and D must each be below 2^31")
    h_all = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if plan is None:
        plan = _auto_plan(x, decay, h_all)
    if plan.rows != STAGE_ROWS:
        raise ValueError(f"{name}: stages of {STAGE_ROWS} rows, got {plan.rows}")
    with torch.cuda.device(x.device):
        rc = _lib()(x.data_ptr(), decay.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
                    h_last.data_ptr(), T, D, plan.features, plan.stages,
                    int(plan.mode == TMA), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, name)
    _build.count(LAUNCHES, name)
    return h_all, h_last


def chunked_scan(x, decay, h0, chunk: int = 128):
    """``(h_all, h_last)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check(x, decay, h0, chunk)
    if x.is_cuda:
        return _launch(x, decay, h0)
    return chunked_scan_plain(x, decay, h0)
