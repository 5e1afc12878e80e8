"""Gated linear scan ``h_t = decay_t ⊙ h_{t-1} + x_t``: CUDA kernel (K8) and
its plain PyTorch version.

Port of ``repro/kernels/chunked_scan.py`` (``chunked_scan_pallas``). x and
decay ``(T, D)``, h0 ``(D,)``; returns ``(h_all (T, D), h_last (D,))``.
Each step rounds ``decay·h + x`` once, as a fused multiply-add, in the
kernel (``__fmaf_rn``) and in the plain version (``core.semiring.fma_f32``)
alike: XLA's CPU compiler contracts the reference's ``d*h + x`` into one
FMA, so kernel, plain version and reference are bit-equal. A CPU tensor
goes through :func:`chunked_scan_plain`; a CUDA tensor launches
``csrc/chunked_scan.cu`` (float32), one launch per call. ``chunk`` is the
reference's chunk length; both versions walk the rows one at a time, so it
does not change the result and is only checked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.semiring import fma_f32
from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"linear_scan": 0}


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


def _launch(x, decay, h0):
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
    lib = _build.load("chunked_scan")
    fn = lib.chunked_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), decay.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
                h_last.data_ptr(), T, D,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return h_all, h_last


def chunked_scan(x, decay, h0, chunk: int = 128):
    """``(h_all, h_last)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU ones."""
    _check(x, decay, h0, chunk)
    if x.is_cuda:
        return _launch(x, decay, h0)
    return chunked_scan_plain(x, decay, h0)
