"""Weighted tropical (min,+) matrix product: CUDA kernel (K5) and its plain
PyTorch version.

    C[b,i,j] = min_k ( A[b,i,k] + B[b,k,j] + (av[b,i]·gv[b,k])·bv[b,j] )

Port of ``repro/kernels/semiring_matmul.py`` (``tropical_matmul_pallas``),
the compute core of the blocked MCM route (``core/blocked_mcm.py``): the
split combine over a block's middle tiles is this product. Every candidate
rounds as ``repro`` computes it on the CPU, where XLA contracts the
weighted term into one fused multiply-add: ``fma(av·gv, bv, A + B)``, with
``A + B`` and ``av·gv`` each rounded to float32 first. Without weights the
candidate is ``A + B``. Min is exact, so the order of ``k`` does not
matter; NaN propagates, as in ``torch.amin``.

``a``: ``(M, K)`` or ``(batch, M, K)``, ``b``: ``(K, N)`` or ``(batch, K,
N)``, float32; the weights ``av (.., M)``, ``gv (.., K)``, ``bv (.., N)``
are all given or all None. Any shape works (no block divisibility). A CPU
tensor goes through :func:`tropical_matmul_plain`; a CUDA tensor launches
``csrc/semiring_matmul.cu``, one launch per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.semiring import fma_f32
from repro_torch.kernels import _build

#: kernel launches per wrapper (incremented only where a kernel launches)
LAUNCHES = {"tropical_matmul": 0}
#: candidates the plain version materializes per K chunk (float64 at most
#: 4 · 2^24 bytes per temporary)
_CHUNK_ELEMS = 2 ** 24


def _batched(a, b, av, gv, bv):
    """Lift unbatched operands to a batch of one; returns the operands and
    whether to squeeze the result."""
    weights = (av, gv, bv)
    if any(w is None for w in weights) and any(w is not None for w in weights):
        raise ValueError("tropical_matmul: give all of av, gv, bv or none")
    if a.dim() == 2:
        return (a[None], b[None]) + tuple(
            None if w is None else w[None] for w in weights) + (True,)
    return (a, b) + weights + (False,)


def tropical_matmul_plain(a, b, av=None, gv=None, bv=None):
    """The kernel's function in PyTorch, ``K`` in chunks with a running
    min, so memory stays bounded at any ``K``."""
    a, b, av, gv, bv, squeeze = _batched(a, b, av, gv, bv)
    bt, m, k = a.shape
    n = b.shape[-1]
    acc = torch.full((bt, m, n), float("inf"), dtype=a.dtype, device=a.device)
    kc = max(1, _CHUNK_ELEMS // max(1, bt * m * n))
    for k0 in range(0, k, kc):
        k1 = min(k, k0 + kc)
        cand = a[:, :, k0:k1, None] + b[:, None, k0:k1, :]     # (bt, m, kc, n)
        if av is not None:
            w = av[:, :, None] * gv[:, None, k0:k1]             # (bt, m, kc)
            cand = fma_f32(w[..., None], bv[:, None, None, :], cand)
        acc = torch.minimum(acc, cand.amin(dim=2))
    return acc[0] if squeeze else acc


def _launch(a, b, av, gv, bv):
    name = "tropical_matmul"
    a, b, av, gv, bv, squeeze = _batched(a, b, av, gv, bv)
    weighted = av is not None
    tensors = (a, b) + ((av, gv, bv) if weighted else ())
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{name}: a and b must be 2-D or 3-D, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    bt, m, k = a.shape
    n = b.shape[-1]
    shapes = [(bt, k, n)] + ([(bt, m), (bt, k), (bt, n)] if weighted else [])
    for t, want in zip(tensors[1:], shapes):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, "
                             f"expected {want}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"{name}: operands must be float32 on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"{name}: a matrix of 2^31 or more entries")
    dev = a.device
    c = torch.empty((bt, m, n), dtype=torch.float32, device=dev)
    lib = _build.load("semiring_matmul")
    fn = lib.tropical_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), ptr(av), ptr(gv), ptr(bv),
                c.data_ptr(), bt, m, n, k,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return c[0] if squeeze else c


def tropical_matmul(a, b, av=None, gv=None, bv=None):
    """Weighted (min,+) product: the CUDA kernel for CUDA operands, the
    plain version for CPU ones."""
    if a.is_cuda:
        return _launch(a, b, av, gv, bv)
    return tropical_matmul_plain(a, b, av, gv, bv)
