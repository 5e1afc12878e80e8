"""Plain oracles for the port's kernels, beside the plain versions each
kernel module keeps (port of ``repro/kernels/ref.py``).

:func:`tropical_matmul_ref` evaluates the weighted (min,+) product in one
broadcast, with the candidate rounding of ``kernels/semiring_matmul.py``;
the tests hold that module's K-chunked plain version against it.
"""
from __future__ import annotations

from repro_torch.core.semiring import fma_f32


def tropical_matmul_ref(a, b, av=None, gv=None, bv=None):
    """``C[..,i,j] = min_k fma(av[i]·gv[k], bv[j], A[i,k] + B[k,j])`` (the
    weighted term dropped when ``av`` is None) over the last two axes."""
    t = a[..., :, :, None] + b[..., None, :, :]
    if av is not None:
        t = fma_f32((av[..., :, None] * gv[..., None, :])[..., None],
                    bv[..., None, None, :], t)
    return t.amin(dim=-2)
