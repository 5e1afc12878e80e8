"""Semigroup / semiring algebra used by the DP solvers.

The paper's S-DP problem (Def. 1) only needs a *semigroup* ``⊗``; the
weighted extension pairs it with the semiring whose ``add`` matches it
(tropical ``(min, +)`` / ``(max, +)``, or ``(+, ×)``), where ``mul``
combines a table value with its lane weight. The companion-matrix scan
(``core.sdp.solve_companion_scan``) multiplies matrices in that semiring.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Semigroup:
    """The paper's ``⊗``: an associative binary operator on tensors."""

    name: str
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    np_op: Callable[[np.ndarray, np.ndarray], np.ndarray]

    def reduce(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Pairwise tree reduction along ``dim`` (the tournament of §II-B),
        in the same pairing order as ``repro``'s, so ``op="add"`` rounds
        identically."""
        x = torch.movedim(x, dim, 0)
        while x.shape[0] > 1:
            m = x.shape[0]
            half = m // 2
            head = self.op(x[:half], x[half:2 * half])
            x = torch.cat([head, x[2 * half:]], dim=0) if m % 2 else head
        return x[0]


@dataclasses.dataclass(frozen=True)
class Semiring:
    """``(add, mul)`` with identities; ``add`` is the S-DP ``⊗``."""

    name: str
    add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float  # identity of add
    one: float  # identity of mul
    #: numpy-side mul for the host oracles
    np_mul: Callable[[np.ndarray, np.ndarray], np.ndarray] = np.add

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Semiring matrix product ``C[i,j] = add_k mul(A[i,k], B[k,j])``
        over the last two axes (``a: (..., m, k)``, ``b: (..., k, n)``).
        The tropical rings broadcast ``mul`` and reduce over ``k`` (exact
        in any order); ``plus_times`` is an ordinary product."""
        if self.name == "plus_times":
            return a @ b
        prod = self.mul(a[..., :, :, None], b[..., None, :, :])
        if self.name == "min_plus":
            return prod.amin(dim=-2)
        if self.name == "max_plus":
            return prod.amax(dim=-2)
        raise NotImplementedError(self.name)

    def matvec(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.matmul(a, v[..., None])[..., 0]


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x·y + z`` of float32 tensors rounded once to float32, as a fused
    multiply-add rounds it (CUDA's ``__fmaf_rn``; XLA's CPU compiler
    contracts ``z + x·y`` into one). Computed in float64: the product is
    exact there, the sum is rounded to odd (its TwoSum error decides the
    last bit), and rounding that to float32 equals rounding the exact
    value."""
    xy = x.double() * y.double()
    zd = z.double()
    s = xy + zd
    bb = s - xy
    err = (xy - (s - bb)) + (zd - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    odd = torch.where((err != 0) & even & torch.isfinite(s),
                      torch.nextafter(s, away), s)
    return odd.float()


SEMIGROUPS = {
    "min": Semigroup("min", torch.minimum, np.minimum),
    "max": Semigroup("max", torch.maximum, np.maximum),
    "add": Semigroup("add", torch.add, np.add),
}

MIN_PLUS = Semiring("min_plus", add=torch.minimum, mul=torch.add,
                    zero=float("inf"), one=0.0, np_mul=np.add)
MAX_PLUS = Semiring("max_plus", add=torch.maximum, mul=torch.add,
                    zero=float("-inf"), one=0.0, np_mul=np.add)
PLUS_TIMES = Semiring("plus_times", add=torch.add, mul=torch.mul,
                      zero=0.0, one=1.0, np_mul=np.multiply)

#: semigroup name -> semiring whose ``add`` matches it
SEMIGROUP_TO_SEMIRING = {"min": MIN_PLUS, "max": MAX_PLUS, "add": PLUS_TIMES}
