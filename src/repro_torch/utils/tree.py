"""Helpers over trees of tensors (port of ``repro/utils/tree.py``): nested
dicts, lists and tuples whose leaves are tensors, walked in insertion
order."""
from __future__ import annotations

import torch


def leaves(tree) -> list:
    """The tensors of ``tree``, dicts in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    total = sum((lambda f: (f * f).sum())(x.float()) for x in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def count_params(tree) -> int:
    return sum(x.numel() for x in leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf, its dicts, lists and
    tuples rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype, device=x.device),
                    tree)
