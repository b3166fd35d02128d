"""Minimal pytree helpers for the port's nested dict / list parameter
trees (the counterpart of ``jax.tree`` for plain containers)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of identical structure (dicts,
    lists, tuples; ``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in key-insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_index(tree: Any, i: int) -> Any:
    """Slice index ``i`` off the leading axis of every leaf (one layer
    of a layer-stacked tree)."""
    return tree_map(lambda a: a[i], tree)


def tree_to(tree: Any, device) -> Any:
    """Every tensor leaf on ``device`` (no copy when already there)."""
    return tree_map(lambda a: a.to(device) if isinstance(a, torch.Tensor)
                    else a, tree)


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensor leaves."""
    return int(sum(a.numel() * a.element_size() for a in tree_leaves(tree)
                   if isinstance(a, torch.Tensor)))
