"""Carry parameter trees between the reference (JAX) package and the port.

The two packages use the same tree layout — nested dicts keyed
``x1 y1 x2 y2`` / ``w`` / ``scale``, with the layers of
``DecoderLM.init_params`` stacked along a leading ``(L, ...)`` axis —
so a tree crosses as numpy arrays leaf by leaf. This module imports
neither package: the caller converts the reference's leaves to numpy
(``jax.tree.map(np.asarray, tree)``) and hands them over, or passes an
``.npz`` file written with :func:`save_npz`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.tree import tree_map

_SEP = "/"


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_jax_params(tree: Any, device="cpu") -> Any:
    """A tree of numpy arrays (the reference's params) as a tree of
    tensors on ``device``; every leaf keeps its values bit for bit."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def to_numpy(tree: Any) -> Any:
    """A tree of tensors as a tree of numpy arrays (bf16 leaves widen to
    fp32, exactly)."""
    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} contains {_SEP!r}")
            _flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        raise ValueError("save_npz: list nodes are not supported")
    else:
        out[prefix] = tree


def save_npz(tree: Any, path: str) -> None:
    """Write a nested-dict tree of numpy arrays (or tensors) to ``.npz``
    with ``a/b/c`` keys."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    np.savez(path, **{k: (to_numpy(v) if isinstance(v, torch.Tensor) else
                          np.asarray(v)) for k, v in flat.items()})


def load_npz(path: str, device="cpu") -> Any:
    """Read a tree written by :func:`save_npz` as tensors on ``device``."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _to_tensor(data[key], device)
    return tree
