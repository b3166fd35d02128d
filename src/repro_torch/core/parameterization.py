"""Weight parameterizations: FedPara, original and pFedPara (PyTorch).

Key-name conventions, identical to the reference package so that trees
carry across (``repro_torch.interop``):

  original : {"w"}
  fedpara  : {"x1", "y1", "x2", "y2"}        W = (X1Y1ᵀ) ⊙ (X2Y2ᵀ)
  pfedpara : {"x1", "y1", "x2", "y2"}        W = (X1Y1ᵀ) ⊙ (X2Y2ᵀ + 1)

Factors are stored fp32 (master copy); :func:`materialize` casts the
composed weight to ``dtype``. Every init takes an explicit
``torch.Generator`` and ``device``; the numbers differ from
``jax.random`` for the same seed, so parity tests start from weights
the reference initialized.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import rank_policy
from repro_torch.tree import tree_leaves

ParamTree = Dict[str, Any]

PFEDPARA_GLOBAL_KEYS = ("x1", "y1")   # transferred to the server
PFEDPARA_LOCAL_KEYS = ("x2", "y2")    # kept on-device


def fedpara_factor_std(fan_in: int, r: int, target_gain: float = 2.0) -> float:
    """Factor std so the composed FedPara W matches He variance."""
    return float((target_gain / fan_in) ** 0.125 / (r ** 0.25))


def lowrank_factor_std(fan_in: int, r: int, target_gain: float = 2.0) -> float:
    """Factor std so a rank-r product X Yᵀ matches He variance."""
    return float((target_gain / (fan_in * r)) ** 0.25)


def _randn(gen: torch.Generator, shape, device, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * std


def init_original(gen: torch.Generator, m: int, n: int,
                  device="cpu") -> ParamTree:
    """He-initialized dense ``{"w": (m, n)}`` baseline."""
    return {"w": _randn(gen, (m, n), device, (2.0 / m) ** 0.5)}


def init_fedpara(gen: torch.Generator, m: int, n: int, r: int,
                 device="cpu") -> ParamTree:
    """FedPara factors ``{"x1"/"x2": (m, r), "y1"/"y2": (n, r)}``."""
    std = fedpara_factor_std(m, r)
    return {"x1": _randn(gen, (m, r), device, std),
            "y1": _randn(gen, (n, r), device, std),
            "x2": _randn(gen, (m, r), device, std),
            "y2": _randn(gen, (n, r), device, std)}


def init_pfedpara(gen: torch.Generator, m: int, n: int, r: int,
                  device="cpu") -> ParamTree:
    """pFedPara: W = W1 ⊙ (W2 + 1); the personal half starts at half the
    global std so W ≈ W1 at initialization (paper §2.3)."""
    std1 = lowrank_factor_std(m, r)
    std2 = 0.5 * std1
    return {"x1": _randn(gen, (m, r), device, std1),
            "y1": _randn(gen, (n, r), device, std1),
            "x2": _randn(gen, (m, r), device, std2),
            "y2": _randn(gen, (n, r), device, std2)}


def _cast(a: torch.Tensor, dtype) -> torch.Tensor:
    return a.to(dtype) if dtype is not None else a


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """X Yᵀ over the last two dims; leading (L, ...) dims ride along."""
    return torch.matmul(x, y.transpose(-1, -2))


def compose_fedpara(params: ParamTree, dtype=None,
                    use_tanh: bool = False) -> torch.Tensor:
    """W = (X1 Y1ᵀ) ⊙ (X2 Y2ᵀ)   (optionally tanh(W1)⊙tanh(W2), supp. B)."""
    w1 = _outer(_cast(params["x1"], dtype), _cast(params["y1"], dtype))
    w2 = _outer(_cast(params["x2"], dtype), _cast(params["y2"], dtype))
    if use_tanh:
        w1, w2 = torch.tanh(w1), torch.tanh(w2)
    return w1 * w2


def compose_pfedpara(params: ParamTree, dtype=None) -> torch.Tensor:
    """W = W1 ⊙ (W2 + 1) = W_per + W_glo  (paper §2.3)."""
    w1 = _outer(_cast(params["x1"], dtype), _cast(params["y1"], dtype))
    w2 = _outer(_cast(params["x2"], dtype), _cast(params["y2"], dtype))
    return w1 * (w2 + 1.0)


def resolve_rank(m: int, n: int, gamma: float, rank: Optional[int]) -> int:
    """Explicit ``rank`` or the paper's policy rank for ``gamma``."""
    if rank is not None:
        return rank
    return rank_policy.matrix_rank_for_gamma(m, n, gamma)


def _refuse_lowrank(kind: str) -> None:
    """The reference's low-rank kind is not ported yet: refuse it by its
    ROADMAP item, as every other unported setting is refused."""
    if kind == "lowrank":
        raise NotImplementedError("parameterization kind 'lowrank' is not "
                                  "ported yet: ROADMAP A2")


def init_linear(gen: torch.Generator, m: int, n: int, *,
                kind: str = "fedpara", gamma: float = 0.1,
                rank: Optional[int] = None, device="cpu") -> ParamTree:
    """Initialize one parameterized (m -> n) weight."""
    if kind == "original":
        return init_original(gen, m, n, device)
    _refuse_lowrank(kind)
    r = resolve_rank(m, n, gamma, rank)
    if kind in ("fedpara", "fedpara_tanh"):
        return init_fedpara(gen, m, n, r, device)
    if kind == "pfedpara":
        return init_pfedpara(gen, m, n, r, device)
    raise ValueError(f"unknown parameterization kind: {kind}")


def materialize(params: ParamTree, kind: str, dtype=None) -> torch.Tensor:
    """Compose the dense weight for the given parameterization kind."""
    if kind == "original":
        return _cast(params["w"], dtype)
    if kind == "fedpara":
        return compose_fedpara(params, dtype, use_tanh=False)
    if kind == "fedpara_tanh":
        return compose_fedpara(params, dtype, use_tanh=True)
    if kind == "pfedpara":
        return compose_pfedpara(params, dtype)
    _refuse_lowrank(kind)
    raise ValueError(f"unknown parameterization kind: {kind}")


_MATRIX_KEYS = ("x1", "y1", "x2", "y2")


def factor_spec(node: Any) -> Optional[Dict[str, Any]]:
    """``{"kind": "matrix", "m", "n", "r"}`` for an unstacked matrix
    factor node (``{x1, y1[, x2, y2]}`` — pFedPara halves included),
    else ``None``. Conv and low-rank nodes are not ported yet."""
    if not isinstance(node, dict) or not node:
        return None
    if any(k not in _MATRIX_KEYS for k in node):
        return None
    if "x1" in node and "y1" in node:
        x, y = node["x1"], node["y1"]
    elif "x2" in node and "y2" in node:
        x, y = node["x2"], node["y2"]
    else:
        return None
    if getattr(x, "ndim", 0) != 2 or getattr(y, "ndim", 0) != 2:
        return None
    if x.shape[-1] != y.shape[-1]:
        return None
    return {"kind": "matrix", "m": int(x.shape[0]), "n": int(y.shape[0]),
            "r": int(x.shape[-1])}


def num_params(tree: Any) -> int:
    """Total scalar count over a tree of tensors (an exact integer)."""
    return int(sum(a.numel() for a in tree_leaves(tree)
                   if isinstance(a, torch.Tensor)))
