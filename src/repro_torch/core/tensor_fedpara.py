"""Tensor (Proposition 3) FedPara parameterization for convolution kernels
(PyTorch), the counterpart of the reference's ``core/tensor_fedpara.py``.

W = (T1 ×₁ X1 ×₂ Y1) ⊙ (T2 ×₁ X2 ×₂ Y2)  ∈ R^{O×I×K1×K2}

with Tᵢ ∈ R^{R×R×K1×K2}, Xᵢ ∈ R^{O×R}, Yᵢ ∈ R^{I×R}. Parameter count
2R(O + I + R·K1·K2); unfolding ranks rank(W⁽¹⁾) = rank(W⁽²⁾) ≤ R². The
composes are ``torch.einsum`` calls (the reference computes them in XLA,
not in a kernel of its own); the OIHW result feeds ``F.conv2d``. Every
init takes an explicit ``torch.Generator`` and ``device``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import rank_policy
from repro_torch.core.parameterization import ParamTree


def _randn(gen: torch.Generator, shape, device, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * std


def _cast(w: torch.Tensor, dtype) -> torch.Tensor:
    return w.to(dtype) if dtype is not None else w


def init_conv_fedpara(gen: torch.Generator, out_ch: int, in_ch: int, k1: int,
                      k2: int, *, gamma: float = 0.1,
                      rank: Optional[int] = None, device="cpu") -> ParamTree:
    """Prop.-3 factors ``{t1, x1, y1, t2, x2, y2}``; the std matches the
    composed kernel's variance to He's (each branch is a sum of r² three-way
    products: σ = (2/fan_in)^(1/12) / r^(1/3))."""
    r = rank if rank is not None else rank_policy.conv_rank_for_gamma(
        out_ch, in_ch, k1, k2, gamma)
    fan_in = in_ch * k1 * k2
    std = float((2.0 / fan_in) ** (1.0 / 12.0) / (r ** (1.0 / 3.0)))
    shape_t = (r, r, k1, k2)
    return {"t1": _randn(gen, shape_t, device, std),
            "x1": _randn(gen, (out_ch, r), device, std),
            "y1": _randn(gen, (in_ch, r), device, std),
            "t2": _randn(gen, shape_t, device, std),
            "x2": _randn(gen, (out_ch, r), device, std),
            "y2": _randn(gen, (in_ch, r), device, std)}


def _branch(x, y, t) -> torch.Tensor:
    return torch.einsum("oa,ib,abhw->oihw", x, y, t)


def compose_conv_fedpara(params: ParamTree, dtype=None,
                         use_tanh: bool = False) -> torch.Tensor:
    """Compose the OIHW kernel via two mode products + Hadamard (Prop. 3)."""
    w1 = _branch(params["x1"], params["y1"], params["t1"])
    w2 = _branch(params["x2"], params["y2"], params["t2"])
    if use_tanh:
        w1, w2 = torch.tanh(w1), torch.tanh(w2)
    return _cast(w1 * w2, dtype)


def init_conv_lowrank(gen: torch.Generator, out_ch: int, in_ch: int, k1: int,
                      k2: int, *, rank: int, device="cpu") -> ParamTree:
    """Tucker-2 low-rank conv baseline: W = K ×₁ X ×₂ Y with
    K ∈ R^{r×r×K1×K2}; r²K1K2 + r(O+I) parameters."""
    fan_in = in_ch * k1 * k2
    std = float((2.0 / fan_in) ** (1.0 / 3.0) / (rank ** (1.0 / 3.0)))
    return {"t": _randn(gen, (rank, rank, k1, k2), device, std),
            "x": _randn(gen, (out_ch, rank), device, std),
            "y": _randn(gen, (in_ch, rank), device, std)}


def compose_conv_lowrank(params: ParamTree, dtype=None) -> torch.Tensor:
    """The Tucker-2 OIHW kernel."""
    return _cast(_branch(params["x"], params["y"], params["t"]), dtype)


def init_conv_original(gen: torch.Generator, out_ch: int, in_ch: int,
                       k1: int, k2: int, device="cpu") -> ParamTree:
    """He-initialized dense ``{"w": (O, I, K1, K2)}``."""
    fan_in = in_ch * k1 * k2
    return {"w": _randn(gen, (out_ch, in_ch, k1, k2), device,
                        (2.0 / fan_in) ** 0.5)}


def materialize_conv(params: ParamTree, kind: str, dtype=None) -> torch.Tensor:
    """Compose the dense OIHW conv kernel for the given parameterization
    kind (original | lowrank | fedpara | fedpara_tanh)."""
    if kind == "original":
        return _cast(params["w"], dtype)
    if kind == "lowrank":
        return compose_conv_lowrank(params, dtype)
    if kind == "fedpara":
        return compose_conv_fedpara(params, dtype, use_tanh=False)
    if kind == "fedpara_tanh":
        return compose_conv_fedpara(params, dtype, use_tanh=True)
    raise ValueError(f"unknown conv parameterization kind: {kind}")


def init_conv(gen: torch.Generator, out_ch: int, in_ch: int, k1: int,
              k2: int, *, kind: str = "fedpara", gamma: float = 0.1,
              rank: Optional[int] = None, device="cpu") -> ParamTree:
    """Initialize one parameterized (out_ch, in_ch, k1, k2) conv kernel;
    ``rank=None`` resolves the inner rank from ``gamma`` via the Prop.-3
    policy (the low-rank baseline gets ``2r`` for parameter parity)."""
    if kind == "original":
        return init_conv_original(gen, out_ch, in_ch, k1, k2, device)
    if kind == "lowrank":
        r = rank if rank is not None else 2 * rank_policy.conv_rank_for_gamma(
            out_ch, in_ch, k1, k2, gamma)
        return init_conv_lowrank(gen, out_ch, in_ch, k1, k2, rank=r,
                                 device=device)
    if kind in ("fedpara", "fedpara_tanh"):
        return init_conv_fedpara(gen, out_ch, in_ch, k1, k2, gamma=gamma,
                                 rank=rank, device=device)
    raise ValueError(f"unknown conv parameterization kind: {kind}")
