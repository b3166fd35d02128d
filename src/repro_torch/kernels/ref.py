"""Plain PyTorch versions of the port's kernels.

Each function computes what one hand-written CUDA kernel computes,
densely and in fp32, the way the reference's ``kernels/ref.py`` oracles
do. They are the CPU path of ``repro_torch.kernels.ops`` (a tensor on
the host takes them) and the oracle the kernels are held against on
the card. ``kind`` selects the paper variant: "fedpara" (identity),
"fedpara_tanh" (tanh ⊙ tanh, supp. B) or "pfedpara" (the "+1 switch",
§2.3).
"""
from __future__ import annotations

import torch

KINDS = ("fedpara", "fedpara_tanh", "pfedpara")


def fedpara_compose_ref(x1, y1, x2, y2, *, kind: str = "fedpara",
                        out_dtype=None) -> torch.Tensor:
    """W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ), computed densely in fp32."""
    if kind not in KINDS:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    w1 = x1.float() @ y1.float().T
    w2 = x2.float() @ y2.float().T
    if kind == "fedpara_tanh":
        w1, w2 = torch.tanh(w1), torch.tanh(w2)
    if kind == "pfedpara":
        w2 = w2 + 1.0
    return (w1 * w2).to(out_dtype or x1.dtype)


def fedpara_matmul_ref(x, x1, y1, x2, y2, *, kind: str = "fedpara",
                       out_dtype=None) -> torch.Tensor:
    """y = x @ W with W = f1(X1Y1ᵀ)⊙f2(X2Y2ᵀ); x: (B, m) -> y: (B, n)."""
    w = fedpara_compose_ref(x1, y1, x2, y2, kind=kind,
                            out_dtype=torch.float32)
    return (x.float() @ w).to(out_dtype or x.dtype)


def _dequant(w, scale) -> torch.Tensor:
    wf = w.float()
    if scale is not None:
        wf = wf * scale.reshape(1, -1).float()
    return wf


def w8_matmul_ref(x, w, scale=None, *, out_dtype=None) -> torch.Tensor:
    """y = (x @ W) · s, dequantizing the whole cache to fp32 up front
    (the widening the kernel avoids outside its tiles)."""
    return (x.float() @ _dequant(w, scale)).to(out_dtype or x.dtype)


def cache_residual_ref(x, w, scale, x2, y2, *, out_dtype=None
                       ) -> torch.Tensor:
    """y = x @ (dequant(W) ⊙ (X2ᵤY2ᵤᵀ + 1)) per user. Single user: x
    (B, m), X2 (m, r), Y2 (n, r); many users: x (U, t, m) with per-user
    factors (U, m, r) / (U, n, r) against one shared cache."""
    wf = _dequant(w, scale)
    xf, x2f, y2f = x.float(), x2.float(), y2.float()
    if x.ndim == 3:
        wu = wf[None] * (torch.einsum("umr,unr->umn", x2f, y2f) + 1.0)
        y = torch.einsum("utm,umn->utn", xf, wu)
    else:
        y = xf @ (wf * (x2f @ y2f.T + 1.0))
    return y.to(out_dtype or x.dtype)
