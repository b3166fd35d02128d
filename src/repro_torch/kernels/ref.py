"""Plain PyTorch versions of the port's kernels.

Each function computes what one hand-written CUDA kernel computes,
densely and in fp32, the way the reference's ``kernels/ref.py`` oracles
do. They are the CPU path of ``repro_torch.kernels.ops`` (a tensor on
the host takes them) and the oracle the kernels are held against on
the card. ``kind`` selects the paper variant: "fedpara" (identity),
"fedpara_tanh" (tanh ⊙ tanh, supp. B) or "pfedpara" (the "+1 switch",
§2.3).

The fused-matmul functions also take the client-stacked form of the
batched FL engine (K2 and the client-axis K3/K4): x (C, B, m) with
factors (C, m, r) / (C, n, r), every client against its own W. The
products run over the last two axes, so a leading client axis rides
along.
"""
from __future__ import annotations

import torch

KINDS = ("fedpara", "fedpara_tanh", "pfedpara")


def _hadamard(w1, w2, kind: str) -> torch.Tensor:
    """f1(W1) ⊙ f2(W2) for the paper variant ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    if kind == "fedpara_tanh":
        w1, w2 = torch.tanh(w1), torch.tanh(w2)
    if kind == "pfedpara":
        w2 = w2 + 1.0
    return w1 * w2


def fedpara_compose_ref(x1, y1, x2, y2, *, kind: str = "fedpara",
                        out_dtype=None) -> torch.Tensor:
    """W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ), computed densely in fp32; (m, n), or
    (C, m, n) for client-stacked factors."""
    w1 = x1.float() @ y1.float().mT
    w2 = x2.float() @ y2.float().mT
    return _hadamard(w1, w2, kind).to(out_dtype or x1.dtype)


# ---------------------------------------------- the kernels' precision

_TF32_MASK = -0x2000   # 0xffffe000 as int32: sign, exponent, 10 mantissa bits


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits, the low 13 cleared), to nearest
    with ties away from zero, by bit operations on an int32 view: the
    host twin of ``csrc/mma.cuh:tf32_rna``. Returns fp32 holding TF32
    values."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & _TF32_MASK).view(torch.float32)


def split_3xtf32(t: torch.Tensor):
    """(hi, lo) as the fused matmul's 3xTF32 products take an fp32
    operand: hi = tf32_round(t), and lo = t - hi (exact in fp32) as the
    tensor core reads it, truncated to TF32 (``csrc/mma.cuh:split``)."""
    hi = tf32_round(t)
    lo = (t.float() - hi).contiguous().view(torch.int32) & _TF32_MASK
    return hi, lo.view(torch.float32)


def _tf32_product(a, b, passes: int) -> torch.Tensor:
    """a @ bᵀ from TF32 operands with fp32 sums: the single pass
    a_hi·b_hiᵀ, or the 3xTF32 sum a_lo·b_hiᵀ + a_hi·b_loᵀ + a_hi·b_hiᵀ."""
    ah, al = split_3xtf32(a)
    bh, bl = split_3xtf32(b)
    if passes == 1:
        return ah @ bh.mT
    if passes == 3:
        return al @ bh.mT + ah @ bl.mT + ah @ bh.mT
    raise ValueError(f"passes must be 1 or 3, got {passes}")


def fedpara_compose_tf32(x1, y1, x2, y2, *, kind: str = "fedpara",
                         passes: int = 3) -> torch.Tensor:
    """W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ) in fp32 with each rank-r product
    taken as the fused matmul (``csrc/fedpara_matmul.cu``) takes it on
    the tensor cores: ``passes=3`` is its 3xTF32 compose, ``passes=1`` a
    single TF32 pass (the cheaper design it does not use)."""
    w1 = _tf32_product(x1.float(), y1.float(), passes)
    w2 = _tf32_product(x2.float(), y2.float(), passes)
    return _hadamard(w1, w2, kind)


def w8_matmul_tf32(x, w, scale=None, *, passes: int = 2) -> torch.Tensor:
    """y = (x @ W) · s with fp32 x as K8's prefill kernel takes it on the
    tensor cores (``csrc/serve_matmul.cu``): W widened exactly (every
    int8 and finite fp16 value is a TF32 value), x split into TF32 halves,
    ``passes=2`` its x_hi·W + x_lo·W, ``passes=1`` x_hi·W alone; the scale
    on the fp32 result. Returns fp32."""
    wf = w.float()
    xh, xl = split_3xtf32(x.float())
    if passes == 1:
        y = xh @ wf
    elif passes == 2:
        y = xl @ wf + xh @ wf
    else:
        raise ValueError(f"passes must be 1 or 2, got {passes}")
    return y if scale is None else y * scale.reshape(1, -1).float()


def cache_residual_tf32(x, w, scale, x2, y2) -> torch.Tensor:
    """K9/K10 as the kernel computes it (``csrc/fused.cuh`` with
    ``ResidOp``): the residual X2ᵤY2ᵤᵀ in 3xTF32, the cache value exact,
    W' = W ⊙ (R + 1) in fp32 and rounded once (to bf16 for bf16 x; into
    TF32 halves for a 3xTF32 contraction with fp32 x), the scale on the
    fp32 result. Shapes as :func:`cache_residual_ref`; returns fp32."""
    wu = w.float() * (_tf32_product(x2.float(), y2.float(), 3) + 1.0)
    if x.dtype == torch.bfloat16:
        y = x.float() @ wu.to(torch.bfloat16).float()
    else:
        y = _tf32_product(x.float(), wu.mT, 3)
    return y if scale is None else y * scale.reshape(1, -1).float()


def fedpara_matmul_ref(x, x1, y1, x2, y2, *, kind: str = "fedpara",
                       out_dtype=None) -> torch.Tensor:
    """y = x @ W with W = f1(X1Y1ᵀ)⊙f2(X2Y2ᵀ); x: (B, m) -> y: (B, n), or
    (C, B, m) -> (C, B, n) per client (K2's function)."""
    w = fedpara_compose_ref(x1, y1, x2, y2, kind=kind,
                            out_dtype=torch.float32)
    return (x.float() @ w).to(out_dtype or x.dtype)


def _variants(x1, y1, x2, y2, kind: str):
    """(W1, W2, f1(W1), f2(W2), f1'(W1), f2'(W2)) densely in fp32; the
    derivatives are None where they are 1."""
    if kind not in KINDS:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    w1 = x1.float() @ y1.float().mT
    w2 = x2.float() @ y2.float().mT
    if kind == "fedpara_tanh":
        t1, t2 = torch.tanh(w1), torch.tanh(w2)
        return w1, w2, t1, t2, 1.0 - t1 * t1, 1.0 - t2 * t2
    return w1, w2, w1, (w2 + 1.0 if kind == "pfedpara" else w2), None, None


def fedpara_dx_ref(dy, x1, y1, x2, y2, *, kind: str = "fedpara",
                   out_dtype=None) -> torch.Tensor:
    """dx = dy @ Wᵀ (K3's function); dy (B, n) -> dx (B, m), or
    (C, B, n) -> (C, B, m) per client. Like K3 it casts W to dy's dtype
    before the contraction, then accumulates in fp32."""
    w = fedpara_compose_ref(x1, y1, x2, y2, kind=kind, out_dtype=dy.dtype)
    return (dy.float() @ w.float().mT).to(out_dtype or dy.dtype)


def _factor_grads(x, dy, x1, y1, x2, y2, kind: str):
    """(G1, G2) = (dW ⊙ f2(W2) ⊙ f1'(W1), dW ⊙ f1(W1) ⊙ f2'(W2)) with
    dW = xᵀ dy, densely in fp32."""
    _, _, f1, f2, d1, d2 = _variants(x1, y1, x2, y2, kind)
    dw = x.float().mT @ dy.float()
    g1 = dw * f2 if d1 is None else dw * f2 * d1
    g2 = dw * f1 if d2 is None else dw * f1 * d2
    return g1, g2


def fedpara_dfactors_ref(x, dy, x1, y1, x2, y2, *, side: str,
                         kind: str = "fedpara"):
    """K4's function, fp32: side "x" gives (dX1, dX2) = (G1 Y1, G2 Y2),
    side "y" gives (dY1, dY2) = (G1ᵀ X1, G2ᵀ X2); per client for x
    (C, B, m), dy (C, B, n) and (C, ·, r) factors."""
    g1, g2 = _factor_grads(x, dy, x1, y1, x2, y2, kind)
    if side == "x":
        return g1 @ y1.float(), g2 @ y2.float()
    if side == "y":
        return g1.mT @ x1.float(), g2.mT @ x2.float()
    raise ValueError(f"side must be 'x' or 'y', got {side!r}")


def fedpara_dfactors_tf32(x, dy, x1, y1, x2, y2, *, side: str,
                          kind: str = "fedpara", passes: int = 3):
    """K4 as the kernel computes it on the tensor cores
    (``csrc/fedpara_grad.cu``): dW = xᵀdy from bf16 products (exact in
    fp32) or, for fp32 activations, in TF32 passes; W1, W2 and the
    contractions G·H (side x) or Gᵀ·F (side y) in TF32 passes; G in
    fp32. ``passes=3`` is the kernel's 3xTF32, ``passes=1`` a single
    TF32 pass (the cheaper design it does not use). Shapes as
    :func:`fedpara_dfactors_ref`; returns fp32."""
    if side not in ("x", "y"):
        raise ValueError(f"side must be 'x' or 'y', got {side!r}")
    if x.dtype == torch.bfloat16:
        dw = x.float().mT @ dy.float()
    else:
        dw = _tf32_product(x.float().mT, dy.float().mT, passes)
    w1 = _tf32_product(x1.float(), y1.float(), passes)
    w2 = _tf32_product(x2.float(), y2.float(), passes)
    if kind == "fedpara_tanh":
        t1, t2 = torch.tanh(w1), torch.tanh(w2)
        g1, g2 = dw * t2 * (1.0 - t1 * t1), dw * t1 * (1.0 - t2 * t2)
    elif kind in KINDS:
        g1 = dw * (w2 + 1.0 if kind == "pfedpara" else w2)
        g2 = dw * w1
    else:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    if side == "x":   # G·H with H = Y: a @ bᵀ for b = Yᵀ
        return (_tf32_product(g1, y1.float().mT, passes),
                _tf32_product(g2, y2.float().mT, passes))
    return (_tf32_product(g1.mT, x1.float().mT, passes),
            _tf32_product(g2.mT, x2.float().mT, passes))


def fedpara_matmul_vjp_ref(x, x1, y1, x2, y2, dy, *, kind: str = "fedpara"):
    """Closed-form dense VJP oracle: (dx, dX1, dY1, dX2, dY2) in fp32
    (dx in x's dtype), the reference's ``kernels/ref.py:133-169``:
    materializes W, dW = xᵀdy and the chain-rule terms — the ground truth
    the backward kernels reproduce without building them."""
    _, _, f1, f2, _, _ = _variants(x1, y1, x2, y2, kind)
    g1, g2 = _factor_grads(x, dy, x1, y1, x2, y2, kind)
    dx = (dy.float() @ (f1 * f2).mT).to(x.dtype)
    return (dx, g1 @ y1.float(), g1.mT @ x1.float(), g2 @ y2.float(),
            g2.mT @ x2.float())


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


def dequant_acc_ref(acc, q, coeff) -> torch.Tensor:
    """K7's function: acc (L,) + coeff (C,) @ float(q (C, L)), in fp32
    (the reference's ``kernels/ref.py:67``); returns a new tensor."""
    return acc + torch.tensordot(coeff.float(), q.float(), dims=1)


def is_qnode(n) -> bool:
    """Whether a wire-tree node is an int8 ``{"q", "scale"}`` node."""
    return isinstance(n, dict) and set(n) == {"q", "scale"}


def tree_dequant_acc_ref(acc_tree, wire, weights):
    """Tree-level oracle (the reference's ``kernels/ref.py:75``):
    dequantize every client's wire leaf densely (``{"q", "scale"}`` nodes
    to fp32) and add its weighted sum over the client axis to the
    accumulator; returns a new tree."""
    w = weights.float()

    def walk(acc, n):
        if is_qnode(n):
            C = n["q"].shape[0]
            deq = (n["q"].float().reshape(C, -1)
                   * n["scale"].reshape(C, 1).float())
            return acc + torch.tensordot(w, deq, dims=1).reshape(acc.shape)
        if isinstance(n, dict):
            return {k: walk(acc[k], v) for k, v in n.items()}
        if isinstance(n, (list, tuple)):
            return type(n)(walk(a, v) for a, v in zip(acc, n))
        C = n.shape[0]
        return acc + torch.tensordot(
            w, n.float().reshape(C, -1), dims=1).reshape(acc.shape)

    return walk(acc_tree, wire)
