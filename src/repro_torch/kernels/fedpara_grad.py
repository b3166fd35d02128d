"""Fused FedPara backward on the card, and the autograd wiring.

Gradients of y = x @ W, W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ):

  dx  = dy @ Wᵀ                       K3 (``fedpara_dx``)
  G1  = dW ⊙ f2(W2) ⊙ f1'(W1)         dX1 = G1 Y1,  dY1 = G1ᵀ X1
  G2  = dW ⊙ f1(W1) ⊙ f2'(W2)         dX2 = G2 Y2,  dY2 = G2ᵀ X2
  dW  = xᵀ dy                         K4 (``fedpara_dfactors``), side x / y

Neither W nor dW reaches device memory. K3 is the K1 kernel of
``csrc/fedpara_matmul.cu`` run on the transposed weight
(``repro_fedpara_dx``); K4 is ``csrc/fedpara_grad.cu``, launched once per
side. They replace ``repro/kernels/fedpara_grad.py:_dx_body`` and
``:_dfactors_body``.

:class:`FedParaMatmul` is the counterpart of that module's
``differentiable_matmul`` (``jax.custom_vjp``): its forward runs K1 and
saves only x and the four factors, never W; its backward runs K3 and K4.
It dispatches through ``repro_torch.kernels.ops``, so on a CPU tensor the
forward and backward take the plain versions (``kernels/ref.py``), and on
a CUDA tensor they launch the kernels or raise.

The launchers here take CUDA tensors only and launch unconditionally.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.fedpara_matmul import KIND_CODES
from repro_torch.kernels.serve_matmul import X_CODES, check_status

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_fedpara_dx": ("fedpara_matmul",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "repro_dfactors_splits": ("fedpara_grad", [_I, _I, _I, _I]),
    "repro_fedpara_dfactors": ("fedpara_grad",
                               [_P] * 9 + [_I] * 7 + [_P]),
}


def _cfn(symbol: str):
    lib, argtypes = _SIGNATURES[symbol]
    fn = getattr(build.library(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(kind: str, act: torch.Tensor, rows_cols, factors, dims, r):
    if kind not in KIND_CODES:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    if act.ndim != 2 or act.dtype not in X_CODES:
        raise ValueError(f"activations must be 2-D float32/bfloat16, got "
                         f"{tuple(act.shape)} {act.dtype}")
    if tuple(act.shape) != rows_cols:
        raise ValueError(f"activations {tuple(act.shape)}, want {rows_cols}")
    out = []
    for f, d in zip(factors, dims):
        if f.shape != (d, r) or f.device != act.device:
            raise ValueError(f"factor {tuple(f.shape)} on {f.device}, "
                             f"want ({d}, {r}) on {act.device}")
        out.append(f.float().contiguous())
    return out


def fedpara_dx(dy: torch.Tensor, x1, y1, x2, y2, *,
               kind: str = "fedpara") -> torch.Tensor:
    """Launch K3: dy (B, n) fp32/bf16, factors (m, r) / (n, r). Returns
    dx = dy @ Wᵀ, (B, m) in dy's dtype."""
    m, n, r = x1.shape[0], y1.shape[0], x1.shape[1]
    f = _check(kind, dy, (dy.shape[0], n), (x1, y1, x2, y2), (m, n, m, n), r)
    dyc = dy.contiguous()
    dx = torch.empty((dy.shape[0], m), dtype=dy.dtype, device=dy.device)
    with torch.cuda.device(dy.device):
        err = _cfn("repro_fedpara_dx")(
            dyc.data_ptr(), *(a.data_ptr() for a in f), dx.data_ptr(),
            dy.shape[0], m, n, r, KIND_CODES[kind], X_CODES[dy.dtype],
            torch.cuda.current_stream(dy.device).cuda_stream)
    check_status(err, "fedpara_dx")
    return dx


def fedpara_dfactors(x: torch.Tensor, dy: torch.Tensor, x1, y1, x2, y2, *,
                     side: str, kind: str = "fedpara"):
    """Launch K4 for one side: side "x" returns (dX1, dX2), (m, r) fp32;
    side "y" returns (dY1, dY2), (n, r) fp32. x (B, m) and dy (B, n)
    share one dtype (fp32 or bf16)."""
    if side not in ("x", "y"):
        raise ValueError(f"side must be 'x' or 'y', got {side!r}")
    if dy.dtype != x.dtype:
        raise ValueError(f"x ({x.dtype}) and dy ({dy.dtype}) must share a "
                         "dtype")
    m, n, r = x1.shape[0], y1.shape[0], x1.shape[1]
    batch = x.shape[0]
    fx1, fy1, fx2, fy2 = _check(kind, x, (batch, m), (x1, y1, x2, y2),
                                (m, n, m, n), r)
    _check(kind, dy, (batch, n), (), (), r)
    xc, dyc = x.contiguous(), dy.contiguous()
    # side y is side x of the transposed problem (csrc/fedpara_grad.cu)
    a, d, f1, f2, h1, h2, P, Q = ((xc, dyc, fx1, fx2, fy1, fy2, m, n)
                                  if side == "x" else
                                  (dyc, xc, fy1, fy2, fx1, fx2, n, m))
    dev = x.device
    o1 = torch.empty((P, r), dtype=torch.float32, device=dev)
    o2 = torch.empty((P, r), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = _cfn("repro_dfactors_splits")(P, Q, r, sms)
    scratch = (torch.empty((2, splits, P, r), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        err = _cfn("repro_fedpara_dfactors")(
            a.data_ptr(), d.data_ptr(), f1.data_ptr(), f2.data_ptr(),
            h1.data_ptr(), h2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            batch, P, Q, r, splits, KIND_CODES[kind], X_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    check_status(err, "fedpara_dfactors")
    return o1, o2


class FedParaMatmul(torch.autograd.Function):
    """y = x @ (f1(X1Y1ᵀ) ⊙ f2(X2Y2ᵀ)) with a fused backward; W is never
    materialized on the card, forward or backward.

    ``apply(x, x1, y1, x2, y2, kind, out_dtype)``: x (B, m), factors
    (m, r) / (n, r); y (B, n) in ``out_dtype`` (default x's dtype). The
    gradients come back in the dtypes of their primals, as
    ``differentiable_matmul`` casts them (``fedpara_grad.py:383-386``).
    """

    @staticmethod
    def forward(ctx, x, x1, y1, x2, y2, kind, out_dtype):
        from repro_torch.kernels import ops

        ctx.kind = kind
        ctx.save_for_backward(x, x1, y1, x2, y2)
        return ops.fedpara_forward(x, x1, y1, x2, y2, kind=kind,
                                   out_dtype=out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        from repro_torch.kernels import ops

        x, x1, y1, x2, y2 = ctx.saved_tensors
        kind = ctx.kind
        need = ctx.needs_input_grad
        dx = dx1 = dy1 = dx2 = dy2 = None
        if need[0]:
            dx = ops.fedpara_dx(dy, x1, y1, x2, y2, kind=kind,
                                out_dtype=x.dtype)
        act = dy.to(x.dtype)
        if need[1] or need[3]:
            dx1, dx2 = ops.fedpara_dfactors(x, act, x1, y1, x2, y2,
                                            side="x", kind=kind)
            dx1, dx2 = dx1.to(x1.dtype), dx2.to(x2.dtype)
        if need[2] or need[4]:
            dy1, dy2 = ops.fedpara_dfactors(x, act, x1, y1, x2, y2,
                                            side="y", kind=kind)
            dy1, dy2 = dy1.to(y1.dtype), dy2.to(y2.dtype)
        return dx, dx1, dy1, dx2, dy2, None, None
