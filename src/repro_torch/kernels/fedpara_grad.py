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
``:_dfactors_body``, both in their 2-D form and in their ``lead=True``
form: with x (C, B, m), dy (C, B, n) and factors (C, m, r) / (C, n, r)
every client is its own problem, and one launch serves all C clients
(the batched FL engine's backward).

:class:`FedParaMatmul` is the counterpart of that module's
``differentiable_matmul`` (``jax.custom_vjp``): its forward runs K1 (K2
for a client stack) and saves only x and the four factors, never W; its
backward runs K3 and K4.
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
from repro_torch.kernels.fedpara_matmul import (KIND_CODES, check_operands,
                                                launch)
from repro_torch.kernels.serve_matmul import X_CODES, check_status

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_dfactors_splits": [_I] * 5,
    "repro_fedpara_dfactors": [_P] * 9 + [_I] * 8 + [_P],
}


def _cfn(symbol: str):
    fn = getattr(build.library("fedpara_grad"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def fedpara_dx(dy: torch.Tensor, x1, y1, x2, y2, *,
               kind: str = "fedpara") -> torch.Tensor:
    """Launch K3: dy (B, n) fp32/bf16 with factors (m, r) / (n, r), or a
    client stack dy (C, B, n) with factors (C, m, r) / (C, n, r).
    Returns dx = dy @ Wᵀ, (B, m) / (C, B, m) in dy's dtype."""
    m, n, r = x1.shape[-2], y1.shape[-2], x1.shape[-1]
    f = check_operands(kind, dy, (*dy.shape[:-1], n), (x1, y1, x2, y2),
                       (m, n, m, n), r)
    dx = torch.empty((*dy.shape[:-1], m), dtype=dy.dtype, device=dy.device)
    launch("repro_fedpara_dx", dy, f, dx, m, n, r, kind)
    return dx


def fedpara_dfactors(x: torch.Tensor, dy: torch.Tensor, x1, y1, x2, y2, *,
                     side: str, kind: str = "fedpara"):
    """Launch K4 for one side: side "x" returns (dX1, dX2), (m, r) fp32;
    side "y" returns (dY1, dY2), (n, r) fp32. x (B, m) and dy (B, n)
    share one dtype (fp32 or bf16). With a client axis (x (C, B, m), dy
    (C, B, n), factors (C, ·, r)) every output gains it: (C, m, r) /
    (C, n, r), one launch for all clients."""
    if side not in ("x", "y"):
        raise ValueError(f"side must be 'x' or 'y', got {side!r}")
    if dy.dtype != x.dtype:
        raise ValueError(f"x ({x.dtype}) and dy ({dy.dtype}) must share a "
                         "dtype")
    m, n, r = x1.shape[-2], y1.shape[-2], x1.shape[-1]
    lead, batch = tuple(x.shape[:-2]), x.shape[-2]
    clients = x.shape[0] if x.ndim == 3 else 1
    fx1, fy1, fx2, fy2 = check_operands(kind, x, (*lead, batch, m),
                                        (x1, y1, x2, y2), (m, n, m, n), r)
    check_operands(kind, dy, (*lead, batch, n), (), (), r)
    xc, dyc = x.contiguous(), dy.contiguous()
    # side y is side x of the transposed problem (csrc/fedpara_grad.cu)
    a, d, f1, f2, h1, h2, P, Q = ((xc, dyc, fx1, fx2, fy1, fy2, m, n)
                                  if side == "x" else
                                  (dyc, xc, fy1, fy2, fx1, fx2, n, m))
    dev = x.device
    o1 = torch.empty((*lead, P, r), dtype=torch.float32, device=dev)
    o2 = torch.empty((*lead, P, r), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = _cfn("repro_dfactors_splits")(clients, P, Q, r, sms)
    scratch = (torch.empty((2, splits, clients, P, r), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        err = _cfn("repro_fedpara_dfactors")(
            a.data_ptr(), d.data_ptr(), f1.data_ptr(), f2.data_ptr(),
            h1.data_ptr(), h2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            clients, batch, P, Q, r, splits, KIND_CODES[kind],
            X_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    check_status(err, "fedpara_dfactors")
    return o1, o2


class FedParaMatmul(torch.autograd.Function):
    """y = x @ (f1(X1Y1ᵀ) ⊙ f2(X2Y2ᵀ)) with a fused backward; W is never
    materialized on the card, forward or backward.

    ``apply(x, x1, y1, x2, y2, kind, out_dtype)``: x (B, m), factors
    (m, r) / (n, r); y (B, n) in ``out_dtype`` (default x's dtype). A
    client stack x (C, B, m) with factors (C, m, r) / (C, n, r) gives y
    (C, B, n), each client through its own W (K2 forward, the client
    forms of K3 and K4 backward); clients share no parameter, so the
    gradient of a sum over clients is each client's own gradient. The
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
