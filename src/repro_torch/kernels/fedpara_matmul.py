"""Fused FedPara forward matmul on the card: launcher for
``csrc/fedpara_matmul.cu``.

Computes y = x @ W with W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ) without writing W
to device memory: each (32 x 32) tile of W is composed in shared memory
from factor slices, cast to the activation dtype and contracted at
once. Replaces ``repro/kernels/fedpara_matmul.py:_kernel`` (K1). The
backward kernels (K3, which runs this kernel on the transposed weight,
and K4) are launched from ``kernels/fedpara_grad.py``; the
client-stacked ``_kernel_batched`` (K2) waits for the batched engine.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.serve_matmul import X_CODES, check_status

KIND_CODES = {"fedpara": 0, "fedpara_tanh": 1, "pfedpara": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def _factor(f: torch.Tensor, rows: int, r: int, device) -> torch.Tensor:
    if f.shape != (rows, r) or f.device != device:
        raise ValueError(f"factor {tuple(f.shape)} on {f.device}, "
                         f"want ({rows}, {r}) on {device}")
    return f.float().contiguous()


def fedpara_matmul(x: torch.Tensor, x1, y1, x2, y2, *,
                   kind: str = "fedpara") -> torch.Tensor:
    """Launch K1: x (B, m) fp32/bf16, factors (m, r) / (n, r). Returns
    (B, n) in x's dtype."""
    if kind not in KIND_CODES:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    if x.ndim != 2 or x.dtype not in X_CODES:
        raise ValueError(f"x must be 2-D float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    rows, m = x.shape
    n, r = y1.shape[0], x1.shape[1]
    f = [_factor(a, d, r, x.device) for a, d in ((x1, m), (y1, n),
                                                  (x2, m), (y2, n))]
    xc = x.contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    fn = build.library("fedpara_matmul").repro_fedpara_matmul
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(xc.data_ptr(), *(a.data_ptr() for a in f), y.data_ptr(),
                 rows, m, n, r, KIND_CODES[kind], X_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    check_status(err, "fedpara_matmul")
    return y
