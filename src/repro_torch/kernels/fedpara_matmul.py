"""Fused FedPara forward matmul on the card: launcher for
``csrc/fedpara_matmul.cu``.

Computes y = x @ W with W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ) without writing W
to device memory: each (32 x 64) tile of Wᵀ is composed on the tensor
cores at fp32 accuracy (3xTF32), cast to the activation dtype in shared
memory and contracted at once on the tensor cores. Replaces
``repro/kernels/fedpara_matmul.py:_kernel`` (K1) and, with a leading
client axis (x (C, B, m), factors (C, m, r) / (C, n, r), the client on
grid axis z), ``_kernel_batched`` (K2): one launch for all the clients
of a batched FL step. A launch too small to fill the card splits the
contraction axis across blocks; the wrapper then allocates the fp32
workspace of the partial sums. The backward kernels (K3, which runs
this kernel on the transposed weight, and K4) are launched from
``kernels/fedpara_grad.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.serve_matmul import X_CODES, check_status

KIND_CODES = {"fedpara": 0, "fedpara_tanh": 1, "pfedpara": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_fedpara_splits": [_I] * 7,
    "repro_fedpara_matmul": [_P] * 7 + [_I] * 8 + [_P],
    "repro_fedpara_dx": [_P] * 7 + [_I] * 8 + [_P],
}


def _cfn(symbol: str):
    fn = getattr(build.library("fedpara_matmul"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def check_operands(kind: str, act: torch.Tensor, want: tuple, factors,
                   dims, r: int):
    """Validate a fused-matmul launch: ``act`` has shape ``want``,
    (rows, cols) or (C, rows, cols), in fp32/bf16; each factor is
    (d, r), or (C, d, r) with the same C, on act's device. Returns the
    factors as contiguous fp32 tensors."""
    if kind not in KIND_CODES:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    if act.ndim not in (2, 3) or act.dtype not in X_CODES:
        raise ValueError(f"activations must be 2-D or 3-D (client-stacked) "
                         f"float32/bfloat16, got {tuple(act.shape)} "
                         f"{act.dtype}")
    if tuple(act.shape) != tuple(want):
        raise ValueError(f"activations {tuple(act.shape)}, want {tuple(want)}")
    lead = tuple(want[:-2])
    out = []
    for f, d in zip(factors, dims):
        if tuple(f.shape) != (*lead, d, r) or f.device != act.device:
            raise ValueError(f"factor {tuple(f.shape)} on {f.device}, "
                             f"want {(*lead, d, r)} on {act.device}")
        out.append(f.float().contiguous())
    return out


def launch(symbol: str, act: torch.Tensor, factors, out: torch.Tensor,
           m: int, n: int, r: int, kind: str) -> None:
    """Call ``repro_fedpara_matmul`` / ``repro_fedpara_dx`` on a checked
    (rows, m) or (C, rows, m) activation and write ``out``; allocates the
    split-sum workspace when the launch splits its contraction axis."""
    clients = act.shape[0] if act.ndim == 3 else 1
    rows = act.shape[-2]
    # the contraction runs over m (forward) or n (dx, the transposed W)
    k_len, width = (n, m) if symbol == "repro_fedpara_dx" else (m, n)
    dev = act.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ac = act.contiguous()
    with torch.cuda.device(dev):
        splits = _cfn("repro_fedpara_splits")(clients, rows, k_len, width, r,
                                               X_CODES[act.dtype], sms)
        ws = (torch.empty((splits, clients, rows, width), dtype=torch.float32,
                          device=dev) if splits > 1 else None)
        err = _cfn(symbol)(ac.data_ptr(), *(a.data_ptr() for a in factors),
                           out.data_ptr(),
                           ws.data_ptr() if ws is not None else None, clients,
                           rows, m, n, r, KIND_CODES[kind], X_CODES[act.dtype],
                           splits, torch.cuda.current_stream(dev).cuda_stream)
    check_status(err, symbol)


def fedpara_matmul(x: torch.Tensor, x1, y1, x2, y2, *,
                   kind: str = "fedpara") -> torch.Tensor:
    """Launch K1 on x (B, m) with factors (m, r) / (n, r), or K2 on a
    client stack x (C, B, m) with factors (C, m, r) / (C, n, r). Returns
    (B, n) / (C, B, n) in x's dtype."""
    m, n, r = x1.shape[-2], y1.shape[-2], x1.shape[-1]
    f = check_operands(kind, x, (*x.shape[:-1], m), (x1, y1, x2, y2),
                       (m, n, m, n), r)
    y = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    launch("repro_fedpara_matmul", x, f, y, m, n, r, kind)
    return y
