"""FedPara compose on the card: launcher for ``csrc/fedpara_compose.cu``.

Writes the dense weight W = f1(X1 Y1ᵀ) ⊙ f2(X2 Y2ᵀ) to device memory in
fp32, fp16 or bf16, each element rounded once at its store: the serving
path's pre-composition (``serve/cache.py``, ``nn/layers.py::
precompose_tree``). Factors (m, r) / (n, r) give (m, n) (K5, replacing
``repro/kernels/fedpara_compose.py:_kernel``); a leading axis, factors
(L, m, r) / (L, n, r) (a layer-stacked node), gives (L, m, n) in one
launch (K6, ``_kernel_batched``): the kernel's persistent blocks walk
every (layer, tile). The products run on the tensor cores in 3xTF32
(``ref.fedpara_compose_tf32`` is the host twin of that arithmetic), at
any rank.

The launcher takes CUDA tensors only and launches unconditionally;
``repro_torch.kernels.ops`` dispatches between it and the plain version
and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedpara_matmul import KIND_CODES
from repro_torch.kernels.serve_matmul import _sms, check_status

OUT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def fedpara_compose(x1: torch.Tensor, y1, x2, y2, *, kind: str = "fedpara",
                    out_dtype=torch.float32) -> torch.Tensor:
    """Launch K5 on factors (m, r) / (n, r), or K6 on stacked factors
    (L, m, r) / (L, n, r); returns W (m, n) / (L, m, n) in
    ``out_dtype``."""
    if kind not in KIND_CODES:
        raise ValueError(f"unsupported compose kind: {kind!r}")
    if out_dtype not in OUT_CODES:
        raise ValueError(f"compose writes float32/float16/bfloat16, not "
                         f"{out_dtype}")
    if x1.ndim not in (2, 3):
        raise ValueError(f"factors must be (m, r) or (L, m, r), got "
                         f"{tuple(x1.shape)}")
    lead = tuple(x1.shape[:-2])
    m, r = x1.shape[-2:]
    n = y1.shape[-2]
    want = {"x1": (*lead, m, r), "y1": (*lead, n, r), "x2": (*lead, m, r),
            "y2": (*lead, n, r)}
    fac = []
    for name, f in zip(want, (x1, y1, x2, y2)):
        if tuple(f.shape) != want[name] or f.device != x1.device:
            raise ValueError(f"{name} {tuple(f.shape)} on {f.device}, want "
                             f"{want[name]} on {x1.device}")
        fac.append(f.float().contiguous())
    w = torch.empty((*lead, m, n), dtype=out_dtype, device=x1.device)
    fn = build.library("fedpara_compose").repro_fedpara_compose
    if fn.argtypes is None:
        fn.argtypes = SIGNATURE
        fn.restype = ctypes.c_int
    with torch.cuda.device(x1.device):
        err = fn(*(f.data_ptr() for f in fac), w.data_ptr(),
                 lead[0] if lead else 1, m, n, r, KIND_CODES[kind],
                 OUT_CODES[out_dtype], _sms(x1.device),
                 torch.cuda.current_stream(x1.device).cuda_stream)
    check_status(err, "repro_fedpara_compose")
    return w


def smem_bytes() -> int:
    """Dynamic shared memory per block of the compose kernel, in bytes
    (the same at every shape; ptxas reports static shared memory only)."""
    fn = build.library("fedpara_compose").repro_fedpara_compose_smem_bytes
    fn.restype = ctypes.c_size_t
    return int(fn())
