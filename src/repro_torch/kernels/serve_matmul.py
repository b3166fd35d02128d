"""Serve-path kernels on the card: launchers for ``csrc/serve_matmul.cu``
and the Hadamard-Gram decode.

``w8_matmul``
    y = (x @ W_q) · s for a pre-composed cache stored int8 (or fp16,
    ``scale=None``). The cache tile is widened on chip only; the
    per-column scale is applied once to the fp32 accumulator. Decode
    widths (rows <= 32) take a CUDA-core kernel bound by the cache's
    bytes, prefill widths a tensor-core GEMM. Replaces
    ``repro/kernels/serve_matmul.py:_w8_kernel`` (K8).

``cache_residual_matmul``
    y = (x @ (W_q ⊙ (X2ᵤY2ᵤᵀ + 1))) · s — pFedPara serving against the
    shared W1 cache; the residual tile is composed on chip, on the
    tensor cores at fp32 accuracy (3xTF32). x (U, t, m) with per-user
    factors (U, m, r) / (U, n, r); a 2-D x is one user (U = 1).
    Replaces ``_resid_kernel`` (K9) and ``_resid_kernel_users`` (K10):
    on Hopper both are one kernel with the user on grid axis z.

A launch too small to fill the card splits the contraction axis across
blocks; the wrapper then allocates the fp32 workspace of the partial
sums, which a second pass adds in a fixed order.

``fedpara_gram_decode``
    The decode-batch fused path through the Gram identity. The
    reference computes it with XLA einsums outside any Pallas kernel,
    and the port keeps it as plain torch einsums.

The launchers here take CUDA tensors only and launch unconditionally;
``repro_torch.kernels.ops`` dispatches between them and the plain
versions and counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

X_CODES = {torch.float32: 0, torch.bfloat16: 1}
W_CODES = {torch.int8: 0, torch.float16: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_w8_splits": [_I] * 6,
    "repro_w8_matmul": [_P] * 5 + [_I] * 6 + [_P],
    "repro_cache_residual_splits": [_I] * 8,
    "repro_cache_residual": [_P] * 7 + [_I] * 5 + [_LL, _LL] + [_I] * 3 + [_P],
    "repro_serve_smem_bytes": [_I] * 5,
}


def _cfn(symbol: str):
    fn = getattr(build.library("serve_matmul"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def check_status(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _x_code(x: torch.Tensor) -> int:
    _require(x.dtype in X_CODES,
             f"activations must be float32 or bfloat16, got {x.dtype}")
    return X_CODES[x.dtype]


def _scale_vec(scale, n: int, device):
    if scale is None:
        return None
    s = scale.reshape(-1)
    _require(s.numel() == n and s.dtype == torch.float32
             and s.device == device,
             "scale must be n fp32 values on the activations' device")
    return s.contiguous()


@functools.lru_cache(maxsize=None)
def _splits(symbol: str, *shape: int) -> int:
    """A launch's split count from the CUDA source's own query (an
    occupancy computation), once per shape: serving calls the same few
    shapes every layer and step, and decode is bound by host time."""
    return _cfn(symbol)(*shape)


def _workspace(splits: int, shape, device):
    """The fp32 partial sums of a launch split ``splits`` ways (None when
    it is not split)."""
    if splits <= 1:
        return None
    return torch.empty((splits, *shape), dtype=torch.float32, device=device)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes(kernel: str, rows: int, r: int, x_dtype, w_dtype) -> int:
    """The dynamic shared memory of one block that ``kernel`` ("w8" for
    K8, "resid" for K9/K10) launches at ``rows`` activation rows (per
    user) and rank ``r``, from the CUDA source's own launch table."""
    return _cfn("repro_serve_smem_bytes")(
        {"w8": 0, "resid": 1}[kernel], rows, r, X_CODES[x_dtype],
        W_CODES[w_dtype])


def w8_matmul(x: torch.Tensor, w: torch.Tensor, scale=None) -> torch.Tensor:
    """Launch K8: x (B, m) fp32/bf16, W (m, n) int8/fp16 contiguous,
    scale (n,) or (1, n) fp32 or None. Returns (B, n) in x's dtype."""
    _require(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[0],
             f"w8_matmul: x {tuple(x.shape)} and W {tuple(w.shape)}")
    _require(w.dtype in W_CODES, f"cache must be int8 or fp16, got {w.dtype}")
    _require(w.is_contiguous() and w.device == x.device,
             "cache must be contiguous and on the activations' device")
    xc = x.contiguous()
    rows, m = xc.shape
    n = w.shape[1]
    s = _scale_vec(scale, n, x.device)
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    xcode, wcode = _x_code(xc), W_CODES[w.dtype]
    with torch.cuda.device(x.device):
        splits = _splits("repro_w8_splits", rows, m, n, xcode, wcode,
                         _sms(x.device))
        ws = _workspace(splits, (rows, n), x.device)
        err = _cfn("repro_w8_matmul")(
            xc.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
            y.data_ptr(), None if ws is None else ws.data_ptr(), rows, m, n,
            xcode, wcode, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(err, "w8_matmul")
    return y


def _user_slabs(f: torch.Tensor, rows: int, r: int) -> torch.Tensor:
    """Validate per-user factors (U, rows, r): each user's slab must be a
    contiguous fp32 matrix; the user stride may be anything."""
    _require(f.dtype == torch.float32, "residual factors must be fp32")
    _require(f.shape[1:] == (rows, r),
             f"residual factor shape {tuple(f.shape)}, want (U, {rows}, {r})")
    if f.stride(2) != 1 or f.stride(1) != r:
        f = f.contiguous()
    return f


def cache_residual_matmul(x: torch.Tensor, w: torch.Tensor, scale,
                          x2: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Launch K9/K10: x (B, m) with X2 (m, r), Y2 (n, r), or x (U, t, m)
    with X2 (U, m, r), Y2 (U, n, r); W (m, n) int8/fp16 shared by all
    users. Returns (B, n) or (U, t, n) in x's dtype."""
    single = x.ndim == 2
    if single:
        x, x2, y2 = x[None], x2[None], y2[None]
    _require(x.ndim == 3 and w.ndim == 2 and x.shape[2] == w.shape[0],
             f"cache_residual: x {tuple(x.shape)} and W {tuple(w.shape)}")
    _require(w.dtype in W_CODES, f"cache must be int8 or fp16, got {w.dtype}")
    _require(w.is_contiguous() and w.device == x.device,
             "cache must be contiguous and on the activations' device")
    users, t, m = x.shape
    n, r = w.shape[1], x2.shape[-1]
    _require(x2.shape[0] == users and y2.shape[0] == users,
             "one factor set per user")
    _require(x2.device == x.device and y2.device == x.device,
             "factors must be on the activations' device")
    x2 = _user_slabs(x2, m, r)
    y2 = _user_slabs(y2, n, r)
    xc = x.contiguous()
    s = _scale_vec(scale, n, x.device)
    y = torch.empty((users, t, n), dtype=x.dtype, device=x.device)
    xcode, wcode = _x_code(xc), W_CODES[w.dtype]
    with torch.cuda.device(x.device):
        splits = _splits("repro_cache_residual_splits", users, t, m, n, r,
                         xcode, wcode, _sms(x.device))
        ws = _workspace(splits, (users, t, n), x.device)
        err = _cfn("repro_cache_residual")(
            xc.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
            x2.data_ptr(), y2.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), users, t, m, n, r,
            x2.stride(0), y2.stride(0), xcode, wcode, splits,
            torch.cuda.current_stream(x.device).cuda_stream)
    check_status(err, "cache_residual_matmul")
    return y[0] if single else y


# ------------------------------------------------------- Gram decode path
#
#   y_n = Σ_m x_m (X1Y1ᵀ)_mn (X2Y2ᵀ)_mn = Σ_{i,j} Y1_ni Y2_nj · G_ij,
#   G = X1ᵀ diag(x) X2  (r1 × r2)
#
# so y = rowsum((Y1 G) ⊙ Y2) at O(r²(m+n)) FLOPs per token, no (m, n)
# object anywhere. Invalid for the tanh variant; pFedPara's "+1 switch"
# adds the rank-r term x@X1@Y1ᵀ.

def fedpara_gram_decode(x, x1, y1, x2, y2, *, kind: str = "fedpara",
                        out_dtype=None) -> torch.Tensor:
    """y = x @ (X1Y1ᵀ ⊙ f2(X2Y2ᵀ)) via the Gram identity (decode path).

    x: (B, m) with shared factors, or (U, t, m) with per-user residual
    factors x2/y2: (U, m, r)/(U, n, r) (x1/y1 always shared).
    """
    if kind not in ("fedpara", "pfedpara"):
        raise ValueError(f"gram decode is invalid for kind {kind!r}")
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    x1f, y1f, x2f, y2f = x1.float(), y1.float(), x2.float(), y2.float()
    if x.ndim == 3:
        g = torch.einsum("utm,mi,umj->utij", xf, x1f, x2f)
        y = torch.einsum("ni,utij,unj->utn", y1f, g, y2f)
        if kind == "pfedpara":
            y = y + torch.einsum("utm,mi,ni->utn", xf, x1f, y1f)
        return y.to(out_dtype)
    g = torch.einsum("bm,mi,mj->bij", xf, x1f, x2f)
    y = torch.einsum("ni,bij,nj->bn", y1f, g, y2f)
    if kind == "pfedpara":
        y = y + (xf @ x1f) @ y1f.T
    return y.to(out_dtype)
