"""Fused dequant-accumulate for streaming FL aggregation on the card:
launcher for ``csrc/agg.cu`` (K7), and the tree walk over a wire tree.

The streaming round's hot reduction is acc += Σ_c coeff_c · dequant(q_c)
over a client-stacked uplink wire buffer, where ``coeff_c`` folds the
arrival mask, the aggregation weight and (for int8 ``{"q", "scale"}``
nodes) the client's quantizer scale into one fp32 scalar. The kernel
reads each wire value once at its wire width (int8, fp16 or fp32),
widens it in registers, and adds the weighted sum over the clients to
the fp32 accumulator **in place**: the caller's ``acc`` tensor is
updated and returned, as the reference aliases it through the kernel
(``repro/kernels/agg.py:120``). Replaces
``repro/kernels/agg.py:_agg_body`` (wrapper ``dequant_acc``).

:func:`tree_dequant_acc` walks a codec wire tree (``{"q", "scale"}``
nodes, fp16 or fp32 dense leaves; ``Codec.encode_for_agg``) against a
payload-structured fp32 accumulator tree, one launch per leaf, through
``repro_torch.kernels.ops.dequant_acc`` (the kernel on the card, the
plain version on the host). The two-level ``sharded_tree_dequant_acc``
of the reference waits for the distributed port (ROADMAP A8). The
streaming engine feeds this walk what ``Codec.encode_for_agg`` yields,
so int8, fp16 and fp32 wire all reach K7 on the main path;
``ops.wire_launches`` counts its launches by wire type.

:func:`dequant_acc` takes CUDA tensors only and launches
unconditionally.
"""
from __future__ import annotations

import ctypes
from typing import Any

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import is_qnode
from repro_torch.kernels.serve_matmul import check_status

Q_CODES = {torch.int8: 0, torch.float16: 1, torch.float32: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURE = [_P, _P, _P, _I, _LL, _LL, _I, _P]


def dequant_acc(acc: torch.Tensor, q: torch.Tensor,
                coeff: torch.Tensor) -> torch.Tensor:
    """Launch K7: acc (L,) fp32 += coeff (C,) @ float(q (C, L)), acc
    updated in place and returned. q is int8, fp16 or fp32 with unit
    stride along L (its rows may sit at any stride >= L and any
    alignment); coeff is cast to a contiguous fp32 vector."""
    if acc.dtype != torch.float32 or acc.ndim != 1 or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous 1-D float32 tensor, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if q.ndim != 2 or q.dtype not in Q_CODES:
        raise ValueError(f"q must be 2-D int8/float16/float32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    C, L = q.shape
    if L != acc.shape[0] or coeff.shape != (C,):
        raise ValueError(f"q {tuple(q.shape)}, acc {tuple(acc.shape)}, coeff "
                         f"{tuple(coeff.shape)} do not agree")
    if len({acc.device, q.device, coeff.device}) != 1:
        raise ValueError("acc, q and coeff must be on one device")
    if C == 0 or L == 0:
        return acc
    if q.stride(1) != 1 or q.stride(0) < L:
        q = q.contiguous()
    cf = coeff.float().contiguous()
    fn = build.library("agg").repro_dequant_acc
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), q.data_ptr(), cf.data_ptr(), C, L,
                 q.stride(0), Q_CODES[q.dtype],
                 torch.cuda.current_stream(acc.device).cuda_stream)
    check_status(err, "dequant_acc")
    return acc


def acc_zeros_like(wire: Any) -> Any:
    """fp32 zero accumulator tree with the payload structure of ``wire``:
    one dense leaf per ``{"q", "scale"}`` node, the client axis dropped."""
    def walk(n):
        if is_qnode(n):
            return torch.zeros(n["q"].shape[1:], dtype=torch.float32,
                               device=n["q"].device)
        if isinstance(n, dict):
            return {k: walk(v) for k, v in n.items()}
        if isinstance(n, (list, tuple)):
            return type(n)(walk(v) for v in n)
        return torch.zeros(n.shape[1:], dtype=torch.float32, device=n.device)

    return walk(wire)


def tree_dequant_acc(acc_tree: Any, wire: Any, weights: torch.Tensor) -> Any:
    """Fold one client-stacked wire tree into a running fp32
    accumulator tree, in place (K7 once per leaf on the card).

    ``wire`` leaves are ``{"q": (C, ...), "scale": (C,)}`` int8 nodes or
    dense ``(C, ...)`` tensors (fp16 / fp32); ``weights`` is the (C,)
    mask·weight vector; ``acc_tree`` mirrors the payload structure with
    contiguous fp32 leaves. Returns ``acc_tree``, whose leaves now hold
    the updated sums.
    """
    from repro_torch.kernels import ops

    w = weights.float()

    def one(acc, q, coeff):
        ops.dequant_acc(acc.view(-1), q.reshape(q.shape[0], -1), coeff)

    def walk(acc, n):
        if is_qnode(n):
            scale = n["scale"].reshape(n["q"].shape[0]).float()
            one(acc, n["q"], w * scale)
        elif isinstance(n, dict):
            for k, v in n.items():
                walk(acc[k], v)
        elif isinstance(n, (list, tuple)):
            for a, v in zip(acc, n):
                walk(a, v)
        else:
            one(acc, n, w)

    walk(acc_tree, wire)
    return acc_tree
