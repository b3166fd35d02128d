"""Dispatch for the port's kernels.

Each wrapper looks at where its activations live:

* a CUDA tensor launches the hand-written kernel (``csrc/*.cu``) or
  raises — there is no fallback to the plain version on the card;
* a CPU tensor takes the plain PyTorch version (``kernels/ref.py``),
  which is how the tests run on a host without a card.

Each wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels (:func:`reset_launches` /
:func:`launches`). The client-stacked calls of the batched FL engine
(x (C, B, m), factors (C, ·, r)) count under their own entries
(``*_clients``), apart from the 2-D calls of the sequential engine and
of serving, so a run shows which path it took; likewise the compose
of a layer-stacked node (K6, factors (L, ·, r)) counts under
``fedpara_compose_stacked``, apart from the 2-D compose (K5).

The fused matmul trains through ``kernels.fedpara_grad.FedParaMatmul``
(K1/K2 forward, K3/K4 backward). The serve-only kernels (K8, K10) have
no backward, as in the reference: on the card a tensor that requires
grad raises ``NotImplementedError`` there.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import agg as _agg
from repro_torch.kernels import fedpara_compose as _fc
from repro_torch.kernels import fedpara_grad as _fg
from repro_torch.kernels import fedpara_matmul as _fm
from repro_torch.kernels import ref, serve_matmul

KERNELS = ("fedpara_matmul", "fedpara_dx", "fedpara_dfactors", "w8_matmul",
           "cache_residual_matmul", "fedpara_matmul_clients",
           "fedpara_dx_clients", "fedpara_dfactors_clients", "dequant_acc",
           "fedpara_compose", "fedpara_compose_stacked")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        LAUNCHES[k] = 0


def launches() -> Dict[str, int]:
    """A copy of the launch counts since the last reset."""
    return dict(LAUNCHES)


def resolve_kind(kind=None) -> str:
    """Validate a fused-matmul variant name (fedpara | fedpara_tanh |
    pfedpara); None means fedpara."""
    if kind is None:
        return "fedpara"
    if kind not in ref.KINDS:
        raise ValueError(f"unsupported fused-matmul kind: {kind!r}")
    return kind


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA activation (launch the kernel), False for a CPU
    one (plain version); raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    return True


def _serve_only(x: torch.Tensor, what: str, *tensors) -> bool:
    """:func:`_on_card` for a kernel without a backward: on the card a
    tensor that requires grad raises."""
    if not _on_card(x, what):
        return False
    if any(t is not None and t.requires_grad for t in (x, *tensors)):
        raise NotImplementedError(
            f"{what}: a serve-only kernel with no backward (as in the "
            "reference); call it without autograd")
    return True


def _count(name: str, act: torch.Tensor) -> None:
    """One launch of the fused-matmul family: the 2-D kernel's entry,
    or its ``*_clients`` entry for a client stack (3-D activations)."""
    LAUNCHES[name + ("_clients" if act.ndim == 3 else "")] += 1


def _same_dtype(x: torch.Tensor, out_dtype, what: str) -> None:
    if out_dtype is not None and out_dtype != x.dtype:
        raise ValueError(f"{what}: the kernel writes x's dtype ({x.dtype}); "
                         f"cast x to {out_dtype} first")


def fedpara_matmul(x, x1, y1, x2, y2, *, kind=None,
                   out_dtype=None) -> torch.Tensor:
    """y = x @ (f1(X1Y1ᵀ)⊙f2(X2Y2ᵀ)), x (B, m) -> (B, n), differentiable
    in x and the factors; on the card K1 forward, K3 and K4 backward, W
    never materialized. A client stack x (C, B, m) with factors
    (C, m, r) / (C, n, r) gives (C, B, n) through K2 and the client
    forms of K3/K4."""
    return _fg.FedParaMatmul.apply(x, x1, y1, x2, y2, resolve_kind(kind),
                                   out_dtype)


def fedpara_forward(x, x1, y1, x2, y2, *, kind=None,
                    out_dtype=None) -> torch.Tensor:
    """The forward of :func:`fedpara_matmul` without autograd: K1 on the
    card, the plain version on the host."""
    kind = resolve_kind(kind)
    if not _on_card(x, "fedpara_matmul"):
        return ref.fedpara_matmul_ref(x, x1, y1, x2, y2, kind=kind,
                                      out_dtype=out_dtype)
    _same_dtype(x, out_dtype, "fedpara_matmul")
    y = _fm.fedpara_matmul(x, x1, y1, x2, y2, kind=kind)
    _count("fedpara_matmul", x)
    return y


def fedpara_dx(dy, x1, y1, x2, y2, *, kind=None,
               out_dtype=None) -> torch.Tensor:
    """dx = dy @ Wᵀ, dy (B, n) -> (B, m) (or (C, B, n) -> (C, B, m) per
    client) in ``out_dtype`` (default dy's); K3 on the card."""
    kind = resolve_kind(kind)
    if not _on_card(dy, "fedpara_dx"):
        return ref.fedpara_dx_ref(dy, x1, y1, x2, y2, kind=kind,
                                  out_dtype=out_dtype)
    dx = _fg.fedpara_dx(dy, x1, y1, x2, y2, kind=kind)
    _count("fedpara_dx", dy)
    return dx.to(out_dtype or dy.dtype)


def fedpara_dfactors(x, dy, x1, y1, x2, y2, *, side: str, kind=None):
    """The factor gradients of one side, fp32: side "x" (dX1, dX2) (m, r),
    side "y" (dY1, dY2) (n, r), with a leading C for a client stack; K4
    on the card (one launch per call)."""
    kind = resolve_kind(kind)
    if not _on_card(x, "fedpara_dfactors"):
        return ref.fedpara_dfactors_ref(x, dy, x1, y1, x2, y2, side=side,
                                        kind=kind)
    out = _fg.fedpara_dfactors(x, dy, x1, y1, x2, y2, side=side, kind=kind)
    _count("fedpara_dfactors", x)
    return out


def dequant_acc(acc, q, coeff) -> torch.Tensor:
    """acc (L,) fp32 += coeff (C,) @ float(q (C, L)) for an int8, fp16 or
    fp32 wire stack, acc updated **in place** and returned (K7 on the
    card; the plain version, copied into acc, on the host)."""
    if not _on_card(acc, "dequant_acc"):
        return acc.copy_(ref.dequant_acc_ref(acc, q, coeff))
    _agg.dequant_acc(acc, q, coeff)
    LAUNCHES["dequant_acc"] += 1
    return acc


def fedpara_compose(x1, y1, x2, y2, *, kind=None,
                    out_dtype=None) -> torch.Tensor:
    """W = f1(X1Y1ᵀ) ⊙ f2(X2Y2ᵀ) in ``out_dtype`` (default x1's): (m, n)
    from (m, r) / (n, r) factors, K5 on the card; (L, m, n) from a
    stacked node's (L, m, r) / (L, n, r), K6, one launch. The sums are
    fp32 and each element is rounded once, at its store."""
    kind = resolve_kind(kind)
    if not _serve_only(x1, "fedpara_compose", y1, x2, y2):
        return ref.fedpara_compose_ref(x1, y1, x2, y2, kind=kind,
                                       out_dtype=out_dtype)
    w = _fc.fedpara_compose(x1, y1, x2, y2, kind=kind,
                            out_dtype=out_dtype or x1.dtype)
    LAUNCHES["fedpara_compose" + ("_stacked" if x1.ndim == 3 else "")] += 1
    return w


def w8_matmul(x, w, scale=None, *, out_dtype=None) -> torch.Tensor:
    """y = (x @ W)·s against an int8 (with ``scale``) or fp16
    (``scale=None``) weight cache; K8 on the card, the cache widened only
    inside the kernel's tiles."""
    if not _serve_only(x, "w8_matmul"):
        return ref.w8_matmul_ref(x, w, scale, out_dtype=out_dtype)
    _same_dtype(x, out_dtype, "w8_matmul")
    y = serve_matmul.w8_matmul(x, w, scale)
    LAUNCHES["w8_matmul"] += 1
    return y


def cache_residual_matmul(x, w, scale, x2, y2, *, out_dtype=None
                          ) -> torch.Tensor:
    """pFedPara serve matmul y = (x @ (W ⊙ (X2Y2ᵀ + 1)))·s against the
    shared W1 cache; x (B, m) for one user or (U, t, m) for U users in
    one launch (K9/K10 on the card)."""
    if not _serve_only(x, "cache_residual_matmul", x2, y2):
        return ref.cache_residual_ref(x, w, scale, x2, y2,
                                      out_dtype=out_dtype)
    _same_dtype(x, out_dtype, "cache_residual_matmul")
    y = serve_matmul.cache_residual_matmul(x, w, scale, x2, y2)
    LAUNCHES["cache_residual_matmul"] += 1
    return y


def fedpara_gram_decode(x, x1, y1, x2, y2, *, kind=None, out_dtype=None
                        ) -> torch.Tensor:
    """Decode-batch fused matmul via the Hadamard-Gram identity (plain
    torch einsums on every device; no (m, n) intermediate)."""
    return serve_matmul.fedpara_gram_decode(
        x, x1, y1, x2, y2, kind=resolve_kind(kind), out_dtype=out_dtype)
