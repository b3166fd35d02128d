"""Core layers (PyTorch): parameterized dense, norms, rotary embeddings,
activations.

Every weight matrix goes through :func:`dense` / :func:`init_dense`,
which dispatch on the configured parameterization and on the serve node
layouts the engine writes (``repro_torch.serve.cache``):

* ``{'w_q', 'scale'}`` — int8 composed cache → K8 (``ops.w8_matmul``);
* ``{'w'}`` stored fp16 — fp16 composed cache → K8 with ``scale=None``;
* ``{'w1_q'|'w1', 'scale', 'ux2', 'uy2'}`` — pFedPara shared cache plus
  injected per-user residual factors → K9/K10
  (``ops.cache_residual_matmul``);
* factor nodes ``{'x1', 'y1', 'x2', 'y2'}`` — the fused path: the
  Hadamard-Gram identity at row counts <= ``pcfg.gram_batch``, else K1
  (``ops.fedpara_matmul``);
* factor nodes with injected ``ux2/uy2`` — the per-user Gram path.

``use_kernels=False`` is the reference's plain path (materialize W, then
a matmul): the oracle the serve tests merge users into, and the plain
training path. With ``use_kernels`` a factor node trains through
``ops.fedpara_matmul``, differentiable through
``kernels.fedpara_grad.FedParaMatmul`` (K1 forward, K3/K4 backward):
the counterpart of the reference's ``use_pallas``. Training keeps
``gram_batch`` at 0, so every row count takes K1.

:func:`dense_clients` is the client-stacked layer of the batched FL
engine: every leaf carries a leading client axis and each client
multiplies by its own W (K2 forward, the client forms of K3/K4
backward). It is a function of its own because a 3-D factor in
:func:`dense` means a layer-stacked scan node, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ParamCfg
from repro_torch.core import parameterization as par
from repro_torch.core import rank_policy
from repro_torch.kernels import ops, ref

FUSED_KINDS = ("fedpara", "fedpara_tanh", "pfedpara")


# ----------------------------------------------------------------- dispatch

def materialize_auto(sub: Dict[str, torch.Tensor], kind_hint: str,
                     dtype=None) -> torch.Tensor:
    """Compose the dense weight from whatever factor set is stored."""
    if "w_q" in sub:  # int8 serving weights: dequantize per output channel
        dt = dtype or torch.bfloat16
        return sub["w_q"].to(dt) * sub["scale"].to(dt)
    if "w" in sub:
        w = sub["w"]
        return w.to(dtype) if dtype is not None else w
    if "x1" in sub:
        k = kind_hint if kind_hint in FUSED_KINDS else "fedpara"
        return par.materialize(sub, k, dtype)
    raise ValueError(f"unrecognized parameterized weight keys: {list(sub)}")


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize a composed weight to int8 with per-output-channel scales
    (``{'w_q', 'scale'}``); the scale reduces only the contraction dim
    (-2). Non-matrix or integer leaves pass through as ``{'w'}``."""
    if w.ndim < 2 or w.dtype == torch.int32:
        return {"w": w}
    wf = w.float()
    scale = torch.amax(wf.abs(), dim=-2, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_q": wq, "scale": scale}


def should_factorize(m: int, n: int, pcfg: ParamCfg) -> bool:
    """Whether an (m, n) layer is stored factorized under ``pcfg``."""
    if pcfg.kind == "original":
        return False
    if min(m, n) < pcfg.min_dim_for_factorization:
        return False
    r = rank_policy.matrix_rank_for_gamma(m, n, pcfg.gamma)
    return 2 * r * (m + n) < m * n


def init_dense(gen: torch.Generator, m: int, n: int, pcfg: ParamCfg,
               device="cpu") -> Dict[str, torch.Tensor]:
    """One (m -> n) weight: factorized per ``pcfg`` when that saves
    parameters, else dense He-initialized."""
    if should_factorize(m, n, pcfg):
        return par.init_linear(gen, m, n, kind=pcfg.kind, gamma=pcfg.gamma,
                               device=device)
    return par.init_original(gen, m, n, device)


def dense(sub: Dict[str, torch.Tensor], x: torch.Tensor, pcfg: ParamCfg,
          dtype=torch.bfloat16, use_kernels: bool = True) -> torch.Tensor:
    """y = x @ W for any parameterization / serve layout (module
    docstring). ``x``: (..., m) -> (..., n)."""
    lead = x.shape[:-1]
    m = x.shape[-1]
    rows = math.prod(lead)

    if "ux2" in sub:  # serve: per-user pFedPara residual injected
        return _serve_personalized(sub, x, dtype, use_kernels)
    if use_kernels:
        xk = x.reshape(-1, m).to(dtype)
        if "w_q" in sub and sub["w_q"].ndim == 2:
            y = ops.w8_matmul(xk, sub["w_q"], sub["scale"], out_dtype=dtype)
            return y.reshape(*lead, y.shape[-1])
        if ("w" in sub and sub["w"].ndim == 2
                and sub["w"].dtype == torch.float16):
            y = ops.w8_matmul(xk, sub["w"], None, out_dtype=dtype)
            return y.reshape(*lead, y.shape[-1])
        if ("x1" in sub and sub["x1"].ndim == 2
                and pcfg.kind in FUSED_KINDS):
            if pcfg.gram_batch >= rows > 0 and pcfg.kind != "fedpara_tanh":
                y = ops.fedpara_gram_decode(
                    xk, sub["x1"], sub["y1"], sub["x2"], sub["y2"],
                    kind=pcfg.kind, out_dtype=dtype)
            else:
                y = ops.fedpara_matmul(
                    xk, sub["x1"], sub["y1"], sub["x2"], sub["y2"],
                    kind=pcfg.kind, out_dtype=dtype)
            return y.reshape(*lead, y.shape[-1])
    w = materialize_auto(sub, pcfg.kind, dtype)
    return torch.matmul(x.to(dtype), w)


def dense_clients(sub: Dict[str, torch.Tensor], x: torch.Tensor,
                  pcfg: ParamCfg, dtype=torch.float32,
                  use_kernels: bool = True) -> torch.Tensor:
    """y[c] = x[c] @ W[c] for a client stack: x (C, B, m) and a node
    whose leaves lead with the same C (factors (C, m, r) / (C, n, r), or
    a dense w (C, m, n)) -> (C, B, n). With ``use_kernels`` a factor
    node goes through ``ops.fedpara_matmul`` on the stack (one K2
    launch for all clients); otherwise each client's W is materialized
    and multiplied, the reference's plain path under its client vmap."""
    if use_kernels and "x1" in sub and pcfg.kind in FUSED_KINDS:
        return ops.fedpara_matmul(x.to(dtype), sub["x1"], sub["y1"],
                                  sub["x2"], sub["y2"], kind=pcfg.kind,
                                  out_dtype=dtype)
    w = materialize_auto(sub, pcfg.kind, dtype)
    return torch.matmul(x.to(dtype), w)


def _serve_personalized(sub, x, dtype, use_kernels: bool) -> torch.Tensor:
    """Serve-time pFedPara node with injected per-user factors.

    ``{'w1_q'|'w1', 'scale', 'ux2', 'uy2'}`` — cache + residual kernel;
    ``{'x1', 'y1', 'ux2', 'uy2'}`` — fully-fused per-user Gram decode.
    ``ux2`` 3-D means many users: x (..., m) regroups to (U, t, m).
    """
    lead = x.shape[:-1]
    m = x.shape[-1]
    ux2, uy2 = sub["ux2"], sub["uy2"]
    if ux2.ndim == 3:
        xk = x.reshape(ux2.shape[0], -1, m).to(dtype)
    else:
        xk = x.reshape(-1, m).to(dtype)

    if "w1_q" in sub or "w1" in sub:
        w1 = sub["w1_q"] if "w1_q" in sub else sub["w1"]
        scale = sub.get("scale")
        if use_kernels:
            y = ops.cache_residual_matmul(xk, w1, scale, ux2, uy2,
                                          out_dtype=dtype)
        else:  # plain path: materializes each user's W
            y = ref.cache_residual_ref(xk, w1, scale, ux2, uy2,
                                       out_dtype=dtype)
        return y.reshape(*lead, y.shape[-1])
    y = ops.fedpara_gram_decode(xk, sub["x1"], sub["y1"], ux2, uy2,
                                kind="pfedpara", out_dtype=dtype)
    return y.reshape(*lead, y.shape[-1])


def precompose_tree(params, pcfg: ParamCfg, dtype=torch.bfloat16,
                    int8: bool = False):
    """Replace every weight subtree with ``{'w': dense}`` (serving), as
    the reference's ``precompose_tree`` does.

    A FedPara factor node is composed by ``ops.fedpara_compose`` in
    ``dtype`` (K5 on the card; K6 for a layer-stacked node, one launch).
    ``int8=True`` then quantizes composed weights to int8 with
    per-output-channel scales (``{'w_q', 'scale'}``), embeddings
    excepted."""
    kind = pcfg.kind if pcfg.kind in FUSED_KINDS else "fedpara"

    def is_param_leafdict(d):
        return isinstance(d, dict) and any(
            k in d for k in ("w", "x", "x1", "t", "t1"))

    def walk(node, name=""):
        if is_param_leafdict(node):
            if "x1" in node and "x2" in node:
                w = ops.fedpara_compose(node["x1"], node["y1"], node["x2"],
                                        node["y2"], kind=kind,
                                        out_dtype=dtype)
            else:
                w = materialize_auto(node, pcfg.kind, dtype)
            if int8 and name not in ("embed", "unembed"):
                return quantize_int8(w)
            return {"w": w}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)


# -------------------------------------------------------------------- norms

def init_scale(n: int, device="cpu") -> Dict[str, torch.Tensor]:
    """RMSNorm scale ``{'scale': ones(n)}``."""
    return {"scale": torch.ones((n,), dtype=torch.float32, device=device)}


def rms_norm(x: torch.Tensor, sub: Dict[str, torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * sub["scale"]).to(x.dtype)


# -------------------------------------------------------------------- rope

def rope_angles(positions: torch.Tensor, rotary_dim: int,
                base: float) -> torch.Tensor:
    """(..., rotary_dim/2) angles for given integer positions."""
    idx = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                       device=positions.device)
    inv = 1.0 / (base ** (idx / rotary_dim))
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """Rotary embedding on (..., S, H, hd); ``positions``: (..., S)."""
    hd = x.shape[-1]
    rd = int(hd * rotary_frac)
    rd -= rd % 2
    ang = rope_angles(positions, rd, base)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], dim=-1)


# -------------------------------------------------------------- activations

def act_fn(name: str):
    """The activation function named in an ArchConfig."""
    return {
        "silu": F.silu,
        "gelu": lambda t: F.gelu(t, approximate="tanh"),
        "relu": F.relu,
        "tanh": torch.tanh,
    }[name]
