"""Load-time serve-weight construction from a decision plan.

``build_serve_params`` walks the global params in lockstep with a
``{path: LayerDecision}`` plan (``cost_model.plan_params``) and rewrites
each factor node to the layout its decision calls for:

fused
    factors kept verbatim — decode composes nothing (Gram identity),
    prefill composes tiles on chip (K1).

precompose
    W composed once here and cached: fp16 ``{'w'}`` or int8
    ``{'w_q', 'scale'}`` with per-output-channel scales. For pFedPara
    layers with resident users only the *shared* half W1 = X1·Y1ᵀ is
    composed — ``{'w1_q'|'w1', 'scale'}`` — and the per-user residual
    is applied inside the cache+residual kernel at serve time.

W is composed by ``ops.fedpara_compose``: on the card the compose
kernels, K5 for one (m, n) weight and K6 for a layer-stacked node in one
launch. The fp16 cache of a stacked (L, m, r) node is K6's output
itself, (L, m, n) fp16, with no fp32 W at all (the host's plain version
composes the stack in fp32 and casts). The int8 cache is composed ONE
LAYER AT A TIME: K5 writes one layer's fp32 W, which is quantized into
preallocated (L, m, n) codes, so the dense fp32 W of only one layer
exists at once (composing qwen3-8b's whole tree in fp32 at once would
take about 28 GB). The pFedPara shared half W1 = X1·Y1ᵀ is a plain
rank-r product (the reference's einsum), ``torch.matmul``.

Embeddings/unembed stay in their native dtype.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.kernels import ops
from repro_torch.nn.layers import FUSED_KINDS, quantize_int8
from repro_torch.serve.cost_model import LayerDecision
from repro_torch.tree import tree_bytes

_NO_QUANT = ("embed", "unembed", "pos_embed")


def _personalized(node: Dict[str, Any], kind: str) -> bool:
    """A pFedPara factor node whose personal half lives in the arena
    (global halves carry x1/y1 only)."""
    return kind == "pfedpara" and "x1" in node and "x2" not in node


def _per_layer(node: Dict[str, torch.Tensor],
               fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    """Apply ``fn`` to an unstacked node, or layer by layer to a stacked
    one, writing each layer's result into preallocated stacked outputs."""
    if node["x1"].ndim == 2:
        return fn(node)
    n_layers = node["x1"].shape[0]
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        res = fn({k: v[i] for k, v in node.items()})
        for k, v in res.items():
            if k not in out:
                out[k] = torch.empty((n_layers, *v.shape), dtype=v.dtype,
                                     device=v.device)
            out[k][i].copy_(v)
        del res
    return out


def build_serve_params(params: Any, kind: str,
                       plan: Dict[str, LayerDecision],
                       cache_dtype: str = "int8") -> Any:
    """Rewrite ``params`` per the plan. ``cache_dtype``: 'int8' | 'fp16'
    for precomposed caches."""
    if cache_dtype not in ("int8", "fp16"):
        raise ValueError(f"cache_dtype must be int8|fp16, got {cache_dtype}")

    def compose_w1(node):
        w1 = node["x1"].float() @ node["y1"].float().T
        if cache_dtype == "int8":
            q = quantize_int8(w1)
            return {"w1_q": q["w_q"], "scale": q["scale"]}
        return {"w1": w1.half()}

    fkind = kind if kind in FUSED_KINDS else "fedpara"

    def compose(node, dtype):
        return ops.fedpara_compose(node["x1"], node["y1"], node["x2"],
                                   node["y2"], kind=fkind, out_dtype=dtype)

    def compose_w(node, name):
        if cache_dtype == "int8" and name not in _NO_QUANT:
            return _per_layer(node, lambda nd: quantize_int8(
                compose(nd, torch.float32)))
        return {"w": compose(node, torch.float16)}

    def walk(node, path="", name=""):
        dec = plan.get(path)
        if dec is not None and isinstance(node, dict):
            if dec.mode != "precompose":
                return dict(node)       # fused / dense: leave verbatim
            if _personalized(node, kind):
                return _per_layer(node, compose_w1)
            return compose_w(node, name)
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k), k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i),
                                   name) for i, v in enumerate(node))
        return node

    return walk(params)


def serve_state_bytes(params: Any) -> int:
    """Device bytes of a serve-params tree."""
    return tree_bytes(params)
