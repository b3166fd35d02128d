"""Decoder-only LM (PyTorch): the dense family.

A port of the reference's ``nn/transformer.py::DecoderLM``: the
training forward (``hidden_states``, ``loss`` through
:func:`chunked_ce_loss`), the serving path (``init_params``,
``init_cache``, ``prefill``, ``decode_step``) and ``precompose``. Layer
parameters are stacked along a leading layer axis exactly as the
reference's ``jax.vmap(init_layer)`` stacks them, so trees carry across
unchanged (``repro_torch.interop``); the forward walks the layers with
a Python loop where the reference scans. MoE, the hybrid, xLSTM and
enc-dec models are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as attn
from repro_torch.nn.layers import (act_fn, dense, init_dense, init_scale,
                                   precompose_tree, rms_norm)
from repro_torch.tree import tree_index


@dataclass(frozen=True)
class ModelOptions:
    attn_chunk: int = 512          # query-chunk size of full attention
    logit_chunk: int = 1024        # sequence chunk of the training loss
    use_kernels: bool = True       # serve kernels via repro_torch.kernels.ops
                                   # (False: the plain materialize path)
    dtype: Any = torch.bfloat16


# ----------------------------------------------------------------- MLP/FFN

def init_mlp(gen: torch.Generator, cfg: ArchConfig, device="cpu",
             d_in: Optional[int] = None, d_ff: Optional[int] = None) -> Dict:
    """SwiGLU (silu) or plain two-matrix MLP weights."""
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"w_gate": init_dense(gen, d, f, cfg.param, device),
                "w_up": init_dense(gen, d, f, cfg.param, device),
                "w_down": init_dense(gen, f, d, cfg.param, device)}
    return {"w_up": init_dense(gen, d, f, cfg.param, device),
            "w_down": init_dense(gen, f, d, cfg.param, device)}


def mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig, dtype,
        use_kernels: bool = True) -> torch.Tensor:
    """The feed-forward block."""
    a = act_fn(cfg.act)
    if "w_gate" in p:
        h = a(dense(p["w_gate"], x, cfg.param, dtype, use_kernels)) * dense(
            p["w_up"], x, cfg.param, dtype, use_kernels)
    else:
        h = a(dense(p["w_up"], x, cfg.param, dtype, use_kernels))
    return dense(p["w_down"], h, cfg.param, dtype, use_kernels)


def _stack_into(out: Optional[Dict], layer: Dict, i: int, n: int) -> Dict:
    """Copy one layer's tree into slot ``i`` of layer-stacked buffers
    (allocated on the first layer), so a deep init holds one unstacked
    layer at a time."""
    if isinstance(layer, dict):
        out = out if out is not None else {}
        for k, v in layer.items():
            out[k] = _stack_into(out.get(k), v, i, n)
        return out
    if out is None:
        out = torch.empty((n, *layer.shape), dtype=layer.dtype,
                          device=layer.device)
    out[i].copy_(layer)
    return out


# ----------------------------------------------------------- loss utilities

def chunked_ce_loss(h: torch.Tensor, unembed_w: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Masked mean next-token cross-entropy, unembedding ``chunk``
    positions at a time (bounds the fp32 logit buffer to (B, chunk, V));
    h (B, S, d), targets and mask (B, S)."""
    S = h.shape[1]
    C = min(chunk, S)
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, C):
        logits = torch.matmul(h[:, c0:c0 + C], unembed_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           targets[:, c0:c0 + C, None].long())[..., 0]
        mi = mask[:, c0:c0 + C].float()
        tot = tot + ((lse - tgt) * mi).sum()
        cnt = cnt + mi.sum()
    return tot / torch.clamp_min(cnt, 1.0)


# ============================================================ decoder-only LM

class DecoderLM:
    """Dense decoder-only LM (qwen3, llama3, ... without MoE)."""

    def __init__(self, cfg: ArchConfig, opts: ModelOptions = ModelOptions()):
        if cfg.n_experts:
            raise NotImplementedError("MoE layers are not ported yet")
        self.cfg = cfg
        self.opts = opts

    # ---------------- init
    def init_layer(self, gen: torch.Generator, device="cpu") -> Dict:
        """One layer's parameters (unstacked)."""
        cfg = self.cfg
        return {"ln1": init_scale(cfg.d_model, device),
                "attn": attn.init_attention(gen, cfg, device),
                "ln2": init_scale(cfg.d_model, device),
                "mlp": init_mlp(gen, cfg, device)}

    def init_params(self, gen: torch.Generator, device="cpu") -> Dict:
        """Seeded random parameters, layers stacked on a leading axis."""
        cfg = self.cfg
        stacked = None
        for i in range(cfg.n_layers):
            stacked = _stack_into(stacked, self.init_layer(gen, device), i,
                                  cfg.n_layers)
        scale = 1.0 / cfg.d_model ** 0.5
        emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                          device=device, dtype=torch.float32) * scale
        p = {"embed": {"w": emb}, "layers": stacked,
             "final_norm": init_scale(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            unemb = torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                                device=device, dtype=torch.float32) * scale
            p["unembed"] = {"w": unemb}
        return p

    def layer_windows(self) -> List[int]:
        """Per-layer attention window (0 = full causal)."""
        cfg = self.cfg
        if cfg.local_global_period:
            per = cfg.local_global_period
            return [0 if i % per == per - 1 else cfg.local_window
                    for i in range(cfg.n_layers)]
        return [cfg.sliding_window] * cfg.n_layers

    def unembed_w(self, params: Dict, dtype) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["w"].to(dtype).T
        return params["unembed"]["w"].to(dtype)

    # ---------------- train forward
    def hidden_states(self, params: Dict, tokens: torch.Tensor
                      ) -> torch.Tensor:
        """Final-norm hidden states (B, S, d) of tokens (B, S), causal
        over the whole sequence (differentiable)."""
        cfg, opts = self.cfg, self.opts
        h = params["embed"]["w"][tokens].to(opts.dtype)
        for i, window in enumerate(self.layer_windows()):
            def attend(pa, x, window=window):
                return attn.full_attention(
                    pa, x, cfg, window=window, chunk=opts.attn_chunk,
                    dtype=opts.dtype, use_kernels=opts.use_kernels)

            h = self._block(h, tree_index(params["layers"], i), cfg, attend)
        return rms_norm(h, params["final_norm"], cfg.norm_eps)

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S):
        a plain function of the params dict, the ``loss_fn`` an
        ``FLServer`` trains through."""
        tokens = batch["tokens"]
        h = self.hidden_states(params, tokens[:, :-1])
        targets = tokens[:, 1:]
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
        return chunked_ce_loss(h, self.unembed_w(params, self.opts.dtype),
                               targets, mask, self.opts.logit_chunk)

    def precompose(self, params: Dict, int8: bool = False) -> Dict:
        """Every weight composed to ``{'w'}`` in the model's dtype (or int8
        ``{'w_q', 'scale'}``): :func:`precompose_tree`."""
        return precompose_tree(params, self.cfg.param, self.opts.dtype,
                               int8=int8)

    # ---------------- serving
    def init_cache(self, batch: int, max_seq: int, device="cpu") -> Dict:
        """Zeroed KV cache for ``batch`` sequences of ``max_seq`` tokens."""
        return attn.init_kv_cache(self.cfg, batch, max_seq, self.cfg.n_layers,
                                  dtype=self.opts.dtype, device=device)

    def _block(self, h, p, cfg, attend):
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        h = h + attend(p["attn"], x)
        x = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + mlp(p["mlp"], x, cfg, self.opts.dtype,
                       self.opts.use_kernels)

    def prefill(self, params: Dict, tokens: torch.Tensor, cache: Dict
                ) -> Tuple[Dict, torch.Tensor]:
        """Run prompts (B, S) through the model, filling ``cache`` in
        place; returns (cache, last-position logits (B, V) fp32)."""
        cfg, opts = self.cfg, self.opts
        h = params["embed"]["w"][tokens].to(opts.dtype)
        for i, window in enumerate(self.layer_windows()):
            kv = (cache["k"][i], cache["v"][i])

            def attend(pa, x, kv=kv, window=window):
                return attn.prefill_attention(
                    pa, x, cfg, kv, window=window, chunk=opts.attn_chunk,
                    dtype=opts.dtype, use_kernels=opts.use_kernels)

            h = self._block(h, tree_index(params["layers"], i), cfg, attend)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = h[:, -1].float() @ self.unembed_w(params, torch.float32)
        return cache, logits

    def decode_step(self, params: Dict, cache: Dict, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        """One token (B, 1) at position ``pos``; updates ``cache`` in
        place and returns (logits (B, V) fp32, cache)."""
        cfg, opts = self.cfg, self.opts
        h = params["embed"]["w"][token].to(opts.dtype)
        for i, window in enumerate(self.layer_windows()):
            kv = (cache["k"][i], cache["v"][i])

            def attend(pa, x, kv=kv, window=window):
                return attn.decode_attention(
                    pa, x, cfg, kv, pos, window=window, dtype=opts.dtype,
                    use_kernels=opts.use_kernels)

            h = self._block(h, tree_index(params["layers"], i), cfg, attend)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = h.float() @ self.unembed_w(params, torch.float32)
        return logits[:, 0], cache


def build_model(cfg: ArchConfig, opts: ModelOptions = ModelOptions()):
    """The model class for ``cfg``'s family (only the dense decoder-only
    family is ported)."""
    if cfg.is_encdec or cfg.attn_every or cfg.block_pattern:
        raise NotImplementedError(f"{cfg.name}: only the dense decoder-only "
                                  "family is ported")
    return DecoderLM(cfg, opts)
