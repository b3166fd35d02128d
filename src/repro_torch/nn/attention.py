"""GQA attention (PyTorch): full-sequence (training) attention, chunked
prefill and single-token decode.

Mirrors the reference's ``nn/attention.py`` math for the features the
served archs use: grouped-query attention, rotary embeddings (full /
half), qk-norm, and a bf16 KV cache. The reference has no Pallas
attention kernel, so this is plain torch; the projections go through
:func:`repro_torch.nn.layers.dense` and so through the serve kernels.

The KV cache is ``{"k", "v"}`` of shape (layers, B, S_cache, Hkv, hd);
prefill and decode write their layer's slice IN PLACE (the reference
donates the cache to the same effect). Sliding-window ring buffers and
the int8 KV cache are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import layers
from repro_torch.nn.layers import dense, init_dense, init_scale, rms_norm

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   device="cpu") -> Dict:
    """q/k/v/o projections (+ qk-norm scales) for one layer."""
    hd = cfg.resolved_head_dim()
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": init_dense(gen, d, H * hd, cfg.param, device),
        "wk": init_dense(gen, d, Hkv * hd, cfg.param, device),
        "wv": init_dense(gen, d, Hkv * hd, cfg.param, device),
        "wo": init_dense(gen, H * hd, d, cfg.param, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_scale(hd, device)
        p["k_norm"] = init_scale(hd, device)
    return p


def _project_qkv(p, cfg: ArchConfig, x, positions, dtype, use_kernels):
    """Project and rope q, k, v from x (self-attention)."""
    hd = cfg.resolved_head_dim()
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    rotary_frac = 0.5 if cfg.rope_style == "half" else 1.0
    lead = x.shape[:-1]
    q = dense(p["wq"], x, cfg.param, dtype, use_kernels).reshape(*lead, H, hd)
    k = dense(p["wk"], x, cfg.param, dtype, use_kernels).reshape(*lead, Hkv, hd)
    v = dense(p["wv"], x, cfg.param, dtype, use_kernels).reshape(*lead, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_base, rotary_frac)
    k = layers.apply_rope(k, positions, cfg.rope_base, rotary_frac)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,C,Hkv,G,hd), k: (B,S,Hkv,hd) -> (B,Hkv,G,C,S), in q's dtype."""
    return torch.einsum("bckgh,bskh->bkgcs", q, k)


def _gqa_out(probs, v):
    """probs: (B,Hkv,G,C,S), v: (B,S,Hkv,hd) -> (B,C,Hkv,G,hd)."""
    return torch.einsum("bkgcs,bskh->bckgh", probs.to(v.dtype), v)


def _chunked_attend(q, k, v, cfg: ArchConfig, *, window: int, chunk: int):
    """Causal attention of q (B,S,H,hd) over k/v (B,S,Hkv,hd), one query
    chunk at a time (the (C, S) score tile is the only quadratic
    buffer)."""
    B, S, H, hd = q.shape
    Hkv = cfg.n_kv_heads
    G = H // Hkv
    C = min(chunk, S)
    kv_pos = torch.arange(S, device=q.device)
    scale = 1.0 / (hd ** 0.5)
    outs = []
    for c0 in range(0, S, C):
        qi = q[:, c0:c0 + C].reshape(B, -1, Hkv, G, hd)
        q_pos = torch.arange(c0, c0 + qi.shape[1], device=q.device)
        s = _gqa_scores(qi, k).float() * scale
        m = q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            m &= kv_pos[None, :] > q_pos[:, None] - window
        s = torch.where(m[None, None, None], s, NEG_INF)
        outs.append(_gqa_out(torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def full_attention(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                   window: int, chunk: int = 512, dtype=torch.bfloat16,
                   use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence causal self-attention (the training forward): x
    (B, S, d) -> (B, S, d), one query chunk at a time, as the
    reference's ``full_attention`` scans its chunks. Differentiable; the
    projections go through :func:`dense`."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, pos, dtype, use_kernels)
    y = _chunked_attend(q, k, v, cfg, window=window, chunk=chunk)
    return dense(p["wo"], y.reshape(B, S, -1), cfg.param, dtype, use_kernels)


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, n_sites: int,
                  dtype=torch.bfloat16, device="cpu") -> Dict[str, torch.Tensor]:
    """(sites, B, S_cache, Hkv, hd) K and V buffers."""
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window ring caches are not "
                                  "ported yet")
    shape = (n_sites, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attention(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                      cache_kv: Tuple[torch.Tensor, torch.Tensor], *,
                      window: int, chunk: int = 512, dtype=torch.bfloat16,
                      use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence attention over the prompt x (B, S, d); writes the
    prompt's K/V into this layer's cache slices (B, S_cache, Hkv, hd) in
    place and returns the attention output (B, S, d)."""
    B, S, _ = x.shape
    ck, cv = cache_kv
    if S > ck.shape[1]:
        raise ValueError(f"prompt of {S} tokens exceeds the cache "
                         f"({ck.shape[1]})")
    pos = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, cfg, x, pos, dtype, use_kernels)
    ck[:, :S] = k.to(ck.dtype)
    cv[:, :S] = v.to(cv.dtype)
    y = _chunked_attend(q, k, v, cfg, window=window, chunk=chunk)
    return dense(p["wo"], y.reshape(B, S, -1), cfg.param, dtype, use_kernels)


def decode_attention(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                     cache_kv: Tuple[torch.Tensor, torch.Tensor], pos: int, *,
                     window: int, dtype=torch.bfloat16,
                     use_kernels: bool = True) -> torch.Tensor:
    """One-token decode: x (B, 1, d) at position ``pos``; writes its K/V
    into the cache slices in place and returns (B, 1, d)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim()
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = H // Hkv
    ck, cv = cache_kv
    S_cache = ck.shape[1]

    pos_b = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, pos_b, dtype, use_kernels)
    slot = pos % S_cache
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    qh = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh, ck).float()
    s = s / (hd ** 0.5)
    idx = torch.arange(S_cache, device=x.device)
    valid = idx <= pos
    if window > 0:
        valid &= idx > pos - window
    s = torch.where(valid[None, None, None], s, NEG_INF)
    pbs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", pbs.to(cv.dtype), cv)
    out = out.reshape(B, 1, H * hd)
    return dense(p["wo"], out, cfg.param, dtype, use_kernels)
