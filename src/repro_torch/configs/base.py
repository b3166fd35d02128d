"""Architecture and parameterization configs (PyTorch port).

A copy of the reference package's ``configs/base.py`` trimmed to what
the serving slice needs: :class:`ParamCfg`, :class:`ArchConfig` with
``reduced()`` / ``resolved_head_dim()``, and the arch registry. The
port keeps its own copy so that it never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict


@dataclass(frozen=True)
class ParamCfg:
    """Parameterization (the paper's technique) settings."""

    kind: str = "fedpara"          # original | lowrank | fedpara | fedpara_tanh | pfedpara
    gamma: float = 0.1             # paper's rank interpolation knob
    factorize_embeddings: bool = False  # paper keeps embeddings/last-FC dense
    min_dim_for_factorization: int = 128  # below this, 2R(m+n) >= mn anyway
    gram_batch: int = 0            # serve decode: row counts <= this use the
                                   # Hadamard-Gram identity instead of the
                                   # fused tile kernel (the serve cost model
                                   # sets it; 0 = never)
    use_kernels: bool = False      # train through the fused differentiable
                                   # matmul (K1 forward, K3/K4 backward);
                                   # the reference's ``use_pallas``


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # MoE (not served by the port yet)
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # attention pattern
    sliding_window: int = 0        # 0 = full attention
    local_global_period: int = 0   # gemma3: every Nth layer is global
    local_window: int = 0          # window used by the local layers
    qk_norm: bool = False
    rope_style: str = "full"       # full | half (chatglm 2d-RoPE)
    rope_base: float = 10000.0

    # hybrid / ssm / enc-dec (not served by the port yet)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0
    block_pattern: str = ""
    encoder_layers: int = 0
    encoder_seq: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"

    param: ParamCfg = field(default_factory=ParamCfg)
    dtype: str = "bfloat16"

    subquadratic: bool = False
    is_encdec: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """A smoke-test-sized config of the same family/feature set."""
        kw = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(1, self.n_heads))),
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
        )
        if self.n_experts:
            kw["n_experts"] = 4
            kw["experts_per_token"] = min(2, self.experts_per_token)
            kw["moe_capacity_factor"] = 4.0
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.local_global_period:
            kw["local_global_period"] = 2
            kw["local_window"] = 16
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 4
        if self.block_pattern:
            kw["block_pattern"] = self.block_pattern[:4] or "sm"
            kw["n_layers"] = 4
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 16
        if self.ssm_state:
            kw["ssm_state"] = 16
            kw["ssm_head_dim"] = 16
        return replace(self, **kw)


# ---------------------------------------------------------------- registry

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (ensure modules imported)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
