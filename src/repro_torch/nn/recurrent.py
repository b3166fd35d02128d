"""The paper's two-FC-layer MLP (FEMNIST/MNIST experiments) in PyTorch,
the counterpart of the MLP half of the reference's
``repro/nn/recurrent.py`` (the character LSTM is not ported yet).

Both weight matrices go through :func:`repro_torch.nn.layers.dense`, so
``ParamCfg(use_kernels=True)`` puts every local training step of an FL
client on the fused differentiable matmul (K1 forward, K3/K4 backward;
W never materialized) with no model-code change, and without it the
layer materializes W and multiplies, as the reference's plain path does.

The ``*_clients`` functions are the same model on a client stack (every
leaf and the batch lead with a client axis C), the batched FL engine's
counterpart of the reference's ``jax.vmap`` over clients: each client
runs its own weights, and the loss is one mean cross-entropy per
client, shape (C,).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ParamCfg
from repro_torch.nn.layers import dense, dense_clients, init_dense


@dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 256
    classes: int = 62
    param: ParamCfg = field(default_factory=lambda: ParamCfg(
        gamma=0.5, min_dim_for_factorization=8))


def init_mlp_model(gen: torch.Generator, cfg: MLPConfig,
                   device="cpu") -> Dict:
    """``{"fc1", "fc2", "b1", "b2"}``; the weights factorized per
    ``cfg.param`` where that saves parameters. The numbers differ from
    the reference's ``jax.random`` init: parity runs load the
    reference's params instead (``repro_torch.interop``)."""
    return {
        "fc1": init_dense(gen, cfg.in_dim, cfg.hidden, cfg.param, device),
        "fc2": init_dense(gen, cfg.hidden, cfg.classes, cfg.param, device),
        "b1": torch.zeros((cfg.hidden,), dtype=torch.float32, device=device),
        "b2": torch.zeros((cfg.classes,), dtype=torch.float32,
                          device=device),
    }


def mlp_apply(params: Dict, cfg: MLPConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, in_dim) -> logits (B, classes), fp32."""
    use = cfg.param.use_kernels
    h = F.relu(dense(params["fc1"], x, cfg.param, torch.float32, use)
               + params["b1"])
    return dense(params["fc2"], h, cfg.param, torch.float32, use) + params["b2"]


def mlp_loss(params: Dict, cfg: MLPConfig, batch: Dict) -> torch.Tensor:
    """Mean cross-entropy of ``batch = {"x", "y"}``."""
    logits = mlp_apply(params, cfg, batch["x"])
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch["y"].long()[:, None]))


def mlp_accuracy(params: Dict, cfg: MLPConfig, batch: Dict) -> torch.Tensor:
    """Top-1 accuracy of ``batch = {"x", "y"}`` (a 0-d fp32 tensor)."""
    logits = mlp_apply(params, cfg, batch["x"])
    return torch.mean((torch.argmax(logits, -1) == batch["y"].long()
                       ).float())


def mlp_apply_clients(params: Dict, cfg: MLPConfig,
                      x: torch.Tensor) -> torch.Tensor:
    """Client stack: params leaves (C, ...), x (C, B, in_dim) -> logits
    (C, B, classes), fp32."""
    use = cfg.param.use_kernels
    h = F.relu(dense_clients(params["fc1"], x, cfg.param, torch.float32, use)
               + params["b1"][:, None, :])
    return (dense_clients(params["fc2"], h, cfg.param, torch.float32, use)
            + params["b2"][:, None, :])


def mlp_loss_clients(params: Dict, cfg: MLPConfig,
                     batch: Dict) -> torch.Tensor:
    """Per-client mean cross-entropy of ``batch = {"x": (C, B, in_dim),
    "y": (C, B)}``, shape (C,)."""
    logits = mlp_apply_clients(params, cfg, batch["x"])
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 2, batch["y"].long()[..., None]
                                    )[..., 0], dim=1)


def mlp_accuracy_clients(params: Dict, cfg: MLPConfig,
                         batch: Dict) -> torch.Tensor:
    """Per-client top-1 accuracy of a client-stacked batch, shape (C,)."""
    logits = mlp_apply_clients(params, cfg, batch["x"])
    return torch.mean((torch.argmax(logits, -1) == batch["y"].long()
                       ).float(), dim=1)
