"""FL client (PyTorch): local SGD epochs on private data (paper
Algorithm 1/2), the counterpart of the reference's ``repro/fl/client.py``.

``local_update`` is strategy-aware (FedProx penalty, SCAFFOLD gradient
correction, FedDyn dynamic regularizer) and parameterization-agnostic:
FedPara factors are just leaves of the params tree. The gradient in
:func:`_step_math` is ``torch.autograd.grad`` of whatever the model's
``loss_fn`` runs, so with kernels enabled (``ParamCfg(use_kernels=True)``)
every local step's forward runs K1 and its backward K3 and K4
(``repro_torch.kernels.fedpara_grad.FedParaMatmul``): W is never
materialized, and no engine code changes. PyTorch runs eagerly, so
there is no jitted step: each minibatch is one call of the step math.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.strategies import (Strategy, tree_dot, tree_sqnorm,
                                       tree_sub, tree_zeros)
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class ClientConfig:
    """Local-SGD settings shared by every simulated client: base
    learning rate (decayed per round by ``ServerConfig.lr_decay``),
    SGD momentum, minibatch size, local epochs per round, and weight
    decay."""

    lr: float = 0.1
    momentum: float = 0.0
    batch: int = 64
    epochs: int = 10
    weight_decay: float = 0.0


def _batch_to(batch: Dict, device) -> Dict:
    """A numpy minibatch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def _step_math(params, opt_mu, batch, global_params, client_state,
               loss_fn, strategy_name: str, lr, momentum: float, wd: float):
    """One strategy-aware local SGD step: the reference's ``_step_math``
    with ``torch.autograd.grad`` in place of ``jax.value_and_grad``.
    Returns ``(params, opt_mu, loss)``; the new params are fresh tensors
    (nothing is updated in place)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    p = tree_map(lambda _: next(it), params)

    base = loss_fn(p, batch)
    if strategy_name == "fedprox":
        base = base + 0.5 * client_state["mu_prox"] * tree_sqnorm(
            tree_sub(p, global_params))
    if strategy_name == "feddyn":
        base = base + (-tree_dot(client_state["lambda_i"], p)
                       + 0.5 * client_state["alpha"] * tree_sqnorm(
                           tree_sub(p, global_params)))
    flat = torch.autograd.grad(base, live)
    git = iter(flat)
    grads = tree_map(lambda _: next(git), params)
    with torch.no_grad():
        if strategy_name == "scaffold":
            grads = tree_map(lambda g, ci, c: g - ci + c, grads,
                             client_state["c_i"], client_state["c"])
        if wd:
            grads = tree_map(lambda g, q: g + wd * q, grads, params)
        if momentum:
            opt_mu = tree_map(lambda m, g: momentum * m + g, opt_mu, grads)
            step_dir = opt_mu
        else:
            step_dir = grads
        params = tree_map(lambda q, g: q - lr * g, params, step_dir)
    return params, opt_mu, base.detach()


def strategy_post(strategy_name: str, state: Dict, global_params: Any,
                  params: Any, n_steps, lr) -> Dict:
    """Per-client post-round state update (SCAFFOLD Option II c_i,
    FedDyn lambda_i); a zero step count leaves the SCAFFOLD state
    unchanged."""
    state = dict(state)
    with torch.no_grad():
        if strategy_name == "scaffold" and n_steps > 0:
            scale = 1.0 / (max(float(n_steps), 1.0) * lr)
            state["c_i"] = tree_map(
                lambda ci, c, wg, wl: ci - c + scale * (wg - wl),
                state["c_i"], state["c"], global_params, params)
        if strategy_name == "feddyn":
            state["lambda_i"] = tree_map(
                lambda lam, wl, wg: lam - state["alpha"] * (wl - wg),
                state["lambda_i"], params, global_params)
    return state


def local_update(
    global_params: Any,
    batches: Iterator[Dict],
    loss_fn: Callable,
    cfg: ClientConfig,
    strategy: Strategy,
    client_state: Optional[Dict] = None,
    lr: Optional[float] = None,
) -> Tuple[Any, Dict, Dict]:
    """Run local epochs; returns (new_params, new_client_state, metrics).
    Numpy minibatches move to the params' device one step at a time."""
    params = global_params
    state = dict(client_state or {})
    mu = tree_zeros(params)
    lr = cfg.lr if lr is None else lr
    device = tree_leaves(params)[0].device
    n_steps, last_loss = 0, 0.0
    for batch in batches:
        params, mu, loss = _step_math(
            params, mu, _batch_to(batch, device), global_params, state,
            loss_fn, strategy.name, lr, cfg.momentum, cfg.weight_decay)
        n_steps += 1
        last_loss = loss
    state = strategy_post(strategy.name, state, global_params, params,
                          n_steps, lr)
    metrics = {"steps": n_steps, "loss": float(last_loss)}
    return params, state, metrics


def init_client_state(strategy: Strategy, params: Any, **kw) -> Dict:
    """Strategy-owned client state (the key ``"_ef_up"`` is reserved for
    the uplink codec's error feedback, which the identity codec never
    creates)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    if strategy.name == "scaffold":
        return {"c_i": tree_zeros(params), "c": tree_zeros(params)}
    if strategy.name == "feddyn":
        return {"lambda_i": tree_zeros(params),
                "alpha": torch.tensor(kw.get("alpha", 0.1),
                                      dtype=torch.float32, device=dev)}
    if strategy.name == "fedprox":
        return {"mu_prox": torch.tensor(kw.get("mu", 0.1),
                                        dtype=torch.float32, device=dev)}
    return {}
