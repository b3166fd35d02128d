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

``_step_math(..., stacked=True)`` is the same step for a client stack
(the batched engines' step, the reference's ``jax.vmap`` of
``_step_math`` written out over a leading client axis): the loss is per
client, (C,), and so are the FedProx and FedDyn terms; clients share no
parameter, so the gradient of the summed loss is each client's own
gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.strategies import (Strategy, lead, tree_dot,
                                       tree_dot_clients, tree_sqnorm,
                                       tree_sqnorm_clients, tree_sub,
                                       tree_zeros)
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
               loss_fn, strategy_name: str, lr, momentum: float, wd: float,
               stacked: bool = False):
    """One strategy-aware local SGD step: the reference's ``_step_math``
    with ``torch.autograd.grad`` in place of ``jax.value_and_grad``.
    Returns ``(params, opt_mu, loss)``; the new params are fresh tensors
    (nothing is updated in place).

    ``stacked``: the step on a client stack (the reference's
    ``batch_engine.py:86-106`` vmap of this step): params, opt_mu, the
    start params ``global_params`` and the state lead with a client axis
    C (the scalars ``mu_prox`` and ``alpha`` are (C,)), the batch is
    ``{"x": (C, B, ...), "y": (C, B)}``, ``loss_fn`` returns one loss per
    client, and so does the step: ``loss`` is (C,)."""
    sqnorm, dot = ((tree_sqnorm_clients, tree_dot_clients) if stacked
                   else (tree_sqnorm, tree_dot))
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    p = tree_map(lambda _: next(it), params)

    base = loss_fn(p, batch)
    if strategy_name == "fedprox":
        base = base + 0.5 * client_state["mu_prox"] * sqnorm(
            tree_sub(p, global_params))
    if strategy_name == "feddyn":
        base = base + (-dot(client_state["lambda_i"], p)
                       + 0.5 * client_state["alpha"] * sqnorm(
                           tree_sub(p, global_params)))
    flat = torch.autograd.grad(base.sum() if stacked else base, live)
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
    FedDyn lambda_i). ``n_steps`` is one client's step count, or a (C,)
    tensor of them for a client stack (every state leaf then leads with
    C); a client with zero steps keeps its SCAFFOLD state."""
    state = dict(state)
    with torch.no_grad():
        if strategy_name == "scaffold":
            like = tree_leaves(state["c_i"])[0]
            n = torch.as_tensor(n_steps, dtype=torch.float32,
                                device=like.device)
            scale = 1.0 / (torch.clamp_min(n, 1.0) * lr)
            live = n > 0
            state["c_i"] = tree_map(
                lambda ci, c, wg, wl: torch.where(
                    lead(live, ci), ci - c + lead(scale, ci) * (wg - wl), ci),
                state["c_i"], state["c"], global_params, params)
        if strategy_name == "feddyn":
            alpha = state["alpha"]
            state["lambda_i"] = tree_map(
                lambda lam, wl, wg: lam - lead(alpha, lam) * (wl - wg),
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
