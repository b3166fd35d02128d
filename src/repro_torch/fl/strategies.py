"""FL strategies (PyTorch): FedAvg, FedProx, SCAFFOLD, FedDyn, FedAdam —
the counterpart of the reference's ``repro/fl/strategies.py``.

Each strategy contributes an optional client-side loss modifier or
gradient correction and a server aggregation rule,
``server_update(server_state, global_params, mean_w)``, a transform of
the (already weighted) client mean. The paper shows FedPara composes
with all of them (Table 3) because it only changes the layer
parameterization. Trees are nested dicts / lists of tensors
(``repro_torch.tree``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch

from repro_torch.tree import tree_index, tree_leaves, tree_map


def tree_mean(trees: List[Any], weights: Optional[List[float]] = None) -> Any:
    """Weighted mean of identically structured trees (weights normalized
    to sum to 1, summed in list order as the reference does)."""
    if weights is None:
        weights = [1.0 / len(trees)] * len(trees)
    total = sum(weights)
    weights = [w / total for w in weights]
    return tree_map(lambda *xs: sum(w * x for w, x in zip(weights, xs)),
                    *trees)


def tree_stack(trees: List[Any]) -> Any:
    """Stack identically structured trees along a new leading client
    axis: leaves (..,) -> (C, ..)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree: Any) -> List[Any]:
    """Inverse of :func:`tree_stack`: split the leading axis back into a
    list of trees."""
    n = tree_leaves(tree)[0].shape[0]
    return [tree_index(tree, i) for i in range(n)]


def tree_broadcast(tree: Any, n: int) -> Any:
    """Replicate a tree along a new leading client axis of size ``n``
    (a copy per client, as the reference's ``broadcast_to`` gives each
    client of its vmap its own buffer)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape).clone(),
                    tree)


def tree_wmean_stacked(stacked: Any, weights: torch.Tensor) -> Any:
    """Masked weighted mean over the leading client axis: ``weights`` is
    (C,) and a client that did not arrive carries weight 0, so the mask
    is the participation decision."""
    total = torch.clamp_min(weights.sum(), 1e-12)
    wn = (weights / total).float()
    return tree_map(
        lambda x: torch.tensordot(wn, x.float(), dims=1).to(x.dtype),
        stacked)


def lead(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-client () or (C,) tensor shaped to broadcast over the
    leading axis of ``like``."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def tree_sqnorm_clients(a: Any) -> torch.Tensor:
    """Per-client squared norm of a client-stacked tree, shape (C,)."""
    return sum(torch.sum(torch.square(x).reshape(x.shape[0], -1), dim=1)
               for x in tree_leaves(a))


def tree_dot_clients(a: Any, b: Any) -> torch.Tensor:
    """Per-client inner product of two client-stacked trees, (C,)."""
    return sum(torch.sum((x * y).reshape(x.shape[0], -1), dim=1)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: x - y, a, b)


def tree_add(a: Any, b: Any, scale: float = 1.0) -> Any:
    return tree_map(lambda x, y: x + scale * y, a, b)


def tree_zeros(a: Any) -> Any:
    return tree_map(torch.zeros_like, a)


def tree_sqnorm(a: Any) -> torch.Tensor:
    return sum(torch.sum(torch.square(x)) for x in tree_leaves(a))


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a),
                                                tree_leaves(b)))


@dataclass
class Strategy:
    """FL strategy. Server-side aggregation is
    ``server_update(server_state, global_params, mean_w)`` ->
    ``(new_global, new_server_state)``; ``aggregate`` is the list-based
    entry point derived from it."""

    name: str = "fedavg"
    # client loss modifier: fn(params, global_params, client_state) -> penalty
    client_penalty: Optional[Callable] = None
    # gradient correction: fn(grads, client_state) -> grads
    grad_correction: Optional[Callable] = None
    server_init: Optional[Callable] = None
    server_update: Optional[Callable] = None
    aggregate: Optional[Callable] = None

    def __post_init__(self):
        if self.server_update is None:
            self.server_update = lambda st, gp, mean_w: (mean_w, st)
        if self.aggregate is None:
            def agg(server_state, global_params, client_params, weights):
                return self.server_update(server_state, global_params,
                                          tree_mean(client_params, weights))
            self.aggregate = agg


def fedavg() -> Strategy:
    return Strategy(name="fedavg")


def fedprox(mu: float = 0.1) -> Strategy:
    def penalty(params, global_params, _state):
        return 0.5 * mu * tree_sqnorm(tree_sub(params, global_params))

    return Strategy(name="fedprox", client_penalty=penalty)


def scaffold(lr_local: float = 0.1, local_steps_hint: int = 1) -> Strategy:
    """Option II control variates: the correction is g - c_i + c; the
    c_i update happens client-side after the local steps."""

    def correction(grads, client_state):
        return tree_map(lambda g, ci, c: g - ci + c,
                        grads, client_state["c_i"], client_state["c"])

    return Strategy(name="scaffold", grad_correction=correction)


def feddyn(alpha: float = 0.1) -> Strategy:
    """Client: L(w) - <lambda_i, w> + alpha/2 ||w - w_g||^2 with lambda_i
    updated post-round; the server keeps a running h."""

    def penalty(params, global_params, client_state):
        lam = client_state["lambda_i"]
        return (-tree_dot(lam, params)
                + 0.5 * alpha * tree_sqnorm(tree_sub(params, global_params)))

    def server_init(params):
        return {"h": tree_zeros(params)}

    def update(server_state, global_params, mean_w):
        delta = tree_sub(mean_w, global_params)
        h = tree_add(server_state["h"], delta, scale=-alpha)
        new_global = tree_add(mean_w, h, scale=-1.0 / alpha)
        return new_global, {"h": h}

    return Strategy(name="feddyn", client_penalty=penalty,
                    server_init=server_init, server_update=update)


def fedadam(eta_g: float = 0.01, b1: float = 0.9, b2: float = 0.99,
            tau: float = 1e-3) -> Strategy:
    def server_init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        return {"m": tree_zeros(params), "v": tree_zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(server_state, global_params, mean_w):
        delta = tree_sub(mean_w, global_params)
        m = tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d,
                     server_state["m"], delta)
        v = tree_map(lambda v_, d: b2 * v_ + (1 - b2) * d * d,
                     server_state["v"], delta)
        new_global = tree_map(
            lambda w, m_, v_: w + eta_g * m_ / (torch.sqrt(v_) + tau),
            global_params, m, v)
        return new_global, {"m": m, "v": v, "t": server_state["t"] + 1}

    return Strategy(name="fedadam", server_init=server_init,
                    server_update=update)


def make_strategy(name: str, **kw) -> Strategy:
    """Build a named strategy: ``fedavg`` | ``fedprox`` (``mu``) |
    ``scaffold`` | ``feddyn`` (``alpha``) | ``fedadam`` (``eta_g``,
    ``b1``, ``b2``, ``tau``); ``kw`` forwards to its constructor."""
    return {
        "fedavg": fedavg,
        "fedprox": fedprox,
        "scaffold": scaffold,
        "feddyn": feddyn,
        "fedadam": fedadam,
    }[name](**kw)
