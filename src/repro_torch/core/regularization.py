"""Jacobian correction regularization (paper supplementary B, Eq. 6-9),
the counterpart of the reference's ``core/regularization.py``.

Induces the one-step factor update to track the ideal dense-weight SGD
step:   R = L + λ/2 · ‖W' − (W − η J_W)‖_F
where W' is the weight composed from the factor values after one SGD step
computed with the chain-rule Jacobians of Eq. 6.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def jacobian_correction_penalty(params: Dict[str, torch.Tensor],
                                j_w: torch.Tensor, eta: float
                                ) -> torch.Tensor:
    """Penalty for one FedPara weight given J_W = dL/dW: Eq. 6's
    chain-rule Jacobians, Eq. 7's one-step SGD on the factors and Eq. 9's
    Frobenius mismatch."""
    x1, y1, x2, y2 = params["x1"], params["y1"], params["x2"], params["y2"]
    w1 = x1 @ y1.T
    w2 = x2 @ y2.T
    w = w1 * w2
    # Eq. 6
    j_w1 = j_w * w2
    j_w2 = j_w * w1
    j_x1 = j_w1 @ y1          # (m,n)@(n,r) -> (m,r)
    j_y1 = j_w1.T @ x1        # (n,m)@(m,r) -> (n,r)
    j_x2 = j_w2 @ y2
    j_y2 = j_w2.T @ x2
    # Eq. 7
    x1p, y1p = x1 - eta * j_x1, y1 - eta * j_y1
    x2p, y2p = x2 - eta * j_x2, y2 - eta * j_y2
    w_prime = (x1p @ y1p.T) * (x2p @ y2p.T)
    target = w - eta * j_w
    return torch.linalg.norm(w_prime - target)


def fedpara_loss_with_jacobian_correction(
        loss_of_weight: Callable[[torch.Tensor], torch.Tensor],
        params: Dict[str, torch.Tensor], lam: float, eta: float
        ) -> torch.Tensor:
    """Total objective  R = L(W(factors)) + λ/2·penalty  (Eq. 9).

    ``loss_of_weight``: callable W -> scalar loss. J_W = dL/dW comes from
    ``torch.autograd.grad`` on the composed W and is detached, so the
    penalty's gradient does not flow through it (the reference's
    ``stop_gradient``); the loss keeps its graph to the factors."""
    with torch.enable_grad():
        w = (params["x1"] @ params["y1"].T) * (params["x2"] @ params["y2"].T)
        if not w.requires_grad:   # factors without grad: J_W of W alone
            w = w.detach().requires_grad_()
        loss = loss_of_weight(w)
        (j_w,) = torch.autograd.grad(loss, w, retain_graph=True)
    penalty = jacobian_correction_penalty(params, j_w.detach(), eta)
    return loss + 0.5 * lam * penalty
