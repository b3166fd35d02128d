"""Client-batched FL round engine (PyTorch), the counterpart of the
reference's ``repro/fl/batch_engine.py``.

The sequential engine trains the round's clients one after another.
This engine stacks the sampled clients' params, optimizer momentum and
strategy state along a leading **client axis** and trains them
together:

  1. a Python loop over the round's local steps (the reference's
     ``lax.scan``), every step one client-stacked step for all C
     clients (``client._step_math(..., stacked=True)``); a float step
     mask keeps a client whose data ran out where it was: its padding
     step runs the same math and is discarded, so real steps are
     unaffected;
  2. the client axis is written out (the reference's ``jax.vmap``):
     the model's stacked loss runs each client on its own weights, so
     with ``ParamCfg(use_kernels=True)`` every layer of every step is one
     client-stacked kernel launch (K2 forward, the client forms of K3
     and K4 backward), not C launches;
  3. payload selection (none / pfedpara / fedper / local) as tree
     restructuring on the stacked tree;
  4. the uplink codec on the client stack (``Codec.encode_decode`` /
     ``encode_for_agg`` with ``stacked=True``): delta against the
     round's decoded broadcast, top-k with the client-stacked error
     feedback in ``stacked_state["_ef_up"]``, low-rank, int8 (one scale
     per client, its noise drawn per sampled position) and fp16;
  5. a masked weighted mean over the client axis (the arrived-mask
     gives a client that did not arrive weight 0) and the strategy's
     ``server_update``.

Ported for homogeneous ranks with defense ``none``; rank tiers, faults
and defenses (A5), the arena store (A4) and meshes (A8) are not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.fl import comm
from repro_torch.fl.client import ClientConfig, _step_math, strategy_post
from repro_torch.fl.codecs import Codec, make_codec
from repro_torch.fl.strategies import (Strategy, lead, tree_broadcast,
                                       tree_wmean_stacked, tree_zeros)
from repro_torch.tree import tree_map


def _tree_where(on: torch.Tensor, a: Any, b: Any) -> Any:
    """Per client: ``a`` where ``on`` (a (C,) bool) holds, else ``b``."""
    return tree_map(lambda x, y: torch.where(lead(on, x), x, y), a, b)


def batched_local_update(stacked_params: Any, stacked_state: Dict,
                         batches: Dict[str, torch.Tensor],
                         step_mask: torch.Tensor, loss_fn: Callable,
                         cfg: ClientConfig, strategy_name: str, lr):
    """Run every stacked client's local epochs at once.

    ``stacked_params`` / ``stacked_state`` leaves are ``(C, ...)``;
    ``batches`` leaves are ``(C, S, B, ...)`` tensors on the params'
    device; ``step_mask`` is ``(C, S)`` float32; ``loss_fn(params,
    batch)`` is the client-stacked loss, (C,). Returns ``(new_params,
    new_state, last_loss, n_steps)``, all stacked along the client axis.
    A masked step feeds its padding batch through the same step math and
    then discards the result: params, momentum and the last loss stay
    as they were."""
    params0 = stacked_params
    p, mu = params0, tree_zeros(params0)
    C, S = step_mask.shape
    last = torch.zeros((C,), dtype=torch.float32, device=step_mask.device)
    for s in range(S):
        b = {k: v[:, s] for k, v in batches.items()}
        new_p, new_mu, loss = _step_math(
            p, mu, b, params0, stacked_state, loss_fn, strategy_name, lr,
            cfg.momentum, cfg.weight_decay, stacked=True)
        on = step_mask[:, s] > 0
        p = _tree_where(on, new_p, p)
        mu = _tree_where(on, new_mu, mu)
        last = torch.where(on, loss.float(), last)
    n = step_mask.sum(dim=1)
    state = strategy_post(strategy_name, stacked_state, params0, p, n, lr)
    return p, state, last, n


def assemble_client_params(down_payload: Any, residents: Any, n: int,
                           personalization: str,
                           fedper_local_keys: Tuple[str, ...] = ()):
    """Stacked ``(n, model)`` client params from the round's decoded
    broadcast plus client-stacked personalization residents, the inverse
    of :func:`select_upload`. With ``personalization="none"`` it is a
    pure broadcast and ``residents`` is ignored."""
    if personalization == "none":
        return tree_broadcast(down_payload, n)
    if personalization == "pfedpara":
        return comm.merge_pfedpara(tree_broadcast(down_payload, n),
                                   residents)
    if personalization == "fedper":
        merged = dict(tree_broadcast(down_payload, n))
        merged.update(residents)
        return merged
    # "local": residents are the full per-client params
    return residents


def select_upload(stacked_params: Any, personalization: str,
                  fedper_local_keys: Tuple[str, ...] = ()):
    """(upload, local) stacked trees per personalization mode."""
    if personalization == "pfedpara":
        return comm.split_pfedpara(stacked_params)
    if personalization == "fedper":
        up = {k: v for k, v in stacked_params.items()
              if k not in fedper_local_keys}
        loc = {k: v for k, v in stacked_params.items()
               if k in fedper_local_keys}
        return up, loc
    if personalization == "local":
        return None, stacked_params
    return stacked_params, None


def chunk_round_program(stacked_params: Any, stacked_state: Dict,
                        batches: Dict[str, torch.Tensor],
                        step_mask: torch.Tensor, down_payload: Any, *,
                        loss_fn: Callable, client_cfg: ClientConfig,
                        strategy_name: str, personalization: str,
                        fedper_local_keys: Tuple[str, ...],
                        uplink_codec: Codec, lr,
                        encoded_upload: bool = False, noise: Any = None):
    """One chunk of clients: local epochs, payload selection, per-client
    uplink encoding; the shared core of the batched round (chunk = the
    whole cohort) and of every streaming step (chunk = ``client_chunk``
    clients). The codec encodes the stacked uploads against the round's
    decoded broadcast ``down_payload``, its error feedback threaded
    through ``stacked_state["_ef_up"]``; ``noise`` is the int8 stage's
    noise source for the stack (``Codec.encode``). ``encoded_upload``
    asks for the encoded-for-aggregation form (``Codec.encode_for_agg``)
    instead of the decoded upload. Returns ``(new_params, new_state,
    upload, local, last_loss, n_steps)``, all stacked along the chunk's
    client axis."""
    new_p, new_state, last_loss, n_steps = batched_local_update(
        stacked_params, stacked_state, batches, step_mask, loss_fn,
        client_cfg, strategy_name, lr)
    upload, local = select_upload(new_p, personalization, fedper_local_keys)
    codec = uplink_codec
    if upload is not None:
        enc = codec.encode_for_agg if encoded_upload else codec.encode_decode
        upload, new_ef = enc(upload, ref=down_payload,
                             ef=new_state.get("_ef_up"), noise=noise,
                             stacked=True)
        if codec.has_ef:
            new_state = {**new_state, "_ef_up": new_ef}
    return new_p, new_state, upload, local, last_loss, n_steps


@dataclass
class ClientBatch:
    """The batched round program, configured once per server: local
    updates, payload selection, uplink codec, masked aggregation and the
    strategy's server update for the whole sampled cohort. ``loss_fn``
    is the client-stacked loss, ``loss_fn(params, batch) -> (C,)``."""

    loss_fn: Callable
    strategy: Strategy
    client_cfg: ClientConfig
    personalization: str = "none"
    uplink_codec: Optional[Codec] = None
    fedper_local_keys: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.uplink_codec is None:
            self.uplink_codec = make_codec("")

    def run(self, stacked_params, stacked_state, batches, step_mask,
            arrived_mask, sizes, lr, server_state, agg_target, down_payload,
            noise=None):
        """Execute one round. ``arrived_mask`` and ``sizes`` are (C,)
        float32; a client that did not arrive trains but carries
        aggregation weight 0; ``noise`` is the uplink int8 stage's noise
        source for the stack. Returns ``(new_params, new_state, upload,
        local, last_loss, n_steps, new_global, new_server_state)``."""
        new_p, new_state, upload, local, last_loss, n_steps = \
            chunk_round_program(
                stacked_params, stacked_state, batches, step_mask,
                down_payload, loss_fn=self.loss_fn,
                client_cfg=self.client_cfg,
                strategy_name=self.strategy.name,
                personalization=self.personalization,
                fedper_local_keys=self.fedper_local_keys,
                uplink_codec=self.uplink_codec, lr=lr, noise=noise)
        if upload is not None:
            mean_w = tree_wmean_stacked(upload, arrived_mask * sizes)
            new_global, new_server_state = self.strategy.server_update(
                server_state, agg_target, mean_w)
        else:
            new_global, new_server_state = agg_target, server_state
        return (new_p, new_state, upload, local, last_loss, n_steps,
                new_global, new_server_state)
