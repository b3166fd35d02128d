"""Streaming chunked FL rounds (PyTorch), the counterpart of the
reference's ``repro/fl/stream_engine.py``: O(chunk) client memory per
round.

The batched engine stacks every sampled client into one ``(C, ...)``
tree. This engine walks the cohort in fixed-size client **chunks**
(``ServerConfig.client_chunk``), a Python loop where the reference has
``lax.scan``:

  1. each chunk runs the batched engine's chunk program
     (``batch_engine.chunk_round_program``) on ``chunk`` clients, so the
     training working set peaks at O(chunk · model);
  2. a chunk's params are assembled from the round's single decoded
     broadcast (plus the chunk's personalization residents), so no
     ``(C, model)`` params tree exists;
  3. uploads stay in the codec's encoded-for-aggregation form
     (``Codec.encode_for_agg``: int8 ``{"q", "scale"}`` nodes, fp16 or
     fp32 dense leaves; a low-rank stage composed back per client) and
     are folded straight into a running fp32 accumulator and weight
     total by the fused dequant-accumulate kernel (K7,
     ``kernels.agg.tree_dequant_acc``: one launch per leaf per chunk,
     in place, each wire value read at its wire width, an int8 node's
     per-client scale folded into its coefficient); the ``(C, model)``
     upload stack never exists;
  4. after the last chunk: mean = acc / max(wtot, 1e-12), then the
     codec's ``agg_finalize`` (which adds a delta codec's reference
     back) and the strategy's ``server_update``.

Pad slots (the cohort rounded up to whole chunks) carry aggregation
weight 0, so K7 adds exact zeros for them. Chunking only reassociates
the fp32 weighted sum: the result equals the batched engine's to fp32
accumulation-order tolerance. Ported for homogeneous ranks, eager data
and defense ``none``; rank tiers, chunked data, defenses, the arena and
the two-level mesh reduction are ROADMAP A4, A5 and A8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.fl.batch_engine import (assemble_client_params,
                                         chunk_round_program)
from repro_torch.fl.client import ClientConfig
from repro_torch.fl.codecs import Codec, make_codec
from repro_torch.fl.strategies import Strategy
from repro_torch.kernels.agg import acc_zeros_like, tree_dequant_acc
from repro_torch.tree import tree_index, tree_leaves, tree_map


@dataclass
class StreamingRound:
    """The streaming round program, configured once per server.
    ``loss_fn`` is the client-stacked loss, ``loss_fn(params, batch) ->
    (C,)``; ``chunk`` the configured clients per chunk."""

    loss_fn: Callable
    strategy: Strategy
    client_cfg: ClientConfig
    personalization: str = "none"
    uplink_codec: Optional[Codec] = None
    fedper_local_keys: Tuple[str, ...] = ()
    chunk: int = 16

    def __post_init__(self):
        if self.uplink_codec is None:
            self.uplink_codec = make_codec("")

    def run(self, state_xs, resident_xs, batches_xs, step_mask_xs, mask_xs,
            sizes_xs, lr, server_state, agg_target, down_payload,
            noise_xs=None):
        """Execute one streaming round over chunk-stacked inputs: every
        ``*_xs`` leaf leads with ``(n_chunks, chunk, ...)``
        (:func:`to_chunks`); ``resident_xs`` is ``None`` without
        personalization residents; ``noise_xs`` lists each chunk's
        uplink int8 noise source. Returns ``(state_ys, local_ys,
        loss_ys, steps_ys, new_global, new_server_state)``, the ``*_ys``
        chunk-stacked like the inputs."""
        codec = self.uplink_codec
        mode = self.personalization
        n_chunks, chunk = step_mask_xs.shape[:2]
        acc = wtot = None
        ys = []
        for i in range(n_chunks):
            params_c = assemble_client_params(
                down_payload,
                None if resident_xs is None else tree_index(resident_xs, i),
                chunk, mode, self.fedper_local_keys)
            new_p, new_state, upload, local, last_loss, n_steps = \
                chunk_round_program(
                    params_c, tree_index(state_xs, i),
                    tree_index(batches_xs, i), step_mask_xs[i], down_payload,
                    loss_fn=self.loss_fn, client_cfg=self.client_cfg,
                    strategy_name=self.strategy.name, personalization=mode,
                    fedper_local_keys=self.fedper_local_keys,
                    uplink_codec=codec, lr=lr, encoded_upload=True,
                    noise=None if noise_xs is None else noise_xs[i])
            del new_p   # reassembled from the broadcast next round
            if upload is not None:
                w = mask_xs[i] * sizes_xs[i]
                if acc is None:
                    acc = acc_zeros_like(upload)
                    wtot = torch.zeros((), dtype=torch.float32,
                                       device=w.device)
                tree_dequant_acc(acc, upload, w)
                wtot = wtot + w.sum()
            ys.append((new_state, local, last_loss, n_steps))

        if mode != "local":
            den = torch.clamp_min(wtot, 1e-12)
            mean = codec.agg_finalize(tree_map(lambda a: a / den, acc),
                                      ref=down_payload)
            new_global, new_server_state = self.strategy.server_update(
                server_state, agg_target, mean)
        else:
            new_global, new_server_state = agg_target, server_state
        state_ys, local_ys, loss_ys, steps_ys = (
            _stack_chunks([y[k] for y in ys]) for k in range(4))
        return (state_ys, local_ys, loss_ys, steps_ys, new_global,
                new_server_state)


def _stack_chunks(trees):
    """Per-chunk trees stacked along a new leading chunk axis (``None``
    and empty trees stay as they are)."""
    if trees[0] is None or not tree_leaves(trees[0]):
        return trees[0]
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def chunk_layout(n_clients: int, chunk: int) -> Tuple[int, int, int]:
    """(chunk, n_chunks, pad): clients padded to a whole number of
    fixed-size chunks; pad entries ride along fully masked."""
    chunk = max(1, min(int(chunk), n_clients))
    n_chunks = -(-n_clients // chunk)
    return chunk, n_chunks, n_chunks * chunk - n_clients


def to_chunks(tree: Any, n_chunks: int, chunk: int) -> Any:
    """Reshape (C_pad, ...) stacked leaves (tensors or numpy arrays) to
    (n_chunks, chunk, ...)."""
    return tree_map(
        lambda x: x.reshape((n_chunks, chunk) + tuple(x.shape[1:])), tree)


def from_chunks(tree: Any) -> Any:
    """Inverse of :func:`to_chunks`: flatten the two leading axes."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), tree)
