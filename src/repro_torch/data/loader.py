"""Local-epoch minibatches for FL clients (numpy), a copy of the
reference's ``repro/data/loader.py``: ``_epoch_rng``, ``client_epochs``
and ``client_step_count`` (the sequential engine), and the eager
client stack ``stack_client_epochs`` with ``_client_steps``,
``_pad_batch`` and ``_fill_row`` (the batched and streaming engines).
The chunked sources of the streaming engine (``ChunkBatchSource``,
``VirtualPartitions``) are not ported yet (ROADMAP A10)."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _epoch_rng(seed: int) -> np.random.RandomState:
    """Shuffle RNG for one client's local epochs. Seeds below 2^32 keep
    the ``RandomState(seed)`` stream; wider 64-bit seeds (from
    ``repro_torch.fl.trace.spawn_seeds``) are folded through a
    SeedSequence into a full 128-bit ``RandomState`` key."""
    s = int(seed)
    if 0 <= s < 2 ** 32:
        return np.random.RandomState(s)
    return np.random.RandomState(np.random.SeedSequence(s).generate_state(4))


def client_epochs(data: Dict[str, np.ndarray], idx: np.ndarray, batch: int,
                  epochs: int, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Minibatch iterator over one client's local data for E epochs."""
    rng = _epoch_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(len(idx))
        for i in range(0, len(order) - batch + 1, batch):
            sel = idx[order[i: i + batch]]
            yield {k: v[sel] for k, v in data.items()}
        if 0 < len(order) < batch:  # tiny client: one short batch per epoch
            sel = idx[order]
            yield {k: v[sel] for k, v in data.items()}


def client_step_count(n_samples: int, batch: int, epochs: int) -> int:
    """Number of local steps ``client_epochs`` yields for a client with
    ``n_samples`` points, from sizes alone."""
    if n_samples <= 0:
        return 0
    per_epoch = n_samples // batch if n_samples >= batch else 1
    return per_epoch * epochs


def _client_steps(data: Dict[str, np.ndarray], idx: np.ndarray, batch: int,
                  epochs: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """One client's materialized local-epoch minibatch list (empty for
    clients with no samples)."""
    return (list(client_epochs(data, idx, batch, epochs, seed))
            if len(idx) else [])


def _pad_batch(b: Dict[str, np.ndarray], batch: int,
               keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """Wrap a tiny client's short batch up to the full batch size."""
    n = len(b[keys[0]])
    if n == batch:
        return b
    sel = np.resize(np.arange(n), batch)  # wrap tiny-client batches
    return {k: v[sel] for k, v in b.items()}


def _fill_row(out: Dict[str, np.ndarray], step_mask: np.ndarray, row: int,
              steps: List[Dict[str, np.ndarray]], S: int, batch: int,
              keys: Sequence[str]) -> None:
    """Write one client's steps into row ``row`` of the stacked output,
    right-padding by repeating its own batches."""
    if not steps:  # empty client: all-padding (zeros), mask stays 0
        return
    steps = [_pad_batch(b, batch, keys) for b in steps]
    step_mask[row, : len(steps)] = 1.0
    for s in range(S):
        b = steps[s] if s < len(steps) else steps[s % len(steps)]
        for k in keys:
            out[k][row, s] = b[k]


def stack_client_epochs(
    data: Dict[str, np.ndarray],
    partitions: Sequence[np.ndarray],
    cids: Sequence[int],
    batch: int,
    epochs: int,
    seeds: Sequence[int],
    pad_steps: Optional[int] = None,
    pad_clients: int = 0,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Every sampled client's ``client_epochs`` stream as one stacked
    batch array for the client-batched engines.

    Returns ``(batches, step_mask)``: ``batches[k]`` has shape
    ``(C, S, B, ...)`` (C clients, S = the most local steps of any of
    them, B = batch size) and ``step_mask`` is a float32 ``(C, S)``
    array with 1.0 on real steps. Clients with fewer than S steps are
    right-padded by repeating their own batches (the pad steps are
    masked out); short batches of tiny clients are filled by wrapping
    their indices. ``pad_steps`` fixes S explicitly (it must cover every
    client's real step count); ``pad_clients`` appends that many
    all-zero, fully masked client rows (the streaming engine's chunk
    padding)."""
    per_client = [_client_steps(data, partitions[cid], batch, epochs, seed)
                  for cid, seed in zip(cids, seeds)]
    C = len(per_client)
    S = max(1, max(len(s) for s in per_client))
    if pad_steps is not None:
        if pad_steps < S:
            raise ValueError(
                f"pad_steps={pad_steps} below max real step count {S}")
        S = max(1, pad_steps)
    keys = list(data.keys())

    step_mask = np.zeros((C + pad_clients, S), np.float32)
    out = {k: np.zeros((C + pad_clients, S, batch) + data[k].shape[1:],
                       data[k].dtype) for k in keys}
    for c, steps in enumerate(per_client):
        _fill_row(out, step_mask, c, steps, S, batch, keys)
    return out, step_mask
