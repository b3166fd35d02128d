"""Local-epoch minibatches for FL clients (numpy), a copy of the
reference's ``repro/data/loader.py::_epoch_rng``, ``client_epochs`` and
``client_step_count``. The chunked sources of the streaming engine are
not ported yet (ROADMAP A10)."""
from __future__ import annotations

from typing import Dict, Iterator

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
