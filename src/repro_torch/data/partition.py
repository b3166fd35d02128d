"""Federated data partitioning (numpy), a copy of the reference's
``repro/data/partition.py::iid_partition`` and ``dirichlet_partition``
(He et al. 2020, alpha = 0.5 as in the paper)."""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(n: int, clients: int, seed: int = 0) -> List[np.ndarray]:
    """``clients`` sorted index arrays of a seeded permutation of n."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    return [np.sort(part) for part in np.array_split(idx, clients)]


def dirichlet_partition(labels: np.ndarray, clients: int, alpha: float = 0.5,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Per-class Dirichlet(alpha) shares, redrawn until every client holds
    at least ``min_size`` samples."""
    rng = np.random.RandomState(seed)
    classes = int(labels.max()) + 1
    while True:
        parts: List[List[int]] = [[] for _ in range(clients)]
        for c in range(classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, chunk in enumerate(np.split(idx_c, cuts)):
                parts[cid].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_size:
            break
    return [np.sort(np.array(p, np.int64)) for p in parts]
