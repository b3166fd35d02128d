"""Arrival ordering of a synchronous round (numpy), a copy of the
reference's ``repro/fl/arrivals.py``: one stable latency sort decides
which sampled clients are among the first ``n_target`` arrivals, so the
port's arrived masks equal the reference's bit for bit."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def arrival_order(lat: np.ndarray) -> np.ndarray:
    """Sampling-order positions sorted by simulated latency; the sort is
    stable, so equal latencies keep sampling order."""
    return np.argsort(np.asarray(lat), kind="stable")


def arrival_mask(ok: np.ndarray, lat: np.ndarray, n_target: int) -> np.ndarray:
    """Among clients that survived dropout and the deadline (``ok``), the
    ``n_target`` with the smallest latency; a boolean mask in sampling
    order."""
    order = arrival_order(lat)
    keep_sorted = ok[order] & (np.cumsum(ok[order]) <= n_target)
    mask = np.zeros_like(ok)
    mask[order] = keep_sorted
    return mask


def arrival_events(mask: np.ndarray, lat: np.ndarray,
                   t0: float = 0.0) -> List[Tuple[float, int]]:
    """``(absolute_time, position)`` for every admitted client, in
    arrival order (the async engine's stream; same ordering as
    :func:`arrival_order`)."""
    lat = np.asarray(lat, np.float64)
    mask = np.asarray(mask, bool)
    return [(float(t0 + lat[p]), int(p))
            for p in arrival_order(lat) if mask[p]]


def fold_crashes(mask: np.ndarray,
                 crash: Optional[np.ndarray]) -> np.ndarray:
    """Effective arrival mask after crash-before-upload faults
    (``crash=None``: the mask unchanged)."""
    if crash is None:
        return mask
    return mask & ~np.asarray(crash, bool)
