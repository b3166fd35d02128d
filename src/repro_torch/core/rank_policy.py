"""Rank hyper-parameter policy for FedPara (Prop. 2 / Corollary 1).

The paper controls the per-layer inner rank with a single scalar
``gamma`` in [0, 1]:

    r = round((1 - gamma) * r_min + gamma * r_max)

* ``r_min = ceil(sqrt(min(m, n)))`` — the smallest inner rank for which
  ``r^2 >= min(m, n)``, i.e. the constructed matrix can reach full rank
  (Corollary 1).
* ``r_max`` — the largest inner rank whose parameter count does not
  exceed the original layer (parameter parity).

A copy of the matrix half of the reference's ``core/rank_policy.py``;
conv ranks and heterogeneous tiers are not needed by serving yet.
"""
from __future__ import annotations

import math


def matrix_rmin(m: int, n: int) -> int:
    """Minimum inner rank achieving full-rank capability (Corollary 1)."""
    return max(1, math.isqrt(min(m, n) - 1) + 1) if min(m, n) > 1 else 1


def matrix_rmax(m: int, n: int) -> int:
    """Largest r with 2r(m+n) <= mn (parameter parity with the dense layer)."""
    return max(1, (m * n) // (2 * (m + n)))


def matrix_rank_for_gamma(m: int, n: int, gamma: float) -> int:
    """Paper's interpolation  r = (1-γ)·r_min + γ·r_max  (§3.1)."""
    rmin, rmax = matrix_rmin(m, n), matrix_rmax(m, n)
    if rmax < rmin:  # degenerate tiny layer: parity already below full-rank point
        return rmin
    return int(round((1.0 - gamma) * rmin + gamma * rmax))
