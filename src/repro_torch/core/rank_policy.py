"""Rank hyper-parameter policy for FedPara (Prop. 2 / Corollary 1).

The paper controls the per-layer inner rank with a single scalar
``gamma`` in [0, 1]:

    r = round((1 - gamma) * r_min + gamma * r_max)

* ``r_min = ceil(sqrt(min(m, n)))`` — the smallest inner rank for which
  ``r^2 >= min(m, n)``, i.e. the constructed matrix can reach full rank
  (Corollary 1).
* ``r_max`` — the largest inner rank whose parameter count does not
  exceed the original layer (parameter parity).

Convolutions (Prop. 3) interpolate the same way between ``conv_rmin``
and ``conv_rmax`` (:func:`conv_rank_for_gamma`); :func:`resolve_matrix`
and :func:`resolve_conv` bundle a layer's decision as a
:class:`RankSpec`. A copy of the reference's ``core/rank_policy.py``
without the heterogeneous tiers (``TierSchedule``, the tier ranks),
which come with ROADMAP A5.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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


def matrix_param_count(m: int, n: int, r: int) -> int:
    """FedPara FC parameter count 2R(m+n) for r1 = r2 = R (Prop. 2)."""
    return 2 * r * (m + n)


def lowrank_rank_for_params(m: int, n: int, budget: int) -> int:
    """Rank of a conventional X Yᵀ factorization with <= ``budget`` params."""
    return max(1, budget // (m + n))


# ---------------------------------------------------------------- conv (Prop 3)

def conv_rmin(out_ch: int, in_ch: int) -> int:
    """Corollary 1's full-rank floor on the (O, I) unfolding."""
    return matrix_rmin(out_ch, in_ch)


def conv_rmax(out_ch: int, in_ch: int, k1: int, k2: int) -> int:
    """Largest R with 2R(O+I+R·K1K2) <= O·I·K1·K2 (Prop. 3 param count)."""
    # Solve 2k R^2 + 2(O+I) R - OIk <= 0  with k = K1*K2.
    k = k1 * k2
    a, b, c = 2 * k, 2 * (out_ch + in_ch), -(out_ch * in_ch * k)
    disc = b * b - 4 * a * c
    r = int((-b + math.sqrt(disc)) / (2 * a))
    return max(1, r)


def conv_rank_for_gamma(out_ch: int, in_ch: int, k1: int, k2: int,
                        gamma: float) -> int:
    """The paper's interpolation between :func:`conv_rmin` and
    :func:`conv_rmax`."""
    rmin, rmax = conv_rmin(out_ch, in_ch), conv_rmax(out_ch, in_ch, k1, k2)
    if rmax < rmin:
        return rmin
    return int(round((1.0 - gamma) * rmin + gamma * rmax))


def conv_param_count(out_ch: int, in_ch: int, k1: int, k2: int, r: int) -> int:
    """FedPara conv (Prop. 3) parameter count 2R(O + I + R·K1·K2)."""
    return 2 * r * (out_ch + in_ch + r * k1 * k2)


def conv_reshape_param_count(out_ch: int, in_ch: int, k1: int, k2: int,
                             r: int) -> int:
    """FedPara conv via reshape (Prop. 1 on O×(I·K1·K2)): 2R(O + I·K1·K2)."""
    return 2 * r * (out_ch + in_ch * k1 * k2)


@dataclass(frozen=True)
class RankSpec:
    """Resolved rank decision for one layer."""

    r: int
    r_min: int
    r_max: int
    params: int
    dense_params: int

    @property
    def compression(self) -> float:
        return self.params / max(1, self.dense_params)


def resolve_matrix(m: int, n: int, gamma: float) -> RankSpec:
    """The rank decision for an (m, n) FedPara matrix layer."""
    r = matrix_rank_for_gamma(m, n, gamma)
    return RankSpec(r=r, r_min=matrix_rmin(m, n), r_max=matrix_rmax(m, n),
                    params=matrix_param_count(m, n, r), dense_params=m * n)


def resolve_conv(out_ch: int, in_ch: int, k1: int, k2: int,
                 gamma: float) -> RankSpec:
    """The rank decision for an (O, I, K1, K2) Prop.-3 conv layer."""
    r = conv_rank_for_gamma(out_ch, in_ch, k1, k2, gamma)
    return RankSpec(r=r, r_min=conv_rmin(out_ch, in_ch),
                    r_max=conv_rmax(out_ch, in_ch, k1, k2),
                    params=conv_param_count(out_ch, in_ch, k1, k2, r),
                    dense_params=out_ch * in_ch * k1 * k2)
