"""The paper's cost analysis (§4.2, §5.2, §6.3) as executable formulas.

Cost metric: number of tuples read onto the accelerator chip.  These are the
closed forms the algorithms' realized ``tuples_read`` are validated against,
and the inputs to the planner's 3-way vs cascaded-binary decision.

All counts are float (they model 1e11-scale relations); M is the on-chip
memory budget in tuples; d is the max distinct values over join columns.
"""

from __future__ import annotations

import math
from typing import NamedTuple


def linear3_tuples(n_r: float, n_s: float, n_t: float, m: float) -> float:
    """|R| + |S| + |R||T|/M  (§4.2).  R should be the smaller of R, T."""
    return n_r + n_s + (n_r * n_t) / m


def cyclic3_optimal_h(n_r: float, n_s: float, n_t: float, m: float) -> float:
    """H* = √(|R||T| / (M|S|))  (§5.2)."""
    return math.sqrt((n_r * n_t) / (m * n_s))


def cyclic3_tuples(n_r: float, n_s: float, n_t: float, m: float,
                   h: float | None = None) -> float:
    """|R| + H|S| + G|T| with GH = |R|/M;  at H* this is
    |R| + 2√(|R||S||T|/M)  (§5.2)."""
    if h is None:
        return n_r + 2.0 * math.sqrt(n_r * n_s * n_t / m)
    g = n_r / (m * h)
    return n_r + h * n_s + g * n_t


def intermediate_size(n_r: float, n_s: float, d: float) -> float:
    """|R ⋈ S| ≤ |R||S|/d under the uniform assumption (Swami–Schiefer)."""
    return n_r * n_s / d


def cascaded_binary_tuples(n_r: float, n_s: float, n_t: float, m: float,
                           d: float) -> float:
    """Tuples moved on/off chip for the cascade: read R,S; write intermediate
    I; read I back; read T once per I-partition batch (T partition-resident
    like Algorithm 1 with I streamed — the paper streams I and loads T
    partitions; tuple traffic: |R|+|S| + 2|I| + |T|)."""
    i = intermediate_size(n_r, n_s, d)
    return n_r + n_s + 2.0 * i + n_t


class PlanChoice(NamedTuple):
    strategy: str          # "linear3" | "cascade"
    tuples_3way: float
    tuples_cascade: float
    speed_ratio: float     # cascade / 3way traffic ratio (>1 favors 3-way)


def choose_linear_strategy(n_r: float, n_s: float, n_t: float, m: float,
                           d: float) -> PlanChoice:
    """§4.2 / Example 3 decision: 3-way wins iff its total tuple traffic is
    below the cascade's (which includes the intermediate round-trip)."""
    t3 = linear3_tuples(n_r, n_s, n_t, m)
    tc = cascaded_binary_tuples(n_r, n_s, n_t, m, d)
    return PlanChoice("linear3" if t3 < tc else "cascade", t3, tc, tc / t3)


def choose_cyclic_strategy(n_r: float, n_s: float, n_t: float, m: float,
                           d: float) -> PlanChoice:
    t3 = cyclic3_tuples(n_r, n_s, n_t, m)
    tc = cascaded_binary_tuples(n_r, n_s, n_t, m, d)
    return PlanChoice("cyclic3" if t3 < tc else "cascade", t3, tc, tc / t3)


def example3_threshold_m(n: float = 6e11) -> float:
    """Example 3: the M above which the 3-way self-join reads fewer tuples
    than the cascade's intermediate for the Facebook relation."""
    # n + n + n²/M < 3.6e14  =>  M > n² / (3.6e14 - 2n)
    rhs = 3.6e14 - 2.0 * n
    return (n * n) / rhs


def example4_threshold_m(n: float = 6e11,
                         intermediate: float = 1.8e14) -> float:
    """Example 4: minimal M for the cyclic 3-way to beat the intermediate.

    Follows the paper's in-text expression n(1 + √(n/M)) — which drops the
    factor 2 of the §5.2 closed form (a paper-internal inconsistency we
    reproduce as written; see EXPERIMENTS.md §Paper-claims).
    """
    # n(1 + sqrt(n/M)) < intermediate  =>  M > n / (intermediate/n - 1)^2
    return n / (intermediate / n - 1.0) ** 2
