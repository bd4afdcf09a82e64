"""Cyclic 3-way join  R(AB) ⋈ S(BC) ⋈ T(CA)  (triangles) — paper §5.

Partitioning scheme (Fig 3):
  * coarse ``H(A) × G(B)`` → an H×G grid of R partitions, each sized to
    on-chip memory; T is partitioned by H(A) (read G times), S by G(B)
    (read H times),
  * fine ``h(A) × g(B)`` → the √U×√U PMU grid *within* a partition:
    r(a,b) → PMU[h(a), g(b)];  s(b,c) broadcast down column g(b);
    t(c,a) broadcast across row h(a),
  * ``f(C)`` → streaming buckets so the S'/T' pieces per step are small.

Cost: |R| + H·|S| + G·|T|, minimized at H* = √(|R||T| / (M|S|)) giving
|R| + 2√(|R||S||T|/M)  (§5.2).

This module holds the plan and result types and the plan sizing; the fused
engine (``core.engine``) executes the plan.  (The bucket-row scan driver of
the reference is not ported yet.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.core import partition


class Cyclic3Plan(NamedTuple):
    h_parts: int   # coarse H(A) partitions
    g_parts: int   # coarse G(B) partitions
    uh: int        # PMU grid rows, h(A)
    ug: int        # PMU grid cols, g(B)
    f_parts: int   # streaming f(C) buckets
    r_cap: int
    s_cap: int
    t_cap: int


class Cyclic3Result(NamedTuple):
    count: object
    overflowed: object
    tuples_read: object


def default_plan(n_r: int, n_s: int, n_t: int, *, m_budget: int,
                 uh: int = 8, ug: int = 8, f_parts: int | None = None,
                 slack: float = 2.5) -> Cyclic3Plan:
    """H·G = ceil(|R|/M); split via the optimal H* = √(|R||T|/(M|S|)) (§5.2),
    clamped to [1, HG]."""
    hg = max(1, math.ceil(n_r / m_budget))
    h_star = math.sqrt(max(1.0, n_r * n_t / (m_budget * max(1, n_s))))
    h_parts = int(min(max(1.0, h_star), hg))
    g_parts = max(1, math.ceil(hg / h_parts))
    if f_parts is None:
        f_parts = max(1, math.ceil(max(n_s / g_parts, n_t / h_parts) / m_budget))
    r_cap = partition.suggest_capacity(n_r, h_parts * g_parts * uh * ug, slack)
    s_cap = partition.suggest_capacity(n_s, g_parts * f_parts * ug, slack)
    t_cap = partition.suggest_capacity(n_t, h_parts * f_parts * uh, slack)
    return Cyclic3Plan(h_parts, g_parts, uh, ug, f_parts, r_cap, s_cap, t_cap)
