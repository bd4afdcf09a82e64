"""Linear 3-way join  R(AB) ⋈ S(BC) ⋈ T(CD)  — paper §4, Algorithm 1.

Partitioning scheme (Fig 2):
  * coarse ``H(B)`` → `h_parts` partitions of R and S; one R partition is
    sized to fit the on-chip memory budget,
  * fine ``h(B)`` → `u` PMU buckets within a partition,
  * fine ``g(C)`` → `g_parts` streaming buckets of S and T; the T bucket with
    the same g(C) is *broadcast to every PMU* (Algorithm 1 line 15).

Cost (tuples touched): |R| + |S| + h_parts·|T|  ==  |R| + |S| + |R||T|/M.

This module holds the plan and result types and the plan sizing; the fused
engine (``core.engine``) executes the plan.  (The bucket-row scan driver of
the reference is not ported yet.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.core import partition


class Linear3Plan(NamedTuple):
    h_parts: int   # coarse H(B) partitions of R and S
    u: int         # PMU buckets per partition, h(B)
    g_parts: int   # streaming g(C) buckets of S and T
    r_cap: int     # per-(H,h) bucket capacity for R
    s_cap: int     # per-(H,g,h) bucket capacity for S
    t_cap: int     # per-g bucket capacity for T


class Linear3Result(NamedTuple):
    count: object                # () int total join cardinality
    overflowed: object           # () bool — any bucket overflow (skew signal)
    tuples_read: object          # () int64 tuples streamed on-chip


def default_plan(n_r: int, n_s: int, n_t: int, *, m_budget: int,
                 u: int = 64, g_parts: int | None = None,
                 slack: float = 2.5) -> Linear3Plan:
    """Size partition counts from the paper's rules: h_parts = ceil(|R|/M) so
    one R partition fits the memory budget; g_parts so a T bucket does."""
    h_parts = max(1, math.ceil(n_r / m_budget))
    if g_parts is None:
        g_parts = max(1, math.ceil(n_t / m_budget))
    r_cap = partition.suggest_capacity(n_r, h_parts * u, slack)
    s_cap = partition.suggest_capacity(n_s, h_parts * g_parts * u, slack)
    t_cap = partition.suggest_capacity(n_t, g_parts, slack)
    return Linear3Plan(h_parts, u, g_parts, r_cap, s_cap, t_cap)
