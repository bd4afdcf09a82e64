"""Star 3-way join — paper §6.5: small dimension relations R(AB), T(CD)
pinned on-chip, large fact relation S(BC) streamed through once.

One level of hashing on both join columns: the PMU at grid position
(h(b), g(c)) holds the R bucket h(b) and the T bucket g(c); each streamed
s(b,c) tuple is routed to exactly that one PMU (hash-pair routing).

Cost: |R| + |T| + |S| — every tuple is read exactly once.

This module holds the plan and result types and the plan sizing; the fused
engine (``core.engine``) executes the plan.  (The bucket-row scan driver of
the reference is not ported yet.)
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.core import partition


class Star3Plan(NamedTuple):
    uh: int        # R-side grid rows, h(B)
    ug: int        # T-side grid cols, g(C)
    chunks: int    # S streaming chunks (arrival-order tiles)
    r_cap: int
    s_cap: int
    t_cap: int


class Star3Result(NamedTuple):
    count: object
    overflowed: object
    tuples_read: object


def default_plan(n_r: int, n_s: int, n_t: int, *, uh: int = 8, ug: int = 8,
                 chunks: int = 1, slack: float = 2.5) -> Star3Plan:
    r_cap = partition.suggest_capacity(n_r, uh, slack)
    s_cap = partition.suggest_capacity(n_s, chunks * uh * ug, slack)
    t_cap = partition.suggest_capacity(n_t, ug, slack)
    return Star3Plan(uh, ug, chunks, r_cap, s_cap, t_cap)
