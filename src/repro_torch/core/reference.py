"""Scan-based reference baselines: whole-query retry drivers and the host
join-count oracle.

The paper assumes near-uniform keys (§1.2) and notes that skew must be
handled by "leaving some components to handle overflow" or re-partitioning.
These drivers implement the naive whole-query version of that loop: on
overflow, grow every per-bucket capacity geometrically and re-run the
whole join.  The fused engine's per-cell recovery (``core.recovery``)
replaces this on the production path; these functions are the scan-based
baselines the engine is measured and tested against.

This module is also the one place a host ``np.unique`` is allowed:
:func:`host_join_count` is the host-histogram oracle that the device-side
``binary_join.exact_join_count`` is tested against — nothing on the
execution path calls it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core import cyclic3, linear3, recovery, star3
from repro_torch.core.relation import Relation


class OverflowError_(RuntimeError):
    pass


def host_join_count(build: Relation, build_key: str,
                    probe: Relation, probe_key: str) -> int:
    """Exact ``|build ⋈ probe|`` via host-side key histograms (np.unique +
    intersect1d), summed in int64."""
    bv = build.col(build_key)[build.valid].cpu().numpy()
    pv = probe.col(probe_key)[probe.valid].cpu().numpy()
    bu, bc = np.unique(bv, return_counts=True)
    pu, pc = np.unique(pv, return_counts=True)
    _, bi, pi = np.intersect1d(bu, pu, return_indices=True)
    return int((bc[bi].astype(np.int64) * pc[pi].astype(np.int64)).sum())


def _grown(plan: Any, growth: float, align: int = 8) -> Any:
    return recovery.grown(plan, growth, align)


def linear3_count_auto(r, s, t, plan: linear3.Linear3Plan, *,
                       max_retries: int = 4, growth: float = 2.0, **kw):
    """linear3_count with geometric capacity growth on overflow.  Returns
    (result, the plan of the run that did not overflow)."""
    for _ in range(max_retries + 1):
        res = linear3.linear3_count(r, s, t, plan, **kw)
        if not bool(res.overflowed):
            return res, plan
        plan = _grown(plan, growth)
    raise OverflowError_(f"linear3 overflow persisted; final plan {plan}")


def linear3_per_r_counts_auto(r, s, t, plan: linear3.Linear3Plan, *,
                              max_retries: int = 4, growth: float = 2.0, **kw):
    for _ in range(max_retries + 1):
        keys, counts, valid, ovf = linear3.linear3_per_r_counts(
            r, s, t, plan, **kw)
        if not bool(ovf):
            return (keys, counts, valid), plan
        plan = _grown(plan, growth)
    raise OverflowError_(f"linear3 per-r overflow persisted; final plan {plan}")


def cyclic3_count_auto(r, s, t, plan: cyclic3.Cyclic3Plan, *,
                       max_retries: int = 4, growth: float = 2.0, **kw):
    for _ in range(max_retries + 1):
        res = cyclic3.cyclic3_count(r, s, t, plan, **kw)
        if not bool(res.overflowed):
            return res, plan
        plan = _grown(plan, growth)
    raise OverflowError_(f"cyclic3 overflow persisted; final plan {plan}")


def star3_count_auto(r, s, t, plan: star3.Star3Plan, *,
                     max_retries: int = 4, growth: float = 2.0, **kw):
    for _ in range(max_retries + 1):
        res = star3.star3_count(r, s, t, plan, **kw)
        if not bool(res.overflowed):
            return res, plan
        plan = _grown(plan, growth)
    raise OverflowError_(f"star3 overflow persisted; final plan {plan}")
