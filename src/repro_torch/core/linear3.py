"""Linear 3-way join  R(AB) ⋈ S(BC) ⋈ T(CD)  — paper §4, Algorithm 1.

Partitioning scheme (Fig 2):
  * coarse ``H(B)`` → `h_parts` partitions of R and S; one R partition is
    sized to fit the on-chip memory budget,
  * fine ``h(B)`` → `u` PMU buckets within a partition,
  * fine ``g(C)`` → `g_parts` streaming buckets of S and T; the T bucket with
    the same g(C) is *broadcast to every PMU* (Algorithm 1 line 15).

Execution = a loop over H(B) partitions; inside one, the bucket-row join
runs on the (g, h) grid of that partition (``kernels.ops.bucket_*``).  The
reference scanned g(C) one bucket at a time; here the g loop is the
kernel's batch, so there is one launch per H partition and the T bucket
rows are addressed by their g index (a size-1 batch dimension), never
copied per PMU bucket.  The fused engine (``core.engine``) runs the whole
sweep in one launch; these drivers are the paper's bucket-by-bucket
baseline.

Cost (tuples touched): |R| + |S| + h_parts·|T|  ==  |R| + |S| + |R||T|/M.
``tuples_read`` on the result reports the realized value.  Per-bucket
counts are int32, as the kernels return them; sums over buckets and
partitions are int64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import partition
from repro_torch.core.relation import Relation
from repro_torch.kernels import ops as kops


class Linear3Plan(NamedTuple):
    h_parts: int   # coarse H(B) partitions of R and S
    u: int         # PMU buckets per partition, h(B)
    g_parts: int   # streaming g(C) buckets of S and T
    r_cap: int     # per-(H,h) bucket capacity for R
    s_cap: int     # per-(H,g,h) bucket capacity for S
    t_cap: int     # per-g bucket capacity for T


class Linear3Result(NamedTuple):
    count: object                # () int64 total join cardinality
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


def layouts(r: Relation, s: Relation, t: Relation, plan: Linear3Plan, *,
            salt: int = 0, rb: str = "b", sb: str = "b", sc: str = "c",
            tc: str = "c"):
    """The Fig 2 data reorganization: R → [hp,u,cap], S → [hp,gp,u,cap],
    T → [gp,cap] (``salt`` re-randomizes every hash level)."""
    hp, u, gp = plan.h_parts, plan.u, plan.g_parts
    r_ids, r_nb = partition.composite_ids(
        r, [(rb, hp, "H"), (rb, u, "h")], salt)
    rg = partition.bucketize_by_ids(r, r_ids, r_nb, plan.r_cap, (hp, u))
    s_ids, s_nb = partition.composite_ids(
        s, [(sb, hp, "H"), (sc, gp, "g"), (sb, u, "h")], salt)
    sg = partition.bucketize_by_ids(s, s_ids, s_nb, plan.s_cap, (hp, gp, u))
    tg = partition.bucketize(t, tc, gp, plan.t_cap, fn="g", salt=salt)
    return rg, sg, tg


def _partition_rows(rg, sg, tg, i, rb, sb, sc, tc):
    """The bucket-row operands of H(B) partition i on its (g, h) grid:
    R row (i, h) shared along g, S rows (i, g, h), T row g shared along
    h."""
    return (rg.columns[rb][i][None], rg.valid[i][None], sg.columns[sb][i],
            sg.columns[sc][i], sg.valid[i], tg.columns[tc][:, None],
            tg.valid[:, None])


def linear3_count(r: Relation, s: Relation, t: Relation,
                  plan: Linear3Plan, *, rb: str = "b", sb: str = "b",
                  sc: str = "c", tc: str = "c") -> Linear3Result:
    """COUNT of the linear 3-way join per Algorithm 1: one bucket-row
    launch per H(B) partition."""
    rg, sg, tg = layouts(r, s, t, plan, rb=rb, sb=sb, sc=sc, tc=tc)
    total = torch.zeros((), dtype=torch.int64, device=r.device)
    for i in range(plan.h_parts):
        c = kops.bucket_count3_linear(
            *_partition_rows(rg, sg, tg, i, rb, sb, sc, tc))   # [gp, u]
        total += c.to(torch.int64).sum()
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    return Linear3Result(total, overflow, r.n + s.n + plan.h_parts * t.n)


def linear3_per_r_counts(r: Relation, s: Relation, t: Relation,
                         plan: Linear3Plan, *, rb: str = "b", sb: str = "b",
                         sc: str = "c", tc: str = "c", key_col: str = "a"):
    """Per-R-tuple counts (Example 1: friends-of-friends-of-friends per user).

    Returns (keys [hp,u,r_cap], counts [hp,u,r_cap] int64, valid,
    overflowed): counts aligned with the bucketized R layout so callers
    can group-by the carried key column.
    """
    rg, sg, tg = layouts(r, s, t, plan, rb=rb, sb=sb, sc=sc, tc=tc)
    counts = torch.stack([
        kops.bucket_per_r_counts(
            *_partition_rows(rg, sg, tg, i, rb, sb, sc, tc))   # [gp, u, Cr]
        .to(torch.int64).sum(0) for i in range(plan.h_parts)])
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    key = key_col if key_col in rg.columns else rb
    return rg.columns[key], counts, rg.valid, overflow
