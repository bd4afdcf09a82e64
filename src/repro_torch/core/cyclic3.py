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

``cyclic3_count`` is the bucket-row baseline: one launch per (H(A), G(B))
cell, with the f(C) stream as the kernel's batch; the S row (j, f, b) is
shared down the grid's columns and the T row (i, f, a) across its rows
(size-1 batch dimensions, never copied per PMU).  The fused engine
(``core.engine``) runs the whole sweep in one launch per round.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import partition
from repro_torch.core.relation import Relation
from repro_torch.kernels import ops as kops


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


def layouts(r: Relation, s: Relation, t: Relation, plan: Cyclic3Plan, *,
            salt: int = 0, ra: str = "a", rb: str = "b", sb: str = "b",
            sc: str = "c", tc: str = "c", ta: str = "a"):
    """The Fig 3 data reorganization: R → [hp,gp,uh,ug,cap],
    S → [gp,fp,ug,cap], T → [hp,fp,uh,cap] (``salt`` re-randomizes every
    hash level)."""
    hp, gp, uh, ug, fp = (plan.h_parts, plan.g_parts, plan.uh, plan.ug,
                          plan.f_parts)
    r_ids, r_nb = partition.composite_ids(
        r, [(ra, hp, "H"), (rb, gp, "G"), (ra, uh, "h"), (rb, ug, "g")], salt)
    rg = partition.bucketize_by_ids(r, r_ids, r_nb, plan.r_cap,
                                    (hp, gp, uh, ug))
    s_ids, s_nb = partition.composite_ids(
        s, [(sb, gp, "G"), (sc, fp, "f"), (sb, ug, "g")], salt)
    sg = partition.bucketize_by_ids(s, s_ids, s_nb, plan.s_cap, (gp, fp, ug))
    t_ids, t_nb = partition.composite_ids(
        t, [(ta, hp, "H"), (tc, fp, "f"), (ta, uh, "h")], salt)
    tg = partition.bucketize_by_ids(t, t_ids, t_nb, plan.t_cap, (hp, fp, uh))
    return rg, sg, tg


def cyclic3_count(r: Relation, s: Relation, t: Relation,
                  plan: Cyclic3Plan, *, pair_index: bool = True,
                  ra: str = "a", rb: str = "b", sb: str = "b", sc: str = "c",
                  tc: str = "c", ta: str = "a") -> Cyclic3Result:
    """Bucket-row triangle count, one call per (H(A), G(B)) cell on its
    (f, a, b) grid.

    ``pair_index=True`` (default) lex-sorts each T bucket row into a
    (c, a)-pair index once and probes it per cell in plain torch
    (``bucket_count3_cyclic_pairidx``), as the reference does.
    ``pair_index=False`` is the all-pairs form, the ``count3_cyclic``
    kernel on the card.
    """
    rg, sg, tg = layouts(r, s, t, plan, ra=ra, rb=rb, sb=sb, sc=sc, tc=tc,
                         ta=ta)
    if pair_index:
        t_c, t_a = kops.sorted_pair_index(tg.columns[tc], tg.columns[ta],
                                          tg.valid)
    else:
        t_c, t_a = tg.columns[tc], tg.columns[ta]
    # S row (j, f, b) shared along a; T row (i, f, a) shared along b
    s_b, s_c, s_v = (x[:, :, None] for x in (sg.columns[sb], sg.columns[sc],
                                             sg.valid))    # [gp,fp,1,ug,Cs]
    t_c, t_a, t_v = (x[..., None, :] for x in (t_c, t_a, tg.valid))
    total = torch.zeros((), dtype=torch.int64, device=r.device)
    for i in range(plan.h_parts):
        for j in range(plan.g_parts):
            cell = (rg.columns[ra][i, j], rg.columns[rb][i, j],
                    rg.valid[i, j], s_b[j], s_c[j], s_v[j])  # R [uh,ug,Cr]
            if pair_index:
                c = kops.bucket_count3_cyclic_pairidx(*cell, t_c[i], t_a[i])
            else:
                c = kops.bucket_count3_cyclic(*cell, t_c[i], t_a[i], t_v[i])
            total += c.to(torch.int64).sum()                # c [fp, uh, ug]
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    tuples = r.n + plan.h_parts * s.n + plan.g_parts * t.n
    return Cyclic3Result(total, overflow, tuples)
