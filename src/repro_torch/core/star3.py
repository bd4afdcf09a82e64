"""Star 3-way join — paper §6.5: small dimension relations R(AB), T(CD)
pinned on-chip, large fact relation S(BC) streamed through once.

One level of hashing on both join columns: the PMU at grid position
(h(b), g(c)) holds the R bucket h(b) and the T bucket g(c); each streamed
s(b,c) tuple is routed to exactly that one PMU (hash-pair routing).

Cost: |R| + |T| + |S| — every tuple is read exactly once.

``star3_count`` is the bucket-row baseline: one launch per S chunk over the
uh x ug grid, with the R row h shared along g and the T row g shared along
h (size-1 batch dimensions, never copied per PMU).  The fused engine
(``core.engine``) runs the same plan in one launch per query round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import partition
from repro_torch.core.relation import Relation
from repro_torch.kernels import ops as kops


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


def layouts(r: Relation, s: Relation, t: Relation, plan: Star3Plan, *,
            salt: int = 0, rb: str = "b", sb: str = "b", sc: str = "c",
            tc: str = "c"):
    """R → [uh,cap], S → [ch,uh,ug,cap], T → [ug,cap]: the dimensions
    pinned by one hash level each, the fact relation routed by arrival
    chunk × (h(B), g(C)) (``salt`` re-randomizes the hashes)."""
    uh, ug, ch = plan.uh, plan.ug, plan.chunks
    rg = partition.bucketize(r, rb, uh, plan.r_cap, fn="h", salt=salt)
    tg = partition.bucketize(t, tc, ug, plan.t_cap, fn="g", salt=salt)
    pos = torch.arange(s.capacity, dtype=torch.int64, device=s.device)
    chunk_ids = torch.where(s.valid, (pos * ch) // s.capacity,
                            torch.zeros_like(pos))
    hb = partition.bucket_ids_for(s, sb, uh, "h", salt)
    gc = partition.bucket_ids_for(s, sc, ug, "g", salt)
    flat = torch.where(s.valid, (chunk_ids * uh + hb) * ug + gc,
                       torch.full_like(chunk_ids, ch * uh * ug))
    sg = partition.bucketize_by_ids(s, flat.to(torch.int32), ch * uh * ug,
                                    plan.s_cap, (ch, uh, ug))
    return rg, sg, tg


def star3_count(r: Relation, s: Relation, t: Relation, plan: Star3Plan, *,
                rb: str = "b", sb: str = "b", sc: str = "c",
                tc: str = "c") -> Star3Result:
    """COUNT of the star join, one bucket-row launch per S chunk."""
    rg, sg, tg = layouts(r, s, t, plan, rb=rb, sb=sb, sc=sc, tc=tc)
    rbx, rvx = rg.columns[rb][:, None], rg.valid[:, None]   # [uh, 1, Cr]
    tcx, tvx = tg.columns[tc][None], tg.valid[None]         # [1, ug, Ct]
    total = torch.zeros((), dtype=torch.int64, device=r.device)
    for k in range(plan.chunks):
        c = kops.bucket_count3_linear(rbx, rvx, sg.columns[sb][k],
                                      sg.columns[sc][k], sg.valid[k], tcx,
                                      tvx)                   # [uh, ug]
        total += c.to(torch.int64).sum()
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    return Star3Result(total, overflow, r.n + s.n + t.n)
