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


# Largest dense operand of the FM existence product, in f32 cells: the
# product runs over the compacted key domains of the surviving rows while
# [nb, nc] and [nc, nd] fit it (R's [na, nb] is taken a slice of rows at a
# time); past it the chunked sparse join runs (``ops.fm_join_registers``).
_DENSE_CELLS = 1 << 26


def _fm_dense(ra, rb, sb, sc, tc, td, n_registers: int):
    """``[1, K]`` registers of the distinct (a, d) pairs of R ⋈ S ⋈ T as
    ``((A_R A_S > 0) A_T) > 0`` over compacted key ids: 0/1 f32 operands,
    f32 sums exact while the inner dimensions stay under 2^24.  None when
    the key domains are past ``_DENSE_CELLS``."""
    dev = ra.device
    ub, ib = torch.unique(torch.cat([rb, sb]), return_inverse=True)
    uc, ic = torch.unique(torch.cat([sc, tc]), return_inverse=True)
    ud, idd = torch.unique(td, return_inverse=True)
    nb, nc, nd = ub.numel(), uc.numel(), ud.numel()
    if (max(nb * nc, nc * nd) > _DENSE_CELLS
            or max(nb, nc) >= kops.EXACT_F32_MAX):
        return None
    ua, ia = torch.unique(ra, return_inverse=True)
    ib_r, ib_s = ib[:rb.numel()], ib[rb.numel():]
    ic_s, ic_t = ic[:sc.numel()], ic[sc.numel():]

    def adjacency(rows, cols, shape):
        m = torch.zeros(shape, dtype=torch.float32, device=dev)
        m[rows, cols] = 1.0
        return m

    a_s = adjacency(ib_s, ic_s, (nb, nc))
    a_t = adjacency(ic_t, idd, (nc, nd))
    regs = torch.zeros((1, n_registers), dtype=torch.int32, device=dev)
    step = max(1, _DENSE_CELLS // max(nb, nc, nd))
    for a0 in range(0, ua.numel(), step):
        a1 = min(a0 + step, ua.numel())
        sel = (ia >= a0) & (ia < a1)
        a_r = adjacency(ia[sel] - a0, ib_r[sel], (a1 - a0, nb))
        reach = (a_r @ a_s > 0).to(torch.float32)
        ai, di = torch.nonzero(reach @ a_t > 0, as_tuple=True)
        regs = kops.fm_fold(regs, kops.fm_pair_keys(ua[a0 + ai], ud[di]))
    return regs


def linear3_fm_distinct(r: Relation, s: Relation, t: Relation,
                        plan: Linear3Plan, *, n_registers: int = 32,
                        rb: str = "b", sb: str = "b", sc: str = "c",
                        tc: str = "c", ra_col: str = "a",
                        td_col: str = "d"):
    """Flajolet–Martin registers of |distinct (a, d)| over the join output
    (Example 1's aggregation), never materializing the join.

    Returns ``(registers [n_registers] int32, overflowed)``, equal to the
    reference's OR over every (H, g) step and h bucket of the Fig 2
    layout.  The layout routes each joining triple to exactly one step and
    bucket (R by (H(b), h(b)), S by (H(b), g(c), h(b)), T by g(c) to every
    bucket), so that OR is the sketch of the distinct (a, d) pairs of
    R' ⋈ S' ⋈ T', R', S' and T' the rows the layout keeps in valid slots
    (an overflowing bucket drops the same rows as the reference's).
    Combine across shards with elementwise OR; estimate via
    ``sketches.fm_estimate``."""
    rg, sg, tg = layouts(r, s, t, plan, rb=rb, sb=sb, sc=sc, tc=tc)

    def live(g, *cols):
        return tuple(g.columns[c][g.valid] for c in cols)

    ra, rbk = live(rg, ra_col, rb)
    sbk, sck = live(sg, sb, sc)
    tck, td = live(tg, tc, td_col)
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    regs = _fm_dense(ra, rbk, sbk, sck, tck, td, n_registers)
    if regs is None:     # every row in bucket 0
        regs = kops.fm_join_registers(
            (torch.zeros_like(ra), ra, rbk), (torch.zeros_like(sbk), sbk, sck),
            (torch.zeros_like(tck), tck, td), n_registers=n_registers)
    return regs[0], overflow
