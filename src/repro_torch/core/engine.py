"""Unified multiway join engine: fused partition sweeps + skew recovery.

The engine issues ONE fused sweep per query and round
(``kernels.ops.fused_*``): on the card that is the hand-written Hopper
kernel, which covers the whole (h_parts, u, g_parts) sweep (resp. the
cyclic/star equivalents) in one call.

Skew recovery (paper §5's skew discussion, made correct-by-construction):
exact coarse partitions keep their fused partial counts, overflowed ones
re-run with a salted hash and grown capacities, and the final round is
exact-histogram-sized so it cannot overflow — ``overflowed == False`` is a
postcondition.  Each round performs exactly ONE hashing pass per relation;
see ``recovery``'s docstring for the full contract.

The ``*_count_fused`` functions are single-pass (overflow flagged, not
recovered); ``MultiwayJoinEngine`` adds the recovery loop.  N-way queries
reach the engine through ``core.plan_ir``: each ``fused3`` plan step runs
through ``MultiwayJoinEngine.count``.
"""

from __future__ import annotations

import torch

from repro_torch.core import cyclic3, linear3, recovery, star3
from repro_torch.core.cyclic3 import layouts as cyclic3_layouts
from repro_torch.core.linear3 import layouts as linear3_layouts
from repro_torch.core.recovery import EngineResult, PerRResult  # noqa: F401  (re-export)
from repro_torch.core.relation import Relation
from repro_torch.core.star3 import layouts as star3_layouts
from repro_torch.kernels import ops as kops


def traffic64(terms) -> torch.Tensor:
    """Σ k·n over ``(static int k, int64 scalar n)`` terms as one int64.

    The reference splits this product into int32 limbs because x64 is off
    in JAX; torch has int64, so it is a plain sum with the same values.
    The multiplier range check stays, so both packages accept and refuse
    the same plans.
    """
    total = torch.zeros((), dtype=torch.int64)
    for k, n in terms:
        k = int(k)
        if k == 0:
            continue
        if not 0 < k < 2**31:
            raise ValueError(f"static traffic multiplier {k} out of range")
        n = torch.as_tensor(n, dtype=torch.int64)
        total = total.to(n.device) + k * n
    return total


# ==========================================================================
# single-pass fused counts (overflow flagged, not recovered)
# ==========================================================================

def linear3_count_fused(r: Relation, s: Relation, t: Relation,
                        plan: linear3.Linear3Plan, *, salt: int = 0,
                        rb: str = "b", sb: str = "b", sc: str = "c",
                        tc: str = "c") -> linear3.Linear3Result:
    """Algorithm 1 as ONE fused sweep (overflow flagged, not recovered)."""
    rg, sg, tg = linear3_layouts(r, s, t, plan, salt=salt, rb=rb, sb=sb,
                                 sc=sc, tc=tc)
    c = kops.fused_count3_linear(rg.columns[rb], rg.valid, sg.columns[sb],
                                 sg.columns[sc], sg.valid, tg.columns[tc],
                                 tg.valid)
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    tuples = traffic64([(1, r.n), (1, s.n), (plan.h_parts, t.n)])
    return linear3.Linear3Result(c.to(torch.int64).sum(), overflow, tuples)


def cyclic3_count_fused(r: Relation, s: Relation, t: Relation,
                        plan: cyclic3.Cyclic3Plan, *, salt: int = 0,
                        pair_index: bool = True,
                        ra: str = "a", rb: str = "b", sb: str = "b",
                        sc: str = "c", tc: str = "c",
                        ta: str = "a") -> cyclic3.Cyclic3Result:
    """The §5 grid algorithm as ONE fused sweep (sorted (c, a)-pair-index
    probes)."""
    rg, sg, tg = cyclic3_layouts(r, s, t, plan, salt=salt, ra=ra, rb=rb,
                                 sb=sb, sc=sc, tc=tc, ta=ta)
    c = kops.fused_count3_cyclic(rg.columns[ra], rg.columns[rb], rg.valid,
                                 sg.columns[sb], sg.columns[sc], sg.valid,
                                 tg.columns[tc], tg.columns[ta], tg.valid,
                                 pair_index=pair_index)
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    tuples = traffic64([(1, r.n), (plan.h_parts, s.n),
                        (plan.g_parts, t.n)])
    return cyclic3.Cyclic3Result(c.to(torch.int64).sum(), overflow, tuples)


def star3_count_fused(r: Relation, s: Relation, t: Relation,
                      plan: star3.Star3Plan, *, salt: int = 0,
                      rb: str = "b", sb: str = "b", sc: str = "c",
                      tc: str = "c") -> star3.Star3Result:
    """The §6.5 star join as ONE fused sweep."""
    rg, sg, tg = star3_layouts(r, s, t, plan, salt=salt, rb=rb, sb=sb,
                               sc=sc, tc=tc)
    c = kops.fused_count3_star(rg.columns[rb], rg.valid, sg.columns[sb],
                               sg.columns[sc], sg.valid, tg.columns[tc],
                               tg.valid)
    overflow = rg.overflowed | sg.overflowed | tg.overflowed
    tuples = traffic64([(1, r.n), (1, s.n), (1, t.n)])
    return star3.Star3Result(c.to(torch.int64).sum(), overflow, tuples)


# ==========================================================================
# the engine: fused sweeps + surgical skew recovery
# ==========================================================================

class MultiwayJoinEngine:
    """Executable multiway hash join with per-partition skew recovery.

    Parameters
    ----------
    kind:        "linear" | "cyclic" | "star" — which §4/§5/§6.5 plan.
    max_rounds:  recovery rounds before the exact-histogram final round.
    growth:      geometric per-round bucket-capacity growth for re-run
                 shards.

    The device of the relations chooses the kernel: CUDA relations run the
    Hopper kernels, CPU relations the plain versions.
    """

    KINDS = ("linear", "cyclic", "star")

    def __init__(self, kind: str = "linear", *, max_rounds: int = 3,
                 growth: float = 2.0, base_salt: int = 0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown kind {kind!r}; choose from {self.KINDS}")
        self.kind = kind
        self.max_rounds = max_rounds
        self.growth = growth
        self.base_salt = base_salt

    # -- planning ----------------------------------------------------------

    def default_plan(self, n_r: int, n_s: int, n_t: int, *, m_budget: int,
                     **kw):
        if self.kind == "linear":
            return linear3.default_plan(n_r, n_s, n_t, m_budget=m_budget,
                                        **kw)
        if self.kind == "cyclic":
            return cyclic3.default_plan(n_r, n_s, n_t, m_budget=m_budget,
                                        **kw)
        return star3.default_plan(n_r, n_s, n_t, **kw)

    # -- execution ---------------------------------------------------------

    def count(self, r: Relation, s: Relation, t: Relation, plan=None, *,
              m_budget: int | None = None, binding=None,
              **cols) -> EngineResult:
        """Exact skew-recovered COUNT.  Column names come from ``binding``
        (a ``query.Binding``) or the per-kind ``rb=/sb=/...`` kwargs."""
        if plan is None:
            if m_budget is None:
                raise ValueError("pass a plan or m_budget")
            plan = self.default_plan(int(r.n), int(s.n), int(t.n),
                                     m_budget=m_budget)
        if binding is not None:
            if binding.kind != self.kind:
                raise ValueError(f"binding classified {binding.kind!r}, "
                                 f"engine built for {self.kind!r}")
            ops = binding.kind_ops()
        else:
            ops = recovery.OPS[self.kind](**cols)
        return recovery.run_count_rounds(
            ops, r, s, t, plan, max_rounds=self.max_rounds,
            growth=self.growth, base_salt=self.base_salt)

    # -- per-R aggregates (linear only) ------------------------------------

    def per_r_counts(self, r: Relation, s: Relation, t: Relation, plan, *,
                     rb: str = "b", sb: str = "b", sc: str = "c",
                     tc: str = "c", key_col: str = "a",
                     binding=None) -> PerRResult:
        """Per-R-tuple counts (Example 1) with skew recovery.  Returns
        flattened (keys, counts, valid) concatenated across rounds."""
        if self.kind != "linear":
            raise ValueError("per_r_counts is a linear-join aggregate")
        if binding is not None:
            ops = binding.kind_ops()
        else:
            ops = recovery.LinearOps(rb=rb, sb=sb, sc=sc, tc=tc)
        return recovery.run_per_r_rounds(
            ops, r, s, t, plan, max_rounds=self.max_rounds,
            growth=self.growth, base_salt=self.base_salt, key_col=key_col)
