"""Shared skew-recovery round engine (the paper's §5 skew handling, unified).

Every multiway kind (linear §4, cyclic §5, star §6.5) recovers from bucket
overflow the same way — only the partition geometry differs.  This module
owns the round loop once; ``engine.MultiwayJoinEngine`` binds it to a kind
via a small KindOps adapter.

The recovery-round contract
---------------------------
Per round ``rnd`` (salt = ``base_salt + rnd``):

1. **One hashing pass per relation.**  ``partition.composite_ids`` is called
   exactly once per relation per round; everything else in the round derives
   from those ids: the exact per-bucket histogram (``torch.bincount`` on the
   device; only the histogram is copied to the host, for capacity sizing
   and overflow detection), the salted bucket layout
   (``partition.bucketize_by_ids``) and the residual mask (the coarse cell
   of a row is id arithmetic, kept on the device).
2. **Exact partials are kept.**  Coarse cells whose buckets all fit are
   final: their fused partial counts are accumulated and never recomputed.
   Each output tuple is owned by exactly one row of the kind's *driving*
   relation (R for linear/cyclic, S for star), and that row lives in exactly
   one coarse cell per round, so kept partials never double count.
3. **Overflowed cells re-run.**  Rows of the driving relation in overflowed
   cells stay valid for the next round; everything else is masked out.  The
   next round re-partitions them with a fresh salt and geometrically grown
   capacities.
4. **The final round cannot overflow.**  Round ``max_rounds`` sizes every
   capacity from the exact histogram of that round's ids, so
   ``overflowed == False`` is a postcondition, not a hope.

Totals are accumulated in int64 and returned as ``np.int64`` — the fused
kernels produce int32 *per-cell* partials (each cell must stay below
2^31), but the query total routinely exceeds int32.

The counts, rounds and tuples_read equal the JAX package's: the hashing,
the layouts and the round decisions are bit-exact with it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import partition
from repro_torch.core.relation import Relation
from repro_torch.core.results import JoinResult, PerRResult  # noqa: F401 (re-export)
from repro_torch.kernels import ops as kops

# Internal alias (see core.results): the recovery loop's scalar result IS
# the unified JoinResult — kept under the engine layer's historical name.
EngineResult = JoinResult


class RelPass(NamedTuple):
    """One relation's single hashing pass for one round."""
    ids: torch.Tensor            # flat composite bucket id per row (device)
    nb: int                      # number of flat buckets
    hist: np.ndarray             # exact per-bucket histogram, out_shape (host)
    out_shape: tuple


def _align(n: int, align: int = 8) -> int:
    return max(align, int(math.ceil(n / align)) * align)


def grown(plan, growth: float, align: int = 8):
    """Geometric per-round bucket-capacity growth for re-run shards."""
    caps = {f: getattr(plan, f) for f in ("r_cap", "s_cap", "t_cap")}
    caps = {f: int(math.ceil(c * growth / align) * align)
            for f, c in caps.items()}
    return plan._replace(**caps)


def exact_cap(hist: np.ndarray) -> int:
    return _align(max(int(hist.max(initial=0)), 1))


def _host_hist(ids: torch.Tensor, nb: int) -> np.ndarray:
    """Exact histogram of flat ids on the device; only the nb counts cross
    to the host."""
    hist = torch.bincount(ids.to(torch.int64), minlength=nb + 1)[:nb]
    return hist.cpu().numpy().astype(np.int64)


def hash_pass(rel: Relation, specs, out_shape: tuple, salt: int) -> RelPass:
    """THE hashing pass: composite ids + the exact histogram derived from
    them.  Everything else a round needs re-uses the returned ids."""
    ids, nb = partition.composite_ids(rel, specs, salt)
    return RelPass(ids, nb, _host_hist(ids, nb).reshape(out_shape), out_shape)


def layout(rel: Relation, p: RelPass, cap: int) -> partition.Buckets:
    """Bucketize from an existing pass — zero additional hashing."""
    return partition.bucketize_by_ids(rel, p.ids, p.nb, cap, p.out_shape)


def cell_of(p: RelPass, inner: int, n_cells: int) -> torch.Tensor:
    """Coarse-cell id per row from composite-id arithmetic (no re-hash),
    on the device.  Invalid rows land on a clipped cell; callers AND with
    ``rel.valid``."""
    return torch.clamp(p.ids.to(torch.int64) // inner, 0, n_cells - 1)


def _mask_by_cells(rel: Relation, bad: np.ndarray, cell: torch.Tensor):
    keep = torch.as_tensor(bad.reshape(-1), device=rel.device)[cell]
    return rel.mask_where(keep)


# ==========================================================================
# kind adapters
# ==========================================================================

class LinearOps:
    """R(aB) ⋈ S(BC) ⋈ T(Cd): coarse cells are the H(B) partitions; the
    driving relation is R (T is shared by every cell and therefore exact-
    sized from its histogram every round — H-splitting cannot recover it)."""

    kind = "linear"
    driving = "r"

    def __init__(self, rb="b", sb="b", sc="c", tc="c"):
        self.rb, self.sb, self.sc, self.tc = rb, sb, sc, tc

    def specs(self, plan):
        hp, u, gp = plan.h_parts, plan.u, plan.g_parts
        return {
            "r": ([(self.rb, hp, "H"), (self.rb, u, "h")], (hp, u)),
            "s": ([(self.sb, hp, "H"), (self.sc, gp, "g"),
                   (self.sb, u, "h")], (hp, gp, u)),
            "t": ([(self.tc, gp, "g")], (gp,)),
        }

    def size_caps(self, plan, passes, final):
        plan = plan._replace(
            t_cap=max(plan.t_cap, exact_cap(passes["t"].hist)))
        if final:
            plan = plan._replace(r_cap=exact_cap(passes["r"].hist),
                                 s_cap=exact_cap(passes["s"].hist))
        return plan

    def count(self, L, plan):
        return kops.fused_count3_linear(
            L["r"].columns[self.rb], L["r"].valid, L["s"].columns[self.sb],
            L["s"].columns[self.sc], L["s"].valid, L["t"].columns[self.tc],
            L["t"].valid)                                         # [hp, u]

    def bad_cells(self, passes, plan):
        return ((passes["r"].hist > plan.r_cap).any(axis=1)
                | (passes["s"].hist > plan.s_cap).any(axis=(1, 2)))  # [hp]

    def good_weight(self, bad):
        return ~bad[:, None]                                      # [hp, u]

    def residual(self, rels, passes, bad, plan):
        hp = plan.h_parts
        r_cell = cell_of(passes["r"], plan.u, hp)
        s_cell = cell_of(passes["s"], plan.g_parts * plan.u, hp)
        return {**rels,
                "r": _mask_by_cells(rels["r"], bad, r_cell),
                "s": _mask_by_cells(rels["s"], bad, s_cell)}

    def tuples_read(self, rels, plan):
        return (int(rels["r"].n) + int(rels["s"].n)
                + plan.h_parts * int(rels["t"].n))


class CyclicOps:
    """R(AB) ⋈ S(BC) ⋈ T(CA) triangles: coarse cells are the H(A)×G(B)
    grid; R drives.  An S column / T row overflow taints every cell that
    reads it."""

    kind = "cyclic"
    driving = "r"

    def __init__(self, ra="a", rb="b", sb="b", sc="c", tc="c", ta="a",
                 pair_index=True):
        self.ra, self.rb, self.sb = ra, rb, sb
        self.sc, self.tc, self.ta = sc, tc, ta
        self.pair_index = pair_index

    def specs(self, plan):
        hp, gp, uh, ug, fp = (plan.h_parts, plan.g_parts, plan.uh, plan.ug,
                              plan.f_parts)
        return {
            "r": ([(self.ra, hp, "H"), (self.rb, gp, "G"),
                   (self.ra, uh, "h"), (self.rb, ug, "g")], (hp, gp, uh, ug)),
            "s": ([(self.sb, gp, "G"), (self.sc, fp, "f"),
                   (self.sb, ug, "g")], (gp, fp, ug)),
            "t": ([(self.ta, hp, "H"), (self.tc, fp, "f"),
                   (self.ta, uh, "h")], (hp, fp, uh)),
        }

    def size_caps(self, plan, passes, final):
        if final:
            plan = plan._replace(r_cap=exact_cap(passes["r"].hist),
                                 s_cap=exact_cap(passes["s"].hist),
                                 t_cap=exact_cap(passes["t"].hist))
        return plan

    def count(self, L, plan):
        return kops.fused_count3_cyclic(
            L["r"].columns[self.ra], L["r"].columns[self.rb], L["r"].valid,
            L["s"].columns[self.sb], L["s"].columns[self.sc], L["s"].valid,
            L["t"].columns[self.tc], L["t"].columns[self.ta], L["t"].valid,
            pair_index=self.pair_index)               # [hp, gp, uh, ug]

    def bad_cells(self, passes, plan):
        r_bad = (passes["r"].hist > plan.r_cap).any(axis=(2, 3))  # [hp, gp]
        s_bad = (passes["s"].hist > plan.s_cap).any(axis=(1, 2))  # [gp]
        t_bad = (passes["t"].hist > plan.t_cap).any(axis=(1, 2))  # [hp]
        return r_bad | s_bad[None, :] | t_bad[:, None]

    def good_weight(self, bad):
        return ~bad[:, :, None, None]

    def residual(self, rels, passes, bad, plan):
        n_cells = plan.h_parts * plan.g_parts
        r_cell = cell_of(passes["r"], plan.uh * plan.ug, n_cells)
        return {**rels, "r": _mask_by_cells(rels["r"], bad, r_cell)}

    def tuples_read(self, rels, plan):
        return (int(rels["r"].n) + plan.h_parts * int(rels["s"].n)
                + plan.g_parts * int(rels["t"].n))


class StarOps:
    """Dimension R(aB), fact S(BC), dimension T(Cd): coarse cells are the
    uh×ug PMU grid; the fact relation S drives (each output tuple owns
    exactly one fact row)."""

    kind = "star"
    driving = "s"

    def __init__(self, rb="b", sb="b", sc="c", tc="c"):
        self.rb, self.sb, self.sc, self.tc = rb, sb, sc, tc

    def specs(self, plan):
        return {
            "r": ([(self.rb, plan.uh, "h")], (plan.uh,)),
            "t": ([(self.tc, plan.ug, "g")], (plan.ug,)),
        }

    def s_pass(self, rel, plan, salt):
        """S adds an arrival-order chunk level on top of the hashed
        (h(B), g(C)) pair — composed arithmetically, still ONE hash pass."""
        uh, ug, ch = plan.uh, plan.ug, plan.chunks
        ids2, nb2 = partition.composite_ids(
            rel, [(self.sb, uh, "h"), (self.sc, ug, "g")], salt)
        pos = torch.arange(rel.capacity, dtype=torch.int64, device=rel.device)
        chunk = torch.where(rel.valid, (pos * ch) // rel.capacity,
                            torch.zeros_like(pos))
        nb = ch * nb2
        ids = torch.where(rel.valid,
                          chunk * nb2 + torch.clamp(ids2, 0, nb2 - 1),
                          torch.full_like(chunk, nb)).to(torch.int32)
        return RelPass(ids, nb, _host_hist(ids, nb).reshape(ch, uh, ug),
                       (ch, uh, ug))

    def size_caps(self, plan, passes, final):
        if final:
            plan = plan._replace(r_cap=exact_cap(passes["r"].hist),
                                 s_cap=exact_cap(passes["s"].hist),
                                 t_cap=exact_cap(passes["t"].hist))
        return plan

    def count(self, L, plan):
        return kops.fused_count3_star(
            L["r"].columns[self.rb], L["r"].valid, L["s"].columns[self.sb],
            L["s"].columns[self.sc], L["s"].valid, L["t"].columns[self.tc],
            L["t"].valid)                                         # [uh, ug]

    def bad_cells(self, passes, plan):
        r_bad = passes["r"].hist > plan.r_cap                     # [uh]
        t_bad = passes["t"].hist > plan.t_cap                     # [ug]
        s_bad = (passes["s"].hist > plan.s_cap).any(axis=0)       # [uh, ug]
        return r_bad[:, None] | t_bad[None, :] | s_bad

    def good_weight(self, bad):
        return ~bad

    def residual(self, rels, passes, bad, plan):
        uh, ug = plan.uh, plan.ug
        s_cell = torch.clamp(passes["s"].ids.to(torch.int64) % (uh * ug),
                             0, uh * ug - 1)
        return {**rels, "s": _mask_by_cells(rels["s"], bad, s_cell)}

    def tuples_read(self, rels, plan):
        return int(rels["r"].n) + int(rels["s"].n) + int(rels["t"].n)


OPS = {"linear": LinearOps, "cyclic": CyclicOps, "star": StarOps}


def ops_from_binding(binding, **kw):
    """Build the KindOps adapter from a ``query.Binding`` — the checked
    column binding replaces the per-kind kwarg soup, so the recovery layer
    and the fused layouts are guaranteed to agree on column roles."""
    return OPS[binding.kind](**binding.col_kwargs(), **kw)


# ==========================================================================
# the round loop
# ==========================================================================

def _round_pass(ops, rels, plan, salt, final):
    """One round's single-hash passes, capacity sizing and layouts."""
    passes = {}
    for key, (specs, out_shape) in ops.specs(plan).items():
        passes[key] = hash_pass(rels[key], specs, out_shape, salt)
    if hasattr(ops, "s_pass"):
        passes["s"] = ops.s_pass(rels["s"], plan, salt)
    plan = ops.size_caps(plan, passes, final)
    caps = {"r": plan.r_cap, "s": plan.s_cap, "t": plan.t_cap}
    layouts = {k: layout(rels[k], passes[k], caps[k]) for k in passes}
    return plan, passes, layouts


def _weighted_sum(counts: torch.Tensor, weight: np.ndarray | None) -> int:
    c = counts.to(torch.int64)
    if weight is not None:
        c = c * torch.as_tensor(np.broadcast_to(weight, c.shape).copy(),
                                device=c.device)
    return int(c.sum())


def run_count_rounds(ops, r: Relation, s: Relation, t: Relation, plan, *,
                     max_rounds: int = 3, growth: float = 2.0,
                     base_salt: int = 0) -> EngineResult:
    """The shared recovery loop: fused sweep, keep exact partials, re-run
    overflowed cells, exact-sized final round (see module docstring)."""
    rels = {"r": r, "s": s, "t": t}
    total, tuples = 0, 0
    for rnd in range(max_rounds + 1):
        final = rnd == max_rounds
        plan, passes, layouts = _round_pass(ops, rels, plan,
                                            base_salt + rnd, final)
        counts = ops.count(layouts, plan)
        bad = ops.bad_cells(passes, plan)
        tuples += ops.tuples_read(rels, plan)
        if final or not bad.any():
            total += _weighted_sum(counts, None)
            return EngineResult(np.int64(total), False, np.int64(tuples),
                                rnd + 1)
        total += _weighted_sum(counts, ops.good_weight(bad))
        rels = ops.residual(rels, passes, bad, plan)
        plan = grown(plan, growth)
    raise AssertionError("unreachable: final round is exact-sized")


def run_per_r_rounds(ops: LinearOps, r: Relation, s: Relation, t: Relation,
                     plan, *, max_rounds: int = 3, growth: float = 2.0,
                     base_salt: int = 0, key_col: str = "a") -> PerRResult:
    """Linear-only per-R-tuple aggregate under the same round contract.
    Emits (keys, counts, valid) aligned with each round's R layout; kept
    slots are those of exact cells (plus everything in the final round)."""
    rels = {"r": r, "s": s, "t": t}
    keys_out, counts_out, valid_out = [], [], []
    rounds, tuples = 0, 0
    for rnd in range(max_rounds + 1):
        final = rnd == max_rounds
        plan, passes, layouts = _round_pass(ops, rels, plan,
                                            base_salt + rnd, final)
        tuples += ops.tuples_read(rels, plan)
        rg = layouts["r"]
        counts = kops.fused_per_r_counts(
            rg.columns[ops.rb], rg.valid, layouts["s"].columns[ops.sb],
            layouts["s"].columns[ops.sc], layouts["s"].valid,
            layouts["t"].columns[ops.tc], layouts["t"].valid)  # [hp, u, Cr]
        bad = ops.bad_cells(passes, plan)
        key = key_col if key_col in rg.columns else ops.rb
        valid = rg.valid
        if bad.any() and not final:
            keep = torch.as_tensor(~bad, device=valid.device)
            valid = valid & keep[:, None, None]
        keys_out.append(rg.columns[key].reshape(-1))
        counts_out.append(counts.reshape(-1).to(torch.int64))
        valid_out.append(valid.reshape(-1))
        rounds = rnd + 1
        if final or not bad.any():
            break
        rels = ops.residual(rels, passes, bad, plan)
        plan = grown(plan, growth)
    keys = torch.cat(keys_out)
    counts = torch.cat(counts_out)
    valid = torch.cat(valid_out)
    total = int(counts[valid].sum())
    return PerRResult(count=np.int64(total), overflowed=False,
                      tuples_read=np.int64(tuples), rounds=rounds,
                      keys=keys, counts=counts, valid=valid)
