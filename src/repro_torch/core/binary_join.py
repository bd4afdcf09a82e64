"""Binary hash joins on the sorted path: sizing, staging, materializing.

Exact joins via sort + searchsorted range probes: O((n+m) log n), fixed
shapes, no host copy of any column.  ``exact_join_count`` sizes
intermediates exactly and aggregates all-binary roots; the plan executor's
binary steps split the same primitive into ``stage_join`` (sort + ranges +
exact total, all on the device) and ``gather_staged`` (prefix-sum offsets
+ gather-materialize into a log-bucketed capacity), with the two-scalar
total as the one host sync between them.

The paper's binary baselines sit beside them: ``cascaded_binary_count``
(the first join materialized into a bounded intermediate, the second
aggregated, paper §6.3) and ``bucketed_join_count`` (both sides hashed into
a ``[n_buckets, capacity]`` PMU grid and joined bucket by bucket with the
``bucket_pair_count`` kernel).

Counts are int64 sums (the reference needed two int32 limbs because x64 is
off in JAX, and its cascade total is int32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import partition, sketches
from repro_torch.core.reference import host_join_count  # noqa: F401  (the
#   parity oracle of this module; it lives in core.reference, the one
#   module allowed np.unique, and is re-exported here as the JAX package
#   re-exports it)
from repro_torch.core.relation import SENTINEL, Relation
from repro_torch.kernels import ops as kops


def match_ranges(sorted_keys: torch.Tensor, probe_keys: torch.Tensor):
    """For each probe key, the [lo, hi) range of equal keys in sorted_keys."""
    probe_keys = probe_keys.contiguous()
    lo = torch.searchsorted(sorted_keys, probe_keys, side="left")
    hi = torch.searchsorted(sorted_keys, probe_keys, side="right")
    return lo, hi


def _probe_counts(build: Relation, build_key: str, probe: Relation,
                  probe_key: str):
    sbuild, skeys = partition.sort_by_key(build, build_key)
    lo, hi = match_ranges(skeys, probe.col(probe_key))
    cnt = torch.where(probe.valid, hi - lo, torch.zeros_like(lo))
    return sbuild, lo, cnt


def exact_join_count(build: Relation, build_key: str,
                     probe: Relation, probe_key: str) -> int:
    """Exact ``|build ⋈ probe|`` (int64): sort + searchsorted segment
    counts on the device, one scalar to the host."""
    _, _, cnt = _probe_counts(build, build_key, probe, probe_key)
    return int(cnt.sum())


def join_count(build: Relation, build_key: str,
               probe: Relation, probe_key: str) -> torch.Tensor:
    """Exact number of matching (build, probe) pairs on the sorted path,
    as the reference's 0-d int32 (the sum wraps past 2^31 as the
    reference's does; ``exact_join_count`` is the int64 form)."""
    _, _, cnt = _probe_counts(build, build_key, probe, probe_key)
    return sketches._to_int32_bits(cnt.sum() & 0xFFFFFFFF)


def probe_weight_sum(build: Relation, build_key: str,
                     build_weights: torch.Tensor, probe_keys: torch.Tensor,
                     probe_valid: torch.Tensor) -> torch.Tensor:
    """For each probe row: sum of weights over matching build rows
    (weights flow backwards through each join stage without materializing
    anything)."""
    keys = torch.where(build.valid, build.col(build_key),
                       torch.full_like(build.col(build_key), 0x7FFFFFFF))
    skeys, order = torch.sort(keys, stable=True)
    w = torch.where(build.valid, build_weights,
                    torch.zeros_like(build_weights))[order].to(torch.int64)
    cw = torch.nn.functional.pad(torch.cumsum(w, 0), (1, 0))
    lo, hi = match_ranges(skeys, probe_keys)
    out = cw[hi] - cw[lo]
    return torch.where(probe_valid, out, torch.zeros_like(out))


class MaterializeResult(NamedTuple):
    rel: Relation            # materialized join, fixed capacity, masked
    total: int               # true (unclipped) number of result tuples
    overflowed: bool         # result exceeded out_capacity


def _gather(sorted_build: Relation, lo: torch.Tensor, cnt: torch.Tensor,
            probe: Relation, out_capacity: int, build_prefix: str,
            probe_prefix: str) -> Relation:
    """Prefix-sum offsets + gather-materialize into ``out_capacity`` slots."""
    dev = cnt.device
    off = torch.nn.functional.pad(torch.cumsum(cnt, 0), (1, 0))
    total = off[-1]
    slots = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    owner = torch.searchsorted(off, slots, side="right") - 1
    owner = torch.clamp(owner, 0, probe.capacity - 1)
    rank = slots - off[owner]
    bidx = torch.clamp(lo[owner] + rank, 0, sorted_build.capacity - 1)
    ok = slots < total
    fill = torch.tensor(SENTINEL, dtype=torch.int32, device=dev)
    cols = {}
    for name, col in sorted_build.columns.items():
        cols[build_prefix + name] = torch.where(ok, col[bidx], fill)
    for name, col in probe.columns.items():
        key = probe_prefix + name
        if key in cols:  # join column appears once
            continue
        cols[key] = torch.where(ok, col[owner], fill)
    return Relation(cols, ok)


def join_materialize(build: Relation, build_key: str,
                     probe: Relation, probe_key: str,
                     out_capacity: int,
                     build_prefix: str = "",
                     probe_prefix: str = "") -> MaterializeResult:
    """Materialize the equi-join into a fixed-capacity Relation (the
    cascaded-binary intermediate I = R ⋈ S of paper §6.3; ``overflowed``
    models the spill condition)."""
    sbuild, lo, cnt = _probe_counts(build, build_key, probe, probe_key)
    total = int(cnt.sum())
    rel = _gather(sbuild, lo, cnt, probe, out_capacity, build_prefix,
                  probe_prefix)
    return MaterializeResult(rel, total, total > out_capacity)


# --------------------------------------------------------------------------
# staged binary-step pipeline (the plan executor's hot path)
# --------------------------------------------------------------------------

class StagedJoin(NamedTuple):
    """Stage 1 of a pipelined binary step, still on the device: the sorted
    build side, the per-probe match ranges, and the exact int64 total.
    ``staged_total`` syncs the scalar; ``gather_staged`` finishes the
    materialization without re-sorting."""

    sorted_build: Relation     # build side sorted by its join key
    lo: torch.Tensor           # (probe_cap,) int64 match-range starts
    cnt: torch.Tensor          # (probe_cap,) int64 per-probe match counts
    total: torch.Tensor        # () int64


def stage_join(build: Relation, probe: Relation, *, build_key: str,
               probe_key: str) -> StagedJoin:
    """Sort the build side, probe it, and total the matches — queued on the
    device stream without a host sync."""
    sbuild, lo, cnt = _probe_counts(build, build_key, probe, probe_key)
    return StagedJoin(sbuild, lo, cnt, cnt.sum())


def staged_total(staged: StagedJoin) -> int:
    """Host-sync the exact join cardinality of a staged step (one scalar —
    the pipeline's only host↔device traffic)."""
    return int(staged.total)


def bucket_capacity(total: int) -> int:
    """Materialization capacity for an exact row total: the next power of
    two (>= 64).  Log-bucketing keeps refreshed executions at a similar
    scale on the same shapes — at most 2x buffer slack."""
    return max(64, 1 << math.ceil(math.log2(int(total) + 8)))


def gather_staged(staged: StagedJoin, probe: Relation, out_capacity: int,
                  *, build_prefix: str = "",
                  probe_prefix: str = "") -> Relation:
    """Finish a staged materialize: prefix-sum offsets + gather into
    ``out_capacity`` slots (which must cover the staged total)."""
    return _gather(staged.sorted_build, staged.lo, staged.cnt, probe,
                   out_capacity, build_prefix, probe_prefix)


# --------------------------------------------------------------------------
# the binary baselines
# --------------------------------------------------------------------------

class CascadeResult(NamedTuple):
    count: torch.Tensor            # () int64 total 3-way join cardinality
    intermediate_total: int        # true (unclipped) |R ⋈ S|
    intermediate_overflowed: bool  # |R ⋈ S| exceeded the intermediate buffer


def cascaded_binary_count(r: Relation, s: Relation, t: Relation,
                          intermediate_capacity: int,
                          rb: str = "b", sb: str = "b", sc: str = "c",
                          tc: str = "c") -> CascadeResult:
    """COUNT(R(AB) ⋈ S(BC) ⋈ T(CD)) as two cascaded binary joins with a
    bounded, materialized intermediate (the paper's baseline plan)."""
    inter = join_materialize(r, rb, s, sb, intermediate_capacity,
                             build_prefix="r_", probe_prefix="s_")
    # second join: aggregate only (the final output is never materialized)
    w = probe_weight_sum(t, tc, torch.ones_like(t.col(tc)),
                         inter.rel.col("s_" + sc), inter.rel.valid)
    return CascadeResult(w.sum(), inter.total, inter.overflowed)


def cascaded_binary_per_r_counts(r: Relation, s: Relation, t: Relation,
                                 rb: str = "b", sb: str = "b", sc: str = "c",
                                 tc: str = "c") -> torch.Tensor:
    """Per-R-row 3-way join counts (int64) via weight backflow, nothing
    materialized: w_s = |{t : t.c == s.c}|, count_r = Σ_{s.b == r.b} w_s."""
    w_s = probe_weight_sum(t, tc, torch.ones_like(t.col(tc)), s.col(sc),
                           s.valid)
    return probe_weight_sum(s, sb, w_s, r.col(rb), r.valid)


def bucketed_join_count(build: Relation, build_key: str,
                        probe: Relation, probe_key: str,
                        n_buckets: int, build_cap: int, probe_cap: int):
    """Hash-partition both sides and count matches per bucket pair.

    Returns (count () int64, overflowed () bool).  Matching keys hash
    identically, so bucket-local compares lose nothing, and keys of two
    buckets never match — exact unless a bucket overflows, which is
    reported.
    """
    b = partition.bucketize(build, build_key, n_buckets, build_cap, fn="h")
    p = partition.bucketize(probe, probe_key, n_buckets, probe_cap, fn="h")
    counts = kops.bucket_pair_count(b.columns[build_key], b.valid,
                                    p.columns[probe_key], p.valid)
    return counts.to(torch.int64).sum(), b.overflowed | p.overflowed
