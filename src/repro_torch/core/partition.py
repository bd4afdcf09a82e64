"""Radix hash partitioning (the paper's Fig 2 / Fig 3 data reorganization).

``bucketize`` / ``bucketize_by_ids`` scatter a relation into a
fixed-capacity ``[n_buckets, capacity]`` grid with per-bucket counts and an
overflow indicator.  Bucket i is the contents of PMU i (one tile of the
fused kernels).  Overflow (a bucket exceeding its capacity) is the skew
signal; callers either size capacity with slack (uniform assumption, §1.2)
or re-partition with a salt.

The layouts are bit-exact with the JAX package's: rows are ranked within
their bucket by a STABLE sort on the flat bucket id, so the same rows land
in the same slots.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import hashing
from repro_torch.core.relation import SENTINEL, Relation

_INT32_MAX = 2**31 - 1


def _check_flat_range(n_slots: int, what: str) -> None:
    """Flat bucket/slot ids are int32 throughout; a silent wrap would scatter
    rows into the wrong buckets.  Fail loudly instead."""
    if n_slots > _INT32_MAX:
        raise ValueError(
            f"{what} = {n_slots} exceeds the int32 id range ({_INT32_MAX}); "
            "use fewer/coarser bucket levels or smaller capacities")


class Buckets(NamedTuple):
    columns: dict              # name -> (*out_shape, capacity) int32, sentinel-padded
    valid: torch.Tensor        # (*out_shape, capacity) bool
    counts: torch.Tensor       # out_shape int32 true per-bucket count (pre-clip)
    overflowed: torch.Tensor   # () bool — any bucket exceeded capacity


def bucket_ids_for(rel: Relation, key_col: str, n_buckets: int, fn: str,
                   salt: int = 0) -> torch.Tensor:
    """Bucket id per row; invalid rows get id == n_buckets (sorts last)."""
    ids = hashing.hash_bucket(rel.col(key_col), n_buckets, fn, salt)
    return torch.where(rel.valid, ids, torch.full_like(ids, n_buckets))


def bucketize(rel: Relation, key_col: str, n_buckets: int, capacity: int,
              fn: str = "h", salt: int = 0,
              sentinel: int = SENTINEL) -> Buckets:
    """Scatter rows into a fixed [n_buckets, capacity] grid by one hash
    level.  Rows beyond a bucket's capacity are dropped and flagged via
    ``overflowed``."""
    ids = bucket_ids_for(rel, key_col, n_buckets, fn, salt)
    return bucketize_by_ids(rel, ids, n_buckets, capacity, (n_buckets,),
                            sentinel=sentinel)


def bucketize_by_ids(rel: Relation, flat_ids: torch.Tensor, n_buckets: int,
                     capacity: int, out_shape: tuple,
                     sentinel: int = SENTINEL) -> Buckets:
    """Scatter rows into `[*out_shape, capacity]` by precomputed flat bucket
    ids (invalid rows must carry id == n_buckets).  Generic engine behind the
    composite two/three-level layouts of Fig 2/3: a stable sort ranks each
    row within its bucket, ``searchsorted`` finds the bucket starts, and one
    scatter per column writes the grid — with a trailing drop slot that
    absorbs invalid and over-capacity rows."""
    _check_flat_range(n_buckets * capacity + 1, "n_buckets * capacity")
    dev = flat_ids.device
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    bounds = torch.arange(n_buckets + 1, dtype=sorted_ids.dtype, device=dev)
    starts = torch.searchsorted(sorted_ids, bounds, side="left")
    within = (torch.arange(sorted_ids.shape[0], device=dev)
              - starts[torch.clamp(sorted_ids, 0, n_buckets).to(torch.int64)])
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    overflowed = torch.any(counts > capacity)
    keep = (sorted_ids < n_buckets) & (within < capacity)
    dest = torch.where(keep, sorted_ids.to(torch.int64) * capacity + within,
                       torch.full_like(within, n_buckets * capacity))
    size = n_buckets * capacity + 1
    fill = torch.tensor(sentinel, dtype=torch.int32, device=dev)
    cols = {}
    for name, col in rel.columns.items():
        flat = torch.full((size,), sentinel, dtype=torch.int32, device=dev)
        flat[dest] = torch.where(rel.valid, col, fill)[order]
        cols[name] = flat[:-1].reshape(*out_shape, capacity)
    vflat = torch.zeros((size,), dtype=torch.bool, device=dev)
    vflat[dest] = rel.valid[order]
    valid = vflat[:-1].reshape(*out_shape, capacity)
    return Buckets(cols, valid, counts.reshape(out_shape), overflowed)


def composite_ids(rel: Relation, specs: list[tuple[str, int, str]],
                  salt: int = 0) -> tuple[torch.Tensor, int]:
    """Flat composite bucket id from [(column, n_buckets, hash_fn), ...],
    most-significant first.  Invalid rows get id == prod(n_buckets).
    ``salt`` re-randomizes every level (skew-recovery re-partitioning).

    Raises ``ValueError`` when ``prod(n_buckets)`` exceeds the int32 id
    range, as the reference does: its ids are int32.
    """
    total = 1
    for _col, nb, _fn in specs:
        total *= nb
    _check_flat_range(total, f"prod(n_buckets) for specs {specs!r}")
    flat = torch.zeros((rel.capacity,), dtype=torch.int32, device=rel.device)
    for col, nb, fn in specs:
        ids = bucket_ids_for(rel, col, nb, fn, salt)
        flat = flat * nb + torch.clamp(ids, 0, nb - 1)
    return torch.where(rel.valid, flat, torch.full_like(flat, total)), total


def suggest_capacity(n_rows: int, n_buckets: int, slack: float = 2.0,
                     align: int = 8) -> int:
    """Uniform-hash bucket capacity with slack, aligned to 8 slots."""
    mean = max(1, math.ceil(n_rows / n_buckets))
    # Poisson tail headroom: mean + slack * sqrt(mean) at minimum.
    cap = max(int(mean * slack), mean + int(slack * math.sqrt(mean)) + 1)
    return int(math.ceil(cap / align) * align)


def sort_by_key(rel: Relation, key_col: str,
                big: int = 0x7FFFFFFF) -> tuple[Relation, torch.Tensor]:
    """Sort rows by the *actual* key (invalid rows last).  Returns the sorted
    relation and the sorted key array (invalid = big sentinel) for
    searchsorted probes — the exact-join building block."""
    keys = torch.where(rel.valid, rel.col(key_col),
                       torch.full_like(rel.col(key_col), big))
    skeys, order = torch.sort(keys, stable=True)
    return rel.select(order, torch.ones_like(order, dtype=torch.bool)), skeys
