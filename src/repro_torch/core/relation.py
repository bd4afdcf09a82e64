"""Fixed-capacity, validity-masked relations (struct-of-arrays) on torch.

A Relation is a dict of equal-length int32 column tensors plus a boolean
validity mask, all on one device; the capacity is fixed, the live count
``n`` is a device scalar.  All core algorithms consume and produce
Relations (or aggregates).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and on a machine without CUDA that raises
an error naming ``device="cpu"`` instead of carrying on on the CPU.

Ingest is explicit: :meth:`Relation.append` is the ONE mutation point.  It
compacts live rows, grows capacity along log-bucketed (power-of-two) steps,
updates any cached FM sketches incrementally (sketch insertion is a monotone
bitwise OR, so the incremental update equals a rebuild), bumps a version
counter that cache-like layers key resident state on, and notifies
registered append observers (``on_append``) with the delta — that
notification is what drives :class:`~repro_torch.core.streaming.
StandingQuery` delta execution.  Outside ``append`` the instance is
immutable: the dataclass is frozen and ``columns`` is a read-only mapping
view.  Torch tensors are mutable and derived relations (``select``,
``with_columns``, ``mask_where``) share column tensors, so ``append`` builds
new tensors and rebinds them; it never writes into the old ones.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Mapping

import numpy as np
import torch

# The canonical padding sentinel for invalid relation slots.  Every layer
# that fills dead slots (``sentinel_fill``, ``partition.bucketize``,
# ``partition.bucketize_by_ids``) uses THIS constant; the per-side probe
# sentinels in ``kernels.ops`` are derived from it (SENTINEL + 15 + side)
# so no sentinel of any kind can ever equal a live key (keys are ≥ -2^30
# by the data-layer contract) or a sentinel from another side.
SENTINEL = -0x7FFFFFFF


def _log_bucket_capacity(need: int) -> int:
    """Next power-of-two capacity ≥ need (min 64) — the same log-bucketing
    rule as ``binary_join.bucket_capacity``, inlined to keep this module at
    the bottom of the import graph."""
    return max(64, 1 << max(0, int(need) - 1).bit_length())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    There is no silent CPU fallback: without CUDA, ``device=None`` raises
    and the message says how to ask for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the card "
                "by default — pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_int32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    # np.array copies: the source may be a read-only view
    return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)


@dataclasses.dataclass(frozen=True)
class Relation:
    """Columnar relation with static capacity and a validity mask."""

    columns: Mapping[str, torch.Tensor]  # each (capacity,) int32
    valid: torch.Tensor                  # (capacity,) bool

    def __post_init__(self):
        if not isinstance(self.columns, types.MappingProxyType):
            object.__setattr__(self, "columns",
                               types.MappingProxyType(dict(self.columns)))

    # -- introspection -------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def n(self) -> torch.Tensor:
        """Number of live tuples, as a 0-d int64 device tensor (``int()``
        syncs it)."""
        return self.valid.sum()

    @property
    def version(self) -> int:
        """Ingest version: bumped by every ``append``.  Cache-like layers
        (the standing-query resident intermediates, service snapshots) key
        the validity of derived state on this counter."""
        return self.__dict__.get("_version", 0)

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    # -- distinct-count sketches ---------------------------------------------
    def distinct_sketch(self, col: str) -> torch.Tensor:
        """The column's FM/PCSA register bitmaps (``core.sketches``),
        built on first use and cached on the instance; derived relations
        (``select``/``mask_where``) start with an empty cache."""
        cache = self.__dict__.get("_sketch_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_sketch_cache", cache)
        sk = cache.get(col)
        if sk is None:
            from repro_torch.core import sketches
            sk = sketches.add(sketches.empty(device=self.device),
                              self.columns[col], self.valid)
            cache[col] = sk
        return sk

    def distinct_estimate(self, col: str) -> int:
        """FM-sketch distinct-count estimate of a column (>= 1), clipped
        to the column's capacity — the planner's scan-free replacement for
        a host ``np.unique`` pass."""
        from repro_torch.core import sketches
        est = int(round(float(sketches.fm_estimate(
            self.distinct_sketch(col)))))
        return max(1, min(est, self.capacity))

    # -- ingest --------------------------------------------------------------
    def on_append(self, callback: Callable) -> None:
        """Register ``callback(relation, delta)`` to run after every
        ``append`` (the standing-query ingest hook)."""
        self.__dict__.setdefault("_observers", []).append(callback)

    def remove_on_append(self, callback: Callable) -> None:
        obs = self.__dict__.get("_observers")
        if obs and callback in obs:
            obs.remove(callback)

    def append(self, cols: Mapping | None = None,
               **col_arrays) -> "Relation":
        """THE ingest mutation point: append a batch of rows.

        ``cols`` (or keyword arrays) must cover exactly this relation's
        schema with equal-length arrays.  Live rows are compacted to a
        prefix (stable: live order kept), capacity grows along
        power-of-two buckets, cached FM sketches update incrementally, the
        :attr:`version` counter bumps, and ``on_append`` observers fire
        with the delta.  The columns and ``valid`` are new tensors; the
        old ones, which derived relations may share, are left as they
        were.  Returns the delta as a fresh Relation on this relation's
        device."""
        arrs = dict(cols or {})
        arrs.update(col_arrays)
        if set(arrs) != set(self.columns):
            raise ValueError(
                f"append schema mismatch: got {sorted(arrs)}, relation has "
                f"{sorted(self.columns)}")
        dev = self.device
        arrs = {k: as_int32(v, dev) for k, v in arrs.items()}
        lens = {a.shape[0] for a in arrs.values()}
        if len(lens) != 1:
            raise ValueError(f"ragged delta columns: "
                             f"{ {k: tuple(v.shape) for k, v in arrs.items()} }")
        (k,) = lens
        delta = Relation.from_arrays(device=dev, **arrs)
        if k == 0:
            return delta
        n0 = int(self.n)
        need = n0 + k
        cap = self.capacity
        new_cap = cap if need <= cap else _log_bucket_capacity(need)
        # compact live rows to a prefix, then write the delta at [n0, need)
        _, order = torch.sort((~self.valid).to(torch.int32), stable=True)
        new_cols = {}
        for name, col in self.columns.items():
            base = torch.zeros(new_cap, dtype=torch.int32, device=dev)
            base[:cap] = col[order]
            base[n0:need] = arrs[name]
            new_cols[name] = base
        valid = torch.arange(new_cap, device=dev) < need
        object.__setattr__(self, "columns", types.MappingProxyType(new_cols))
        object.__setattr__(self, "valid", valid)
        object.__setattr__(self, "_version", self.version + 1)
        cache = self.__dict__.get("_sketch_cache")
        if cache:
            from repro_torch.core import sketches
            ones = torch.ones((k,), dtype=torch.bool, device=dev)
            for name, sk in list(cache.items()):
                cache[name] = sketches.add(sk, arrs[name], ones)
        for cb in tuple(self.__dict__.get("_observers", ())):
            cb(self, delta)
        return delta

    # -- construction --------------------------------------------------------
    @classmethod
    def from_arrays(cls, capacity: int | None = None, *, device=None,
                    **cols) -> "Relation":
        """Build from equal-length arrays, optionally padding to `capacity`.
        ``device=None`` puts the relation on the card."""
        dev = resolve_device(device)
        arrs = {k: as_int32(v, dev) for k, v in cols.items()}
        lens = {a.shape[0] for a in arrs.values()}
        if len(lens) != 1:
            raise ValueError(
                f"ragged columns: {dict((k, v.shape) for k, v in arrs.items())}")
        (n,) = lens
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        pad = cap - n
        if pad:
            arrs = {k: torch.nn.functional.pad(a, (0, pad))
                    for k, a in arrs.items()}
        valid = torch.arange(cap, device=dev) < n
        return cls(columns=arrs, valid=valid)

    def select(self, idx: torch.Tensor, idx_valid: torch.Tensor) -> "Relation":
        """Gather rows by index (row validity AND idx_valid)."""
        cols = {k: v[idx] for k, v in self.columns.items()}
        return Relation(cols, self.valid[idx] & idx_valid)

    def with_columns(self, **cols) -> "Relation":
        new = dict(self.columns)
        new.update({k: as_int32(v, self.device) for k, v in cols.items()})
        return Relation(new, self.valid)

    def mask_where(self, keep: torch.Tensor) -> "Relation":
        return Relation(dict(self.columns), self.valid & keep)


def sentinel_fill(rel: Relation, sentinel: int = SENTINEL) -> Relation:
    """Overwrite invalid rows' columns with a sentinel that never equals a
    live key, so masked compare loops need no extra predicate."""
    fill = torch.tensor(sentinel, dtype=torch.int32, device=rel.device)
    cols = {k: torch.where(rel.valid, v, fill)
            for k, v in rel.columns.items()}
    return Relation(cols, rel.valid)
