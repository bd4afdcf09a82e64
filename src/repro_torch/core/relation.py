"""Fixed-capacity, validity-masked relations (struct-of-arrays) on torch.

A Relation is a dict of equal-length int32 column tensors plus a boolean
validity mask, all on one device; the capacity is fixed, the live count
``n`` is a device scalar.  All core algorithms consume and produce
Relations (or aggregates).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and on a machine without CUDA that raises
an error naming ``device="cpu"`` instead of carrying on on the CPU.

The instance is immutable: the dataclass is frozen and ``columns`` is a
read-only mapping view.  (``append`` and the append observers belong to
the streaming slice of the port and are not here yet.)
"""

from __future__ import annotations

import dataclasses
import types
from typing import Mapping

import numpy as np
import torch

# The canonical padding sentinel for invalid relation slots.  Every layer
# that fills dead slots (``sentinel_fill``, ``partition.bucketize``,
# ``partition.bucketize_by_ids``) uses THIS constant; the per-side probe
# sentinels in ``kernels.ops`` are derived from it (SENTINEL + 15 + side)
# so no sentinel of any kind can ever equal a live key (keys are ≥ -2^30
# by the data-layer contract) or a sentinel from another side.
SENTINEL = -0x7FFFFFFF


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
