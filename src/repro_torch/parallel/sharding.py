"""Divisibility-aware logical-axis sharding (MaxText-style rules).

Tensors are annotated with *logical* axis names (``("batch", "seq",
"embed")``); the rules map logical names to mesh axes, and a rule is
dropped per tensor when the dimension is not divisible by the mesh-axis
size (e.g. yi-34b's 56 query heads on a 16-way "model" axis).  These are
the JAX package's rules and its fallback, entry for entry.

A context's mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or an
``AbstractMesh`` (axis names and sizes only: no devices, no process
group), so the rules can be evaluated for a 256- or 512-rank mesh on a
single host.  ``spec_for`` gives a PartitionSpec's entries as a tuple
(``None``, an axis name, or a tuple of names sharding one dimension
together); ``placements_for`` turns such a spec into DTensor placements,
one per mesh dim; ``sharding_for`` gives ``(mesh, placements)``.

The mesh context is process-global and set by the launcher (or a test).
Model code runs on plain tensors: under a mesh each rank holds its own
rows of the batch axes, and where the "model" axis has more than one
rank it computes its share of what these rules split over "model" (q
and k/v heads, the GLU hidden, the vocabulary), as the JAX package's
GSPMD does, with the collectives ``parallel.tensor_parallel`` inserts;
the rest is computed replicated.  ``shard`` is therefore the identity
on a plain tensor and redistributes a DTensor.
``replicated_batch`` marks the stretch where every rank holds the whole
batch instead, because it does not divide the batch axes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

# logical axis -> mesh axes (tried in order; tuple entries shard together)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                 # sequence kept unsharded by default
    "seq_res": (),             # residual-stream seq dim; launcher remaps to
                               # ("model",) for Megatron-style seq parallelism
    "seq_sp": ("model",),      # sequence-parallel variant (long-context)
    "embed": (),               # activation d_model unsharded
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "kv_seq": ("model",),      # sequence-sharded KV cache (decode SP)
    # parameters (2-D sharded: TP on one dim, FSDP on the other)
    "p_embed": ("data",),      # FSDP axis for weights' d_model dim
    "p_vocab": ("model",),
    "p_mlp": ("model",),
    "p_heads": ("model",),
    "p_experts": ("model",),
    "p_state": (),
}

BATCH_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without devices: ``shape`` and ``mesh_dim_names`` as
    a ``DeviceMesh`` gives them."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh-dim order, of a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object               # DeviceMesh or AbstractMesh
    rules: Mapping[str, tuple[str, ...]]

    @property
    def shape(self) -> dict[str, int]:
        return axis_sizes(self.mesh)

    def axis_size(self, names: tuple[str, ...]) -> int:
        n = 1
        for a in names:
            n *= self.shape[a]
        return n


_CTX: list[MeshContext | None] = [None]
_MANUAL: list[bool] = [False]
_REPLICATED_BATCH: list[bool] = [False]


class manual_mode:
    """Context manager: inside a rank-local body the mesh axes are manual,
    so ``shard()`` is a no-op (the JAX package's shard_map bodies)."""

    def __enter__(self):
        self._old = _MANUAL[0]
        _MANUAL[0] = True

    def __exit__(self, *exc):
        _MANUAL[0] = self._old
        return False


class replicated_batch:
    """Context manager: inside, every rank holds the whole batch (it did
    not divide the batch axes, so the rule fell back to replicated);
    outside, under a mesh, a rank holds its own rows of them."""

    def __enter__(self):
        self._old = _REPLICATED_BATCH[0]
        _REPLICATED_BATCH[0] = True

    def __exit__(self, *exc):
        _REPLICATED_BATCH[0] = self._old
        return False


def batch_is_replicated() -> bool:
    return _REPLICATED_BATCH[0]


def set_context(mesh, rules: Mapping[str, tuple[str, ...]] | None = None
                ) -> None:
    _CTX[0] = None if mesh is None else MeshContext(
        mesh, dict(rules or DEFAULT_RULES))


def current_context() -> MeshContext | None:
    return _CTX[0]


def spec_for(shape: Sequence[int], logical: Sequence[str | None],
             ctx: MeshContext) -> tuple:
    """PartitionSpec entries from logical axes, dropping non-divisible
    rules (a prefix that divides is kept)."""
    assert len(shape) == len(logical), (shape, logical)
    sizes = ctx.shape
    parts = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        axes = tuple(a for a in ctx.rules.get(name, ())
                     if a in sizes and a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if not axes or size == 1 or dim % size != 0:
            # try a prefix that divides (e.g. ("pod","data") -> ("pod",))
            ok: tuple[str, ...] = ()
            acc = 1
            for a in axes:
                if dim % (acc * sizes[a]) == 0:
                    acc *= sizes[a]
                    ok = ok + (a,)
                else:
                    break
            axes = ok
        if not axes:
            parts.append(None)
        else:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on
    each mesh dim that shards tensor dim d, ``Replicate()`` elsewhere.  A
    dim sharded over several mesh dims splits over them in mesh-dim order
    (the first major), as XLA splits a PartitionSpec entry's axes; an
    entry whose axes are not in that order has no placement form and
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"dim order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def sharding_for(shape: Sequence[int], logical: Sequence[str | None],
                 ctx: MeshContext | None = None):
    """``(mesh, placements)`` of a tensor by logical axes, or None without
    a mesh context."""
    ctx = ctx or current_context()
    if ctx is None:
        return None
    return ctx.mesh, placements_for(spec_for(shape, logical, ctx), ctx.mesh)


def shard(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    """A DTensor redistributed to its logical axes' placements; a plain
    tensor as it is (a rank's rows, computed replicated).  A no-op without
    a mesh or in manual mode."""
    from torch.distributed.tensor import DTensor
    ctx = current_context()
    if ctx is None or _MANUAL[0] or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements_for(
        spec_for(x.shape, logical, ctx), mesh))
