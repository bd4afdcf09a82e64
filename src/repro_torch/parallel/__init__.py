"""Parallelism substrate: logical-axis sharding rules + mesh context."""

from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, AbstractMesh, MeshContext, current_context,
    placements_for, set_context, shard, sharding_for, spec_for)
