"""Data substrate: synthetic token streams, relation workload generators,
and the join-enriched pipeline (the paper's engine as a framework
feature)."""

from repro_torch.data.pipeline import JoinEnrichedPipeline  # noqa: F401
from repro_torch.data.relations import RelGenConfig, gen_relation  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    TokenGenConfig, batch_at, token_batches)
