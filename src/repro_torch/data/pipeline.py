"""Join-enriched data pipeline: the paper's hash-join engine as a
framework feature.

Training examples carry a document id; a metadata relation maps doc_id ->
quality tier.  The enrichment stage hash-joins the example stream against
the metadata (build once, probe per batch) and emits per-example weights
for the loss or the sampler, with the same
``core.binary_join.probe_weight_sum`` primitive the joins use.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import binary_join
from repro_torch.core.relation import Relation


@dataclasses.dataclass
class JoinEnrichedPipeline:
    """Attaches join-derived example weights to token batches.

    metadata: Relation with columns (doc, tier); examples with no metadata
    row get weight ``tier_weights[default_tier]``.
    """

    metadata: Relation
    tier_weights: tuple = (0.25, 0.5, 1.0, 2.0)
    default_tier: int = 1

    def weights_for(self, doc_ids) -> torch.Tensor:
        """Probe the metadata for each example's doc id: the weight of the
        mean tier over its matching rows (truncated), the default tier's
        when it has none.  f32 on the metadata's device."""
        dev = self.metadata.valid.device
        doc_ids = torch.as_tensor(doc_ids, dtype=torch.int32, device=dev)
        valid = torch.ones(doc_ids.shape, dtype=torch.bool, device=dev)
        top = len(self.tier_weights) - 1
        tiers = torch.clamp(self.metadata.col("tier"), 0, top)
        tw = torch.tensor(self.tier_weights, dtype=torch.float32, device=dev)
        wsum = binary_join.probe_weight_sum(self.metadata, "doc", tiers,
                                            doc_ids, valid)
        cnt = binary_join.probe_weight_sum(
            self.metadata, "doc",
            torch.ones((self.metadata.capacity,), dtype=torch.int32,
                       device=dev), doc_ids, valid)
        mean_tier = torch.where(
            cnt > 0, wsum / torch.clamp(cnt, min=1),
            torch.full(cnt.shape, float(self.default_tier), device=dev))
        return tw[torch.clamp(mean_tier.to(torch.int32), 0, top).long()]

    def enrich(self, batch: dict, doc_ids) -> dict:
        out = dict(batch)
        out["example_weight"] = self.weights_for(doc_ids)
        return out
