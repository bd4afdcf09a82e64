"""Optimizer substrate: AdamW, schedule, clipping, and error-feedback
gradient compression, as plain functions over lists of tensors."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule)
