"""LM substrate: the model families of the assigned architectures (the
dense, MoE and VLM families in this port so far)."""

from repro_torch.models import zoo  # noqa: F401
from repro_torch.models.config import ModelConfig  # noqa: F401
