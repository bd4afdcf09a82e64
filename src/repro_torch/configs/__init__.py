"""Assigned-architecture configs (full + reduced smoke variants) + shapes.

Every architecture is selectable by id:  ``configs.get("yi-34b")``.
``configs.smoke(id)`` returns the reduced same-family config used by the
CPU tests.  Data only, copied from the JAX package so that the port
imports none of it; every config can be built (``models.zoo.build``),
at full width on the card.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "yi-34b", "gemma3-1b", "qwen2-1.5b", "qwen2.5-14b",
    "seamless-m4t-medium", "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b",
    "llama-3.2-vision-11b", "zamba2-1.2b", "mamba2-370m",
)

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return _module(arch_id).CONFIG


def smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (skips noted in DESIGN.md)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True
