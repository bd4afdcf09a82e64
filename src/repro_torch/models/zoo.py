"""Model zoo: one uniform interface over the model families.

  model = zoo.build(cfg)
  params = model.init(torch.Generator(device="cuda").manual_seed(0))
  logits, aux = model.forward(params, tokens, memory=...)
  cache = model.init_cache(batch, max_len, device=...)
  logits, cache = model.prefill(params, tokens, cache, memory=...)
  logits, cache = model.decode_step(params, cache, tokens)

``memory`` is the stubbed modality frontend's output ([B, T_frontend,
d_model]) for the vlm, encdec and audio families (``needs_memory``); None
elsewhere.  The dense, MoE and VLM families are ``models.transformer``,
the SSM and hybrid ones ``models.hybrid``, the enc-dec and audio ones
``models.encdec``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    config: ModelConfig
    init: Callable             # (generator) -> params (an nn.Module)
    forward: Callable          # (params, tokens, memory=None)
    init_cache: Callable       # (batch, max_len, dtype=..., device=...)
    prefill: Callable          # (params, tokens, cache, memory=None)
    decode_step: Callable      # (params, cache, tokens) -> (logits, cache)
    needs_memory: bool = False


def build(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return Model(
            config=cfg,
            init=lambda gen: transformer.init_lm(gen, cfg),
            forward=lambda p, t, memory=None: transformer.forward(
                p, cfg, t, memory=memory),
            init_cache=lambda b, ml, dtype=torch.bfloat16, device=None:
                transformer.init_cache(cfg, b, ml, dtype, device),
            prefill=lambda p, t, c, memory=None: transformer.prefill(
                p, cfg, t, c, memory=memory),
            decode_step=lambda p, c, t: transformer.decode_step(p, cfg, c, t),
            needs_memory=transformer.takes_memory(cfg))
    if cfg.family in ("ssm", "hybrid"):
        return Model(
            config=cfg,
            init=lambda gen: hybrid.init_lm(gen, cfg),
            forward=lambda p, t, memory=None: hybrid.forward(p, cfg, t),
            init_cache=lambda b, ml, dtype=torch.bfloat16, device=None:
                hybrid.init_cache(cfg, b, ml, dtype, device),
            prefill=lambda p, t, c, memory=None: hybrid.prefill(p, cfg, t, c),
            decode_step=lambda p, c, t: hybrid.decode_step(p, cfg, c, t))
    if cfg.family in ("encdec", "audio"):
        return Model(
            config=cfg,
            init=lambda gen: encdec.init_encdec(gen, cfg),
            forward=lambda p, t, memory=None: encdec.forward(
                p, cfg, t, memory=memory),
            init_cache=lambda b, ml, dtype=torch.bfloat16, device=None:
                encdec.init_cache(cfg, b, ml, dtype, device),
            prefill=lambda p, t, c, memory=None: encdec.prefill(
                p, cfg, t, c, memory=memory),
            decode_step=lambda p, c, t: encdec.decode_step(p, cfg, c, t),
            needs_memory=True)
    raise ValueError(f"unknown family {cfg.family!r}")
