"""The serve steps: the functions the serving launcher calls.

Only the serving half is ported; ``make_train_step``, the loss and the
optimizer come with the training slice (ROADMAP Queue A, item 1).  Both
steps run under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from repro_torch.models.zoo import Model


def make_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, tokens, cache):
        return model.prefill(params, tokens, cache)
    return prefill_step


def make_decode_step(model: Model):
    """serve_step: one greedy token for every sequence in the batch."""

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return decode_step
