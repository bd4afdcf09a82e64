"""train_step / serve_step builders: the functions the launchers call.

Batch format: ``{"inputs": [B, S] int, "targets": [B, S] int, optional
"memory": [B, T_frontend, d_model]}`` tensors on the model's device (the
memory is the VLM's or the enc-dec's stubbed modality frontend).

The train step is the JAX package's: the mean token NLL plus a z-loss
(plus ``moe_aux_weight`` times the MoE's load-balance loss), microbatch
gradient accumulation in f32, then AdamW.  The port's
parameters are f32 ``nn.Parameter``s, so each microbatch's ``backward()``
accumulates its gradient into ``.grad`` in f32 (the JAX scan's f32 sum, in
the same order); the sum is divided by the number of microbatches.  The
step updates the state in place and returns it with the loss, the learning
rate, the gradient norm and the model's aux values (the MoE's ``aux_loss``
and ``dropped``, the mean over the microbatches) as device tensors:
nothing waits on the device within a step.  The serve steps run under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Any            # the model's parameters (an nn.Module)
    opt: dict              # {"m": [f32], "v": [f32], "step": int32}
    step: torch.Tensor     # int32 scalar


def init_train_state(model: Model, gen: torch.Generator) -> TrainState:
    params = model.init(gen)
    opt = adamw_init(params.parameters())
    return TrainState(params, opt, torch.zeros((), dtype=torch.int32,
                                               device=gen.device))


def cross_entropy_loss(logits, targets, z_loss: float = 1e-4):
    """Mean token NLL (+ z-loss for logit drift control).  logits f32."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    moe_aux_weight: float = 1e-2,
                    accum_steps: int | None = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps`` (default: the config's ``accum_steps``) splits the
    batch into that many microbatches of consecutive rows, each run
    forward and backward in turn: live activation memory drops by that
    factor.  Metrics: ``loss`` (the microbatches' mean, the aux term
    included), ``lr``, ``grad_norm`` (before clipping), and each aux value
    of the forward (the microbatches' mean)."""
    accum = (accum_steps if accum_steps is not None
             else getattr(model.config, "accum_steps", 1) or 1)

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch["inputs"],
                                    memory=batch.get("memory"))
        loss = cross_entropy_loss(logits, batch["targets"])
        if aux and "aux_loss" in aux:
            loss = loss + moe_aux_weight * aux["aux_loss"]
        return loss, aux

    def train_step(state: TrainState, batch):
        params = list(state.params.parameters())
        b = batch["inputs"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"accum_steps {accum}")
        mb = b // accum
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        auxes = []
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            loss, aux = loss_fn(state.params,
                                {k: v[rows] for k, v in batch.items()})
            loss.backward()
            loss_sum += loss.detach()
            auxes.append({k: v.detach() for k, v in aux.items()})
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        if accum > 1:
            torch._foreach_div_(grads, accum)
        _, opt, om = adamw_update(params, grads, state.opt, opt_cfg)
        del grads
        metrics = {"loss": loss_sum / accum, **om}
        for k in auxes[0]:
            metrics[k] = torch.stack([a[k] for a in auxes]).mean(dim=0)
        return TrainState(state.params, opt, state.step + 1), metrics

    return train_step


def make_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, tokens, cache, memory=None):
        return model.prefill(params, tokens, cache, memory=memory)
    return prefill_step


def make_decode_step(model: Model):
    """serve_step: one greedy token for every sequence in the batch."""

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return decode_step
