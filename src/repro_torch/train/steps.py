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

Under the LM's mesh (``make_train_step(..., mesh=)``, a ``DeviceMesh``
whose batch axes are "pod" and "data") every rank is handed the global
batch and takes its rows as the JAX package's sharded microbatches give
them: microbatch j is rows [j·mb, (j+1)·mb) of the batch, and rank i of
the batch axes takes the i-th of its n equal slices.  Where mb does not
divide n, every rank takes the whole microbatch (the rule's replicated
fallback; ``sharding.replicated_batch``).  The rank's gradients are
summed over the batch axes (one ``all_reduce`` a tensor and axis) and
divided by n and the number of microbatches, so every rank applies the
global gradient; the loss is the mean over the batch axes.  With
``overlap`` each gradient's ``all_reduce`` over the first batch axis is
issued asynchronously from a post-accumulate hook during the last
microbatch's backward and awaited before the optimizer: the same
reductions, the same values.

Tensor parallelism.  Where the mesh's "model" axis has size m > 1 the
step places the state on its first call (``launch.specs.place_model``:
every parameter and moment that ``param_specs`` puts on "model" becomes
this rank's slice) and the model computes each rank's heads, GLU
columns and vocabulary rows (``parallel.tensor_parallel``).  The loss
is then ``tensor_parallel.cross_entropy`` on the vocab-sharded logits.
Gradients are reduced over the batch axes only: a split weight's
gradient is this rank's own, a replicated weight's is already equal on
every model rank.  The gradient norm sums the split tensors' squares
over "model" (``optim.clip_by_global_norm``).  The serve steps run
partitioned under a mesh context holding such an axis, on placed
parameters and a cache of the rank's KV heads, and return
vocab-sharded logits (the greedy token is the global argmax).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch import specs
from repro_torch.models.zoo import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor_parallel as tpl


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


def _batch_groups(mesh) -> tuple[list, int, int]:
    """The process groups of the mesh's batch axes in mesh order, their
    size product n and this rank's index among the n."""
    sizes = sharding.axis_sizes(mesh)
    axes = [a for a in sharding.BATCH_AXES if a in sizes]
    n, index = 1, 0
    for a in axes:
        n *= sizes[a]
        index = index * sizes[a] + mesh.get_local_rank(a)
    return [mesh.get_group(a) for a in axes], n, index


class _MeshStep:
    """The sharding context of ``mesh`` (the caller's, when it already
    holds this mesh) for the length of one step."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = sharding.current_context()
        if self.prev is None or self.prev.mesh is not self.mesh:
            sharding.set_context(self.mesh)

    def __exit__(self, *exc):
        if self.prev is None:
            sharding.set_context(None)
        else:
            sharding.set_context(self.prev.mesh, self.prev.rules)
        return False


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    moe_aux_weight: float = 1e-2,
                    accum_steps: int | None = None, *, mesh=None,
                    overlap: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps`` (default: the config's ``accum_steps``) splits the
    batch into that many microbatches of consecutive rows, each run
    forward and backward in turn: live activation memory drops by that
    factor.  Metrics: ``loss`` (the microbatches' mean, the aux term
    included), ``lr``, ``grad_norm`` (before clipping), and each aux value
    of the forward (the microbatches' mean).  ``mesh``: data-parallel
    over its batch axes, as the module docstring says; ``overlap``
    reduces the gradients during the backward."""
    accum = (accum_steps if accum_steps is not None
             else getattr(model.config, "accum_steps", 1) or 1)
    groups, n_shards, shard = (_batch_groups(mesh) if mesh is not None
                               else ([], 1, 0))

    vocab = model.config.vocab_size

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch["inputs"],
                                    memory=batch.get("memory"))
        tp = tpl.active()
        if tp is not None and tp.splits("vocab", vocab):
            loss = tpl.cross_entropy(logits, batch["targets"], vocab, tp)
        else:
            loss = cross_entropy_loss(logits, batch["targets"])
        if aux and "aux_loss" in aux:
            loss = loss + moe_aux_weight * aux["aux_loss"]
        return loss, aux

    def run(state, batch, params, mb, split):
        """Forward and backward of this rank's rows of each microbatch;
        the gradient sums are left in ``.grad``."""
        each = mb // n_shards if split else mb
        first = shard * each if split else 0
        last_mb, works, hooks = [False], [], []
        if split and overlap:
            def reduce_now(p):
                if last_mb[0]:
                    works.append(dist.all_reduce(p.grad, group=groups[0],
                                                 async_op=True))
            hooks = [p.register_post_accumulate_grad_hook(reduce_now)
                     for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        auxes = []
        try:
            for i in range(accum):
                last_mb[0] = i == accum - 1
                rows = slice(i * mb + first, i * mb + first + each)
                loss, aux = loss_fn(state.params,
                                    {k: v[rows] for k, v in batch.items()})
                loss.backward()
                loss_sum += loss.detach()
                auxes.append({k: v.detach() for k, v in aux.items()})
        finally:
            for h in hooks:
                h.remove()
        if split:
            for w in works:
                w.wait()
            for g in groups[1:] if overlap else groups:
                for p in params:
                    dist.all_reduce(p.grad, group=g)
            for g in groups:
                dist.all_reduce(loss_sum, group=g)
            loss_sum /= n_shards
        return loss_sum, auxes

    def train_step(state: TrainState, batch):
        if mesh is not None:
            specs.place_model(state, mesh)
        params = list(state.params.parameters())
        b = batch["inputs"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"accum_steps {accum}")
        mb = b // accum
        split = mesh is not None and mb % n_shards == 0
        for p in params:
            p.grad = None
        if mesh is None:
            loss_sum, auxes = run(state, batch, params, mb, False)
        else:
            with _MeshStep(mesh):
                if split:
                    loss_sum, auxes = run(state, batch, params, mb, True)
                else:
                    with sharding.replicated_batch():
                        loss_sum, auxes = run(state, batch, params, mb,
                                              False)
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        div = accum * (n_shards if split else 1)
        if div > 1:
            torch._foreach_div_(grads, div)
        placed = specs.model_split(state)
        tp_norm = {} if placed is None else {
            "split": [d is not None for d in placed[1]],
            "group": mesh.get_group("model")}
        _, opt, om = adamw_update(params, grads, state.opt, opt_cfg,
                                  **tp_norm)
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

    vocab = model.config.vocab_size

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        tp = tpl.active()
        if tp is not None and tp.splits("vocab", vocab):
            nxt = tpl.argmax(logits[:, -1], vocab, tp).to(torch.int32)
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return decode_step
