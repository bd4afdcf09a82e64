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

Placement.  On its first call the step places the state
(``launch.specs.place``): every parameter and both moments become this
rank's ``param_specs`` slice over "model" and over "data".

Tensor parallelism.  Where the mesh's "model" axis has size m > 1 the
model computes each rank's heads, GLU columns and vocabulary rows
(``parallel.tensor_parallel``).  The loss is then
``tensor_parallel.cross_entropy`` on the vocab-sharded logits.  A
weight split over "model" has this rank's own gradient; a replicated
one is summed over "model" inside the backward wherever a rank computes
only its part of its gradient (a whole weight used on a rank's heads,
``tensor_parallel.part``), so it leaves the backward equal on every
model rank: neither is reduced over "model" here.

Sequence parallelism.  Under the rule ``seq_res -> ("model",)``
(``rules``; ``parallel.sequence_parallel``) the residual stream is each
rank's positions of the sequence between the regions.  A norm's scale
(and a bias added after the reduce-scatter) then sees only the rank's
positions: its gradient is summed over "model" in the backward
(``sequence_parallel.replicated``).  Every region leaves the stream so
that its backward starts from the whole gradient on every rank, so a
replicated region's weights get the same whole gradient as without the
rule.  Every replicated gradient is therefore still equal on every
model rank when the step reduces over the batch axes, and the
gradient norm's groups are the placement's, as without the rule.

FSDP.  Where "data" has size n > 1, a weight split over "data" is
gathered a block at a time and its gradient reduce-scattered over
"data" in the backward (``parallel.fsdp``): it is summed over "data"
there, and only over the other batch axis ("pod") here; the rest are
all-reduced over every batch axis as above.  Under
``replicated_batch`` every data rank computes the same whole gradient
and the gather's backward takes this rank's slice of it, no sum; no
gradient is reduced then.  ``overlap`` issues each gradient's first
remaining reduction from its hook.  The gradient norm sums each split
tensor's squares over the groups that split it
(``optim.clip_by_global_norm``).  The serve steps run partitioned
under a mesh context holding such axes, on placed parameters (gathered
over "data" a block at a time each call) and a cache built under it:
the rank's ``cache_specs`` slice (its rows, its KV heads where they
split over "model", its positions of T where T splits; decode combines
its softmax over T's axes).  They return vocab-sharded logits (the
greedy token is the global argmax); a prefill whose prompt divides
"model" under the rule runs on a split residual stream.
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


def _batch_axes(mesh) -> tuple[list, int, int]:
    """The mesh's batch axes in mesh order, their size product n and this
    rank's index among the n."""
    sizes = sharding.axis_sizes(mesh)
    axes = [a for a in sharding.BATCH_AXES if a in sizes]
    n, index = 1, 0
    for a in axes:
        n *= sizes[a]
        index = index * sizes[a] + mesh.get_local_rank(a)
    return axes, n, index


class _MeshStep:
    """The sharding context of ``mesh`` (the caller's, when it already
    holds this mesh and no ``rules`` are given) for the length of one
    step."""

    def __init__(self, mesh, rules=None):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self.prev = sharding.current_context()
        if (self.prev is None or self.prev.mesh is not self.mesh
                or self.rules is not None):
            sharding.set_context(self.mesh, self.rules)

    def __exit__(self, *exc):
        if self.prev is None:
            sharding.set_context(None)
        else:
            sharding.set_context(self.prev.mesh, self.prev.rules)
        return False


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    moe_aux_weight: float = 1e-2,
                    accum_steps: int | None = None, *, mesh=None,
                    overlap: bool = False, rules=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps`` (default: the config's ``accum_steps``) splits the
    batch into that many microbatches of consecutive rows, each run
    forward and backward in turn: live activation memory drops by that
    factor.  Metrics: ``loss`` (the microbatches' mean, the aux term
    included), ``lr``, ``grad_norm`` (before clipping), and each aux value
    of the forward (the microbatches' mean).  ``mesh``: data-parallel
    over its batch axes, as the module docstring says; ``overlap``
    reduces the gradients during the backward; ``rules``: the sharding
    rules of the step's context (``parallel.sharding.DEFAULT_RULES``
    with overrides, e.g. ``seq_res -> ("model",)``; the caller's
    context, or the defaults, when None)."""
    accum = (accum_steps if accum_steps is not None
             else getattr(model.config, "accum_steps", 1) or 1)
    axes, n_shards, shard = (_batch_axes(mesh) if mesh is not None
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

    def run(state, batch, params, mb, split, reduce_over):
        """Forward and backward of this rank's rows of each microbatch;
        the gradient sums are left in ``.grad``, each summed over the
        batch axes in ``reduce_over`` (its groups, one list a parameter)
        when ``split``."""
        each = mb // n_shards if split else mb
        first = shard * each if split else 0
        last_mb, works, hooks = [False], [], []
        if split and overlap:
            first_group = {id(p): gs[0] for p, gs in zip(params, reduce_over)
                           if gs}

            def reduce_now(p):
                if last_mb[0] and id(p) in first_group:
                    works.append(dist.all_reduce(
                        p.grad, group=first_group[id(p)], async_op=True))
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
            for p, gs in zip(params, reduce_over):
                for g in gs[1:] if overlap else gs:
                    dist.all_reduce(p.grad, group=g)
            for a in axes:
                dist.all_reduce(loss_sum, group=mesh.get_group(a))
            loss_sum /= n_shards
        return loss_sum, auxes

    def train_step(state: TrainState, batch):
        if mesh is not None:
            specs.place(state, mesh)
        params = list(state.params.parameters())
        placed = specs.placement(state) or {}
        # the mesh axes that split each parameter, and the batch axes its
        # gradient is still summed over: not "data" where FSDP's
        # reduce-scatter summed it already
        split_by = [tuple(a for a in specs.AXES
                          if a in placed and placed[a][1][i] is not None)
                    for i in range(len(params))]
        reduce_over = [[mesh.get_group(a) for a in axes if a not in sp]
                       for sp in split_by]
        b = batch["inputs"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"accum_steps {accum}")
        mb = b // accum
        split = mesh is not None and mb % n_shards == 0
        for p in params:
            p.grad = None
        if mesh is None:
            loss_sum, auxes = run(state, batch, params, mb, False, [])
        else:
            with _MeshStep(mesh, rules):
                if split:
                    loss_sum, auxes = run(state, batch, params, mb, True,
                                          reduce_over)
                else:
                    with sharding.replicated_batch():
                        loss_sum, auxes = run(state, batch, params, mb,
                                              False, reduce_over)
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        div = accum * (n_shards if split else 1)
        if div > 1:
            torch._foreach_div_(grads, div)
        norm_groups = None if not placed else [
            tuple(mesh.get_group(a) for a in sp) for sp in split_by]
        _, opt, om = adamw_update(params, grads, state.opt, opt_cfg,
                                  split=norm_groups)
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


def make_decode_step(model: Model, sample_greedy: bool = True):
    """serve_step: one token for every sequence in the batch, the greedy
    one, or with ``sample_greedy=False`` the input's last token fed back
    (teacher forcing)."""

    vocab = model.config.vocab_size

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        tp = tpl.active()
        if not sample_greedy:
            nxt = tokens[:, -1]
        elif tp is not None and tp.splits("vocab", vocab):
            nxt = tpl.argmax(logits[:, -1], vocab, tp).to(torch.int32)
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return decode_step
