"""Sequence parallelism over "model": the residual stream split along
the sequence (Megatron-style) and the sequence-sharded KV cache.

The JAX package turns it on by rule: the launcher maps ``seq_res ->
("model",)``, and GSPMD splits the residual stream [B, S, d] along S
wherever the model annotates it ``("batch", "seq_res", "embed")`` (the
embedding, each residual add of a block, each SSM block), then gathers
the sequence again at the next consumer annotated "seq" (q/k/v, the GLU,
the MoE's ``shard_map``, the SSM, the cross blocks, the logits).  The
port has no partitioner, so this module holds what GSPMD derives, as
``tensor_parallel`` does for heads and ``fsdp`` for weights.

Which tensors split is ``spec_for``'s decision, asked in one place:
``split(shape)`` gives the "model" axis (a ``tensor_parallel.TP``) where
the S entry of ``spec_for(shape, ("batch", "seq_res", "embed"))`` holds
"model", else None: no sharding context, "model" of size 1, the default
rules (``seq_res -> ()``), or S not dividing "model" (decode's S = 1, an
odd prompt).  Then the model runs exactly its ops without the split.  A
model's forward and prefill enter ``stream(split(...))`` around their
stack; a region reads ``current()``, as it reads
``tensor_parallel.active()``.  A block checkpointed with ``checkpoint``
recomputes in the backward, outside the forward's ``stream``: it
re-enters the forward's stream for the recompute.

The regions and their one convention.  Every region leaves the stream
so that, in the backward, every model rank holds the whole gradient of
the region's output, equal on every rank:

  * a region whose compute is split over "model" (the rank's heads, GLU
    columns, vocabulary rows) enters with ``gather`` (all-gather along
    dim 1; the backward reduce-scatters, a sum over the ranks, since each
    rank's gradient of the gathered input is its share's part) and
    leaves with ``reduce_scatter`` of its partial sums (the backward
    all-gathers): ``enter`` / ``leave``, which without the split are
    ``tensor_parallel.to_model`` / ``from_model``;
  * a region whose compute is replicated (heads, GLU hidden or
    vocabulary that do not divide "model", the SSM, the MoE as a whole)
    enters with ``gather(..., summed=False)`` (the backward takes this
    rank's slice of a gradient every rank holds whole) and leaves with
    ``scatter``, this rank's slice (the backward all-gathers):
    ``enter_replicated`` / ``leave_replicated``.  Its weights then get
    the same whole gradient on every rank, as without the split.

A replicated weight used on the shard itself (a norm's scale) has only
this rank's positions' part of its gradient: ``replicated(w)`` sums it
over "model" (``tensor_parallel.to_model``).

The KV cache's slice of T is ``parallel.sharding``'s (``kv_spec``,
``cache_slice``): it applies whether or not the rule splits the
residual stream.

Every collective runs through ``tensor_parallel.all_gather`` /
``reduce_scatter`` on the "model" group (on gloo a CUDA tensor is
gathered as a sum of zero-padded slices).  ``COUNTS`` tallies the
residual stream's gathers and reduce-scatters and their bytes (the
whole tensor's) for whoever reads them.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.parallel import sharding
from repro_torch.parallel import tensor_parallel as tpl

MODEL = "model"
LOGICAL = ("batch", "seq_res", "embed")
# the default rules with the residual stream's sequence on "model", as
# the JAX package's launcher remaps them (``seq_shard``)
RULES = {**sharding.DEFAULT_RULES, "seq_res": (MODEL,)}

# collective -> [calls, bytes of the whole tensor]
COUNTS: dict[str, list] = {"all_gather": [0, 0], "reduce_scatter": [0, 0]}


def reset_counts() -> None:
    for v in COUNTS.values():
        v[:] = [0, 0]


def _tally(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind][0] += 1
    COUNTS[kind][1] += t.numel() * t.element_size()


# --------------------------------------------------------------------------
# the plan: whether the residual stream splits
# --------------------------------------------------------------------------

def split(shape) -> tpl.TP | None:
    """The "model" axis where ``spec_for`` splits a residual stream of
    ``shape`` [B, S, d] along S over it, else None."""
    tp = tpl.active()
    if tp is None:
        return None
    axes = sharding.axes_of(
        sharding.spec_for(tuple(shape), LOGICAL, tp.ctx)[1])
    if not axes:
        return None
    if axes != (MODEL,):
        raise ValueError(f"seq_res over {axes}: the port splits the "
                         "residual stream over \"model\" only")
    return tp


_STREAM: list[tpl.TP | None] = [None]


@contextlib.contextmanager
def stream(sp: tpl.TP | None):
    """The residual stream is split over ``sp`` (None: whole) inside."""
    old = _STREAM[0]
    _STREAM[0] = sp
    try:
        yield
    finally:
        _STREAM[0] = old


def current() -> tpl.TP | None:
    """The axis the residual stream is split over here, or None."""
    return _STREAM[0]


def checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)``, its
    recompute run inside the stream of the forward."""
    sp = current()
    return torch_checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), stream(sp)), **kwargs)


# --------------------------------------------------------------------------
# the operators along dim 1
# --------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather along dim 1 forward; the backward reduce-scatters (a
    sum over "model") or, with ``summed`` false, takes this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, tp, summed):
        ctx.tp, ctx.summed, ctx.n = tp, summed, x.shape[1]
        out = tpl.all_gather(x, 1, tp)
        _tally("all_gather", out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            _tally("reduce_scatter", g)
            return tpl.reduce_scatter(g, 1, ctx.tp), None, None
        return g.narrow(1, ctx.tp.rank * ctx.n, ctx.n), None, None


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial sums reduce-scattered along dim 1 forward; the
    backward all-gathers."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        _tally("reduce_scatter", y)
        return tpl.reduce_scatter(y, 1, tp)

    @staticmethod
    def backward(ctx, g):
        out = tpl.all_gather(g, 1, ctx.tp)
        _tally("all_gather", out)
        return out, None


class _Scatter(torch.autograd.Function):
    """This rank's slice along dim 1 of a tensor every rank holds whole
    and equal; the backward all-gathers."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        n = y.shape[1] // tp.size
        return y.narrow(1, tp.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = tpl.all_gather(g, 1, ctx.tp)
        _tally("all_gather", out)
        return out, None


def gather(x: torch.Tensor, tp: tpl.TP, *, summed: bool = True
           ) -> torch.Tensor:
    return _Gather.apply(x, tp, summed)


def reduce_scatter(y: torch.Tensor, tp: tpl.TP) -> torch.Tensor:
    return _ReduceScatter.apply(y, tp)


def scatter(y: torch.Tensor, tp: tpl.TP) -> torch.Tensor:
    return _Scatter.apply(y, tp)


def enter(x: torch.Tensor, tp: tpl.TP) -> torch.Tensor:
    """The input of a region split over "model" (``tp``):
    ``to_model``, or the sequence gather (reduce-scattered backward)
    where the stream is split."""
    sp = current()
    return tpl.to_model(x, tp.group) if sp is None else gather(x, sp)


def leave(y: torch.Tensor, tp: tpl.TP) -> torch.Tensor:
    """A split region's partial sums merged: ``from_model``, or the
    sequence reduce-scatter (this rank's positions) where the stream is
    split."""
    sp = current()
    return tpl.from_model(y, tp.group) if sp is None else reduce_scatter(
        y, sp)


def enter_replicated(x: torch.Tensor) -> torch.Tensor:
    """The input of a replicated region: the whole sequence (the
    gradient's own slice backward) where the stream is split."""
    sp = current()
    return x if sp is None else gather(x, sp, summed=False)


def leave_replicated(y: torch.Tensor) -> torch.Tensor:
    """The output of a replicated region back on the stream: this rank's
    slice (all-gathered backward) where the stream is split."""
    sp = current()
    return y if sp is None else scatter(y, sp)


def replicated(w: torch.Tensor) -> torch.Tensor:
    """A replicated weight used on the stream: its gradient summed over
    "model" where the stream is split (each rank's is its positions')."""
    sp = current()
    return w if sp is None else tpl.to_model(w, sp.group)


def last_position(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1:] of the whole sequence, on every rank (no grad): the last
    rank of a split stream holds it, the others add zeros (exact)."""
    sp = current()
    if sp is None:
        return x[:, -1:]
    row = x[:, -1:] if sp.rank == sp.size - 1 else torch.zeros_like(
        x[:, -1:])
    return tpl._sum(row, sp.group)
