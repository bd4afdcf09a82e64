"""FSDP over the "data" mesh axis: weights stored split, used whole.

The JAX package's rules put every weight's d_model dim on "data"
(``"p_embed": ("data",)``; ``launch.specs.param_logical`` says which dim
of which tensor), and both AdamW moments follow their parameter; GSPMD
then gathers each weight over "data" where it is used and
reduce-scatters its gradient.  The port has no partitioner, so this
module holds what GSPMD derives from that rule.

``launch.specs.place`` cuts each parameter to this rank's ``spec_for``
slice and records, on the module that owns a parameter split over
"data", ``data_dims = {name: dim}``.  ``gathered(module)`` returns the
module with every such parameter all-gathered over the mesh's "data"
group (a shallow copy: the stored slices are untouched).  The model code
calls it on one block at a time, inside the function that
``torch.utils.checkpoint`` wraps, so a block's whole weights live only
while the block runs and a recompute gathers them again; the embedding
table and the head are gathered around the stack, a tied table once.
A module with no ``data_dims`` below it is returned as it is: without a
mesh, or with "data" of size 1, the model runs exactly its meshless ops.

The gather's backward is the reduce-scatter of the gradient, a sum over
the "data" ranks, since each computed the whole tensor's gradient from
its own rows of the batch.  Where the batch did not split over the
batch axes (``sharding.replicated_batch``) every data rank computed the
same whole gradient, and the backward takes this rank's slice of it
(exact) instead of a sum.  Collectives inside a checkpointed region run
again in its recompute, in the forward's order; every rank runs the same
blocks, so the ranks' collectives stay matched.

On gloo a CUDA tensor can be reduced but not gathered or scattered:
there the gather sums zero-padded slices and the reduce-scatter is an
all-reduce and a slice (``tensor_parallel.all_gather`` /
``reduce_scatter``).  ``COUNTS`` tallies the gathers and reduce-scatters
and their bytes (the whole tensor's) for whoever reads them.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.parallel import sharding
from repro_torch.parallel import tensor_parallel as tpl

DATA = "data"

# collective -> [calls, bytes of the whole tensor]
COUNTS: dict[str, list] = {"all_gather": [0, 0], "reduce_scatter": [0, 0]}


def reset_counts() -> None:
    for v in COUNTS.values():
        v[:] = [0, 0]


def _tally(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind][0] += 1
    COUNTS[kind][1] += t.numel() * t.element_size()


class _GatherData(torch.autograd.Function):
    """All-gather over "data" along ``dim`` forward; the backward is the
    reduce-scatter of the gradient (a sum over the data ranks)."""

    @staticmethod
    def forward(ctx, w, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return tpl.all_gather(w, dim, ax)

    @staticmethod
    def backward(ctx, g):
        _tally("reduce_scatter", g)
        return tpl.reduce_scatter(g, ctx.dim, ctx.ax), None, None


def gather(w: torch.Tensor, dim: int, ax: tpl.TP) -> torch.Tensor:
    """``w`` (this rank's slice along ``dim``) whole over "data".  Where
    every data rank holds the whole batch the backward is this rank's
    slice of the gradient (``tensor_parallel.gather_model``), else the
    reduce-scatter."""
    out = (tpl.gather_model(w, dim, ax) if sharding.batch_is_replicated()
           else _GatherData.apply(w, dim, ax))
    _tally("all_gather", out)
    return out


def is_split(module: nn.Module) -> bool:
    """Whether a parameter of ``module`` (or below it) is held split over
    "data"."""
    return any(getattr(m, "data_dims", None) for m in module.modules())


def _gathered_copy(m: nn.Module, ax: tpl.TP) -> nn.Module:
    new = copy.copy(m)
    new.__dict__.pop("data_dims", None)
    new._parameters = dict(m._parameters)
    for name, dim in (getattr(m, "data_dims", None) or {}).items():
        new._parameters[name] = gather(m._parameters[name], dim, ax)
    new._modules = {k: None if c is None else _gathered_copy(c, ax)
                    for k, c in m._modules.items()}
    return new


def gathered(module: nn.Module | None) -> nn.Module | None:
    """``module`` with every parameter held split over "data" gathered
    whole (a shallow copy), or ``module`` itself when none is."""
    if module is None or not is_split(module):
        return module
    ax = tpl.axis(DATA)
    if ax is None:
        raise RuntimeError("the parameters are placed over \"data\" "
                           "(launch.specs.place): run under the mesh's "
                           "sharding context")
    return _gathered_copy(module, ax)


def call(fn, block: nn.Module, *args, **kwargs):
    """``fn(gathered(block), *args, **kwargs)``: the form to hand
    ``torch.utils.checkpoint``, so that its recompute gathers again."""
    return fn(gathered(block), *args, **kwargs)


def ends(params: nn.Module) -> tuple:
    """(embedding, head) of an LM, each gathered over "data" around the
    stack: a tied table (no ``lm_head``) is gathered once and serves
    both, so its gradient's two parts are summed before one
    reduce-scatter."""
    emb = gathered(params.embed)
    head = getattr(params, "lm_head", None)
    return emb, (emb if head is None else gathered(head))
