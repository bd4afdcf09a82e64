"""Placements for the LM's trees: parameters, train state, batch, cache.

The placement half of the JAX package's ``launch/specs.py``.  Parameter
placement is path-rule based (``param_logical``): TP on the "model" axis
for head / ffn / vocab / expert dims, FSDP over "data" on the d_model
dim, with the divisibility-aware fallback of ``parallel.sharding``.  Each
port parameter is named by its leaf in the JAX parameter tree
(``convert.leaf_paths``); the JAX package stacks a layer list's leaves
``[L, ...]`` where the port keeps one module a layer, so a port
parameter's spec is the JAX leaf's minus its leading stack entry.

``*_specs`` give PartitionSpec entries (tuples, ``spec_for``'s form);
``*_shardings`` give ``(mesh, placements)``, the form
``checkpoint.restore_pytree(..., shardings=)`` places leaves with.  Both
take a ``MeshContext`` whose mesh may be a ``DeviceMesh`` or a shape-only
``AbstractMesh``.  Parameters come as a model's ``nn.Module``; a train
state as the port's ``TrainState``; batches and caches as dicts of
tensors (the meta device gives shapes without memory: ``abstract_state``).

The cell builders (``build_cell``, ``input_specs``,
``step_and_shardings``) belong to the dry-run tooling, which is not
ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import torch

from repro_torch import convert
from repro_torch.parallel.sharding import (MeshContext, placements_for,
                                           spec_for)


# --------------------------------------------------------------------------
# parameter logical axes by path
# --------------------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "gate", "up"}      # out-dim on "model"
_ROW_PARALLEL = {"wo", "down"}                        # in-dim on "model"
_REPLICATED_LEAVES = {"scale", "a_log", "dt_bias", "d_skip"}


def param_logical(path: tuple[str, ...], ndim: int) -> tuple:
    """Logical axes for one parameter leaf, padded with leading None for
    stacked-layer / group dims."""
    names = list(path)
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    in_moe = "moe" in names and "shared" not in names

    if leaf == "table":                       # [vocab, d_model]
        base = ("p_vocab", "p_embed")
    elif in_moe and leaf in ("gate", "up"):   # [E, d, ff]
        base = ("p_experts", "p_embed", None)
    elif in_moe and leaf == "down":           # [E, ff, d]
        base = ("p_experts", None, "p_embed")
    elif in_moe and parent == "router":       # [d, E]
        base = ("p_embed", None)
    elif parent == "in_proj":                 # ssm fused in [d, X]
        base = ("p_embed", None)
    elif parent == "out_proj":                # ssm out [di, d]
        base = (None, "p_embed")
    elif parent == "conv":                    # depthwise conv [W, C] / [C]
        base = (None,) * min(ndim, 2)
    elif parent in _COL_PARALLEL and leaf == "w":
        kind = "p_mlp" if parent in ("gate", "up") else "p_heads"
        base = ("p_embed", kind)
    elif parent in _COL_PARALLEL and leaf == "b":
        base = ("p_mlp" if parent in ("gate", "up") else "p_heads",)
    elif parent in _ROW_PARALLEL and leaf == "w":
        kind = "p_mlp" if parent == "down" else "p_heads"
        base = (kind, "p_embed")
    elif parent in _ROW_PARALLEL and leaf == "b":
        base = (None,)
    elif leaf in _REPLICATED_LEAVES or leaf == "b":
        base = (None,) * min(ndim, 1)
    else:
        base = ()

    pad = ndim - len(base)
    if pad < 0:        # leaf has fewer dims than the rule (e.g. scalar)
        return (None,) * ndim
    return (None,) * pad + tuple(base)


def param_specs(params, ctx: MeshContext) -> list[tuple]:
    """One spec per tensor of ``params.parameters()``, in that order: the
    JAX leaf's spec (its stacked shape through ``param_logical``) without
    the stack's entry."""
    out = []
    for (path, layer), p in zip(convert.leaf_paths(params),
                                params.parameters()):
        stacked = 1 if layer >= 0 else 0
        shape = ((convert.stack_length(params.cfg, path),) * stacked
                 + tuple(p.shape))
        spec = spec_for(shape, param_logical(tuple(path.split("/")),
                                             len(shape)), ctx)
        out.append(spec[stacked:])
    return out


def state_specs(state, ctx: MeshContext):
    """A ``TrainState`` of specs: the moments mirror the parameters, the
    step counters are replicated."""
    from repro_torch.train.steps import TrainState
    ps = param_specs(state.params, ctx)
    return TrainState(ps, {"m": list(ps), "v": list(ps), "step": ()}, ())


# --------------------------------------------------------------------------
# batch / cache placements
# --------------------------------------------------------------------------

def _div_axes(dim: int, candidates: tuple[str, ...], ctx: MeshContext,
              used: set) -> tuple[str, ...]:
    """Longest prefix of unused mesh axes whose product divides `dim`."""
    sizes = ctx.shape
    got: tuple[str, ...] = ()
    acc = 1
    for a in candidates:
        if a not in sizes or a in used:
            continue
        if dim % (acc * sizes[a]) == 0:
            acc *= sizes[a]
            got = got + (a,)
    return got


def _one(axes: tuple[str, ...]):
    return None if not axes else (axes if len(axes) > 1 else axes[0])


def batch_specs(batch: dict, ctx: MeshContext) -> dict:
    """inputs/targets [B, S] over ("pod", "data"); memory [B, F, d] the
    same."""
    out = {}
    for k, v in batch.items():
        baxes = _div_axes(v.shape[0], ("pod", "data"), ctx, set())
        out[k] = (_one(baxes),) + (None,) * (len(v.shape) - 1)
    return out


def cache_specs(cache: dict, ctx: MeshContext) -> dict:
    """KV cache [L, B, T, KVH, D]; SSM state [L, B, nh, st, hd]; conv
    [L, B, W-1, C]; memory [B, F, d]; length (an int) replicated.

    Batch gets ("pod", "data") when divisible; heads get "model"; when the
    batch cannot shard (long_500k B=1) the cache *sequence* dim takes the
    leftover axes (flash-decoding style sequence sharding)."""
    out = {}
    for key, v in cache.items():
        shape = tuple(getattr(v, "shape", ()))
        if key == "length" or len(shape) == 0:
            out[key] = ()
            continue
        if key == "memory":                     # [B, F, d]
            b = _div_axes(shape[0], ("pod", "data"), ctx, set())
            out[key] = (_one(b), None, None)
            continue
        used: set = set()
        parts: list = [None] * len(shape)
        if key in ("k", "v"):                   # [L, B, T, KVH, D]
            b = _div_axes(shape[1], ("pod", "data"), ctx, used)
            used.update(b)
            h = _div_axes(shape[3], ("model",), ctx, used)
            used.update(h)
            t = _div_axes(shape[2], ("pod", "data", "model"), ctx, used)
            parts[1], parts[2], parts[3] = _one(b), _one(t), _one(h)
        elif key == "state":                    # [L, B, nh, st, hd]
            b = _div_axes(shape[1], ("pod", "data"), ctx, used)
            used.update(b)
            h = _div_axes(shape[2], ("model",), ctx, used)
            parts[1], parts[2] = _one(b), _one(h)
        elif key == "conv":                     # [L, B, W-1, C]
            b = _div_axes(shape[1], ("pod", "data"), ctx, used)
            used.update(b)
            c = _div_axes(shape[3], ("model",), ctx, used)
            parts[1], parts[3] = _one(b), _one(c)
        out[key] = tuple(parts)
    return out


# --------------------------------------------------------------------------
# (mesh, placements)
# --------------------------------------------------------------------------

def _placed(spec, ctx: MeshContext):
    return ctx.mesh, placements_for(spec, ctx.mesh)


def param_shardings(params, ctx: MeshContext) -> list:
    return [_placed(s, ctx) for s in param_specs(params, ctx)]


def state_shardings(state, ctx: MeshContext):
    """A ``TrainState`` of ``(mesh, placements)``, the ``shardings`` tree
    of ``restore_pytree`` for a train state."""
    from repro_torch.train.steps import TrainState
    specs = state_specs(state, ctx)
    ps = [_placed(s, ctx) for s in specs.params]
    return TrainState(ps, {"m": list(ps), "v": list(ps),
                           "step": _placed((), ctx)}, _placed((), ctx))


def batch_shardings(batch: dict, ctx: MeshContext) -> dict:
    return {k: _placed(s, ctx) for k, s in batch_specs(batch, ctx).items()}


def cache_shardings(cache: dict, ctx: MeshContext) -> dict:
    return {k: _placed(s, ctx) for k, s in cache_specs(cache, ctx).items()}


# --------------------------------------------------------------------------
# shapes without memory
# --------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: the models' inits
    draw onto their generator's device, so they build shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_state(model):
    """The model's ``TrainState`` on the meta device (shapes, no memory)."""
    from repro_torch.train.steps import init_train_state
    return init_train_state(model, _MetaGenerator())
