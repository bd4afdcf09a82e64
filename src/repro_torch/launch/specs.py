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

The cell builders are the dry-run's (``launch/dryrun.py``): a ``Cell``
is one (architecture x input shape) of ``configs.SHAPES``; ``input_specs``
gives every input of the cell's step in the order the step takes them,
the JAX package's ``ShapeDtypeStruct`` stand-ins leaf by leaf (a stacked
``[L, ...]`` leaf is L port tensors, paired through
``convert.leaf_paths``).  Built under a ``FakeTensorMode`` they are fake
CPU tensors, shapes without memory; outside one, real CPU tensors from
the seed.  ``cell_step`` gives the step of ``train/steps.py`` the cell
runs; ``step_and_shardings`` gives it with the placements of its inputs
and outputs.  A cache built under a mesh context is a rank's slice
(``parallel.sharding.kv_spec``: its rows, its KV heads, its positions of
T) and carries its specs; ``place_cache`` / ``gather_cache`` carry a
whole cache onto a rank and back, exactly.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from repro_torch import configs, convert
from repro_torch.models import zoo
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (DEFAULT_RULES, MeshContext,
                                           axes_of, batch_axes, div_axes,
                                           kv_spec, one,
                                           placements_for, spec_for)


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
# placement: each rank's "data" and "model" slices of a state
# --------------------------------------------------------------------------

AXES = ("data", "model")       # the axes parameter specs put tensors on


def split_dims(params, ctx: MeshContext, axis: str) -> list:
    """For each tensor of ``params.parameters()`` (whole, not yet
    placed): the dim its ``param_specs`` entry puts on ``axis``, or None
    (whole over that axis, also where the axis has size 1)."""
    if ctx.shape.get(axis, 1) == 1:
        return [None] * len(list(params.parameters()))
    return [next((d for d, e in enumerate(spec) if axis in axes_of(e)), None)
            for spec in param_specs(params, ctx)]


def local_slice(t: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """This rank's slice of the whole ``t`` under ``spec``: mesh dims in
    order, each that shards a tensor dim taking its coordinate's
    ``torch.chunk`` (the first mesh dim major, as DTensor and XLA split
    an entry over several axes).  ``coords``: the rank's coordinate on
    every mesh dim (a ``DeviceMesh``'s own by default; required for an
    ``AbstractMesh``)."""
    coords = mesh.get_coordinate() if coords is None else coords
    for pl, c, n in zip(placements_for(spec, mesh), coords,
                        tuple(mesh.shape)):
        if pl.is_shard():
            t = t.chunk(n, dim=pl.dim)[c]
    return t.clone()


def _split_of(obj):
    from repro_torch.train.steps import TrainState
    st = obj if isinstance(obj, TrainState) else None
    return st, (st.params if st is not None else obj)


def _spec(dims: dict, ndim: int) -> tuple:
    """A spec with ``axis`` on dim ``d`` for each (axis, d) of ``dims``."""
    return tuple(next((a for a, d in dims.items() if d == i), None)
                 for i in range(ndim))


def place(obj, mesh, coords=None, rules=None):
    """A whole model (``nn.Module``) or ``TrainState``, placed in place
    onto one rank of ``mesh``: each parameter, and both AdamW moments of
    a train state, becomes its ``local_slice`` under its ``param_specs``
    "model" and "data" entries (``rules``: ``DEFAULT_RULES`` by default;
    an axis of size 1 splits nothing).  The module records
    ``model_split = (m, dims)`` and ``data_split = (n, dims)`` where
    something splits over that axis, and each submodule owning a tensor
    split over "data" ``data_dims = {name: dim}`` (``parallel.fsdp``
    gathers by it).  A module already placed, or none of whose tensors
    splits, is left as it is.  ``coords``: the rank's coordinate on
    every mesh dim (a ``DeviceMesh``'s own by default; 0 on every dim of
    an ``AbstractMesh``).  Returns ``obj``."""
    from torch import nn
    st, params = _split_of(obj)
    if placement(params) is not None:
        return obj
    ctx = MeshContext(mesh, rules or DEFAULT_RULES)
    dims = {a: split_dims(params, ctx, a) for a in AXES if a in ctx.shape}
    if all(d is None for ds in dims.values() for d in ds):
        return obj
    if coords is None:
        coords = (mesh.get_coordinate() if hasattr(mesh, "get_coordinate")
                  else [0] * len(mesh.shape))
    per = [{a: ds[i] for a, ds in dims.items() if ds[i] is not None}
           for i in range(len(next(iter(dims.values()))))]

    def cut(t, d):
        return local_slice(t.detach(), _spec(d, t.dim()), mesh, coords)

    for (name, p), d in zip(list(params.named_parameters()), per):
        if not d:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = params.get_submodule(owner_name)
        setattr(owner, leaf, nn.Parameter(cut(p, d),
                                          requires_grad=p.requires_grad))
        if "data" in d:
            owner.data_dims = {**getattr(owner, "data_dims", {}),
                               leaf: d["data"]}
    for a, ds in dims.items():
        if any(d is not None for d in ds):
            setattr(params, f"{a}_split", (ctx.shape[a], tuple(ds)))
    if st is not None:
        for k in ("m", "v"):
            st.opt[k][:] = [cut(t, d) if d else t
                            for t, d in zip(st.opt[k], per)]
    return obj


def placement(obj) -> dict | None:
    """``{axis: (size, dims)}`` of a placed module or train state, else
    None."""
    params = _split_of(obj)[1]
    out = {a: getattr(params, f"{a}_split") for a in AXES
           if getattr(params, f"{a}_split", None) is not None}
    return out or None


def _all_gather_over(mesh):
    """``gather(t, dim, axis)``: ``t`` all-gathered along ``dim`` over
    ``mesh``'s group of ``axis`` (the sharding context's mesh by
    default)."""
    from repro_torch.parallel import tensor_parallel as tpl
    if mesh is None:
        from repro_torch.parallel.sharding import current_context
        mesh = current_context().mesh
    ctx = MeshContext(mesh, DEFAULT_RULES)

    def gather(t, d, a):
        return tpl.all_gather(t, d, tpl.TP(
            ctx, ctx.shape[a], mesh.get_local_rank(a), mesh.get_group(a)))
    return gather


def gather_state(obj, mesh=None, gather=None):
    """The inverse of ``place``: a new module or ``TrainState`` of whole
    tensors (tensors that were not split are shared, not copied).
    ``gather(t, dim, axis)`` gives ``t`` whole along ``dim`` over mesh
    axis ``axis``; by default an all-gather over ``mesh``'s group of that
    axis (the sharding context's mesh by default; every rank of the
    groups calls this).  "data" is gathered first, then "model".  A state
    that is not placed is returned as it is."""
    from torch import nn

    from repro_torch.train.steps import TrainState
    st, params = _split_of(obj)
    split = placement(params)
    if split is None:
        return obj
    gather = gather or _all_gather_over(mesh)

    def whole(t, i):
        for a in AXES:
            if a in split and split[a][1][i] is not None:
                t = gather(t, split[a][1][i], a)
        return t

    memo = {}
    with torch.no_grad():
        for i, p in enumerate(params.parameters()):
            w = whole(p, i)
            memo[id(p)] = p if w is p else nn.Parameter(
                w, requires_grad=p.requires_grad)
        full = copy.deepcopy(params, memo)
        for a in split:
            delattr(full, f"{a}_split")
        for m in full.modules():
            m.__dict__.pop("data_dims", None)
        if st is None:
            return full
        opt = {k: [whole(t, i) for i, t in enumerate(st.opt[k])]
               for k in ("m", "v")}
    opt["step"] = st.opt["step"]
    return TrainState(full, opt, st.step)


def serve_bf16_params(params):
    """The ``serve_bf16`` deployment's weights, in place: every f32
    parameter held as bf16 (the JAX package's dry-run casts its f32
    leaves so); the ops cast them per use as they cast f32 masters.
    Returns ``params``."""
    from torch import nn
    for name, p in list(params.named_parameters()):
        if p.dtype == torch.float32:
            owner, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(owner), leaf, nn.Parameter(
                p.detach().to(torch.bfloat16), requires_grad=False))
    return params


# --------------------------------------------------------------------------
# batch / cache placements
# --------------------------------------------------------------------------

def batch_specs(batch: dict, ctx: MeshContext) -> dict:
    """inputs/targets [B, S] over ("pod", "data"); memory [B, F, d] the
    same."""
    out = {}
    for k, v in batch.items():
        baxes = batch_axes(v.shape[0], ctx.shape)
        out[k] = (one(baxes),) + (None,) * (len(v.shape) - 1)
    return out


def cache_specs(cache: dict, ctx: MeshContext) -> dict:
    """KV cache [L, B, T, KVH, D]; SSM state [L, B, nh, st, hd]; conv
    [L, B, W-1, C]; memory [B, F, d]; length (an int) replicated.

    Batch gets ("pod", "data") when divisible; heads get "model"; the
    cache's *sequence* dim takes the axes those leave unused
    (flash-decoding style sequence sharding; ``parallel.sharding.
    kv_spec``).  A rank's cache built under a mesh context (its
    ``"shard"``) gives the specs of what the rank holds: the KV cache's
    as above, the SSM state and conv window over the batch axes only
    (whole over "model" in the port)."""
    if "shard" in cache:
        return {**{k: () for k in cache if k != "shard"},
                **cache["shard"]}
    out = {}
    for key, v in cache.items():
        shape = tuple(getattr(v, "shape", ()))
        if key == "length" or len(shape) == 0:
            out[key] = ()
            continue
        if key == "memory":                     # [B, F, d]
            b = batch_axes(shape[0], ctx.shape)
            out[key] = (one(b), None, None)
            continue
        used: set = set()
        parts: list = [None] * len(shape)
        if key in ("k", "v"):                   # [L, B, T, KVH, D]
            parts = list(kv_spec(shape, ctx.shape))
        elif key == "state":                    # [L, B, nh, st, hd]
            b = batch_axes(shape[1], ctx.shape)
            used.update(b)
            h = div_axes(shape[2], ("model",), ctx.shape, used)
            parts[1], parts[2] = one(b), one(h)
        elif key == "conv":                     # [L, B, W-1, C]
            b = batch_axes(shape[1], ctx.shape)
            used.update(b)
            c = div_axes(shape[3], ("model",), ctx.shape, used)
            parts[1], parts[3] = one(b), one(c)
        out[key] = tuple(parts)
    return out


def place_cache(cache: dict, mesh) -> dict:
    """A whole cache (a meshless one's shapes, the whole batch) as this
    rank of ``mesh`` holds it: each tensor its ``local_slice`` under the
    spec the port places it by (the KV cache's ``kv_spec``, the rest
    over the batch axes only), and ``"shard"``."""
    ctx = MeshContext(mesh, DEFAULT_RULES)
    shard = {}
    for key, v in cache.items():
        if not isinstance(v, torch.Tensor):
            continue
        if key in ("k", "v"):
            shard[key] = kv_spec(tuple(v.shape), ctx.shape)
            continue
        dim = 0 if key == "memory" else 1          # the batch dim
        spec = [None] * v.dim()
        spec[dim] = one(batch_axes(v.shape[dim], ctx.shape))
        shard[key] = tuple(spec)
    out = {k: (local_slice(v, shard[k], mesh) if k in shard
               else v) for k, v in cache.items()}
    out["shard"] = shard
    return out


def gather_cache(cache: dict, mesh) -> dict:
    """The inverse of ``place_cache``: the whole cache of a rank's cache
    (every rank of ``mesh`` calls this).  A cache without ``"shard"`` is
    returned as it is."""
    if "shard" not in cache:
        return cache
    gather = _all_gather_over(mesh)
    out = {}
    with torch.no_grad():
        for key, v in cache.items():
            if key == "shard":
                continue
            spec = cache["shard"].get(key)
            if spec is None:
                out[key] = v
                continue
            # the last axis of an entry is its minor one: gathered first
            for d, entry in enumerate(spec):
                for a in reversed(axes_of(entry)):
                    v = gather(v, d, a)
            out[key] = v
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


# --------------------------------------------------------------------------
# inputs per cell
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    model: Any
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


def build_cell(arch: str, shape: str, *, overrides: dict | None = None
               ) -> Cell:
    cfg = configs.get(arch)
    sh = configs.SHAPES[shape]
    if not configs.shape_applicable(cfg, shape):
        raise ValueError(f"{arch} × {shape}: skipped per DESIGN.md "
                         "§Arch-applicability (full-attention at 500k)")
    upd: dict = {}
    if sh["kind"] in ("decode", "prefill"):
        upd["max_cache_len"] = sh["seq_len"]
    if overrides:
        upd.update(overrides)
    if upd:
        cfg = dataclasses.replace(cfg, **upd)
    return Cell(arch, shape, cfg, zoo.build(cfg), sh["kind"], sh["seq_len"],
                sh["global_batch"])


def train_batch_abs(cell: Cell, gen: torch.Generator) -> dict:
    """inputs / targets [B, S] int32 (and the frontend's memory [B, F, d]
    f32), drawn from ``gen``."""
    b, s = cell.global_batch, cell.seq_len
    batch = {k: torch.randint(0, cell.cfg.vocab_size, (b, s),
                              generator=gen, dtype=torch.int32)
             for k in ("inputs", "targets")}
    if cell.cfg.n_frontend_tokens:
        batch["memory"] = torch.randn(
            (b, cell.cfg.n_frontend_tokens, cell.cfg.d_model), generator=gen)
    return batch


def abstract_cache(cell: Cell, batch: int, max_len: int) -> dict:
    """The model's cache of ``batch`` rows and ``max_len`` positions, on
    the CPU; under a mesh context the rank's ``cache_specs`` slice of it
    (``place_cache``'s layout)."""
    return cell.model.init_cache(batch, max_len, device="cpu")


def cell_inputs(cell: Cell, seed: int = 0) -> tuple:
    """Every input of the cell's step at its global batch, in the order
    the step takes it: train ``(state, batch)``; prefill ``(params,
    tokens [B, S] int32, cache[, memory [B, F, d] f32])``; decode
    ``(params, cache, tokens [B, 1] int32)`` with a full cache of
    ``seq_len`` (its length ``seq_len - 1``)."""
    from repro_torch.train.steps import init_train_state
    gen = torch.Generator().manual_seed(seed)
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        state = init_train_state(cell.model, gen)
        return state, train_batch_abs(cell, gen)
    params = cell.model.init(gen)
    cache = abstract_cache(cell, b, s)
    if cell.kind == "prefill":
        args = [params, torch.randint(0, cell.cfg.vocab_size, (b, s),
                                      generator=gen, dtype=torch.int32),
                cache]
        if cell.cfg.n_frontend_tokens:
            args.append(torch.randn(
                (b, cell.cfg.n_frontend_tokens, cell.cfg.d_model),
                generator=gen))
        return tuple(args)
    cache["length"] = s - 1
    tokens = torch.randint(0, cell.cfg.vocab_size, (b, 1), generator=gen,
                           dtype=torch.int32)
    return params, cache, tokens


def input_specs(arch: str, shape: str = "train_4k",
                overrides: dict | None = None, seed: int = 0):
    """The cell and every input of its step (``cell_inputs``); under a
    ``FakeTensorMode`` fake tensors, shapes without memory.  Returns
    (cell, args)."""
    cell = build_cell(arch, shape, overrides=overrides)
    return cell, cell_inputs(cell, seed)


# --------------------------------------------------------------------------
# step functions + placements per cell
# --------------------------------------------------------------------------

def _logits_placed(cell: Cell, t_spec: tuple, ctx: MeshContext):
    vocab = "model" if cell.cfg.vocab_size % ctx.shape["model"] == 0 \
        else None
    return _placed((t_spec[0], None, vocab), ctx)


def cell_step(cell: Cell, mesh=None):
    """The step of ``train/steps.py`` the cell runs.  Train:
    ``make_train_step``, data-parallel over the batch axes of ``mesh``
    and tensor-parallel over its "model" axis when given one; prefill /
    decode: the serve steps, partitioned under the caller's sharding
    context (they take no mesh)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)
    if cell.kind == "train":
        return make_train_step(cell.model, AdamWConfig(), mesh=mesh)
    if cell.kind == "prefill":
        return make_prefill_step(cell.model)
    return make_decode_step(cell.model)


def step_and_shardings(cell: Cell, ctx: MeshContext, args):
    """Returns (step_fn, in_shardings, out_shardings), each sharding a
    ``(mesh, placements)``: ``cell_step`` on ``ctx``'s mesh.  The steps
    update the train state and the cache in place, which takes the place
    of the JAX package's ``donate_argnums``; the train metrics are
    replicated scalars (one placement for all)."""
    step = cell_step(cell, ctx.mesh)
    repl = _placed((), ctx)
    if cell.kind == "train":
        state, batch = args
        st_sh = state_shardings(state, ctx)
        return step, (st_sh, batch_shardings(batch, ctx)), (st_sh, repl)
    if cell.kind == "prefill":
        params, tokens, cache = args[:3]
        t_spec = batch_specs({"inputs": tokens}, ctx)["inputs"]
        c_sh = cache_shardings(cache, ctx)
        in_sh = [param_shardings(params, ctx), _placed(t_spec, ctx), c_sh]
        if len(args) == 4:
            in_sh.append(batch_shardings({"memory": args[3]}, ctx)["memory"])
        return step, tuple(in_sh), (_logits_placed(cell, t_spec, ctx), c_sh)
    params, cache, tokens = args
    t_spec = batch_specs({"inputs": tokens}, ctx)["inputs"]
    c_sh = cache_shardings(cache, ctx)
    t_sh = _placed(t_spec, ctx)
    return (step, (param_shardings(params, ctx), c_sh, t_sh),
            (t_sh, _logits_placed(cell, t_spec, ctx), c_sh))
