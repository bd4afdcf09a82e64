"""Carry state between numpy, the port and the JAX package's layout.

The state of a join is the relations' columns and validity: these helpers
build the port's relations from numpy arrays (and back), so the tests and
the smoke run feed both packages the same data.  The state of a language
model is its parameter tree and its KV cache: ``lm_params_from_numpy``
turns the JAX package's ``init_lm`` tree (numpy leaves, stacked ``[L, ...]``
per layer; dense, MoE and VLM) into a ``TransformerLM`` and
``lm_params_to_numpy`` back;
``cache_from_numpy`` carries a KV cache across.  The state of training is
the JAX package's ``TrainState(params, opt={"m", "v", "step"}, step)``:
``train_state_to_numpy`` gives it as nested dicts with numpy leaves (the
moments in the parameters' tree layout), ``train_state_from_numpy`` builds
the port's ``TrainState`` from such a tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.relation import Relation, as_int32, resolve_device
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.models.config import ModelConfig


def relation_from_numpy(columns: Mapping[str, np.ndarray], valid=None,
                        capacity: int | None = None, device=None) -> Relation:
    """A Relation from equal-length numpy columns.

    Without ``valid`` every given row is live and ``capacity`` pads with
    dead rows; with ``valid`` the arrays already span the capacity and
    ``valid`` marks the live slots.  ``device=None`` means the card.
    """
    if valid is None:
        return Relation.from_arrays(capacity=capacity, device=device,
                                    **columns)
    dev = resolve_device(device)
    valid = np.array(valid, dtype=bool)
    cols = {k: as_int32(v, dev) for k, v in columns.items()}
    for k, v in cols.items():
        if v.shape != valid.shape:
            raise ValueError(f"column {k!r} has shape {tuple(v.shape)}, "
                             f"valid has {valid.shape}")
    if capacity is not None and capacity != valid.shape[0]:
        raise ValueError(f"capacity {capacity} != {valid.shape[0]} slots")
    return Relation(cols, torch.from_numpy(valid).to(dev))


def relation_to_numpy(rel: Relation) -> dict:
    """``{"columns": {name: int32 array}, "valid": bool array,
    "capacity": int}`` — every slot, padding included."""
    return {"columns": {k: v.cpu().numpy() for k, v in rel.columns.items()},
            "valid": rel.valid.cpu().numpy(),
            "capacity": rel.capacity}


def relation_from_reference_arrays(d: Mapping, device=None) -> Relation:
    """The port's Relation from the numpy arrays of a JAX-package Relation:
    ``{"columns": {...}, "valid": ..., "capacity": ...}`` (the shape
    ``relation_to_numpy`` returns), padding slots included."""
    return relation_from_numpy(d["columns"], valid=d["valid"],
                               capacity=d.get("capacity"), device=device)


# --------------------------------------------------------------------------
# language-model parameters and caches
# --------------------------------------------------------------------------

def _tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 too, as ``np.asarray`` gives it from JAX) as
    a tensor of the same dtype on ``device``."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x)).to(device)


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device=None) -> transformer.TransformerLM:
    """The port's ``TransformerLM`` from the JAX package's ``init_lm``
    parameter tree with numpy leaves (dense or MoE blocks under
    ``layers``, the VLM's cross blocks under ``cross_layers``);
    ``device=None`` means the card."""
    dev = resolve_device(device)
    lay = tree["layers"]
    n_layers = np.asarray(lay["ln_attn"]["scale"]).shape[0]
    if n_layers != cfg.n_layers:
        raise ValueError(f"the tree has {n_layers} layers, {cfg.name} has "
                         f"{cfg.n_layers}")

    def t(x):
        return _tensor(np.asarray(x, dtype=np.float32), dev)

    def lin(d, i):
        return layers.Linear(t(d["w"][i]), t(d["b"][i]) if "b" in d else None)

    def norm(d, i):
        return layers.RMSNorm(t(d["scale"][i]))

    def glu(d, i):
        return layers.GLUMLP(*(lin(d[n], i) for n in ("gate", "up", "down")))

    def attn(a, i):
        qk = ((norm(a["q_norm"], i), norm(a["k_norm"], i))
              if "q_norm" in a else ())
        return attention.Attention(*(lin(a[n], i) for n in
                                     ("wq", "wk", "wv", "wo")), *qk)

    def ffn(i):
        if "moe" not in lay:
            return {"mlp": glu(lay["mlp"], i)}
        m = lay["moe"]
        return {"moe": moe.MoE(lin(m["router"], i), t(m["gate"][i]),
                               t(m["up"][i]), t(m["down"][i]),
                               glu(m["shared"], i) if "shared" in m
                               else None)}

    blocks = [transformer.Block(norm(lay["ln_attn"], i),
                                attn(lay["attn"], i),
                                norm(lay["ln_mlp"], i), **ffn(i))
              for i in range(n_layers)]
    cross = tree.get("cross_layers", {})
    n_cross = (np.asarray(cross["ln"]["scale"]).shape[0] if cross else 0)
    if n_cross != transformer.n_cross_layers(cfg):
        raise ValueError(f"the tree has {n_cross} cross layers, {cfg.name} "
                         f"has {transformer.n_cross_layers(cfg)}")
    cross_blocks = [transformer.CrossBlock(norm(cross["ln"], j),
                                           attn(cross["xattn"], j))
                    for j in range(n_cross)]
    head = (layers.Embed(t(tree["lm_head"]["table"])) if "lm_head" in tree
            else None)
    return transformer.TransformerLM(
        cfg, layers.Embed(t(tree["embed"]["table"])), blocks,
        layers.RMSNorm(t(tree["final_norm"]["scale"])), head, cross_blocks)


def lm_params_to_numpy(params: transformer.TransformerLM) -> dict:
    """The JAX package's parameter tree (numpy f32 leaves, per-layer
    leaves stacked ``[L, ...]`` under ``"layers"`` and the cross blocks'
    under ``"cross_layers"``) of a TransformerLM."""
    return _tree_of(leaf_paths(params), params.parameters())


def cache_from_numpy(cache: Mapping, device=None) -> dict:
    """A KV cache ``{"k", "v": [L, B, T, KVH, D], "length"}`` (and the
    VLM's ``"memory"``) with numpy leaves (bfloat16 too) as the port's
    cache, dtypes kept."""
    dev = resolve_device(device)
    out = {"k": _tensor(cache["k"], dev), "v": _tensor(cache["v"], dev),
           "length": int(np.asarray(cache["length"]))}
    if "memory" in cache:
        out["memory"] = _tensor(cache["memory"], dev)
    return out


# --------------------------------------------------------------------------
# training state
# --------------------------------------------------------------------------

_STACKS = {"blocks": "layers", "cross_blocks": "cross_layers"}


def leaf_paths(params: transformer.TransformerLM) -> list[tuple[str, int]]:
    """For each tensor of ``params.parameters()``, in that order: its
    ``/``-joined path in the JAX parameter tree and its index in its
    stack (``layers`` or ``cross_layers``; -1 outside them)."""
    out = []
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] in _STACKS:
            out.append(("/".join([_STACKS[parts[0]], *parts[2:]]),
                        int(parts[1])))
        else:
            out.append(("/".join(parts), -1))
    return out


def stack_length(cfg: ModelConfig, path: str) -> int:
    """The stacked leading dimension of the JAX tree's leaf at ``path``
    (a path ``leaf_paths`` gives with an index >= 0)."""
    if path.startswith("cross_layers/"):
        return transformer.n_cross_layers(cfg)
    return cfg.n_layers


def _tree_of(paths: list[tuple[str, int]], tensors) -> dict:
    """The JAX tree (numpy f32 leaves, layers stacked) of ``tensors``,
    aligned with ``paths``."""
    flat: dict = {}
    for (path, layer), x in zip(paths, tensors):
        arr = x.detach().float().cpu().numpy()
        if layer >= 0:
            flat.setdefault(path, []).append(arr)
        else:
            flat[path] = arr
    tree: dict = {}
    for path, arr in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(arr) if isinstance(arr, list) else arr
    return tree


def _leaf(tree: Mapping, path: str, layer: int):
    node = tree
    for part in path.split("/"):
        node = node[part]
    arr = np.asarray(node)
    return arr[layer] if layer >= 0 else arr


def train_state_to_numpy(state) -> dict:
    """The JAX package's ``TrainState`` tree of a port ``TrainState``:
    ``{"params": ..., "opt": {"m": ..., "v": ..., "step"}, "step"}`` with
    numpy leaves (f32; the steps int32 scalars)."""
    paths = leaf_paths(state.params)
    step = np.asarray(int(state.step), np.int32)
    return {"params": lm_params_to_numpy(state.params),
            "opt": {"m": _tree_of(paths, state.opt["m"]),
                    "v": _tree_of(paths, state.opt["v"]),
                    "step": np.asarray(int(state.opt["step"]), np.int32)},
            "step": step}


def train_state_from_numpy(tree: Mapping, cfg: ModelConfig, device=None):
    """The port's ``TrainState`` from the JAX package's ``TrainState`` tree
    with numpy leaves (as ``train_state_to_numpy`` gives it, or as
    ``jax.tree.map(np.asarray, state._asdict())``); ``device=None`` means
    the card."""
    from repro_torch.train.steps import TrainState
    dev = resolve_device(device)
    params = lm_params_from_numpy(tree["params"], cfg, device=dev)
    paths = leaf_paths(params)

    def moments(t):
        return [_tensor(np.asarray(_leaf(t, p, i), np.float32), dev)
                for p, i in paths]

    opt = tree["opt"]

    def step(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)

    return TrainState(params, {"m": moments(opt["m"]), "v": moments(opt["v"]),
                               "step": step(opt["step"])},
                      step(tree["step"]))
