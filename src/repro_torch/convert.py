"""Carry state between numpy, the port and the JAX package's layout.

The state of a join is the relations' columns and validity: these helpers
build the port's relations from numpy arrays (and back), so the tests and
the smoke run feed both packages the same data.  The state of a language
model is its parameter tree and its serving cache:
``lm_params_from_numpy`` turns the JAX package's ``init_lm`` /
``init_encdec`` tree (numpy leaves, stacked ``[L, ...]`` per layer) into
the port's model of the config's family (``TransformerLM``, ``HybridLM``
or ``EncDecLM``) and ``lm_params_to_numpy`` back; ``cache_from_numpy``
carries a cache across (KV, SSM state and conv window, memory).  The
state of training is the JAX package's ``TrainState(params, opt={"m",
"v", "step"}, step)``:
``train_state_to_numpy`` gives it as nested dicts with numpy leaves (the
moments in the parameters' tree layout), ``train_state_from_numpy`` builds
the port's ``TrainState`` from such a tree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.relation import Relation, as_int32, resolve_device
from repro_torch.models import (attention, encdec, hybrid, layers, moe,
                                ssm, transformer)
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


class _Loader:
    """Modules of the port from the JAX tree's leaves (numpy, f32 on
    ``dev``); ``i`` indexes a stacked leaf, -1 takes it whole."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def t(self, x, i=-1):
        x = np.asarray(x, dtype=np.float32)
        return _tensor(x[i] if i >= 0 else x, self.dev)

    def lin(self, d, i=-1):
        return layers.Linear(self.t(d["w"], i),
                             self.t(d["b"], i) if "b" in d else None)

    def norm(self, d, i=-1):
        return layers.RMSNorm(self.t(d["scale"], i))

    def glu(self, d, i=-1):
        return layers.GLUMLP(*(self.lin(d[n], i)
                               for n in ("gate", "up", "down")))

    def attn(self, a, i=-1):
        qk = ((self.norm(a["q_norm"], i), self.norm(a["k_norm"], i))
              if "q_norm" in a else ())
        return attention.Attention(*(self.lin(a[n], i) for n in
                                     ("wq", "wk", "wv", "wo")), *qk)

    def block(self, d, i=-1):
        """A dense ``transformer.Block`` (no MoE)."""
        return transformer.Block(self.norm(d["ln_attn"], i),
                                 self.attn(d["attn"], i),
                                 self.norm(d["ln_mlp"], i),
                                 mlp=self.glu(d["mlp"], i))

    def ssm_block(self, d, i):
        s = d["ssm"]
        mixer = ssm.SSM(self.lin(s["in_proj"], i),
                        ssm.DepthwiseConv(self.t(s["conv"]["w"], i),
                                          self.t(s["conv"]["b"], i)),
                        self.t(s["a_log"], i), self.t(s["dt_bias"], i),
                        self.t(s["d_skip"], i), self.norm(s["gate_norm"], i),
                        self.lin(s["out_proj"], i))
        return hybrid.SSMBlock(self.norm(d["ln"], i), mixer)

    def dec_block(self, d, i):
        return encdec.DecBlock(self.norm(d["ln_attn"], i),
                               self.attn(d["attn"], i),
                               self.norm(d["ln_cross"], i),
                               self.attn(d["xattn"], i),
                               self.norm(d["ln_mlp"], i),
                               self.glu(d["mlp"], i))


def _stack_len(tree: Mapping, key: str, leaf: str, want: int,
               cfg: ModelConfig) -> int:
    """The leading dimension of ``tree[key]``'s stacked leaves (read at
    ``leaf``; 0 where the tree has no ``key``), which must be the
    config's ``want``."""
    n = 0
    if key in tree:
        node = tree[key]
        for part in leaf.split("/"):
            node = node[part]
        n = np.asarray(node).shape[0]
    if n != want:
        raise ValueError(f"the tree has {n} {key}, {cfg.name} has {want}")
    return n


def _placed(obj, mesh):
    """``obj`` placed onto this rank's "model" slices of ``mesh``
    (``launch.specs.place_model``), or as it is without a mesh."""
    if mesh is None:
        return obj
    from repro_torch.launch import specs
    return specs.place_model(obj, mesh)


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                         mesh=None):
    """The model, placed onto this rank of ``mesh``'s "model" axis when
    given one (``_lm_params_from_numpy`` says how it is built)."""
    return _placed(_lm_params_from_numpy(tree, cfg, device), mesh)


def _lm_params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None):
    """The port's model from the JAX package's parameter tree with numpy
    leaves (``init_lm`` / ``init_encdec``; per-layer leaves stacked
    ``[L, ...]``), by the config's family: a ``TransformerLM`` (dense or
    MoE blocks under ``layers``, the VLM's cross blocks under
    ``cross_layers``), a ``hybrid.HybridLM`` (SSM blocks under ``layers``,
    the hybrid's unstacked ``shared_block``) or an ``encdec.EncDecLM``
    (``enc_layers``, ``dec_layers``); ``device=None`` means the card."""
    dev = resolve_device(device)
    ld = _Loader(dev)
    head = (layers.Embed(ld.t(tree["lm_head"]["table"]))
            if "lm_head" in tree else None)
    embed = layers.Embed(ld.t(tree["embed"]["table"]))
    final_norm = ld.norm(tree["final_norm"])
    if cfg.family in ("ssm", "hybrid"):
        n = _stack_len(tree, "layers", "ln/scale", cfg.n_layers, cfg)
        blocks = [ld.ssm_block(tree["layers"], i) for i in range(n)]
        shared = (ld.block(tree["shared_block"]) if cfg.is_hybrid
                  else None)
        return hybrid.HybridLM(cfg, embed, blocks, final_norm, shared, head)
    if cfg.family in ("encdec", "audio"):
        ne = _stack_len(tree, "enc_layers", "ln_attn/scale",
                        cfg.n_enc_layers, cfg)
        nd = _stack_len(tree, "dec_layers", "ln_attn/scale", cfg.n_layers,
                        cfg)
        return encdec.EncDecLM(
            cfg, embed, [ld.block(tree["enc_layers"], i) for i in range(ne)],
            ld.norm(tree["enc_norm"]),
            [ld.dec_block(tree["dec_layers"], i) for i in range(nd)],
            final_norm, head)
    lay = tree["layers"]
    n_layers = _stack_len(tree, "layers", "ln_attn/scale", cfg.n_layers,
                          cfg)

    def ffn(i):
        if "moe" not in lay:
            return {"mlp": ld.glu(lay["mlp"], i)}
        m = lay["moe"]
        return {"moe": moe.MoE(ld.lin(m["router"], i), ld.t(m["gate"], i),
                               ld.t(m["up"], i), ld.t(m["down"], i),
                               ld.glu(m["shared"], i) if "shared" in m
                               else None)}

    blocks = [transformer.Block(ld.norm(lay["ln_attn"], i),
                                ld.attn(lay["attn"], i),
                                ld.norm(lay["ln_mlp"], i), **ffn(i))
              for i in range(n_layers)]
    n_cross = _stack_len(tree, "cross_layers", "ln/scale",
                         transformer.n_cross_layers(cfg), cfg)
    cross = tree.get("cross_layers", {})
    cross_blocks = [transformer.CrossBlock(ld.norm(cross["ln"], j),
                                           ld.attn(cross["xattn"], j))
                    for j in range(n_cross)]
    return transformer.TransformerLM(cfg, embed, blocks, final_norm, head,
                                     cross_blocks)


def lm_params_to_numpy(params, mesh=None) -> dict:
    """The JAX package's parameter tree (numpy f32 leaves, per-layer
    leaves stacked ``[L, ...]`` under their stack's key, ``leaf_paths``)
    of any of the port's models; a model placed over "model" is gathered
    over ``mesh``'s "model" group first."""
    if getattr(params, "model_split", None) is not None:
        from repro_torch.launch import specs
        params = specs.gather_model_state(params, mesh)
    return _tree_of(leaf_paths(params), params.parameters())


def cache_from_numpy(cache: Mapping, device=None) -> dict:
    """A serving cache with numpy leaves (bfloat16 too) as the port's,
    dtypes kept: the KV cache ``{"k", "v": [L, B, T, KVH, D], "length"}``
    (and the VLM's and enc-dec's ``"memory"``), or the SSM/hybrid cache
    (``"state"``, ``"conv"``, ``"length"``, and the hybrid's ``"k"``,
    ``"v"``)."""
    dev = resolve_device(device)
    out = {k: _tensor(v, dev) for k, v in cache.items() if k != "length"}
    out["length"] = int(np.asarray(cache["length"]))
    return out


# --------------------------------------------------------------------------
# training state
# --------------------------------------------------------------------------

# the port's module lists -> the JAX tree's stacked keys
_STACKS = {"blocks": "layers", "cross_blocks": "cross_layers",
           "enc_blocks": "enc_layers", "dec_blocks": "dec_layers"}


def leaf_paths(params) -> list[tuple[str, int]]:
    """For each tensor of ``params.parameters()``, in that order: its
    ``/``-joined path in the JAX parameter tree and its index in its
    stack (``layers``, ``cross_layers``, ``enc_layers`` or
    ``dec_layers``; -1 outside them, as for the hybrid's
    ``shared_block``)."""
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
    if path.startswith("enc_layers/"):
        return cfg.n_enc_layers
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


def train_state_to_numpy(state, mesh=None) -> dict:
    """The JAX package's ``TrainState`` tree of a port ``TrainState``:
    ``{"params": ..., "opt": {"m": ..., "v": ..., "step"}, "step"}`` with
    numpy leaves (f32; the steps int32 scalars).  A state placed over
    "model" is gathered over ``mesh``'s "model" group first (every rank
    of the group calls this)."""
    if getattr(state.params, "model_split", None) is not None:
        from repro_torch.launch import specs
        state = specs.gather_model_state(state, mesh)
    paths = leaf_paths(state.params)
    step = np.asarray(int(state.step), np.int32)
    return {"params": lm_params_to_numpy(state.params),
            "opt": {"m": _tree_of(paths, state.opt["m"]),
                    "v": _tree_of(paths, state.opt["v"]),
                    "step": np.asarray(int(state.opt["step"]), np.int32)},
            "step": step}


def train_state_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                           mesh=None):
    """The port's ``TrainState`` from the JAX package's ``TrainState`` tree
    with numpy leaves (as ``train_state_to_numpy`` gives it, or as
    ``jax.tree.map(np.asarray, state._asdict())``); ``device=None`` means
    the card.  With ``mesh``, placed onto this rank's "model" slices
    (parameters and moments)."""
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

    return _placed(TrainState(params, {"m": moments(opt["m"]),
                                       "v": moments(opt["v"]),
                                       "step": step(opt["step"])},
                              step(tree["step"])), mesh)
