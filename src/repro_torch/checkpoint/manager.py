"""Fault-tolerant checkpointing: atomic, resumable, in the JAX package's
format.

Format: one ``step_XXXXXXXX/`` directory per checkpoint step holding
``arrays.npz`` (the flattened tree, keyed by ``/``-joined tree paths) and
``manifest.json`` (step, time, keys, a sha256 of ``arrays.npz``, a
reserved ``shards`` field), plus a ``COMMITTED`` marker.  A port
``TrainState`` is written as the JAX package's ``TrainState`` tree
(``convert.train_state_to_numpy``: ``params/...``, ``opt/m/...``,
``opt/v/...``, ``opt/step``, ``step``; per-layer leaves stacked
``[L, ...]``), so a checkpoint of either package restores in the other.
Writes go to a temporary directory that is renamed when complete; a
checkpoint without its ``COMMITTED`` marker is ignored by restore.  Arrays
are saved unsharded, on the host; ``restore_pytree`` places them on
``device``, and with ``shardings`` (a matching tree of ``(mesh,
placements)``, e.g. ``launch.specs.state_shardings``) distributes each
leaf onto its mesh as a DTensor: a checkpoint restores onto any mesh,
whatever the mesh it was saved from.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import time
from typing import Mapping

import numpy as np
import torch

_SEP = "/"


def _is_train_state(x) -> bool:
    from repro_torch.train.steps import TrainState
    return isinstance(x, TrainState)


def _flatten(tree, prefix: str = "") -> dict:
    """``/``-joined path -> numpy array of a tree of mappings whose leaves
    are arrays or tensors; a port TrainState as the JAX package's
    TrainState tree."""
    if _is_train_state(tree):
        from repro_torch import convert
        tree = convert.train_state_to_numpy(tree)
    if not isinstance(tree, Mapping):
        arr = (tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
               else np.asarray(tree))
        return {prefix: arr}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return flat


def save_pytree(tree, directory: str | os.PathLike, step: int,
                extra_meta: dict | None = None) -> pathlib.Path:
    """Atomic checkpoint write; returns the committed directory."""
    root = pathlib.Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = _flatten(tree)
    arrays_path = tmp / "arrays.npz"
    np.savez(arrays_path, **flat)
    digest = hashlib.sha256(arrays_path.read_bytes()).hexdigest()
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "sha256": digest,
        "shards": None,           # reserved: per-host shard layout
        **(extra_meta or {}),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    (tmp / "COMMITTED").write_text(digest)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)             # atomic on POSIX
    return final


def _is_committed(path: pathlib.Path) -> bool:
    return (path / "COMMITTED").exists() and (path / "manifest.json").exists()


def latest_step(directory: str | os.PathLike) -> int | None:
    root = pathlib.Path(directory)
    if not root.exists():
        return None
    steps = []
    for p in root.iterdir():
        if p.name.startswith("step_") and _is_committed(p):
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _template_shapes(template) -> dict:
    """``/``-joined path -> shape of every leaf of ``template``, without
    copying a port TrainState's tensors off the device."""
    if not _is_train_state(template):
        return {k: tuple(v.shape) for k, v in _flatten(template).items()}
    from repro_torch import convert
    cfg = template.params.cfg
    shapes = {}
    for (path, layer), p in zip(convert.leaf_paths(template.params),
                                template.params.parameters()):
        shape = ((convert.stack_length(cfg, path), *p.shape) if layer >= 0
                 else tuple(p.shape))
        for top in ("params", "opt/m", "opt/v"):
            shapes[f"{top}{_SEP}{path}"] = shape
    shapes.update({"opt/step": (), "step": ()})
    return shapes


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split(_SEP)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _rebuild(template, tree, device):
    """``tree`` (nested dicts of numpy arrays) in the structure of the
    mapping ``template``, leaves as tensors on ``device``."""
    from repro_torch.convert import _tensor
    if isinstance(template, Mapping):
        return {k: _rebuild(v, tree[str(k)], device)
                for k, v in template.items()}
    return _tensor(tree, device)


def _distribute(x: torch.Tensor, sharding):
    """``x`` distributed onto ``sharding = (mesh, placements)`` (every rank
    holds the whole ``x``; each keeps its shard), or as it is for None."""
    if sharding is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = sharding
    return distribute_tensor(x, mesh, list(placements))


def _place_tree(tree, shardings):
    if isinstance(tree, Mapping):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    return _distribute(tree, shardings)


def _place_state(state, shardings):
    """A port TrainState with each tensor distributed by the matching
    ``TrainState`` of shardings (parameters in ``parameters()`` order,
    which the moments' lists follow)."""
    from torch import nn

    from repro_torch.train.steps import TrainState
    params = state.params
    for (name, p), sh in zip(list(params.named_parameters()),
                             shardings.params):
        if sh is not None:
            owner, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(owner), leaf, nn.Parameter(
                _distribute(p.detach(), sh), requires_grad=p.requires_grad))
    opt = {k: [_distribute(x, sh) for x, sh in zip(state.opt[k],
                                                   shardings.opt[k])]
           for k in ("m", "v")}
    opt["step"] = _distribute(state.opt["step"], shardings.opt["step"])
    return TrainState(params, opt, _distribute(state.step, shardings.step))


def restore_pytree(template, directory: str | os.PathLike,
                   step: int | None = None, device=None,
                   verify: bool = True, shardings=None):
    """Restore into the structure of ``template``: a port TrainState (its
    config and layout; its tensors are not read) or a tree of mappings of
    arrays or tensors.  Returns (the restored tree, leaves as tensors on
    ``device``, and the manifest); ``device=None`` means the card.
    ``shardings``: a matching tree of ``(mesh, placements)`` (None for a
    leaf that stays a plain tensor); each leaf is distributed onto its
    mesh as a DTensor (elastic re-mesh)."""
    from repro_torch import convert
    from repro_torch.core.relation import resolve_device
    dev = resolve_device(device)
    root = pathlib.Path(directory)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {root}")
    path = root / f"step_{step:08d}"
    if not _is_committed(path):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    manifest = json.loads((path / "manifest.json").read_text())
    if verify:
        digest = hashlib.sha256((path / "arrays.npz").read_bytes()).hexdigest()
        if digest != manifest["sha256"]:
            raise IOError(f"checkpoint {path} corrupt (checksum mismatch)")
    flat = {}
    with np.load(path / "arrays.npz") as data:
        for key, shape in _template_shapes(template).items():
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{key}: shape {arr.shape} != template "
                                 f"{shape}")
            flat[key] = arr
    tree = _unflatten(flat)
    if _is_train_state(template):
        state = convert.train_state_from_numpy(tree, template.params.cfg,
                                               device=dev)
        if shardings is not None:
            state = _place_state(state, shardings)
        return state, manifest
    out = _rebuild(template, tree, dev)
    if shardings is not None:
        out = _place_tree(out, shardings)
    return out, manifest


class CheckpointManager:
    """Retention + cadence policy around save/restore."""

    def __init__(self, directory: str | os.PathLike, *, every: int = 100,
                 keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.every = every
        self.keep = keep

    def should_save(self, step: int) -> bool:
        return self.every > 0 and step > 0 and step % self.every == 0

    def save(self, tree, step: int, extra_meta: dict | None = None):
        path = save_pytree(tree, self.dir, step, extra_meta)
        self._gc()
        return path

    def restore(self, template, step: int | None = None, device=None,
                shardings=None):
        return restore_pytree(template, self.dir, step, device,
                              shardings=shardings)

    def latest_step(self):
        return latest_step(self.dir)

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.iterdir()
            if p.name.startswith("step_") and _is_committed(p))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
