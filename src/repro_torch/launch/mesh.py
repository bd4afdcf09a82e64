"""Production and host meshes over ``torch.distributed``.

The mesh builders are FUNCTIONS (never module-level constants), so
importing this module touches no process group.  Every rank is one
process: the default process group comes first (``init_world``, or the
caller's ``torch.distributed.init_process_group``), then a mesh over it.
A CUDA mesh is NCCL, one card a rank; a CPU mesh is gloo.  There is no
fallback from one to the other.

Mesh semantics (the JAX package's):
  single-pod: (16, 16)      axes ("data", "model")          = 256 ranks
  multi-pod:  (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

"pod" is the slow-link axis: only the data-parallel gradient reduction
crosses it.  The sharding rules are written against axis *names*
(``repro_torch.parallel.sharding``), so no model code depends on the
mesh's shape.  Start many ranks with ``torchrun``; a launcher started
without it runs a world of one rank.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.core.relation import resolve_device
from repro_torch.parallel import sharding as shd

# the collective backend a mesh's device type takes; there is no other
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _backend(device) -> tuple[torch.device, str]:
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no mesh backend for device {dev}; use \"cuda\" "
                         "(NCCL) or \"cpu\" (gloo)")
    return dev, _BACKENDS[dev.type]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device=None, timeout: float = 600.0) -> bool:
    """Initialise the default process group unless it already is: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) when it is set, else a world of one
    rank on a free ``localhost`` port.  On the card each rank takes card
    ``LOCAL_RANK``.  Returns True when this call created the group (the
    caller then destroys it)."""
    if dist.is_initialized():
        return False
    dev, backend = _backend(device)
    to = datetime.timedelta(seconds=timeout)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", timeout=to)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1, timeout=to)
    return True


def _need_world(n: int, what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs the default process group: call "
            "init_world() or torch.distributed.init_process_group(...) on "
            "every rank first")
    if dist.get_world_size() != n:
        raise ValueError(f"{what} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh of 256 ranks, or with
    ``multi_pod`` the (2, 16, 16) ("pod", "data", "model") mesh of 512;
    a world of any other size raises, naming the ranks it needs."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    dev, _ = _backend(device)
    n = 1
    for s in shape:
        n *= s
    _need_world(n, f"the production mesh {shape} {axes}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(max_devices: int | None = None, device=None):
    """A 1-D ("data",) mesh over the world's ranks, optionally the first
    ``max_devices`` of them (every rank calls this; a rank outside the
    mesh gets one with no coordinate)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    dev, _ = _backend(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs the default process group: call "
            "init_world() or torch.distributed.init_process_group(...) "
            "first")
    world = dist.get_world_size()
    n = min(world, max_devices) if max_devices else world
    if n == world:
        return init_device_mesh(dev.type, (n,), mesh_dim_names=("data",))
    return DeviceMesh(dev.type, torch.arange(n), mesh_dim_names=("data",))


def activate(mesh, rules_overrides: dict | None = None):
    """Install ``mesh`` as the process sharding context (the logical-axis
    rules of ``parallel.sharding``, with optional per-launch overrides)."""
    rules = dict(shd.DEFAULT_RULES)
    if rules_overrides:
        rules.update(rules_overrides)
    shd.set_context(mesh, rules)
    return mesh
