"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule, as plain functions over lists of tensors.

The JAX package's functions map a parameter pytree to a new one; here
``params`` and ``grads`` are aligned lists of tensors (a model's
``parameters()`` and their gradients) and the update runs in place with
``torch._foreach_*`` ops: the parameters, the moments and the gradients
(which are consumed) are overwritten, so a step holds no second copy of
any of them.  The parameters are the model's f32 masters.  The
arithmetic is the JAX package's: decay is applied to every tensor, the
moments ``m``, ``v`` are f32, ``step`` is an int32
tensor, and the schedule and bias corrections are f32 tensors computed on
the parameters' device (no host sync).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    decay to ``min_lr_ratio`` of ``lr``; f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float, split=None,
                        group=None):
    """Scale ``grads`` in place so that their global L2 norm is at most
    ``max_norm``; returns (grads, the norm before clipping).

    Under tensor parallelism ``split[i]`` says that ``grads[i]`` is this
    rank's slice of a tensor split over the "model" ``group``: the norm
    sums those tensors' squares over the group and counts each
    replicated tensor (equal on every model rank) once."""
    norms = torch._foreach_norm(grads)      # one L2 norm per tensor
    if split is None or not any(split):
        gn = torch.linalg.vector_norm(torch.stack(norms))
    else:
        sq = torch.square(torch.stack(norms))
        mask = torch.tensor(split, device=sq.device)
        local = torch.where(mask, sq, 0.0).sum().reshape(1)
        dist.all_reduce(local, group=group)
        gn = torch.sqrt(local[0] + torch.where(mask, 0.0, sq).sum())
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, gn


def adamw_init(params) -> dict:
    """``{"m": [f32 zeros], "v": [f32 zeros], "step": int32 0}`` for the
    tensors of ``params``."""
    params = list(params)
    dev = params[0].device if params else None
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params: list, grads: list, state: dict, cfg: AdamWConfig,
                 split=None, group=None):
    """One AdamW step in place: clip ``grads``, update the moments, then
    ``p -= lr (m_hat / (sqrt(v_hat) + eps) + weight_decay p)``.  Returns
    (params, state with the new step, {"lr", "grad_norm"}); ``grads`` are
    overwritten with the applied update.  ``split`` / ``group``: the
    tensors held as slices over "model" (``clip_by_global_norm``); the
    update itself is elementwise, the same on a slice."""
    params, grads = list(params), list(grads)
    if any(t.dtype != torch.float32 for t in (*params, *grads)):
        raise TypeError("adamw_update: the parameters (f32 masters) and "
                        "their gradients must be float32")
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, split, group)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    ms, vs = state["m"], state["v"]
    torch._foreach_mul_(ms, cfg.b1)
    torch._foreach_add_(ms, grads, alpha=1 - cfg.b1)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_addcmul_(vs, grads, grads, value=1 - cfg.b2)
    # grads <- lr (m_hat / (sqrt(v_hat) + eps) + weight_decay p)
    torch._foreach_copy_(grads, vs)
    torch._foreach_div_(grads, bc2)
    torch._foreach_sqrt_(grads)
    torch._foreach_add_(grads, cfg.eps)
    torch._foreach_reciprocal_(grads)
    torch._foreach_mul_(grads, ms)
    torch._foreach_div_(grads, bc1)
    torch._foreach_add_(grads, params, alpha=cfg.weight_decay)
    torch._foreach_mul_(grads, lr)
    torch._foreach_sub_(params, grads)
    return params, {"m": ms, "v": vs, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
