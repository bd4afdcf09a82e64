"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

Dispatch is the JAX package's fixed-capacity radix idiom (the join
engine's ``partition.bucketize``: token -> expert routing is a relational
shuffle).  Assignments are ranked within their expert by a stable sort,
dropped past the capacity (GShard capacity-factor semantics, reported in
the aux stats), gathered into dense ``[E, C, d]`` blocks, run through the
experts' GLU FFNs as three batched matrix products, and combine-scattered
back with the router weights.  The products and the router are plain
large matrix products, outside any kernel in the JAX package too.

Capacities come from static shapes and every index is a device tensor, so
no call waits on the device; ``dropped`` stays a device scalar.  The
expert weights are f32 masters, cast to the compute dtype on every call
as the JAX package casts them.

The JAX package's expert-parallel dispatch (``moe_mlp_sharded``) runs
inside ``shard_map`` on the LM's mesh, which the port does not have yet:
``moe_mlp_auto`` always takes ``moe_mlp``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


class MoE(nn.Module):
    """The router ``[d, E]`` and the stacked expert weights ``gate``,
    ``up`` ``[E, d, ff]`` and ``down`` ``[E, ff, d]`` (one parameter each,
    not a module per expert), plus the optional shared GLU."""

    def __init__(self, router: layers.Linear, gate, up, down,
                 shared: layers.GLUMLP | None = None):
        super().__init__()
        self.router = router
        self.gate = layers._param(gate)
        self.up = layers._param(up)
        self.down = layers._param(down)
        self.shared = shared


def init_moe(gen: torch.Generator, cfg) -> MoE:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    router = layers.Linear(layers.normal(gen, (d, e), 1.0 / math.sqrt(d)))
    gate = layers.normal(gen, (e, d, ff), 1.0 / math.sqrt(d))
    up = layers.normal(gen, (e, d, ff), 1.0 / math.sqrt(d))
    down = layers.normal(gen, (e, ff, d), 1.0 / math.sqrt(ff))
    shared = (layers.init_glu_mlp(gen, d, ff * cfg.n_shared_experts)
              if cfg.n_shared_experts else None)
    return MoE(router, gate, up, down, shared)


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float = 1.25, align: int = 8) -> int:
    c = math.ceil(n_tokens * top_k / n_experts * factor)
    return max(align, math.ceil(c / align) * align)


def _route(xt, p: MoE, cfg):
    """f32 router probabilities [N, E] and the top-k (weights, experts)
    [N, k].  Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them: a stable descending sort keeps equal values in index
    order."""
    logits = xt.float() @ p.router.w
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = srt[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.norm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_i


def moe_mlp(x, p: MoE, cfg, capacity_factor: float = 1.25):
    """Returns (out [B, S, d], aux): aux ``{"aux_loss", "dropped"}`` f32
    device scalars, the Switch-style load-balance loss and the share of
    assignments dropped past the capacity."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n, e, k, capacity_factor)
    dev = x.device

    xt = x.reshape(n, d)
    probs, top_p, top_i = _route(xt, p, cfg)

    # ---- rank within the expert by a stable sort (the bucketize idiom) --
    flat_e = top_i.reshape(-1)                                  # [N*k]
    token_of = torch.arange(n * k, device=dev) // k
    weight_of = top_p.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e + 1, device=dev),
                                side="left")
    rank = torch.arange(n * k, device=dev) - starts[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, e * cap))          # drop slot

    # ---- gather the tokens into [E, C, d] expert blocks -----------------
    src = token_of[order]
    xe = x.new_zeros((e * cap + 1, d)).index_put((dest,), xt[src])
    xe = xe[:-1].reshape(e, cap, d)

    # ---- the experts' GLU FFNs, one batched product a projection --------
    g = torch.bmm(xe, p.gate.to(x.dtype))
    u = torch.bmm(xe, p.up.to(x.dtype))
    ye = torch.bmm(F.silu(g) * u, p.down.to(x.dtype))

    # ---- combine-scatter back with the router weights -------------------
    ye_flat = ye.reshape(e * cap, d)
    contrib = torch.where(
        keep[:, None],
        ye_flat[torch.clamp(dest, 0, e * cap - 1)]
        * weight_of[order][:, None].to(x.dtype),
        torch.zeros((), dtype=x.dtype, device=dev))
    out = x.new_zeros((n, d)).index_add(0, src, contrib)

    if p.shared is not None:
        out = out + layers.glu_mlp(xt, p.shared, cfg.act)

    # ---- aux: the load-balance loss and the dropped share ---------------
    me = probs.mean(dim=0)                                      # [E]
    # XLA compiles the JAX package's divisions by n k into products with
    # the f32 reciprocal, and ``1 - kept / (n k)`` into one fused
    # multiply-subtract (one rounding; with nothing dropped it gives
    # 1 - (n k)·f32(1/(n k)), e.g. -2.98e-8 at n k = 96): the same here,
    # the product and difference exact in f64, then rounded once
    inv = torch.ones((), dtype=torch.float32, device=dev) / (n * k)
    counts = torch.zeros((e,), dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    fe = counts.to(torch.float32) * inv
    aux_loss = e * torch.sum(me * fe)
    kept = keep.sum().to(torch.float64)
    dropped = (1.0 - kept * inv.to(torch.float64)).to(torch.float32)
    return out.reshape(b, s, d), {"aux_loss": aux_loss, "dropped": dropped}


def moe_mlp_sharded(x, p: MoE, cfg, capacity_factor: float = 1.25):
    """The JAX package's expert-parallel dispatch inside ``shard_map``:
    it needs the LM's mesh, which is not ported."""
    raise NotImplementedError(
        "moe_mlp_sharded: expert-parallel dispatch needs the LM's mesh, "
        "which is not ported yet (ROADMAP Queue A, \"the LM's mesh\"); "
        "moe_mlp runs every expert on one card")


def moe_mlp_auto(x, p: MoE, cfg):
    """The JAX package takes ``moe_mlp_sharded`` under a mesh with a
    usable "model" axis; the port has no LM mesh, so always ``moe_mlp``."""
    return moe_mlp(x, p, cfg)


def moe_mlp_dense_ref(x, p: MoE, cfg):
    """O(E) dense reference (every expert on every token): the oracle of
    the dispatch path, exact when nothing is dropped."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, top_p, top_i = _route(xt, p, cfg)
    w = torch.zeros_like(probs).scatter(1, top_i, top_p)        # [N, E]
    g = torch.einsum("nd,edf->enf", xt, p.gate.to(x.dtype))
    u = torch.einsum("nd,edf->enf", xt, p.up.to(x.dtype))
    ye = torch.einsum("enf,efd->end", F.silu(g) * u, p.down.to(x.dtype))
    out = torch.einsum("end,ne->nd", ye, w.to(x.dtype))
    if p.shared is not None:
        out = out + layers.glu_mlp(xt, p.shared, cfg.act)
    return out.reshape(b, s, d)
