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

Under the LM's mesh (``parallel.sharding``'s context) ``moe_mlp_auto``
takes the expert-parallel dispatch, ``moe_mlp_sharded``: each rank
routes its own rows of the batch axes, keeps the assignments of its
``n_experts / tp`` local experts, runs their FFNs, and one ``all_reduce``
over "model" merges the combine (the JAX package's ``shard_map`` body,
rank for rank).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.parallel import sharding


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


def _ranks(top_i, e: int, cap: int):
    """Each assignment's rank within its expert by a stable sort (the
    bucketize idiom): the flat experts [N*k], the sort order, the sorted
    experts, their ranks, and which are kept under the capacity."""
    dev = top_i.device
    flat_e = top_i.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e + 1, device=dev),
                                side="left")
    rank = torch.arange(flat_e.numel(), device=dev) - starts[sorted_e]
    return flat_e, order, sorted_e, rank, rank < cap


def _experts(x, xt, weights, ffn, cap: int, order, sorted_e, rank, use,
             lo: int, n_exp: int, k: int):
    """The GLU FFNs of experts [lo, lo + n_exp) (``ffn``: their gate, up
    and down weights in the compute dtype) over the sorted assignments
    ``use`` selects: gathered into [n_exp, cap, d] blocks, run as three
    batched products, and combine-scattered back onto the tokens with
    the router ``weights`` [N*k], in f32."""
    n, d = xt.shape
    dest = torch.where(use, (sorted_e - lo) * cap + rank,
                       torch.full_like(rank, n_exp * cap))     # drop slot
    src = order // k                                           # token
    xe = x.new_zeros((n_exp * cap + 1, d)).index_put((dest,), xt[src])
    xe = xe[:-1].reshape(n_exp, cap, d)
    gate, up, down = ffn
    ye = torch.bmm(F.silu(torch.bmm(xe, gate)) * torch.bmm(xe, up), down)
    contrib = torch.where(
        use[:, None],
        ye.reshape(n_exp * cap, d)[torch.clamp(dest, 0, n_exp * cap - 1)]
        * weights[order][:, None].to(x.dtype),
        torch.zeros((), dtype=x.dtype, device=x.device))
    # the k contributions of a token are summed in f32 and rounded once:
    # a bf16 index_add on the card rounds after every atomic add, in an
    # order that changes from run to run (f32 inputs: the same sums)
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    return out.index_add_(0, src, contrib.float()).to(x.dtype)


def _aux(probs, flat_e, keep, e: int):
    """The Switch-style load-balance loss and the share of assignments
    dropped past the capacity, f32 device scalars."""
    dev = probs.device
    nk = flat_e.numel()
    me = probs.mean(dim=0)                                      # [E]
    # XLA compiles the JAX package's divisions by n k into products with
    # the f32 reciprocal, and ``1 - kept / (n k)`` into one fused
    # multiply-subtract (one rounding; with nothing dropped it gives
    # 1 - (n k)·f32(1/(n k)), e.g. -2.98e-8 at n k = 96): the same here,
    # the product and difference exact in f64, then rounded once
    inv = torch.ones((), dtype=torch.float32, device=dev) / nk
    counts = torch.zeros((e,), dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    fe = counts.to(torch.float32) * inv
    aux_loss = e * torch.sum(me * fe)
    kept = keep.sum().to(torch.float64)
    dropped = (1.0 - kept * inv.to(torch.float64)).to(torch.float32)
    return aux_loss, dropped


def moe_mlp(x, p: MoE, cfg, capacity_factor: float = 1.25):
    """Returns (out [B, S, d], aux): aux ``{"aux_loss", "dropped"}`` f32
    device scalars, the Switch-style load-balance loss and the share of
    assignments dropped past the capacity."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n, e, k, capacity_factor)
    xt = x.reshape(n, d)
    probs, top_p, top_i = _route(xt, p, cfg)
    flat_e, order, sorted_e, rank, keep = _ranks(top_i, e, cap)
    ffn = (p.gate.to(x.dtype), p.up.to(x.dtype), p.down.to(x.dtype))
    out = _experts(x, xt, top_p.reshape(-1), ffn, cap, order, sorted_e,
                   rank, keep, 0, e, k)
    if p.shared is not None:
        out = out + layers.glu_mlp(xt, p.shared, cfg.act)
    aux_loss, dropped = _aux(probs, flat_e, keep, e)
    return out.reshape(b, s, d), {"aux_loss": aux_loss, "dropped": dropped}


class _ToModelShards(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over "model": a
    replicated input of the rank-local expert region (each model rank's
    gradient holds only its local experts' part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _FromModelShards(torch.autograd.Function):
    """``all_reduce`` over "model" forward (merging the local experts'
    combines); the identity backward, since every model rank then holds
    the same gradient of the merged output."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _LocalExperts(torch.autograd.Function):
    """Rows [lo, lo + n) of an expert weight held whole on every rank; the
    backward places their gradient in a whole-sized zero tensor and sums
    it over "model", so every rank gets every expert's gradient."""

    @staticmethod
    def forward(ctx, w, lo, n, group):
        ctx.lo, ctx.n, ctx.group, ctx.shape = lo, n, group, w.shape
        return w[lo:lo + n]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.lo:ctx.lo + ctx.n] = g
        torch.distributed.all_reduce(full, group=ctx.group)
        return full, None, None, None


def _batch_mean(x, mesh, batch_axes, straight_through: bool = False):
    """The mean of a 0-d ``x`` over the batch axes (the JAX package's
    ``pmean``s): each rank's value gathered and summed in rank order.
    With ``straight_through`` the result carries this rank's own gradient
    (``x`` plus a detached correction): the data-parallel average of the
    ranks' gradients is then the gradient of the mean."""
    out = x.detach()
    for ax in batch_axes:
        group = mesh.get_group(ax)
        n = torch.distributed.get_world_size(group)
        parts = out.new_empty((n,))
        torch.distributed.all_gather_into_tensor(parts, out.reshape(1),
                                                 group=group)
        acc = parts[0]
        for i in range(1, n):
            acc = acc + parts[i]
        out = acc / n
    return x + (out - x.detach()) if straight_through else out


def moe_mlp_sharded(x, p: MoE, cfg, capacity_factor: float = 1.25):
    """Expert-parallel dispatch on the mesh of the current sharding
    context: the paper's partition phase on the mesh.

    ``x`` [b, s, d] is this rank's rows of the batch axes ("pod",
    "data"); it is replicated over "model".  The capacity is this shard's
    (from its b·s tokens).  Each model rank ranks every assignment within
    its expert as ``moe_mlp`` does, keeps those of its local experts
    [m·E/tp, (m+1)·E/tp) under the capacity, runs their FFNs, and one
    ``all_reduce`` over "model" merges the combine.  ``aux_loss`` and
    ``dropped`` are this shard's, averaged over the batch axes.

    Gradients are the true derivative of the meshed computation: the
    rank-local region sums its inputs' gradients over "model" (the
    tokens and the router weights), the expert weights, held whole on
    every rank, get every expert's gradient by a sum over "model", and
    the aux loss's gradient is this shard's (the data-parallel average
    over the batch axes makes it the mean's).  Every model rank ends
    with the same gradients; the train step averages them over the
    batch axes."""
    ctx = sharding.current_context()
    if ctx is None or not hasattr(ctx.mesh, "get_group"):
        raise RuntimeError(
            "moe_mlp_sharded runs on the LM's mesh: activate a DeviceMesh "
            "with a \"model\" axis first (launch.mesh.activate)")
    mesh = ctx.mesh
    sizes = ctx.shape
    batch_axes = tuple(a for a in sharding.BATCH_AXES if a in sizes)
    group = mesh.get_group("model")
    e, k = cfg.n_experts, cfg.top_k
    tp = sizes["model"]
    e_loc = e // tp
    lo = mesh.get_local_rank("model") * e_loc
    b, s, d = x.shape
    n = b * s
    cap = _capacity(n, e, k, capacity_factor)
    xt = x.reshape(n, d)
    probs, top_p, top_i = _route(xt, p, cfg)
    flat_e, order, sorted_e, rank, keep = _ranks(top_i, e, cap)
    # local-expert ownership: this rank owns [lo, lo + e_loc)
    mine = keep & (sorted_e >= lo) & (sorted_e < lo + e_loc)
    ffn = tuple(_LocalExperts.apply(w, lo, e_loc, group).to(x.dtype)
                for w in (p.gate, p.up, p.down))
    out = _experts(x, _ToModelShards.apply(xt, group),
                   _ToModelShards.apply(top_p, group).reshape(-1), ffn, cap,
                   order, sorted_e, rank, mine, lo, e_loc, k)
    out = _FromModelShards.apply(out, group)      # merge the expert shards
    if p.shared is not None:
        out = out + layers.glu_mlp(xt, p.shared, cfg.act)
    # this shard's aux values, as moe_mlp computes them, then their mean
    aux_loss, dropped = _aux(probs, flat_e, keep, e)
    aux_loss = _batch_mean(aux_loss, mesh, batch_axes, straight_through=True)
    dropped = _batch_mean(dropped, mesh, batch_axes)
    return out.reshape(b, s, d), {"aux_loss": aux_loss, "dropped": dropped}


def moe_mlp_auto(x, p: MoE, cfg):
    """The expert-parallel path under a mesh context with a usable "model"
    axis (> 1, dividing the experts) while the batch is split over the
    batch axes (``sharding.replicated_batch`` marks where it is not: the
    JAX package's ``x.shape[0] % n_batch_shards`` test); else
    ``moe_mlp``."""
    ctx = sharding.current_context()
    if (getattr(cfg, "moe_impl", "shard_map") == "shard_map"
            and ctx is not None and ctx.shape.get("model", 1) > 1
            and cfg.n_experts % ctx.shape["model"] == 0
            and not sharding.batch_is_replicated()):
        return moe_mlp_sharded(x, p, cfg)
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
