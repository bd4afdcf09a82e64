"""Tensor parallelism over the "model" mesh axis.

The JAX package annotates its activations with logical axes (q/k/v by
``heads`` / ``kv_heads``, the GLU hidden by ``mlp``, the logits by
``vocab``) and its weights by ``param_logical``; GSPMD then computes
each rank's share of every tensor those annotations split over "model"
and inserts the collectives.  The port has no partitioner, so this
module holds what GSPMD derives: the Megatron operators at the entry
and exit of a rank-local region, the gathers of weights stored split
but used whole, and the vocab-parallel embedding, loss and argmax.

Which tensors split is ``spec_for``'s decision, asked in one place:
``plan(cfg, ctx)`` for a config, ``TP.splits`` at run time.  ``active()``
is None without a mesh context, under an ``AbstractMesh``, in manual
mode, or when "model" has size 1: the model code then runs exactly its
meshless ops, with no collective.

Every collective runs on the mesh's "model" process group through
``torch.distributed``.  Partial sums (a row-parallel product, a
gradient summed over "model") are reduced in f32 and cast back to their
dtype: one rounding after the sum, as one GEMM's f32 accumulator gives.
On gloo a CUDA tensor can be reduced but not gathered, so there a
gather is the sum of zero-padded slices (exact: one operand of each sum
is nonzero).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding

MODEL = "model"


# --------------------------------------------------------------------------
# the plan: which tensors split over "model"
# --------------------------------------------------------------------------

def splits(ctx: sharding.MeshContext, logical: str, dim: int) -> bool:
    """Whether ``spec_for`` puts a dimension of size ``dim`` with logical
    axis ``logical`` on "model" (the JAX package's constraint kept, not
    dropped for divisibility)."""
    entry = sharding.spec_for((dim,), (logical,), ctx)[0]
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return MODEL in axes


def plan(cfg, ctx: sharding.MeshContext) -> dict[str, str]:
    """Per tensor of the config, "split" over "model" or "replicated": q
    heads, k/v heads, the GLU hidden (and the MoE's shared expert's),
    the vocabulary (logits and embedding rows) and the routed experts."""
    dims = {"heads": ("heads", cfg.n_heads),
            "kv_heads": ("kv_heads", cfg.n_kv_heads),
            "mlp": ("mlp", cfg.d_ff),
            "vocab": ("vocab", cfg.vocab_size)}
    if cfg.is_moe:
        dims["experts"] = ("experts", cfg.n_experts)
        if cfg.n_shared_experts:
            dims["shared_mlp"] = ("mlp",
                                  cfg.moe_d_ff * cfg.n_shared_experts)
    return {k: "split" if dim and splits(ctx, name, dim) else "replicated"
            for k, (name, dim) in dims.items()}


@dataclasses.dataclass(frozen=True)
class TP:
    """The active "model" axis: its size, this rank's coordinate on it,
    its process group, and the sharding context the rules come from."""
    ctx: sharding.MeshContext
    size: int
    rank: int
    group: object

    def splits(self, logical: str, dim: int) -> bool:
        return splits(self.ctx, logical, dim)

    def chunk(self, whole: int) -> tuple[int, int]:
        """(start, length) of this rank's share of a split dimension."""
        n = whole // self.size
        return self.rank * n, n


def active() -> TP | None:
    """The tensor-parallel axis of the current sharding context, or None:
    no context, a shape-only ``AbstractMesh``, manual mode, or "model" of
    size 1."""
    ctx = sharding.current_context()
    if ctx is None or sharding._MANUAL[0]:
        return None
    m = ctx.shape.get(MODEL, 1)
    if m < 2 or not hasattr(ctx.mesh, "get_group"):
        return None
    return TP(ctx, m, ctx.mesh.get_local_rank(MODEL),
              ctx.mesh.get_group(MODEL))


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

_LOW = (torch.bfloat16, torch.float16)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``: in f32 for a 16-bit float, cast back."""
    y = x.to(torch.float32 if x.dtype in _LOW else x.dtype,
             memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gloo_cuda(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in "model" order."""
    x = x.contiguous()
    if _gloo_cuda(x, tp.group):
        shape = list(x.shape)
        n = shape[dim]
        shape[dim] = n * tp.size
        full = x.new_zeros(shape)
        full.narrow(dim, tp.rank * n, n).copy_(x)
        dist.all_reduce(full, group=tp.group)
        return full
    parts = x.new_empty((tp.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(parts, x, group=tp.group)
    if dim == 0:
        return parts
    return torch.cat(parts.chunk(tp.size), dim=dim)


class _ToModelShards(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over "model": a
    replicated input of a rank-local region (each model rank's gradient
    holds only its share's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _FromModelShards(torch.autograd.Function):
    """The sum over "model" forward (merging the ranks' partial results);
    the identity backward, since every model rank then holds the same
    gradient of the merged output."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """All-gather over "model" forward; the backward is this rank's slice
    of the gradient, not a sum: every model rank holds the same gathered
    tensor and computes the same whole gradient from it."""

    @staticmethod
    def forward(ctx, w, dim, tp):
        ctx.dim, ctx.start, ctx.n = dim, tp.rank * w.shape[dim], w.shape[dim]
        return all_gather(w, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ToModelShards.apply(x, group)


def from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _FromModelShards.apply(x, group)


def gather_model(w: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    return _GatherModel.apply(w, dim, tp)


# --------------------------------------------------------------------------
# weights: local shares and whole tensors
# --------------------------------------------------------------------------

def whole(w: torch.Tensor, dim: int, size: int, tp: TP) -> torch.Tensor:
    """``w`` whole along ``dim`` (``size``), for a replicated use: as it
    is when stored whole, gathered when stored split."""
    return w if w.shape[dim] == size else gather_model(w, dim, tp)


def part(w: torch.Tensor, dim: int, size: int, start: int, n: int,
         tp: TP) -> torch.Tensor:
    """Rows [start, start + n) along ``dim`` (whole ``size``) of ``w``,
    used inside a rank-local region.  The rank's own share of a weight
    stored split is ``w`` itself (its gradient is local); any other part
    comes from the whole tensor, whose gradient is summed over "model"
    (each rank's use gives only its part of it)."""
    own = tp.chunk(size)
    if w.shape[dim] != size and (start, n) == own:
        return w
    full = to_model(whole(w, dim, size, tp), tp.group)
    return full if n == size else full.narrow(dim, start, n)


def col_parallel(x, w, b, size: int, tp: TP):
    """``x @ w[:, own] (+ b[own])``: this rank's share of the out-dim
    (whole ``size``); ``x`` must already be inside the region."""
    start, n = tp.chunk(size)
    y = x @ part(w, 1, size, start, n, tp).to(x.dtype)
    if b is not None:
        y = y + part(b, 0, size, start, n, tp).to(x.dtype)
    return y


def row_parallel(x, w, b, size: int, tp: TP):
    """``sum over "model" of x @ w[own, :]``, then ``+ b`` once: the
    region's exit (in-dim whole ``size``)."""
    start, n = tp.chunk(size)
    y = from_model(x @ part(w, 0, size, start, n, tp).to(x.dtype),
                   tp.group)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


# --------------------------------------------------------------------------
# vocab-parallel embedding, loss and argmax
# --------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor, vocab: int,
          dtype: torch.dtype, tp: TP) -> torch.Tensor:
    """The rows of this rank's vocabulary share looked up (zero for the
    tokens outside it), then summed over "model"; the table's gradient
    lands on the rank's rows only."""
    start, n = tp.chunk(vocab)
    rows = part(table, 0, vocab, start, n, tp)
    t = tokens.long() - start
    mine = (t >= 0) & (t < n)
    out = rows[torch.where(mine, t, torch.zeros_like(t))].to(dtype)
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=dtype,
                                                        device=out.device))
    return from_model(out, tp.group)


def unembed(x: torch.Tensor, table: torch.Tensor, vocab: int,
            tp: TP) -> torch.Tensor:
    """f32 logits of this rank's vocabulary share [..., vocab / m]."""
    start, n = tp.chunk(vocab)
    rows = part(table, 0, vocab, start, n, tp)
    return to_model(x, tp.group).float() @ rows.float().T


class _VocabLSE(torch.autograd.Function):
    """(logsumexp, gold logit) over the whole vocabulary from this rank's
    logits [N, V/m]: an all-reduce of the row maxima (max), of the
    shifted exps (sum) and of the gold logit, which only its owner
    holds (sum).  Backward: ``g_lse · softmax + g_gold · onehot`` on the
    rank's own columns; no collective."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        mx = logits.max(dim=-1).values
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        se = torch.exp(logits - mx[:, None]).sum(dim=-1)
        dist.all_reduce(se, group=group)
        lse = torch.log(se) + mx
        t = targets.long() - start
        mine = (t >= 0) & (t < logits.shape[-1])
        idx = torch.where(mine, t, torch.zeros_like(t))
        gold = torch.where(mine, logits.gather(-1, idx[:, None])[:, 0],
                           torch.zeros_like(lse))
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, lse, idx, mine)
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, lse, idx, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse[:, None]) * g_lse[:, None]
        grad.scatter_add_(-1, idx[:, None],
                          torch.where(mine, g_gold, torch.zeros_like(g_gold)
                                      )[:, None])
        return grad, None, None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
                  tp: TP, z_loss: float = 1e-4) -> torch.Tensor:
    """``train.steps.cross_entropy_loss`` on vocab-sharded logits
    [B, S, V/m]: the mean token NLL plus ``z_loss · mean(lse²)`` on the
    global logsumexp."""
    start, _ = tp.chunk(vocab)
    lse, gold = _VocabLSE.apply(logits.reshape(-1, logits.shape[-1]),
                                targets.reshape(-1), start, tp.group)
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def argmax(logits: torch.Tensor, vocab: int, tp: TP) -> torch.Tensor:
    """The global argmax over the last dim of vocab-sharded logits, the
    lowest index on ties (``jnp.argmax``'s): each rank's maximum and
    first index, the global maximum by an all-reduce (max), then the
    least index among the ranks that hold it (min)."""
    start, _ = tp.chunk(vocab)
    mx, idx = logits.max(dim=-1)
    gmax = mx.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=tp.group)
    cand = torch.where(mx == gmax, idx + start,
                       torch.full_like(idx, vocab))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=tp.group)
    return cand
