"""Building-block layers: norms, MLPs, embeddings, rotary.

The ops are plain functions over tensors, as in the JAX package; the
parameters live in small ``nn.Module``s whose attribute paths mirror the
JAX parameter tree (``gate.w``, ``scale``, ``table``), so ``convert`` maps
one onto the other by name.  Weights are f32 masters, cast to the config's
compute dtype per op.  Weights of a linear map are stored ``[d_in, d_out]``
as in JAX.

The JAX package annotates logical sharding axes here (the GLU hidden by
"mlp", the logits by "vocab"), and GSPMD computes each rank's share of
what they split over "model".  The port's model code runs on plain
tensors; under a mesh context whose "model" axis splits them
(``parallel.tensor_parallel.active()``) ``glu_mlp`` is column-parallel
in ``gate`` / ``up`` and row-parallel in ``down``, and ``embed`` /
``unembed`` are vocab-parallel (the logits come out vocab-sharded).
``GLUMLP.d_ff`` and ``Embed.vocab`` keep the whole sizes, so a module
placed onto a rank (``launch.specs.place``) still knows them.
Without such a context the ops are the meshless ones.  Under sequence
parallelism (``parallel.sequence_parallel``) ``embed`` puts its output
on this rank's positions of the sequence, ``glu_mlp`` and ``unembed``
gather the sequence at entry, and a norm on the residual stream takes
its scale through ``sequence_parallel.replicated`` (the caller's).
Init draws from
an explicit
``torch.Generator`` (the parameters land on its device) with the scales of
the JAX package; the bits differ, so tests carry JAX's parameters across.
Parameters are trainable (``requires_grad=True``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import sequence_parallel as seqp
from repro_torch.parallel import tensor_parallel as tpl


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _param(x: torch.Tensor) -> nn.Parameter:
    # Trainable: the train step differentiates through every weight; the
    # serving steps run under torch.no_grad() and record no graph.
    return nn.Parameter(x, requires_grad=True)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def fan_in_init(gen: torch.Generator, shape) -> torch.Tensor:
    return normal(gen, shape, 1.0 / math.sqrt(shape[0]))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(dt)


def init_rms_norm(d: int, device=None) -> RMSNorm:
    return RMSNorm(torch.zeros((d,), dtype=torch.float32, device=device))


# --------------------------------------------------------------------------
# linear / mlp
# --------------------------------------------------------------------------

class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False) -> Linear:
    b = (torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
         if bias else None)
    return Linear(fan_in_init(gen, (d_in, d_out)), b)


class GLUMLP(nn.Module):
    def __init__(self, gate: Linear, up: Linear, down: Linear):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down
        self.d_ff = down.w.shape[0]          # whole, also once placed


def glu_mlp(x: torch.Tensor, p: GLUMLP, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU: act(x @ w_gate) * (x @ w_up) @ w_down.  Under
    tensor parallelism with the hidden split: this rank's hidden columns,
    then one sum over "model"; else replicated.  On a split residual
    stream both gather the sequence at entry and leave on this rank's
    positions."""
    tp = tpl.active()
    if tp is not None and tp.splits("mlp", p.d_ff):
        x = seqp.enter(x, tp)
        g = tpl.col_parallel(x, p.gate.w, None, p.d_ff, tp)
        u = tpl.col_parallel(x, p.up.w, None, p.d_ff, tp)
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        return seqp.leave(tpl.row_parallel(g * u, p.down.w, p.d_ff, tp), tp)
    x = seqp.enter_replicated(x)
    g = linear(x, p.gate.w)
    u = linear(x, p.up.w)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return seqp.leave_replicated(linear(g * u, p.down.w))


def init_glu_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> GLUMLP:
    return GLUMLP(init_linear(gen, d_model, d_ff),
                  init_linear(gen, d_model, d_ff),
                  init_linear(gen, d_ff, d_model))


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)
        self.vocab = table.shape[0]          # whole, also once placed


def embed(tokens: torch.Tensor, p: Embed, dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``p``'s table at ``tokens``, in ``dtype``;
    vocab-parallel under tensor parallelism.  On a split residual stream
    this rank's positions of them (``tokens`` whole)."""
    tp = tpl.active()
    if tp is not None and tp.splits("vocab", p.vocab):
        return seqp.leave(tpl.embed(tokens, p.table, p.vocab, dtype, tp), tp)
    return seqp.leave_replicated(p.table[tokens.long()].to(dtype))


def unembed(x: torch.Tensor, p: Embed) -> torch.Tensor:
    """Logits against ``p``'s [vocab, d_model] table (tied or untied),
    f32; under tensor parallelism with the vocabulary split, this rank's
    share of them [..., vocab / m].  On a split residual stream the
    logits of the whole sequence."""
    tp = tpl.active()
    if tp is not None and tp.splits("vocab", p.vocab):
        return tpl.unembed(seqp.enter(x, tp), p.table, p.vocab, tp)
    return seqp.enter_replicated(x).float() @ p.table.float().T


def init_embed(gen: torch.Generator, vocab: int, d_model: int) -> Embed:
    # std 1/sqrt(d): with tied unembedding, final-norm activations (RMS~1)
    # against this table give logits ~ N(0, 1) at init.
    return Embed(normal(gen, (vocab, d_model), d_model ** -0.5))


# --------------------------------------------------------------------------
# rotary
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply rotary embedding.  x: [B, S, H, D], positions: [B, S].

    The frequencies are computed in f32 from an f32 ``log(theta)``, as the
    JAX package does: a log taken in f64 moves them by about an ulp, which
    reaches ~2e-4 rad at position 2048."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freq = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq              # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
