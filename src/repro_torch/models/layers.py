"""Building-block layers: norms, MLPs, embeddings, rotary.

The ops are plain functions over tensors, as in the JAX package; the
parameters live in small ``nn.Module``s whose attribute paths mirror the
JAX parameter tree (``gate.w``, ``scale``, ``table``), so ``convert`` maps
one onto the other by name.  Weights are f32 masters, cast to the config's
compute dtype per op.  Weights of a linear map are stored ``[d_in, d_out]``
as in JAX.

The JAX package annotates logical sharding axes here; the port's model
code runs on plain tensors (a rank's rows of the batch under the LM's
mesh, ``parallel.sharding``), where such an annotation is the identity,
so it has none.  Init draws from an explicit
``torch.Generator`` (the parameters land on its device) with the scales of
the JAX package; the bits differ, so tests carry JAX's parameters across.
Parameters are trainable (``requires_grad=True``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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


def glu_mlp(x: torch.Tensor, p: GLUMLP, act: str) -> torch.Tensor:
    """SwiGLU / GeGLU: act(x @ w_gate) * (x @ w_up) @ w_down."""
    g = linear(x, p.gate.w)
    u = linear(x, p.up.w)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return linear(g * u, p.down.w)


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


def embed(tokens: torch.Tensor, table: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits against the [vocab, d_model] table (tied or untied), f32."""
    return x.float() @ table.float().T


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
