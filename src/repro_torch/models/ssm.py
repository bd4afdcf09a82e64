"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Chunked SSD: within a chunk of ``chunk`` = 128 positions the recurrence is
a [Q, Q] masked-decay matmul; across chunks a [heads, d_state, head_dim]
state is carried.  The JAX package scans the chunks with ``lax.scan``;
the port takes them in blocks of chunks (as many as keep one
[B, n, Q, Q, nh] f32 tensor within ``BLOCK_ELEMENTS``, so the prefill's
scratch does not grow with the prompt).  In a block it computes every
chunk's intra-chunk terms at once, as batched einsums over a chunk axis,
loops over the chunks only for the carried state (two elementwise ops a
chunk), then adds every chunk's inter-chunk term at once.  The sums are
the JAX package's, grouped by chunk the same way; einsum may contract them in another order (the 4-operand state
update ``bqhs,bqh,bqhd->bhsd`` runs as one product of the B rows scaled
by ``decay_to_end * dt`` with x), which moves f32 results by rounding
only.  The SSD scan is plain torch on every device: no Pallas kernel
computes it in the JAX package either.

A decode step is the bare recurrence (O(1) per token) plus a rolling conv
window: the bounded state that lets the SSM and hybrid families serve long
contexts.  The decode cache (``init_ssm_cache``) is f32 whatever the KV
cache's dtype, and ``ssd_decode_step`` updates it in place.

Layout: d_inner = expand·d_model = n_ssm_heads·headdim; B/C are shared
across heads within each of ``ngroups`` groups.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


class DepthwiseConv(nn.Module):
    """The causal conv's ``w [W, C]`` and ``b [C]``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = layers._param(w)
        self.b = layers._param(b)


class SSM(nn.Module):
    """One SSD mixer: the fused z/x/B/C/dt projection, the causal conv,
    the decay and skip parameters, the gated norm and the output
    projection (the JAX tree's ``ssm/...`` names)."""

    def __init__(self, in_proj, conv, a_log, dt_bias, d_skip, gate_norm,
                 out_proj):
        super().__init__()
        self.in_proj, self.conv = in_proj, conv
        self.a_log = layers._param(a_log)
        self.dt_bias = layers._param(dt_bias)
        self.d_skip = layers._param(d_skip)
        self.gate_norm, self.out_proj = gate_norm, out_proj


def init_ssm(gen: torch.Generator, cfg) -> SSM:
    d = cfg.d_model
    di = cfg.d_inner_ssm
    nh, st, g = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = di + 2 * g * st
    dev = gen.device
    in_proj = layers.Linear(layers.normal(
        gen, (d, 2 * di + 2 * g * st + nh), 1.0 / math.sqrt(d)))
    conv = DepthwiseConv(layers.normal(gen, (cfg.ssm_conv, conv_dim), 0.1),
                         torch.zeros((conv_dim,), device=dev))
    out_proj = layers.Linear(layers.normal(gen, (di, d), 1.0 / math.sqrt(di)))
    return SSM(in_proj, conv,
               torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
               torch.zeros((nh,), device=dev), torch.ones((nh,), device=dev),
               layers.init_rms_norm(di, dev), out_proj)


def _split_proj(cfg, zxbcdt):
    di = cfg.d_inner_ssm
    g, st = cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xin = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + g * st]
    c = zxbcdt[..., 2 * di + g * st:2 * di + 2 * g * st]
    dt = zxbcdt[..., 2 * di + 2 * g * st:]
    return z, xin, b, c, dt


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv along seq.  x: [B, S, C], w: [W, C].
    With ``cache`` [B, W-1, C]: continue from that rolling window
    (decode).  Returns (silu(out), the last W-1 inputs)."""
    win = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], win - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(win))
    out = out + b.to(x.dtype)
    new_cache = xp[:, -(win - 1):, :] if win > 1 else None
    return F.silu(out), new_cache


def ssd_forward(x, p: SSM, cfg, chunk: int = 128):
    """Chunked SSD over a full sequence.  x: [B, S, d] -> [B, S, d]."""
    y, _, _ = _ssd_core(x, p, cfg, chunk, want_state=False)
    return y


def ssd_prefill(x, p: SSM, cfg, chunk: int = 128):
    """Like ``ssd_forward`` but also returns (final_state [B,nh,st,hd] f32,
    conv window [B,W-1,conv_dim] f32: the last W-1 conv inputs) to prime
    decoding."""
    return _ssd_core(x, p, cfg, chunk, want_state=True)


# Elements of one [B, n, Q, Q, nh] f32 intra-chunk tensor of a block of
# chunks (128 MiB): bounds the prefill's scratch whatever the prompt length
BLOCK_ELEMENTS = 2 ** 25


def _ssd_chunks(xc, bgc, cgc, lac, dtc, state, hpg):
    """The SSD of one block of n chunks.  xc [B,n,Q,nh,hd]; bgc, cgc
    [B,n,Q,g,st] (groups broadcast over their ``hpg`` heads here);
    lac, dtc [B,n,Q,nh]; state [B,nh,st,hd], the state entering the
    block.  Returns (y [B,n,Q,nh,hd] f32, the state leaving it)."""
    q = xc.shape[2]
    bc = torch.repeat_interleave(bgc, hpg, dim=3)               # [B,n,Q,nh,st]
    cx = torch.repeat_interleave(cgc, hpg, dim=3)

    # intra-chunk, every chunk of the block at once: decay(i, j) =
    # exp(cum_i - cum_j) for j <= i.  Mask BEFORE exp: for j > i, dec > 0
    # can overflow to +inf, and masking after exp leaves 0 * inf = NaN in
    # the backward.  (A scalar ``where``: masked_fill's backward sums the
    # decays' cotangent in another order, 3x farther from the float64
    # gradient of a_log where the decays overflow.)
    cum = torch.cumsum(lac, dim=2)                              # [B,n,Q,nh]
    ii = torch.arange(q, device=xc.device)
    above = (ii[:, None] < ii[None, :])[None, None, :, :, None]
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,n,Q,Q,nh]
    l_mat = torch.exp(torch.where(above, -math.inf, dec))
    gmat = torch.einsum("bcihs,bcjhs->bcijh", cx, bc)           # C_i · B_j
    wmat = gmat * l_mat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", wmat, xc)
    # each chunk's state growth to its end, and its total decay
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # [B,n,Q,nh]
    sgrow = torch.einsum("bcqhs,bcqhd->bchsd",
                         bc * (decay_to_end * dtc)[..., None], xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])[..., None, None]  # [B,n,nh,1,1]

    # the carried state: the state entering each chunk, then the last one
    entering = []
    for c in range(xc.shape[1]):
        entering.append(state)
        state = state * chunk_decay[:, c] + sgrow[:, c]
    entering = torch.stack(entering, dim=1)                     # [B,n,nh,st,hd]
    y_inter = torch.einsum("bcqhs,bchsd->bcqhd",
                           cx * torch.exp(cum)[..., None], entering)
    return y_intra + y_inter, state


def _ssd_core(x, p: SSM, cfg, chunk: int, want_state: bool):
    bsz, s, _ = x.shape
    nh, hd, st, g = (cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                     cfg.ssm_ngroups)
    di = cfg.d_inner_ssm

    zxbcdt = layers.linear(x, p.in_proj.w)
    z, xin, bb, cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, bb, cc], dim=-1)
    conv_cache = (conv_in[:, -(cfg.ssm_conv - 1):, :].float()
                  if want_state else None)
    conv_out, _ = _causal_conv(conv_in, p.conv.w, p.conv.b)
    xin = conv_out[..., :di]
    bb = conv_out[..., di:di + g * st]
    cc = conv_out[..., di + g * st:]

    dt = F.softplus(dt.float() + p.dt_bias[None, None])         # [B,S,nh]
    a = -torch.exp(p.a_log)                                     # [nh] < 0
    la = dt * a[None, None]                                     # log-decay

    xh = xin.reshape(bsz, s, nh, hd).float()
    bg = bb.reshape(bsz, s, g, st).float()
    cg = cc.reshape(bsz, s, g, st).float()

    # pad to a chunk multiple: zero dt and log-decay, so padding adds
    # nothing to the state and decays nothing
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s

    def chunks(t):
        t = F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        return t.reshape(bsz, nc, q, *t.shape[2:])

    xc, bgc, cgc, lac, dtc = map(chunks, (xh, bg, cg, la, dt))

    # the chunks in blocks of ``per_block``, so that the [B, n, Q, Q, nh]
    # intra-chunk tensors stay within BLOCK_ELEMENTS whatever S is; the
    # state entering each block is carried from the last
    state = torch.zeros((bsz, nh, st, hd), dtype=torch.float32,
                        device=x.device)
    per_block = max(1, BLOCK_ELEMENTS // (bsz * q * q * nh))
    ys = []
    for c0 in range(0, nc, per_block):
        blk = slice(c0, c0 + per_block)
        y_blk, state = _ssd_chunks(xc[:, blk], bgc[:, blk], cgc[:, blk],
                                   lac[:, blk], dtc[:, blk], state, nh // g)
        ys.append(y_blk)
    y = torch.cat(ys, dim=1).reshape(bsz, nc * q, nh, hd)[:, :s]
    y = y + xh * p.d_skip[None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)

    # gated RMSNorm then output projection
    y = layers.rms_norm(y * F.silu(z), p.gate_norm.scale, cfg.norm_eps)
    out = layers.linear(y, p.out_proj.w)
    return out, state, conv_cache


# --------------------------------------------------------------------------
# decode (recurrent) path
# --------------------------------------------------------------------------

def init_ssm_cache(cfg, batch, n_layers, dtype=torch.float32, device=None):
    di = cfg.d_inner_ssm
    conv_dim = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "state": torch.zeros((n_layers, batch, cfg.n_ssm_heads,
                              cfg.ssm_state, cfg.ssm_headdim), dtype=dtype,
                             device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def ssd_decode_step(x, p: SSM, cfg, state, conv_cache):
    """One-token recurrence.  x: [B, 1, d]; state: [B, nh, st, hd];
    conv_cache: [B, W-1, conv_dim].  Returns (y [B,1,d], state,
    conv_cache): the new state and window, written into ``state`` and
    ``conv_cache`` in place."""
    bsz = x.shape[0]
    nh, hd, st, g = (cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                     cfg.ssm_ngroups)
    di = cfg.d_inner_ssm

    zxbcdt = layers.linear(x, p.in_proj.w)
    z, xin, bb, cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, bb, cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p.conv.w, p.conv.b,
                                      cache=conv_cache)
    xin = conv_out[..., :di]
    bb = conv_out[..., di:di + g * st]
    cc = conv_out[..., di + g * st:]

    dt = F.softplus(dt.float() + p.dt_bias)[:, 0]               # [B,nh]
    a = -torch.exp(p.a_log)
    decay = torch.exp(dt * a[None])                             # [B,nh]

    xh = xin.reshape(bsz, nh, hd).float()
    hpg = nh // g
    bh = torch.repeat_interleave(bb.reshape(bsz, g, st), hpg, dim=1)
    ch = torch.repeat_interleave(cc.reshape(bsz, g, st), hpg, dim=1)

    new_state = (state * decay[..., None, None]
                 + torch.einsum("bhs,bhd->bhsd", bh.float() * dt[..., None],
                                xh))
    y = torch.einsum("bhs,bhsd->bhd", ch.float(), new_state)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), p.gate_norm.scale, cfg.norm_eps)
    state.copy_(new_state)
    conv_cache.copy_(new_conv)
    return layers.linear(y, p.out_proj.w), state, conv_cache
