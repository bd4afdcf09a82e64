"""Decoder-only transformer LM (the dense family): per-layer schedule,
blocks, forward, and the stacked KV cache for serving.

The JAX package scans stacked ``[L, ...]`` parameters; the port holds one
``Block`` module per layer in an ``nn.ModuleList`` and loops over them.
Per-layer heterogeneity (gemma3's 5 local : 1 global pattern) is a static
Python list of windows and rope thetas.  With ``cfg.remat`` and grad
enabled, each block of the training forward runs under
``torch.utils.checkpoint`` (as the JAX package wraps it in
``jax.checkpoint``): its activations are recomputed in the backward, so
the flash forward runs twice per block.  MoE blocks and the VLM's
cross-attention groups are not in this slice (``models.zoo`` refuses
their families).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# per-layer schedule (window / rope theta per layer)
# --------------------------------------------------------------------------

def layer_schedule(cfg: ModelConfig):
    """Returns (windows [L] ints, thetas [L] floats)."""
    windows, thetas = [], []
    for i in range(cfg.n_layers):
        if cfg.local_pattern and (i % (cfg.local_pattern + 1)
                                  != cfg.local_pattern):
            windows.append(cfg.sliding_window)
            thetas.append(cfg.rope_local_theta or cfg.rope_theta)
        elif cfg.sliding_window and not cfg.local_pattern:
            windows.append(cfg.sliding_window)
            thetas.append(cfg.rope_theta)
        else:
            windows.append(0)
            thetas.append(cfg.rope_theta)
    return windows, thetas


# --------------------------------------------------------------------------
# one block
# --------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, ln_attn, attn, ln_mlp, mlp):
        super().__init__()
        self.ln_attn, self.attn, self.ln_mlp, self.mlp = (ln_attn, attn,
                                                          ln_mlp, mlp)


def init_block(gen: torch.Generator, cfg: ModelConfig) -> Block:
    if cfg.is_moe:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP "
                                  "Queue A, \"the other LM families\": "
                                  "models/moe.py)")
    return Block(layers.init_rms_norm(cfg.d_model, gen.device),
                 attention.init_attention(gen, cfg),
                 layers.init_rms_norm(cfg.d_model, gen.device),
                 layers.init_glu_mlp(gen, cfg.d_model, cfg.d_ff))


def block_forward(p: Block, cfg: ModelConfig, x, positions, window, theta,
                  return_kv=False):
    """One block; ``positions`` of ``None`` means ``0..S-1`` in every row,
    which ``forward`` and ``prefill`` pass (no device check per layer)."""
    h = layers.rms_norm(x, p.ln_attn.scale, cfg.norm_eps)
    attn_out = attention.self_attention(p.attn, cfg, h, positions,
                                        causal=True, window=window,
                                        theta=theta, return_kv=return_kv)
    if return_kv:
        attn_out, kv_k, kv_v = attn_out
    x = x + attn_out
    h = layers.rms_norm(x, p.ln_mlp.scale, cfg.norm_eps)
    x = x + layers.glu_mlp(h, p.mlp, cfg.act)
    if return_kv:
        return x, None, (kv_k, kv_v)
    return x, None


# --------------------------------------------------------------------------
# full LM
# --------------------------------------------------------------------------

class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, embed, blocks, final_norm,
                 lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head

    def head_table(self) -> torch.Tensor:
        return (self.embed.table if self.cfg.tie_embeddings
                else self.lm_head.table)


@torch.no_grad()
def init_lm(gen: torch.Generator, cfg: ModelConfig) -> TransformerLM:
    if cfg.cross_attn_every:
        raise NotImplementedError("cross-attention groups (the VLM family) "
                                  "are not ported yet (ROADMAP Queue A, "
                                  "\"the other LM families\")")
    emb = layers.init_embed(gen, cfg.vocab_size, cfg.d_model)
    blocks = [init_block(gen, cfg) for _ in range(cfg.n_layers)]
    final_norm = layers.init_rms_norm(cfg.d_model, gen.device)
    head = (None if cfg.tie_embeddings
            else layers.init_embed(gen, cfg.vocab_size, cfg.d_model))
    return TransformerLM(cfg, emb, blocks, final_norm, head)


def forward(params: TransformerLM, cfg: ModelConfig, tokens):
    """Training/prefill forward -> f32 logits [B, S, V] (+ aux dict)."""
    remat = cfg.remat and torch.is_grad_enabled()
    gk = cfg.scan_group
    if (torch.is_grad_enabled() and gk and cfg.n_layers % gk == 0
            and gk < cfg.n_layers):
        raise NotImplementedError(
            f"{cfg.name}: scan_group={gk} (sqrt-L remat, nested "
            "checkpoints) is not ported yet (ROADMAP Queue A, \"the "
            "other LM families\"); of the dense configs, qwen2.5-14b and "
            "yi-34b set it")
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(tokens, params.embed.table, dt)
    windows, thetas = layer_schedule(cfg)
    for blk, w, th in zip(params.blocks, windows, thetas):
        if remat:
            x, _ = checkpoint(block_forward, blk, cfg, x, None, w, th,
                              use_reentrant=False)
        else:
            x, _ = block_forward(blk, cfg, x, positions=None, window=w,
                                 theta=th)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    return layers.unembed(x, params.head_table()), {}


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    return attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                   device=device)


def decode_step(params: TransformerLM, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: [B, 1] -> (logits [B, 1, V], cache).  The
    cache is read only inside the layer loop; this token's k/v are written
    into it in place afterwards, at ``length``."""
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(tokens, params.embed.table, dt)
    length = cache["length"]
    windows, thetas = layer_schedule(cfg)
    ks, vs = [], []
    for i, (blk, w, th) in enumerate(zip(params.blocks, windows, thetas)):
        h = layers.rms_norm(x, blk.ln_attn.scale, cfg.norm_eps)
        k_new, v_new = attention.project_kv_token(blk.attn, cfg, h, length,
                                                  theta=th)
        x = x + attention.decode_attention_append(
            blk.attn, cfg, h, cache["k"][i], cache["v"][i], k_new, v_new,
            length, window=w, theta=th)
        h = layers.rms_norm(x, blk.ln_mlp.scale, cfg.norm_eps)
        x = x + layers.glu_mlp(h, blk.mlp, cfg.act)
        ks.append(k_new)
        vs.append(v_new)
    attention.write_kv_stack(cache["k"], cache["v"], torch.stack(ks),
                             torch.stack(vs), length)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = layers.unembed(x, params.head_table())
    cache["length"] = length + 1
    return logits, cache


def prefill(params: TransformerLM, cfg: ModelConfig, tokens, cache):
    """The full-sequence forward, writing each layer's K/V into the cache
    at positions [0, S) in place; returns (logits [B, 1, V] of the last
    position, cache)."""
    b, s = tokens.shape
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(tokens, params.embed.table, dt)
    windows, thetas = layer_schedule(cfg)
    for i, (blk, w, th) in enumerate(zip(params.blocks, windows, thetas)):
        x, _, (kk, vv) = block_forward(blk, cfg, x, positions=None,
                                       window=w, theta=th,
                                       return_kv=True)
        cache["k"][i, :, :s] = kk.to(cache["k"].dtype)
        cache["v"][i, :, :s] = vv.to(cache["v"].dtype)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = layers.unembed(x[:, -1:], params.head_table())
    cache["length"] = s
    return logits, cache
