"""Decoder-only transformer LM (the dense, MoE and cross-attention VLM
families): per-layer schedule, blocks, forward, and the stacked KV cache
for serving.

The JAX package scans stacked ``[L, ...]`` parameters; the port holds one
``Block`` module per layer in an ``nn.ModuleList`` (and one ``CrossBlock``
per cross-attention layer) and loops over them.  Per-layer heterogeneity
(gemma3's 5 local : 1 global pattern) is a static Python list of windows
and rope thetas.

Remat.  With ``cfg.remat`` and grad enabled, each block of the training
forward runs under ``torch.utils.checkpoint`` (as the JAX package wraps it
in ``jax.checkpoint``): its activations are recomputed in the backward.
With ``cfg.scan_group`` = gk set (``n_layers % gk == 0``, ``gk <
n_layers``) and grad enabled, each group of gk blocks runs under one
outer checkpoint as well (sqrt-L remat: live saved residuals drop from
L·|x| to (L/gk + gk)·|x|), its blocks checkpointed again only under
``cfg.remat``, as the JAX package always checkpoints its group step and
its blocks only under remat.  Without grad both are the flat loop.

MoE blocks return the load-balance loss and the dropped share; the stack
sums them over the layers (``forward``'s aux).  The VLM interleaves a
cross-attention block after every ``cross_attn_every`` self blocks; its
memory (the stubbed modality frontend's output) is an argument of
``forward`` and ``prefill`` and lives in the cache for decode.

Under tensor parallelism (``parallel.tensor_parallel``) the blocks'
attention and GLU compute this rank's heads and hidden columns, the
embedding and unembedding its vocabulary rows: ``forward``, ``prefill``
and ``decode_step`` then return this rank's vocab-sharded logits where
the vocabulary splits, and the cache holds its KV heads where they
split.

Under FSDP over "data" (``parallel.fsdp``) each block's weights are
gathered just before it runs, inside its checkpoint, and the embedding
and head around the stack; the serve steps gather a block at a time
too.

Under sequence parallelism (``parallel.sequence_parallel``: the rule
``seq_res -> ("model",)``, S dividing "model") ``forward`` and
``prefill`` hold the residual stream as this rank's positions of the
sequence from the embedding to the final norm: each block's norms run
on them, its attention, GLU or MoE (and a cross block's attention)
gather the sequence at entry and leave on them, and the logits are the
whole sequence's (``prefill``: the last position's, from the rank that
holds it).  The serve steps run on the rank's ``cache_specs`` slice of
the cache, its positions of T where T splits.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import fsdp
from repro_torch.parallel import sequence_parallel as seqp
from repro_torch.parallel import sharding


# --------------------------------------------------------------------------
# per-layer schedule (window / rope theta per layer)
# --------------------------------------------------------------------------

def layer_schedule(cfg: ModelConfig, n_layers=None):
    """Returns (windows [L] ints, thetas [L] floats); L is ``n_layers``
    when given, else the config's layers."""
    windows, thetas = [], []
    for i in range(n_layers or cfg.n_layers):
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
    """A self-attention block; its FFN is ``mlp`` (dense) or ``moe``."""

    def __init__(self, ln_attn, attn, ln_mlp, mlp=None, moe=None):
        super().__init__()
        self.ln_attn, self.attn, self.ln_mlp = ln_attn, attn, ln_mlp
        self.mlp, self.moe = mlp, moe


def init_block(gen: torch.Generator, cfg: ModelConfig) -> Block:
    ln_attn = layers.init_rms_norm(cfg.d_model, gen.device)
    attn = attention.init_attention(gen, cfg)
    ln_mlp = layers.init_rms_norm(cfg.d_model, gen.device)
    if cfg.is_moe:
        return Block(ln_attn, attn, ln_mlp, moe=moe_lib.init_moe(gen, cfg))
    return Block(ln_attn, attn, ln_mlp,
                 mlp=layers.init_glu_mlp(gen, cfg.d_model, cfg.d_ff))


def _ffn(p: Block, cfg: ModelConfig, h):
    """(out, aux): the MoE through ``moe_lib.moe_mlp_auto``, looked up at
    call time, or the dense GLU with aux None."""
    if cfg.is_moe:
        return moe_lib.moe_mlp_auto(h, p.moe, cfg)
    return layers.glu_mlp(h, p.mlp, cfg.act), None


def block_forward(p: Block, cfg: ModelConfig, x, positions, window, theta,
                  return_kv=False):
    """One block; ``positions`` of ``None`` means ``0..S-1`` in every row,
    which ``forward`` and ``prefill`` pass (no device check per layer).
    Returns (x, aux[, (k, v)]); aux is the MoE's, None for a dense
    block."""
    h = layers.rms_norm(x, seqp.replicated(p.ln_attn.scale), cfg.norm_eps)
    attn_out = attention.self_attention(p.attn, cfg, h, positions,
                                        causal=True, window=window,
                                        theta=theta, return_kv=return_kv)
    if return_kv:
        attn_out, kv_k, kv_v = attn_out
    x = x + attn_out
    h = layers.rms_norm(x, seqp.replicated(p.ln_mlp.scale), cfg.norm_eps)
    out, aux = _ffn(p, cfg, h)
    x = x + out
    if return_kv:
        return x, aux, (kv_k, kv_v)
    return x, aux


class CrossBlock(nn.Module):
    def __init__(self, ln, xattn):
        super().__init__()
        self.ln, self.xattn = ln, xattn


def init_cross_block(gen: torch.Generator, cfg: ModelConfig) -> CrossBlock:
    return CrossBlock(layers.init_rms_norm(cfg.d_model, gen.device),
                      attention.init_attention(gen, cfg))


def cross_block_forward(p: CrossBlock, cfg: ModelConfig, x, memory,
                        positions=None):
    """x plus the cross attention to ``memory`` of its normed self;
    ``positions`` is accepted and unused (``attention.cross_attention``)."""
    h = layers.rms_norm(x, seqp.replicated(p.ln.scale), cfg.norm_eps)
    return x + attention.cross_attention(p.xattn, cfg, h, memory)


def _cross_after(cfg: ModelConfig, i: int):
    """The cross block that follows self block ``i``, or None."""
    k = cfg.cross_attn_every
    return (i + 1) // k - 1 if k and (i + 1) % k == 0 else None


# --------------------------------------------------------------------------
# full LM
# --------------------------------------------------------------------------

class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, embed, blocks, final_norm,
                 lm_head=None, cross_blocks=()):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.cross_blocks = nn.ModuleList(cross_blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head


def n_cross_layers(cfg: ModelConfig) -> int:
    if not cfg.cross_attn_every:
        return 0
    if cfg.n_layers % cfg.cross_attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                         f"groups of cross_attn_every="
                         f"{cfg.cross_attn_every}")
    return cfg.n_layers // cfg.cross_attn_every


@torch.no_grad()
def init_lm(gen: torch.Generator, cfg: ModelConfig) -> TransformerLM:
    emb = layers.init_embed(gen, cfg.vocab_size, cfg.d_model)
    blocks = [init_block(gen, cfg) for _ in range(cfg.n_layers)]
    cross = [init_cross_block(gen, cfg) for _ in range(n_cross_layers(cfg))]
    final_norm = layers.init_rms_norm(cfg.d_model, gen.device)
    head = (None if cfg.tie_embeddings
            else layers.init_embed(gen, cfg.vocab_size, cfg.d_model))
    return TransformerLM(cfg, emb, blocks, final_norm, head, cross)


def _aux0(cfg: ModelConfig, device) -> dict:
    if not cfg.is_moe:
        return {}
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("aux_loss", "dropped")}


def _run_blocks(blocks, cfg: ModelConfig, x, aux, windows, thetas,
                remat: bool):
    """The blocks in turn (each under a checkpoint when ``remat``), their
    MoE aux summed into ``aux`` in layer order."""
    for blk, w, th in zip(blocks, windows, thetas):
        if remat:
            x, a = seqp.checkpoint(fsdp.call, block_forward, blk, cfg, x,
                                   None, w, th)
        else:
            x, a = fsdp.call(block_forward, blk, cfg, x, None, w, th)
        if a is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def _grouped(cfg: ModelConfig) -> bool:
    gk = cfg.scan_group
    return bool(gk) and cfg.n_layers % gk == 0 and gk < cfg.n_layers


def _self_stack(params: TransformerLM, cfg: ModelConfig, x):
    windows, thetas = layer_schedule(cfg)
    grad = torch.is_grad_enabled()
    remat = cfg.remat and grad
    aux = _aux0(cfg, x.device)
    if not (grad and _grouped(cfg)):
        return _run_blocks(params.blocks, cfg, x, aux, windows, thetas,
                           remat)
    gk = cfg.scan_group
    # under tensor parallelism and FSDP a checkpoint's recompute issues
    # the region's collectives again (the "model" sums, the blocks'
    # gathers over "data"), in the forward's order; every rank runs the
    # same groups and blocks, so the ranks' collectives stay matched
    for g0 in range(0, cfg.n_layers, gk):
        grp = slice(g0, g0 + gk)
        x, aux = seqp.checkpoint(_run_blocks, params.blocks[grp], cfg, x,
                                 aux, windows[grp], thetas[grp], remat)
    return x, aux


def _cross_stack(params: TransformerLM, cfg: ModelConfig, x, memory):
    """Groups of ``cross_attn_every`` self blocks, each followed by its
    cross block; under remat (grad enabled) every block and cross block
    runs under its own checkpoint.  The MoE aux is not kept (as in the
    JAX package)."""
    if memory is None:
        raise ValueError(f"{cfg.name}: the cross-attention layers need "
                         "memory [B, n_frontend_tokens, d_model]")
    windows, thetas = layer_schedule(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    k = cfg.cross_attn_every
    for gi, cb in enumerate(params.cross_blocks):
        grp = slice(gi * k, gi * k + k)
        x, _ = _run_blocks(params.blocks[grp], cfg, x, {}, windows[grp],
                           thetas[grp], remat)
        if remat:
            x = seqp.checkpoint(fsdp.call, cross_block_forward, cb, cfg,
                                x, memory)
        else:
            x = fsdp.call(cross_block_forward, cb, cfg, x, memory)
    return x


def forward(params: TransformerLM, cfg: ModelConfig, tokens, memory=None):
    """Training/prefill forward -> (f32 logits [B, S, V], aux): aux
    ``{"aux_loss", "dropped"}`` summed over the layers for MoE, else {}.
    ``memory`` [B, T, d]: the VLM's modality embeddings."""
    dt = layers.dtype_of(cfg.dtype)
    emb, head = fsdp.ends(params)
    with seqp.stream(seqp.split(tuple(tokens.shape) + (cfg.d_model,))):
        x = layers.embed(tokens, emb, dt)
        if cfg.cross_attn_every:
            x, aux = _cross_stack(params, cfg, x, memory), {}
        else:
            x, aux = _self_stack(params, cfg, x)
        x = layers.rms_norm(x, seqp.replicated(params.final_norm.scale),
                            cfg.norm_eps)
        return layers.unembed(x, head), aux


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def takes_memory(cfg: ModelConfig) -> bool:
    """Whether the model attends to a modality memory [B,
    n_frontend_tokens, d_model]: the VLM's cross blocks."""
    return bool(cfg.cross_attn_every and cfg.n_frontend_tokens)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """The stacked KV cache, plus the VLM's ``memory`` [B, T, d]; under a
    mesh context the rank's slice (``attention.init_kv_cache``), the
    memory its rows."""
    cache = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                    device=device)
    if takes_memory(cfg):
        cache["memory"] = torch.zeros(
            (cache["k"].shape[1], cfg.n_frontend_tokens, cfg.d_model),
            dtype=dtype, device=device)
        if "shard" in cache:
            cache["shard"]["memory"] = (cache["shard"]["k"][1], None, None)
    return cache


def decode_step(params: TransformerLM, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: [B, 1] -> (logits [B, 1, V], cache).  The
    cache is read only inside the layer loop; this token's k/v are written
    into it in place afterwards, at ``length``.  The cross blocks attend
    over the cache's memory."""
    dt = layers.dtype_of(cfg.dtype)
    emb, head = fsdp.ends(params)
    x = layers.embed(tokens, emb, dt)
    length = cache["length"]
    memory = cache.get("memory")
    sl = sharding.cache_slice(cache)
    windows, thetas = layer_schedule(cfg)
    ks, vs = [], []
    for i, (blk, w, th) in enumerate(zip(params.blocks, windows, thetas)):
        blk = fsdp.gathered(blk)
        h = layers.rms_norm(x, blk.ln_attn.scale, cfg.norm_eps)
        k_new, v_new = attention.project_kv_token(blk.attn, cfg, h, length,
                                                  theta=th)
        x = x + attention.decode_attention_append(
            blk.attn, cfg, h, cache["k"][i], cache["v"][i], k_new, v_new,
            length, window=w, theta=th, sl=sl)
        h = layers.rms_norm(x, blk.ln_mlp.scale, cfg.norm_eps)
        x = x + _ffn(blk, cfg, h)[0]
        ks.append(k_new)
        vs.append(v_new)
        c = _cross_after(cfg, i)
        if c is not None:
            x = fsdp.call(cross_block_forward, params.cross_blocks[c], cfg,
                          x, memory)
    attention.write_kv_stack(cache["k"], cache["v"], torch.stack(ks),
                             torch.stack(vs), length, sl)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = layers.unembed(x, head)
    cache["length"] = length + 1
    return logits, cache


def prefill(params: TransformerLM, cfg: ModelConfig, tokens, cache,
            memory=None):
    """The full-sequence forward, writing each layer's K/V into the cache
    at positions [0, S) in place (the rank's positions of them where T
    splits); returns (logits [B, 1, V] of the last position, cache).
    ``memory`` goes into the cache in its dtype (the VLM's cross blocks
    read it there, here and in decode)."""
    b, s = tokens.shape
    dt = layers.dtype_of(cfg.dtype)
    emb, head = fsdp.ends(params)
    if memory is not None and "memory" in cache:
        cache["memory"] = memory.to(cache["memory"].dtype)
    mem = cache.get("memory")
    sl = sharding.cache_slice(cache)
    windows, thetas = layer_schedule(cfg)
    with seqp.stream(seqp.split((b, s, cfg.d_model))):
        x = layers.embed(tokens, emb, dt)
        for i, (blk, w, th) in enumerate(zip(params.blocks, windows,
                                             thetas)):
            x, _, (kk, vv) = fsdp.call(block_forward, blk, cfg, x,
                                       positions=None, window=w, theta=th,
                                       return_kv=True)
            attention.write_prefix(cache["k"][i], kk, sl)
            attention.write_prefix(cache["v"][i], vv, sl)
            c = _cross_after(cfg, i)
            if c is not None:
                x = fsdp.call(cross_block_forward, params.cross_blocks[c],
                              cfg, x, mem)
        x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
        x = seqp.last_position(x)
    logits = layers.unembed(x, head)
    cache["length"] = s
    return logits, cache
