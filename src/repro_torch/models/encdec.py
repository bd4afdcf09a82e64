"""Encoder-decoder backbone (seamless-m4t-medium).

The modality frontend is a stub: the caller passes precomputed frame
embeddings [B, S_enc, d_model] as ``memory``.  The encoder is a
bidirectional transformer stack over those frames (each layer's attention
in the flash kernel, non-causal), cast to the compute dtype first, so the
decoder's cross-attention k/v come from memory in that dtype.  The
decoder is causal self-attention + cross-attention to the encoder memory +
MLP.  Decode runs the decoder with the encoded memory in the cache and
re-projects the memory's k/v in every layer at every step, as the JAX
package does (its cross-attention at S = 1 over the memory goes through
the flash kernel).

With ``cfg.remat`` and grad enabled, each encoder and decoder block runs
under its own non-reentrant ``torch.utils.checkpoint``.  Under FSDP over
"data" (``parallel.fsdp``) each block gathers its weights as it runs
(inside its checkpoint), the embedding and head around the stacks.
Under sequence parallelism (``parallel.sequence_parallel``) the
decoder's residual stream is the rank's positions of the target
sequence (its self-attention, cross-attention and GLU gather it at
entry); the encoder runs on the whole frames, which the JAX package
annotates "seq".  The serve steps run on the rank's ``cache_specs``
slice of the decoder's KV cache.
"""

from __future__ import annotations

import torch
from torch import nn
from repro_torch.models import attention, layers, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import fsdp
from repro_torch.parallel import sequence_parallel as seqp
from repro_torch.parallel import sharding


class DecBlock(nn.Module):
    def __init__(self, ln_attn, attn, ln_cross, xattn, ln_mlp, mlp):
        super().__init__()
        self.ln_attn, self.attn = ln_attn, attn
        self.ln_cross, self.xattn = ln_cross, xattn
        self.ln_mlp, self.mlp = ln_mlp, mlp


def init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> DecBlock:
    dev = gen.device
    return DecBlock(layers.init_rms_norm(cfg.d_model, dev),
                    attention.init_attention(gen, cfg),
                    layers.init_rms_norm(cfg.d_model, dev),
                    attention.init_attention(gen, cfg),
                    layers.init_rms_norm(cfg.d_model, dev),
                    layers.init_glu_mlp(gen, cfg.d_model, cfg.d_ff))


class EncDecLM(nn.Module):
    """Encoder blocks (``transformer.Block``s, the JAX tree's
    ``enc_layers``), ``enc_norm``, decoder blocks (``dec_layers``),
    ``final_norm`` and the untied ``lm_head``."""

    def __init__(self, cfg: ModelConfig, embed, enc_blocks, enc_norm,
                 dec_blocks, final_norm, lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = enc_norm
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head


@torch.no_grad()
def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> EncDecLM:
    dev = gen.device
    emb = layers.init_embed(gen, cfg.vocab_size, cfg.d_model)
    enc = [transformer.init_block(gen, cfg) for _ in range(cfg.n_enc_layers)]
    dec = [init_dec_block(gen, cfg) for _ in range(cfg.n_layers)]
    head = layers.init_embed(gen, cfg.vocab_size, cfg.d_model)
    return EncDecLM(cfg, emb, enc, layers.init_rms_norm(cfg.d_model, dev),
                    dec, layers.init_rms_norm(cfg.d_model, dev), head)


def _enc_block(p: transformer.Block, cfg: ModelConfig, x):
    h = layers.rms_norm(x, p.ln_attn.scale, cfg.norm_eps)
    x = x + attention.self_attention(p.attn, cfg, h, causal=False)
    h = layers.rms_norm(x, p.ln_mlp.scale, cfg.norm_eps)
    return x + layers.glu_mlp(h, p.mlp, cfg.act)


def encode(params: EncDecLM, cfg: ModelConfig, frames):
    """frames: [B, S_enc, d_model] stub embeddings -> encoder memory in
    the compute dtype."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs memory [B, "
                         "n_frontend_tokens, d_model]")
    x = frames.to(layers.dtype_of(cfg.dtype))
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in params.enc_blocks:
        if remat:
            x = seqp.checkpoint(fsdp.call, _enc_block, blk, cfg, x)
        else:
            x = fsdp.call(_enc_block, blk, cfg, x)
    return layers.rms_norm(x, params.enc_norm.scale, cfg.norm_eps)


def _dec_block(p: DecBlock, cfg: ModelConfig, x, memory, return_kv=False):
    h = layers.rms_norm(x, seqp.replicated(p.ln_attn.scale), cfg.norm_eps)
    out = attention.self_attention(p.attn, cfg, h, causal=True,
                                   return_kv=return_kv)
    if return_kv:
        out, kk, vv = out
    x = x + out
    h = layers.rms_norm(x, seqp.replicated(p.ln_cross.scale), cfg.norm_eps)
    x = x + attention.cross_attention(p.xattn, cfg, h, memory)
    h = layers.rms_norm(x, seqp.replicated(p.ln_mlp.scale), cfg.norm_eps)
    x = x + layers.glu_mlp(h, p.mlp, cfg.act)
    return (x, kk, vv) if return_kv else x


def forward(params: EncDecLM, cfg: ModelConfig, tokens, memory=None):
    """Teacher-forced decode over ``tokens`` given ``memory`` ([B, S_enc,
    d] stub frame embeddings, pre-encoder) -> (f32 logits [B, S, V], {})."""
    mem = encode(params, cfg, memory)
    emb, head = fsdp.ends(params)
    remat = cfg.remat and torch.is_grad_enabled()
    with seqp.stream(seqp.split(tuple(tokens.shape) + (cfg.d_model,))):
        x = layers.embed(tokens, emb, layers.dtype_of(cfg.dtype))
        for blk in params.dec_blocks:
            if remat:
                x = seqp.checkpoint(fsdp.call, _dec_block, blk, cfg, x, mem)
            else:
                x = fsdp.call(_dec_block, blk, cfg, x, mem)
        x = layers.rms_norm(x, seqp.replicated(params.final_norm.scale),
                            cfg.norm_eps)
        return layers.unembed(x, head), {}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """The decoder's stacked KV cache plus the encoded ``memory`` [B,
    n_frontend_tokens, d], both in ``dtype``; under a mesh context the
    rank's slice (``attention.init_kv_cache``), the memory its rows."""
    cache = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                    device=device)
    cache["memory"] = torch.zeros((cache["k"].shape[1], cfg.n_frontend_tokens,
                                   cfg.d_model), dtype=dtype, device=device)
    if "shard" in cache:
        cache["shard"]["memory"] = (cache["shard"]["k"][1], None, None)
    return cache


def prefill(params: EncDecLM, cfg: ModelConfig, tokens, cache, memory=None):
    """Encode the source into the cache's ``memory``, then run the decoder
    over the target prefix, writing its k/v into the cache at [0, S) (the
    rank's positions of it where T splits); returns (logits [B, 1, V] of
    the last position, cache).  The prefix's
    cross-attention reads the encoder's output, as the JAX package's
    does; decode reads the cache's copy."""
    b, s = tokens.shape
    mem = encode(params, cfg, memory)
    cache["memory"] = mem.to(cache["memory"].dtype)
    emb, head = fsdp.ends(params)
    sl = sharding.cache_slice(cache)
    with seqp.stream(seqp.split((b, s, cfg.d_model))):
        x = layers.embed(tokens, emb, layers.dtype_of(cfg.dtype))
        for i, blk in enumerate(params.dec_blocks):
            x, kk, vv = fsdp.call(_dec_block, blk, cfg, x, mem,
                                  return_kv=True)
            attention.write_prefix(cache["k"][i], kk, sl)
            attention.write_prefix(cache["v"][i], vv, sl)
        x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
        x = seqp.last_position(x)
    logits = layers.unembed(x, head)
    cache["length"] = s
    return logits, cache


def decode_step(params: EncDecLM, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: [B, 1] -> (logits [B, 1, V], cache); each
    layer writes this token's k/v into the cache in place, and its
    cross-attention projects the cached memory's k/v anew."""
    emb, head = fsdp.ends(params)
    x = layers.embed(tokens, emb, layers.dtype_of(cfg.dtype))
    length = cache["length"]
    mem = cache["memory"]
    sl = sharding.cache_slice(cache)
    for i, p in enumerate(params.dec_blocks):
        p = fsdp.gathered(p)
        h = layers.rms_norm(x, p.ln_attn.scale, cfg.norm_eps)
        lk, lv = attention.append_kv(p.attn, cfg, h, cache["k"][i],
                                     cache["v"][i], length, sl=sl)
        x = x + attention.decode_attention(p.attn, cfg, h, lk, lv, length,
                                           sl=sl)
        h = layers.rms_norm(x, p.ln_cross.scale, cfg.norm_eps)
        x = x + attention.cross_attention(p.xattn, cfg, h, mem)
        h = layers.rms_norm(x, p.ln_mlp.scale, cfg.norm_eps)
        x = x + layers.glu_mlp(h, p.mlp, cfg.act)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = layers.unembed(x, head)
    cache["length"] = length + 1
    return logits, cache
