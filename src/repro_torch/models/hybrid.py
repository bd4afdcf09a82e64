"""SSM (mamba2) and hybrid (zamba2) language models.

mamba2-370m: a pure stack of SSD blocks (attention-free).
zamba2-1.2b: a Mamba2 backbone with ONE shared transformer block
(attention + MLP, one parameter set; the port's ``transformer.Block``)
called after every ``hybrid_every`` SSM layers with window 0 and
``rope_theta``, the tail SSM layers after the last call (arXiv:2411.15242;
the JAX package's simplifications: no per-call LoRA, and the shared block
reads the running hidden state).

Both families carry O(1)-per-token SSM state; the hybrid's KV cache holds
one layer per shared-block call.  With ``cfg.remat`` and grad enabled,
each SSM block and each shared call runs under its own non-reentrant
``torch.utils.checkpoint``, as the JAX package wraps each in
``jax.checkpoint``.  Decode runs the shared block through ``append_kv``
and ``decode_attention``, as the JAX package does, and updates every
cache in place.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers, ssm, transformer
from repro_torch.models.config import ModelConfig


class SSMBlock(nn.Module):
    def __init__(self, ln, mixer):
        super().__init__()
        self.ln, self.ssm = ln, mixer


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig) -> SSMBlock:
    return SSMBlock(layers.init_rms_norm(cfg.d_model, gen.device),
                    ssm.init_ssm(gen, cfg))


def _ssm_block_forward(p: SSMBlock, cfg: ModelConfig, x):
    h = layers.rms_norm(x, p.ln.scale, cfg.norm_eps)
    return x + ssm.ssd_forward(h, p.ssm, cfg)


class HybridLM(nn.Module):
    """The SSM blocks (``blocks``, the JAX tree's stacked ``layers``), the
    hybrid's ``shared_block`` (None for the pure SSM) and the tied or
    untied head."""

    def __init__(self, cfg: ModelConfig, embed, blocks, final_norm,
                 shared_block=None, lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.shared_block = shared_block
        self.lm_head = lm_head

    def head(self) -> layers.Embed:
        return self.embed if self.cfg.tie_embeddings else self.lm_head


@torch.no_grad()
def init_lm(gen: torch.Generator, cfg: ModelConfig) -> HybridLM:
    emb = layers.init_embed(gen, cfg.vocab_size, cfg.d_model)
    blocks = [init_ssm_block(gen, cfg) for _ in range(cfg.n_layers)]
    final_norm = layers.init_rms_norm(cfg.d_model, gen.device)
    shared = transformer.init_block(gen, cfg) if cfg.is_hybrid else None
    head = (None if cfg.tie_embeddings
            else layers.init_embed(gen, cfg.vocab_size, cfg.d_model))
    return HybridLM(cfg, emb, blocks, final_norm, shared, head)


def n_shared_calls(cfg: ModelConfig) -> int:
    """The shared block's calls in one pass (0 for the pure SSM)."""
    return cfg.n_layers // cfg.hybrid_every if cfg.is_hybrid else 0


def _groups(cfg: ModelConfig):
    """(the SSM layers before each shared call, the tail layers after the
    last call) as ranges of layer indices."""
    every, n_inv = cfg.hybrid_every, n_shared_calls(cfg)
    if not n_inv:
        return [], range(cfg.n_layers)
    return ([range(i * every, (i + 1) * every) for i in range(n_inv)],
            range(n_inv * every, cfg.n_layers))


def _shared_forward(p: transformer.Block, cfg: ModelConfig, x):
    return transformer.block_forward(p, cfg, x, None, 0, cfg.rope_theta)[0]


def forward(params: HybridLM, cfg: ModelConfig, tokens, memory=None):
    """Training/prefill forward -> (f32 logits [B, S, V], {})."""
    del memory
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(tokens, params.embed, dt)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    groups, tail = _groups(cfg)
    for grp in groups:
        for i in grp:
            x = run(_ssm_block_forward, params.blocks[i], cfg, x)
        x = run(_shared_forward, params.shared_block, cfg, x)
    for i in tail:
        x = run(_ssm_block_forward, params.blocks[i], cfg, x)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    return layers.unembed(x, params.head()), {}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """The f32 SSM state and conv window of every layer, ``length``, and
    for the hybrid a KV cache of one layer per shared call in ``dtype``."""
    cache = ssm.init_ssm_cache(cfg, batch, cfg.n_layers, device=device)
    cache["length"] = 0
    if cfg.is_hybrid:
        kv = attention.init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                     device=device,
                                     n_layers=n_shared_calls(cfg))
        cache["k"], cache["v"] = kv["k"], kv["v"]
    return cache


def _ssm_block_decode(p: SSMBlock, cfg, x, state, conv):
    h = layers.rms_norm(x, p.ln.scale, cfg.norm_eps)
    y, _, _ = ssm.ssd_decode_step(h, p.ssm, cfg, state, conv)
    return x + y


def _shared_decode(p: transformer.Block, cfg, x, layer_k, layer_v,
                   length: int):
    h = layers.rms_norm(x, p.ln_attn.scale, cfg.norm_eps)
    attention.append_kv(p.attn, cfg, h, layer_k, layer_v, length)
    x = x + attention.decode_attention(p.attn, cfg, h, layer_k, layer_v,
                                       length)
    h = layers.rms_norm(x, p.ln_mlp.scale, cfg.norm_eps)
    return x + layers.glu_mlp(h, p.mlp, cfg.act)


def decode_step(params: HybridLM, cfg: ModelConfig, cache, tokens):
    """One decode step.  tokens: [B, 1] -> (logits [B, 1, V], cache); the
    SSM states, conv windows and the shared block's k/v are written in
    place."""
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(tokens, params.embed, dt)
    length = cache["length"]
    groups, tail = _groups(cfg)

    def run(idx, x):
        for i in idx:
            x = _ssm_block_decode(params.blocks[i], cfg, x,
                                  cache["state"][i], cache["conv"][i])
        return x

    for g, grp in enumerate(groups):
        x = run(grp, x)
        x = _shared_decode(params.shared_block, cfg, x, cache["k"][g],
                           cache["v"][g], length)
    x = run(tail, x)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = layers.unembed(x, params.head())
    cache["length"] = length + 1
    return logits, cache


def prefill(params: HybridLM, cfg: ModelConfig, tokens, cache, memory=None):
    """Full-sequence prefill: the chunked SSD of every layer, its final
    state and conv window written into the cache, and for the hybrid the
    shared calls' k/v written into the cache prefix [0, S); returns
    (logits [B, 1, V] of the last position, cache).

    A prompt shorter than ``ssm_conv - 1`` tokens raises ``ValueError``:
    its conv window would be shorter than the decode's, and the JAX
    package's decode then fails on it (ROADMAP Queue C)."""
    del memory
    b, s = tokens.shape
    if s < cfg.ssm_conv - 1:
        raise ValueError(f"{cfg.name}: a prompt of {s} tokens is shorter "
                         f"than the conv window ({cfg.ssm_conv - 1})")
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(tokens, params.embed, dt)
    groups, tail = _groups(cfg)

    def run(idx, x):
        for i in idx:
            blk = params.blocks[i]
            h = layers.rms_norm(x, blk.ln.scale, cfg.norm_eps)
            y, st, cv = ssm.ssd_prefill(h, blk.ssm, cfg)
            x = x + y
            cache["state"][i] = st.to(cache["state"].dtype)
            cache["conv"][i] = cv.to(cache["conv"].dtype)
        return x

    for g, grp in enumerate(groups):
        x = run(grp, x)
        x, _, (kk, vv) = transformer.block_forward(
            params.shared_block, cfg, x, None, 0, cfg.rope_theta,
            return_kv=True)
        cache["k"][g, :, :s] = kk.to(cache["k"].dtype)
        cache["v"][g, :, :s] = vv.to(cache["v"].dtype)
    x = run(tail, x)
    x = layers.rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = layers.unembed(x[:, -1:], params.head())
    cache["length"] = s
    return logits, cache
