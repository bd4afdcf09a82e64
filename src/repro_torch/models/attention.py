"""Attention: GQA with causal / sliding-window masks, cross-attention over
a modality memory, and KV-cache decode.

Prefill, the teacher-forced forward and training run ``flash_attention``,
which on the card launches the hand-written flash forward kernel
(``kernels.flash_attention.flash_fwd``, the counterpart of the JAX
package's Pallas ``flash_fwd``): the score matrix never reaches device
memory.  With grad enabled it goes through ``FlashAttention``, whose
backward is the flash backward kernel.  On the CPU both take the
kernels' plain versions, dense masked softmaxes.  Cross-attention (the
VLM's text -> image layers) takes the same kernels without a mask, at
S != T, and at S = 1 in decode.

Decode attends one query position against the cache.  Its scores are
``[B, KVH, G, 1, T]``, linear in T, and stay plain torch on every device,
as the JAX package computes them with einsums outside any Pallas kernel.
Its products accumulate in f32 (the JAX dots use
``preferred_element_type=f32``; a bf16 torch matmul would round its
output to bf16), and the probabilities are rounded to the value dtype
before the ``PV`` product, as in JAX.

Tensor parallelism.  The JAX package constrains q by "heads" and k/v by
"kv_heads", so GSPMD computes each rank's heads where they divide the
"model" axis.  Under ``parallel.tensor_parallel.active()`` with the q
heads split, a call is a rank-local region (``_Heads``): its input
enters through ``to_model`` (the gradient summed over "model"), it
projects the rank's q heads and the KV heads those heads read (all KV
heads where the call fills a cache and they do not split), runs the
flash kernel on them, and leaves through the row-parallel ``wo`` (one
sum over "model", a row-parallel bias added once after it).  A weight
stored split whose heads are computed whole is gathered; q/k norms and
whole weights used on part of the heads have their gradients summed
over "model".  Where the q heads do not split, attention is replicated
on every rank, its split-stored weights gathered.

The cache is ``{"k", "v": [L, B, T, KVH, D], "length": int}`` (KVH the
rank's KV heads where they split over "model"); the port
updates it in place (the JAX package returns a new one), and its length is
a host integer, so no decode step waits on the device to build its masks.
The transformer decodes with ``project_kv_token`` +
``decode_attention_append`` (the cache read only, the new token scored
from its own k); the SSM/hybrid and enc-dec families with ``append_kv`` +
``decode_attention``, as the JAX package does: the new k/v are written at
``length`` first, cast to the cache's dtype, and scored from there.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import layers
from repro_torch.parallel import tensor_parallel as tpl

NEG_INF = flash_kernel.NEG_INF


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm


def init_attention(gen: torch.Generator, cfg) -> Attention:
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    wq = layers.init_linear(gen, d, nq * hd, bias=cfg.qkv_bias)
    wk = layers.init_linear(gen, d, nkv * hd, bias=cfg.qkv_bias)
    wv = layers.init_linear(gen, d, nkv * hd, bias=cfg.qkv_bias)
    wo = layers.init_linear(gen, nq * hd, d)
    if cfg.qk_norm:
        return Attention(wq, wk, wv, wo,
                         layers.init_rms_norm(hd, gen.device),
                         layers.init_rms_norm(hd, gen.device))
    return Attention(wq, wk, wv, wo)


class _Heads:
    """The heads one call computes: q heads [q0, q0 + nq), KV heads
    [kv0, kv0 + nkv), and ``sel``, which KV heads (of those computed)
    the q heads read: None for all of them, else a slice of consecutive
    ones (each KV head read by the same number of q heads).
    ``tp`` is None without tensor parallelism (every head, the
    meshless ops); ``local``: the q heads are this rank's share, so the
    call is a rank-local region."""

    def __init__(self, cfg, all_kv: bool):
        self.tp = tp = tpl.active()
        self.cfg = cfg
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        self.q0, self.nq, self.kv0, self.nkv, self.sel = 0, h, 0, kvh, None
        self.local = tp is not None and tp.splits("heads", h)
        if not self.local:
            return
        self.q0, self.nq = tp.chunk(h)
        if tp.splits("kv_heads", kvh):
            self.kv0, self.nkv = tp.chunk(kvh)
            return
        g = h // kvh
        need = [(self.q0 + j) // g for j in range(self.nq)]
        first, n_sel = need[0], need[-1] - need[0] + 1
        if not all_kv:
            self.kv0, self.nkv = first, n_sel
        per = self.nq // n_sel
        if self.nq % n_sel or any(n != first + j // per
                                  for j, n in enumerate(need)):
            raise ValueError(
                f"{h} q heads over {kvh} KV heads on {tp.size} \"model\" "
                f"ranks: a rank's q heads [{self.q0}, {self.q0 + self.nq}) "
                "read unequal shares of their KV heads")
        if n_sel != self.nkv:
            self.sel = slice(first - self.kv0, first - self.kv0 + n_sel)

    def enter(self, x):
        """A replicated input of the region (its gradient summed)."""
        return tpl.to_model(x, self.tp.group) if self.local else x

    def select(self, kv):
        """The KV heads [B, T, ·, D] the q heads read."""
        return kv if self.sel is None else kv[:, :, self.sel]

    def proj(self, x, lin, h0: int, nh: int, n_heads: int):
        """x @ the columns of heads [h0, h0 + nh) of ``lin`` (+ bias)."""
        if self.tp is None:
            return layers.linear(x, lin.w, lin.b)
        hd = self.cfg.head_dim
        size, c0, n = n_heads * hd, h0 * hd, nh * hd
        cols = ((lambda w, d: tpl.part(w, d, size, c0, n, self.tp))
                if self.local else
                (lambda w, d: tpl.whole(w, d, size, self.tp)))
        y = x @ cols(lin.w, 1).to(x.dtype)
        if lin.b is not None:
            y = y + cols(lin.b, 0).to(x.dtype)
        return y

    def norm(self, x, scale):
        """RMS norm over head_dim; a replicated scale used on part of
        the heads has its gradient summed over "model"."""
        return layers.rms_norm(x, self.enter(scale), self.cfg.norm_eps)

    def out(self, p, o):
        """The output projection of o [B, S, nq·D]: row-parallel in a
        region (one sum over "model"), else ``wo`` whole."""
        size = self.cfg.n_heads * self.cfg.head_dim
        if self.tp is None:
            return layers.linear(o, p.wo.w)
        if self.local:
            return tpl.row_parallel(o, p.wo.w, p.wo.b, size, self.tp)
        return layers.linear(o, tpl.whole(p.wo.w, 0, size, self.tp),
                             p.wo.b)


def _project_qkv(p: Attention, cfg, x, positions, theta, hs=None):
    """q, k, v of the heads ``hs`` computes (a fresh ``_Heads`` of the
    current context by default)."""
    b, s, _ = x.shape
    hs = _Heads(cfg, all_kv=True) if hs is None else hs
    hd = cfg.head_dim
    x = hs.enter(x)
    q = hs.proj(x, p.wq, hs.q0, hs.nq, cfg.n_heads).reshape(b, s, hs.nq, hd)
    k = hs.proj(x, p.wk, hs.kv0, hs.nkv, cfg.n_kv_heads).reshape(
        b, s, hs.nkv, hd)
    v = hs.proj(x, p.wv, hs.kv0, hs.nkv, cfg.n_kv_heads).reshape(
        b, s, hs.nkv, hd)
    if cfg.qk_norm:
        q = hs.norm(q, p.q_norm.scale)
        k = hs.norm(k, p.k_norm.scale)
    if theta is not None:
        q = layers.rope(q, positions, theta)
        k = layers.rope(k, positions, theta)
    return q, k, v


def _is_arange(pos: torch.Tensor, n: int) -> bool:
    want = torch.arange(n, device=pos.device, dtype=pos.dtype)
    return pos.shape[-1] == n and bool((pos == want).all())


def flash_attention(q, k, v, qpos, kpos, *, causal=True, window=0):
    """Attention of q [B,S,H,D] over k/v [B,T,KVH,D] at positions
    qpos [B,S], kpos [B,T]; returns [B,S,H,D] in q's dtype.

    ``qpos`` / ``kpos`` of ``None`` mean ``0..S-1`` / ``0..T-1`` in every
    row, the positions the kernels take; the model passes ``None`` so that
    no layer waits on the device.  On the card a positions tensor is
    checked (one device sync) and anything but ``0..S-1`` / ``0..T-1``
    raises rather than compute something else.  With grad enabled the
    call goes through ``FlashAttention`` (the backward kernel on the card,
    its plain version on the CPU), else through ``flash_fwd``.  On the CPU
    explicit positions take the plain forward, differentiated by
    autograd."""
    if q.device.type == "cuda":
        if not ((qpos is None or _is_arange(qpos, q.shape[1]))
                and (kpos is None or _is_arange(kpos, k.shape[1]))):
            raise ValueError("flash_attention: the flash kernel takes "
                             "positions 0..S-1 and 0..T-1 only")
    elif qpos is not None or kpos is not None:
        flash_kernel._check_operands(q, k, v)
        return flash_kernel._flash_fwd_ref(q, k, v, causal=causal,
                                           window=window, qpos=qpos,
                                           kpos=kpos)[0]
    if torch.is_grad_enabled():
        return flash_kernel.flash_attention_kernel(q, k, v, causal, window)
    return flash_kernel.flash_fwd(q, k, v, causal=causal, window=window)[0]


def arange_positions(x: torch.Tensor) -> torch.Tensor:
    """Positions ``0..S-1`` of every row of x [B, S, ...], int32."""
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        b, s)


def self_attention(p: Attention, cfg, x, positions=None, *, causal=True,
                   window=0, theta=None, return_kv=False):
    """Full self-attention sub-layer (projections + flash + output).
    ``positions`` [B, S] of ``None`` means ``0..S-1`` in every row (what
    the model passes): rope takes ``arange_positions`` and the flash
    kernel its own positions, with no device check."""
    b, s, _ = x.shape
    theta = cfg.rope_theta if theta is None else theta
    rope_pos = arange_positions(x) if positions is None else positions
    hs = _Heads(cfg, all_kv=return_kv)
    q, k, v = _project_qkv(p, cfg, x, rope_pos, theta, hs)
    out = flash_attention(q, hs.select(k), hs.select(v), positions,
                          positions, causal=causal, window=window)
    out = hs.out(p, out.reshape(b, s, hs.nq * cfg.head_dim))
    if return_kv:
        return out, k, v
    return out


def cross_attention(p: Attention, cfg, x, memory):
    """Text -> memory cross-attention sub-layer: q from x [B,S,d], k/v
    from memory [B,T,d], no rope, QK-norm when set, no mask.  Without a
    causal or window mask positions change nothing, so the flash kernel
    takes its own ``0..S-1`` / ``0..T-1``.

    k/v take the memory's dtype (``linear`` casts the weights to its
    input's): an f32 memory under bf16 compute (the training batch's)
    gives f32 k/v, and the attention runs in f32 with q cast up, its
    output cast back to x's dtype, as the JAX package's flash promotes
    the mixed operands and returns q's dtype."""
    b, s, _ = x.shape
    t = memory.shape[1]
    hd = cfg.head_dim
    hs = _Heads(cfg, all_kv=False)
    x, memory = hs.enter(x), hs.enter(memory)
    q = hs.proj(x, p.wq, hs.q0, hs.nq, cfg.n_heads).reshape(b, s, hs.nq, hd)
    k = hs.proj(memory, p.wk, hs.kv0, hs.nkv, cfg.n_kv_heads).reshape(
        b, t, hs.nkv, hd)
    v = hs.proj(memory, p.wv, hs.kv0, hs.nkv, cfg.n_kv_heads).reshape(
        b, t, hs.nkv, hd)
    if cfg.qk_norm:
        q = hs.norm(q, p.q_norm.scale)
        k = hs.norm(k, p.k_norm.scale)
    dt = torch.promote_types(q.dtype, k.dtype)
    out = flash_attention(q.to(dt), hs.select(k).to(dt),
                          hs.select(v).to(dt), None, None, causal=False)
    return hs.out(p, out.to(x.dtype).reshape(b, s, hs.nq * hd))


# --------------------------------------------------------------------------
# KV cache (decode)
# --------------------------------------------------------------------------

def init_kv_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None,
                  n_layers=None):
    """[L, B, T, KVH, D] stacked cache (+ current length); L is
    ``n_layers`` when given (the hybrid's shared-block calls), else the
    config's layers."""
    nl = cfg.n_layers if n_layers is None else n_layers
    shape = (nl, batch, max_len, _Heads(cfg, all_kv=True).nkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


def _token_positions(x, length: int) -> torch.Tensor:
    return torch.full((x.shape[0], 1), length, dtype=torch.int32,
                      device=x.device)


def project_kv_token(p: Attention, cfg, x, length: int, *, theta=None):
    """This step's k/v [B,1,KVH,D] (the cache's KV heads), without
    writing the cache."""
    b = x.shape[0]
    hd = cfg.head_dim
    hs = _Heads(cfg, all_kv=True)
    theta = cfg.rope_theta if theta is None else theta
    k = hs.proj(x, p.wk, hs.kv0, hs.nkv, cfg.n_kv_heads).reshape(
        b, 1, hs.nkv, hd)
    v = hs.proj(x, p.wv, hs.kv0, hs.nkv, cfg.n_kv_heads).reshape(
        b, 1, hs.nkv, hd)
    if cfg.qk_norm:
        k = hs.norm(k, p.k_norm.scale)
    if theta is not None:
        k = layers.rope(k, _token_positions(x, length), theta)
    return k, v


def _decode_query(p: Attention, cfg, x, length: int, theta, hs, n_kv):
    """This step's query of the heads ``hs`` computes, grouped by the
    ``n_kv`` KV heads they read: [B,1,n_kv,G,D]."""
    b = x.shape[0]
    hd = cfg.head_dim
    theta = cfg.rope_theta if theta is None else theta
    q = hs.proj(x, p.wq, hs.q0, hs.nq, cfg.n_heads).reshape(b, 1, hs.nq, hd)
    if cfg.qk_norm:
        q = hs.norm(q, p.q_norm.scale)
    if theta is not None:
        q = layers.rope(q, _token_positions(x, length), theta)
    return q.reshape(b, 1, n_kv, hs.nq // n_kv, hd)


def _decode_scores(qg, keys):
    """f32 scores [B,KVH,G,1,T] of the grouped query against keys
    [B,T,KVH,D]: operands in q's dtype, products in f32."""
    return torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                        keys.to(qg.dtype).float()) / (qg.shape[-1] ** 0.5)


def _decode_values(wts, values):
    """f32 [B,1,KVH,G,D]: the weights, cast to the values' dtype, times
    the values [B,T,KVH,D]."""
    return torch.einsum("bkgqt,btkd->bqkgd", wts.to(values.dtype).float(),
                        values.float())


def decode_attention_append(p: Attention, cfg, x, layer_k, layer_v, k_new,
                            v_new, length: int, *, window=0, theta=None):
    """One-token attention: scores against the cache slots before
    ``length`` plus the new token's own score, computed separately (the
    cache is read only).  x [B,1,d]; layer_k/v [B,T,KVH,D]."""
    b, t = x.shape[0], layer_k.shape[1]
    hs = _Heads(cfg, all_kv=True)
    layer_k, layer_v = hs.select(layer_k), hs.select(layer_v)
    k_new, v_new = hs.select(k_new), hs.select(v_new)
    qg = _decode_query(p, cfg, x, length, theta, hs, layer_k.shape[2])
    s = _decode_scores(qg, layer_k)
    kpos = torch.arange(t, device=x.device)
    mask = kpos < length                       # strictly-past cache slots
    if window > 0:
        mask = mask & (kpos > length - window)
    s = s.masked_fill(~mask, NEG_INF)
    sc = torch.cat([s, _decode_scores(qg, k_new)], dim=-1)  # [..., T+1]
    wts = torch.softmax(sc, dim=-1)
    out = (_decode_values(wts[..., :t], layer_v)
           + _decode_values(wts[..., t:], v_new))
    out = out.reshape(b, 1, hs.nq * cfg.head_dim).to(x.dtype)
    return hs.out(p, out)


def write_kv_stack(cache_k, cache_v, ks, vs, length: int):
    """Write the per-layer k/v of one step [L,B,1,KVH,D] into the stacked
    [L,B,T,KVH,D] cache at position ``length``, in place."""
    cache_k[:, :, length:length + 1] = ks.to(cache_k.dtype)
    cache_v[:, :, length:length + 1] = vs.to(cache_v.dtype)
    return cache_k, cache_v


def append_kv(p: Attention, cfg, x, layer_k, layer_v, length: int, *,
              theta=None):
    """Project this step's k/v and write them into layer_k/v
    [B,T,KVH,D] at ``length``, cast to the cache's dtype, in place;
    returns (layer_k, layer_v).  With ``decode_attention`` this is the
    SSM/hybrid and enc-dec families' decode (the transformer's is
    ``project_kv_token`` + ``decode_attention_append``)."""
    k, v = project_kv_token(p, cfg, x, length, theta=theta)
    layer_k[:, length:length + 1] = k.to(layer_k.dtype)
    layer_v[:, length:length + 1] = v.to(layer_v.dtype)
    return layer_k, layer_v


def decode_attention(p: Attention, cfg, x, layer_k, layer_v, length: int,
                     *, theta=None):
    """One-token self-attention against the cache, which already holds
    this step's k/v at ``length`` (``append_kv``): the new token is scored
    from its cache copy, in the cache's dtype, as the JAX package scores
    it.  x [B,1,d]; layer_k/v [B,T,KVH,D]; returns [B,1,d].  No window:
    no family that decodes through it has one."""
    b, t = x.shape[0], layer_k.shape[1]
    hs = _Heads(cfg, all_kv=True)
    layer_k, layer_v = hs.select(layer_k), hs.select(layer_v)
    qg = _decode_query(p, cfg, x, length, theta, hs, layer_k.shape[2])
    s = _decode_scores(qg, layer_k)
    kpos = torch.arange(t, device=x.device)
    s = s.masked_fill(kpos > length, NEG_INF)
    out = _decode_values(torch.softmax(s, dim=-1), layer_v)
    out = out.reshape(b, 1, hs.nq * cfg.head_dim).to(x.dtype)
    return hs.out(p, out)
