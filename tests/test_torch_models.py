"""The port's model layers and attention against the JAX package, on the
CPU, on the same seeded numpy inputs.

Tolerances: gathers and casts (``embed``, ``write_kv_stack``) are exact.
Everything else agrees within 1e-6 relative in float32: reductions and
matmuls sum in another order, and the elementwise rope and activations
call exp, sin, cos and tanh, whose last bit differs between XLA's CPU
backend and torch (and between torch builds for different vector
units); rope in bfloat16 within one bf16 rounding (2^-8).  Attention
agrees within 1e-5 in float32; in bfloat16 within 2e-2, two bf16 ulps at
|o| <= 2 (the outputs are rounded to bf16 once, and the jnp flash also
rounds its probabilities to bf16 before the PV product).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn, layers as jlayers
from repro_torch import configs
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import attention, layers

RTOL = 1e-6
F32_ATTN, BF16_ATTN = 1e-5, 2e-2


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(x, dtype=np.float32):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_rms_norm():
    xj, xt = _both(_rng().normal(size=(2, 5, 48)))
    wj, wt = _both(_rng(1).normal(size=(48,)) * 0.1)
    np.testing.assert_allclose(_np(layers.rms_norm(xt, wt, 1e-6)),
                               _np(jlayers.rms_norm(xj, wj, 1e-6)),
                               rtol=RTOL, atol=RTOL)


def test_linear_with_bias():
    xj, xt = _both(_rng().normal(size=(2, 5, 48)))
    wj, wt = _both(_rng(1).normal(size=(48, 24)))
    bj, bt = _both(_rng(2).normal(size=(24,)))
    np.testing.assert_allclose(_np(layers.linear(xt, wt, bt)),
                               _np(jlayers.linear(xj, wj, bj)),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_mlp(act):
    rng = _rng(3)
    xj, xt = _both(rng.normal(size=(2, 5, 32)))
    ws = {n: rng.normal(size=s) / np.sqrt(s[0]) for n, s in
          (("gate", (32, 64)), ("up", (32, 64)), ("down", (64, 32)))}
    pj = {n: {"w": jnp.asarray(w, jnp.float32)} for n, w in ws.items()}
    pt = layers.GLUMLP(*(layers.Linear(torch.from_numpy(
        ws[n].astype(np.float32))) for n in ("gate", "up", "down")))
    np.testing.assert_allclose(_np(layers.glu_mlp(xt, pt, act)),
                               _np(jlayers.glu_mlp(xj, pj, act)),
                               rtol=RTOL, atol=RTOL)


def test_embed_and_unembed():
    rng = _rng(4)
    tj, tt = _both(rng.normal(size=(50, 16)))
    tok = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    got = layers.embed(torch.from_numpy(tok), layers.Embed(tt),
                       torch.bfloat16)
    want = jlayers.embed(jnp.asarray(tok), tj, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    xj, xt = _both(rng.normal(size=(2, 7, 16)))
    got = layers.unembed(xt.to(torch.bfloat16), layers.Embed(tt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        _np(got), _np(jlayers.unembed(xj.astype(jnp.bfloat16), tj)),
        rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    rng = _rng(5)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    got = layers.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                      theta)
    want = jlayers.rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta)
    assert got.dtype == tdt
    tol = RTOL if dtype == "float32" else 2**-8
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _attn_params(cfg, seed):
    """Random attention params (biases and qk-norm scales nonzero) as the
    JAX dict and the port's module."""
    rng = _rng(seed)
    hd, nq, nkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    shapes = {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
              "wo": (nq * hd, d)}
    pj, mods = {}, {}
    for n, s in shapes.items():
        w = (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
        bias = cfg.qkv_bias and n != "wo"
        b = rng.normal(size=s[1]).astype(np.float32) * 0.1 if bias else None
        pj[n] = {"w": jnp.asarray(w)} | ({"b": jnp.asarray(b)} if bias
                                         else {})
        mods[n] = layers.Linear(torch.from_numpy(w), None if b is None
                                else torch.from_numpy(b))
    norms = ()
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            sc = (rng.normal(size=hd) * 0.1).astype(np.float32)
            pj[n] = {"scale": jnp.asarray(sc)}
            norms += (layers.RMSNorm(torch.from_numpy(sc)),)
    return pj, attention.Attention(mods["wq"], mods["wk"], mods["wv"],
                                   mods["wo"], *norms)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])
def test_project_qkv(arch):
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    pj, pt = _attn_params(cfg, 6)
    xj, xt = _both(_rng(7).normal(size=(2, 11, cfg.d_model)))
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    got = attention._project_qkv(pt, cfg, xt, torch.from_numpy(pos), 1e4)
    want = jattn._project_qkv(pj, jcfg, xj, jnp.asarray(pos), 1e4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=1e-5)


def dense_reference(q, k, v, *, causal=True, window=0):
    """O(S·T) numpy attention in float64, GQA via repeat."""
    q, k, v = (np.asarray(_np(x), np.float64) for x in (q, k, v))
    b, s, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    kf = np.repeat(k, nq // nkv, axis=2)
    vf = np.repeat(v, nq // nkv, axis=2)
    sc = np.einsum("bshd,bthd->bhst", q, kf) / np.sqrt(d)
    qpos, kpos = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    sc = np.where(mask, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    p = np.exp(sc - m)
    l = p.sum(-1, keepdims=True)
    return np.einsum("bhst,bthd->bshd", p / l, vf), m, l


# (B, S, T, nq, nkv, D, causal, window, dtype): the six CASES of
# tests/test_flash_kernel.py, then S not a multiple of any chunk, windows
# on and off
CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, "float32"),
    (2, 128, 128, 4, 2, 32, True, 0, "float32"),
    (1, 256, 256, 8, 1, 16, True, 0, "float32"),
    (1, 128, 128, 4, 4, 32, False, 0, "float32"),
    (1, 256, 256, 2, 2, 32, True, 64, "float32"),
    (1, 128, 128, 4, 2, 32, True, 0, "bfloat16"),
    (2, 100, 100, 4, 2, 16, True, 0, "float32"),
    (2, 100, 100, 4, 1, 16, True, 24, "float32"),
    (1, 77, 77, 2, 2, 32, False, 10, "float32"),
    (2, 100, 100, 4, 2, 16, True, 24, "bfloat16"),
]


def _qkv(b, s, t, nq, nkv, d, dtype, seed=0):
    rng = _rng(seed)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, nq, d), (b, t, nkv, d), (b, t, nkv, d))]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("b,s,t,nq,nkv,d,causal,window,dtype", CASES,
                         ids=[f"c{i}" for i in range(len(CASES))])
def test_flash_attention_plain_path(b, s, t, nq, nkv, d, causal, window,
                                    dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(b, s, t, nq, nkv, d, dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    got = attention.flash_attention(qt, kt, vt, torch.from_numpy(pos),
                                    torch.from_numpy(pos), causal=causal,
                                    window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want_jnp = jattn.flash_attention(qj, kj, vj, jnp.asarray(pos),
                                     jnp.asarray(pos), causal=causal,
                                     window=window, q_chunk=64, kv_chunk=64)
    want, _, _ = dense_reference(qt, kt, vt, causal=causal, window=window)
    tol = F32_ATTN if dtype == "float32" else BF16_ATTN
    np.testing.assert_allclose(_np(got), _np(want_jnp), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_flash_fwd_returns_the_softmax_stats(causal, window):
    (_, _, _), (q, k, v) = _qkv(2, 50, 50, 4, 2, 16, "float32", seed=1)
    o, m, l = flash.flash_fwd(q, k, v, causal=causal, window=window)
    want_o, want_m, want_l = dense_reference(q, k, v, causal=causal,
                                             window=window)
    assert m.shape == l.shape == (2, 4, 50, 1) and m.dtype == torch.float32
    np.testing.assert_allclose(_np(o), want_o, rtol=F32_ATTN, atol=F32_ATTN)
    np.testing.assert_allclose(_np(m), want_m, rtol=F32_ATTN, atol=F32_ATTN)
    np.testing.assert_allclose(_np(l), want_l, rtol=F32_ATTN, atol=F32_ATTN)


def test_flash_fwd_bf16_against_rounded_probabilities():
    """The kernel keeps P in f32 (as the Pallas kernel does); the jnp flash
    rounds it to the value dtype: both within the bf16 tolerance."""
    _, (q, k, v) = _qkv(1, 64, 64, 2, 1, 32, "bfloat16", seed=2)
    o, _, _ = flash.flash_fwd(q, k, v, causal=True)
    o_rounded, _, _ = flash._flash_fwd_ref(q, k, v, causal=True,
                                           p_dtype=torch.bfloat16)
    np.testing.assert_allclose(_np(o), _np(o_rounded), rtol=BF16_ATTN,
                               atol=BF16_ATTN)


def test_flash_fwd_refuses_gradients():
    """The kernel entry point records no autograd graph (gradients go
    through ``FlashAttention``, whose backward is the flash backward)."""
    _, (q, k, v) = _qkv(1, 8, 8, 2, 1, 8, "float32")
    o, m, l = flash.flash_fwd(q.requires_grad_(), k, v)
    assert not (o.requires_grad or m.requires_grad or l.requires_grad)
    assert flash.FlashAttention.apply(q, k, v, True, 0).requires_grad


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_append_and_write_kv_stack(window):
    cfg = dataclasses.replace(configs.smoke("gemma3-1b"), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke("gemma3-1b"), dtype="float32")
    pj, pt = _attn_params(cfg, 8)
    rng = _rng(9)
    b, t, length = 2, 12, 9
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    lk, lv, kn, vn = (rng.normal(size=sh).astype(np.float32) for sh in
                      ((b, t, kvh, hd), (b, t, kvh, hd), (b, 1, kvh, hd),
                       (b, 1, kvh, hd)))
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    got = attention.decode_attention_append(
        pt, cfg, torch.from_numpy(x), torch.from_numpy(lk),
        torch.from_numpy(lv), torch.from_numpy(kn), torch.from_numpy(vn),
        length, window=window, theta=1e4)
    want = jattn.decode_attention_append(
        pj, jcfg, jnp.asarray(x), jnp.asarray(lk), jnp.asarray(lv),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(length, jnp.int32),
        window=window, theta=1e4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)

    ks = rng.normal(size=(3, b, 1, kvh, hd)).astype(np.float32)
    vs = rng.normal(size=(3, b, 1, kvh, hd)).astype(np.float32)
    ck = torch.zeros((3, b, t, kvh, hd), dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    nk, nv = attention.write_kv_stack(ck, cv, torch.from_numpy(ks),
                                      torch.from_numpy(vs), length)
    assert nk is ck and nv is cv             # in place
    jk, jv = jattn.write_kv_stack(jnp.zeros(ck.shape, jnp.bfloat16),
                                  jnp.zeros(ck.shape, jnp.bfloat16),
                                  jnp.asarray(ks), jnp.asarray(vs),
                                  jnp.asarray(length, jnp.int32))
    np.testing.assert_array_equal(_np(nk), _np(jk))
    np.testing.assert_array_equal(_np(nv), _np(jv))


def test_layer_schedule_matches_repro():
    from repro.models import transformer as jtr
    from repro_torch.models import transformer
    for arch in ("gemma3-1b", "qwen2-1.5b", "yi-34b"):
        w, th = transformer.layer_schedule(configs.get(arch))
        jw, jth = jtr.layer_schedule(jconfigs.get(arch))
        assert w == np.asarray(jw).tolist()
        np.testing.assert_array_equal(np.float32(th), np.asarray(jth))


def test_init_kv_cache_shape():
    cfg = configs.smoke("qwen2-1.5b")
    cache = attention.init_kv_cache(cfg, 3, 17, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 3, 17, cfg.n_kv_heads,
                                cfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16 and cache["length"] == 0
    jcache = jattn.init_kv_cache(jconfigs.smoke("qwen2-1.5b"), 3, 17)
    assert tuple(cache["v"].shape) == jcache["v"].shape
    assert jax.tree.structure(jcache) == jax.tree.structure(
        {k: 0 for k in cache})


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_flash_attention_none_positions_mean_arange(causal, window):
    """``None`` positions (what the model passes, so the card makes no
    device check per layer) are 0..S-1 / 0..T-1 in every row."""
    _, (q, k, v) = _qkv(2, 40, 40, 4, 2, 16, "float32", seed=3)
    pos = torch.arange(40, dtype=torch.int32)[None].expand(2, 40)
    got = attention.flash_attention(q, k, v, None, None, causal=causal,
                                    window=window)
    want = attention.flash_attention(q, k, v, pos, pos, causal=causal,
                                     window=window)
    assert torch.equal(got, want)
    assert torch.equal(attention.arange_positions(q), pos)


# (arch, x dtype, memory dtype, S, T): the VLM's smoke config, a QK-norm
# config, one query position (decode), and bf16 queries over an f32
# memory (the training batch's), which both packages run in f32
CROSS = [("llama-3.2-vision-11b", "float32", "float32", 9, 16),
         ("qwen3-moe-30b-a3b", "float32", "float32", 7, 20),
         ("llama-3.2-vision-11b", "float32", "float32", 1, 16),
         ("llama-3.2-vision-11b", "bfloat16", "float32", 9, 16)]


@pytest.mark.parametrize("arch,xdt,mdt,s,t", CROSS,
                         ids=[f"x{i}" for i in range(len(CROSS))])
def test_cross_attention_matches_repro(arch, xdt, mdt, s, t):
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    pj, pt = _attn_params(cfg, 10)
    rng = _rng(11)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    got = attention.cross_attention(pt, cfg, torch.from_numpy(x).to(tdt[xdt]),
                                    torch.from_numpy(mem).to(tdt[mdt]))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = jattn.cross_attention(pj, jcfg, jnp.asarray(x, jdt[xdt]),
                                 jnp.asarray(mem, jdt[mdt]), jnp.asarray(pos))
    assert got.dtype == tdt[xdt] and got.shape == x.shape
    assert want.dtype == jdt[xdt]
    tol = F32_ATTN if xdt == "float32" else BF16_ATTN
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
