"""The port's attention gradient (``FlashAttention``, its plain backward)
against the JAX package, on the CPU.

The JAX package's Pallas backward cannot trace with the installed jax (the
known ``tests/test_flash_kernel.py`` failures), so the oracle is
``jax.vjp`` of ``repro.models.attention.flash_attention``, the jnp
attention the JAX model trains through.  Inputs ~N(0, 1) from numpy seeds,
in float32; the six ``CASES`` shapes of ``tests/test_flash_kernel.py``
(its bf16 case in f32) plus a window that empties rows (S > T + window).

Tolerance: o, dq, dk, dv within 1e-5 relative and 1e-5 of the largest
|value| of each tensor (the two sum over keys and heads in other orders;
the worst seen is 1.1e-6 of the largest).  The plain backward against
``torch.autograd.grad`` of the plain forward in float64 within 1e-10, and
``gradcheck`` of the Function in float64 at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa

TOL = 1e-5

# (B, S, T, H, KVH, D, causal, window): tests/test_flash_kernel.py CASES,
# then rows past T + window - 1 with no visible key
CASES = [
    (1, 128, 128, 4, 4, 32, True, 0),
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 256, 256, 8, 1, 16, True, 0),
    (1, 128, 128, 4, 4, 32, False, 0),
    (1, 256, 256, 2, 2, 32, True, 64),
    (1, 128, 128, 4, 2, 32, True, 0),
    (2, 100, 40, 4, 2, 16, True, 20),
]


def _inputs(b, s, t, nq, nkv, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(dtype) for sh in
            ((b, s, nq, d), (b, t, nkv, d), (b, t, nkv, d), (b, s, nq, d))]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("b,s,t,nq,nkv,d,causal,window", CASES,
                         ids=[f"c{i}" for i in range(len(CASES))])
def test_flash_attention_function_matches_jax_vjp(b, s, t, nq, nkv, d,
                                                  causal, window):
    q, k, v, do = _inputs(b, s, t, nq, nkv, d)
    qpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    kpos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))

    @jax.jit
    def ref(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: jflash(
            q, k, v, qpos, kpos, causal=causal, window=window), q, k, v)
        return o, vjp(do)

    o, grads = ref(q, k, v, do)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ot = fa.flash_attention_kernel(qt, kt, vt, causal, window)
    ot.backward(torch.from_numpy(do))
    _close(ot.detach().numpy(), o)
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        assert got.shape == want.shape, name
        _close(got.numpy(), want)
    if s > t + window - 1 and window:
        empty = slice(t + window - 1, None)
        assert not qt.grad[:, empty].any()
        assert not ot[:, empty].any()


@pytest.mark.parametrize("causal,window,nq,nkv,s,t", [
    (True, 0, 2, 1, 6, 6), (True, 3, 4, 2, 7, 7), (False, 2, 2, 2, 5, 5),
    (True, 2, 2, 1, 9, 4)])
def test_flash_attention_gradcheck_float64(causal, window, nq, nkv, s, t):
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in
                  _inputs(1, s, t, nq, nkv, 4, seed=1, dtype=np.float64))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention_kernel(q, k, v, causal, window),
        (q, k, v))


@pytest.mark.parametrize("causal,window,g", [(True, 0, 1), (True, 5, 3),
                                             (False, 0, 2), (False, 4, 1)])
def test_plain_backward_equals_autograd_of_plain_forward(causal, window, g):
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(2, 19, 19, 2 * g, 2, 8, seed=2, dtype=np.float64))
    for x in (q, k, v):
        x.requires_grad_()
    o, m, l = fa._flash_fwd_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = fa._flash_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                            m.detach(), l.detach(), do, causal=causal,
                            window=window)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-10)


def test_plain_backward_keeps_the_input_dtypes_and_empty_rows_at_zero():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in
                   _inputs(1, 12, 5, 2, 1, 8, seed=3))
    o, m, l = fa.flash_fwd(q, k, v, causal=True, window=3)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, m, l, do, causal=True, window=3)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert (dq.shape, dk.shape) == (q.shape, k.shape)
    assert not dq[:, 7:].any() and not o[:, 7:].any()   # rows 7.. see none
    assert torch.equal(l[:, :, 7:], torch.zeros_like(l[:, :, 7:]))


def test_function_saves_the_recomputed_stats_under_checkpoint():
    """Under ``torch.utils.checkpoint`` the backward uses the forward run
    again in the recompute: the gradients equal those without it, and the
    forward runs twice."""
    from torch.utils.checkpoint import checkpoint
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(1, 33, 33, 4, 2, 8, seed=4))
    calls = []
    fwd = fa.flash_fwd

    def counted(*a, **kw):
        calls.append(1)
        return fwd(*a, **kw)

    grads = []
    for remat in (False, True):
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))

        def f(q, k, v):
            return fa.flash_attention_kernel(q, k, v, True, 5) * 2.0

        fa.flash_fwd = counted
        try:
            out = (checkpoint(f, qs, ks, vs, use_reentrant=False) if remat
                   else f(qs, ks, vs))
            out.backward(do)
        finally:
            fa.flash_fwd = fwd
        grads.append((qs.grad, ks.grad, vs.grad))
    assert len(calls) == 3              # once without remat, twice with
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_entry_points_record_no_graph():
    """``flash_fwd`` and ``flash_bwd`` are the kernels' entry points: they
    build no autograd graph on either device; ``FlashAttention`` does."""
    q, k, v, do = (torch.from_numpy(x).requires_grad_() for x in
                   _inputs(1, 8, 8, 2, 1, 8, seed=5))
    o, m, l = fa.flash_fwd(q, k, v)
    assert not (o.requires_grad or m.requires_grad or l.requires_grad)
    assert not any(x.requires_grad for x in fa.flash_bwd(q, k, v, o, m, l,
                                                          do))
    assert fa.flash_attention_kernel(q, k, v).grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_wrappers_want_16_byte_aligned_rows(dtype):
    """The bf16 kernels read q, k, v and do with TMA, which needs 16-byte
    aligned bases and row strides (8 bf16 or 4 f32 elements).  The
    wrappers refuse a view aligned to less, by its base or by a stride
    (in bf16: 4 elements, which the CUDA-core kernels took), before
    anything reaches a device; a 16-byte aligned view passes on to the
    device check (these tensors lie on the CPU)."""
    from repro_torch.kernels import cuda
    half = 16 // torch.zeros((), dtype=dtype).element_size() // 2
    x = torch.zeros((1, 8, 2, 48), dtype=dtype)
    good = x[..., 2 * half:2 * half + 32]
    by_base = x[..., half:half + 32]
    by_stride = torch.zeros((1, 8, 2, 32 + half), dtype=dtype)[..., :32]
    for bad in (by_base, by_stride):
        with pytest.raises(ValueError, match="aligned to 16 bytes"):
            cuda.flash_fwd(bad, good, good)
        with pytest.raises(ValueError, match="aligned to 16 bytes"):
            cuda.flash_bwd(good, good, good, good, None, None, bad)
    with pytest.raises(ValueError, match="cpu"):
        cuda.flash_fwd(good, good, good)
