"""The port's SSD block (``repro_torch.models.ssm``) and the mamba2 family
against the JAX package, on the CPU, on the same seeded numpy inputs.

Parameters come from the JAX package's ``init_lm`` (mamba2-370m's smoke
config in float32) through ``convert.lm_params_from_numpy``; the block
tests take layer 0's SSD mixer.  Sequence lengths: below one chunk, not a
multiple of the chunk (past 128), and, at ``chunk`` 16, many chunks, also
run in blocks of chunks (``ssm.BLOCK_ELEMENTS`` lowered) as long prompts
run.

Tolerance ``TOL`` (``test_torch_train.py``'s): 1e-5 relative and 1e-5
of each array's largest |value| (``_close``).  The port computes a
block of chunks' terms at once and einsum contracts the 4-operand state update in
its own order, so the f32 sums differ from JAX's by rounding only; the
decode's recurrence likewise.  The conv window is a copy of the input projection, whose
matmul XLA and torch round differently, so it too is held to ``TOL``.

One widening, ``A_LOG_TOL`` = 2e-4 (relative, and of the largest
|value|), for the gradient of ``a_log`` alone: it sums the log-decay's
cotangent over every position pair of every chunk, whose terms cancel
(the cumsum's backward takes differences of running sums).  At these
inputs the JAX package's f32 gradient and the port's are each up to 5.5e-5
from a float64 evaluation of the same function (|da_log| <= 1.11), so
they differ from each other by up to 3.2e-5, past ``TOL``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import zoo as jzoo
from repro_torch import configs, convert
from repro_torch.models import hybrid, ssm, zoo

TOL = 1e-5
A_LOG_TOL = 2e-4
ARCH = "mamba2-370m"
B = 2


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _cfgs():
    return (dataclasses.replace(configs.smoke(ARCH), dtype="float32"),
            dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _tree(dt_bias=0.0):
    """JAX's init_lm tree (numpy leaves); ``dt_bias`` shifts every layer's
    dt bias (large values make the masked decays overflow before exp)."""
    _, jcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jzoo.build(jcfg).init(jax.random.key(0)))
    tree["layers"]["ssm"]["dt_bias"] = (tree["layers"]["ssm"]["dt_bias"]
                                        + np.float32(dt_bias))
    return tree


def _block_params(dt_bias=0.0):
    """(JAX's layer-0 SSD params, the port's layer-0 SSM module)."""
    cfg, _ = _cfgs()
    tree = _tree(dt_bias)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])
    model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    return jp, model.blocks[0].ssm


def _x(s, seed=1):
    cfg, _ = _cfgs()
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


# (S, chunk): below one chunk, past 128 and not a multiple, many chunks
SHAPES = [(37, 128), (200, 128), (50, 16)]


@pytest.mark.parametrize("s,chunk", SHAPES)
def test_ssd_forward_matches_repro(s, chunk):
    cfg, jcfg = _cfgs()
    jp, tp = _block_params()
    x = _x(s)
    want = jssm.ssd_forward(jnp.asarray(x), jp, jcfg, chunk=chunk)
    with torch.no_grad():
        got = ssm.ssd_forward(torch.from_numpy(x), tp, cfg, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("s,chunk", SHAPES)
def test_ssd_prefill_state_and_conv_window_match_repro(s, chunk):
    cfg, jcfg = _cfgs()
    jp, tp = _block_params()
    x = _x(s, seed=2)
    wy, wst, wcv = jssm.ssd_prefill(jnp.asarray(x), jp, jcfg, chunk=chunk)
    with torch.no_grad():
        gy, gst, gcv = ssm.ssd_prefill(torch.from_numpy(x), tp, cfg,
                                       chunk=chunk)
    _close(gy, wy)
    assert gst.dtype == gcv.dtype == torch.float32
    _close(gst, wst)
    assert gcv.shape == (B, cfg.ssm_conv - 1,
                         cfg.d_inner_ssm + 2 * cfg.ssm_state)
    _close(gcv, wcv)


def test_ssd_decode_steps_match_repro():
    """Six recurrent steps from a prefill over 130 positions (two chunks):
    each step's output, state and conv window."""
    cfg, jcfg = _cfgs()
    jp, tp = _block_params()
    x = _x(136, seed=3)
    _, jst, jcv = jssm.ssd_prefill(jnp.asarray(x[:, :130]), jp, jcfg)
    with torch.no_grad():
        _, tst, tcv = ssm.ssd_prefill(torch.from_numpy(x[:, :130]), tp, cfg)
        for i in range(130, 136):
            xi = x[:, i:i + 1]
            jy, jst, jcv = jssm.ssd_decode_step(jnp.asarray(xi), jp, jcfg,
                                                jst, jcv)
            ty, st2, cv2 = ssm.ssd_decode_step(torch.from_numpy(xi), tp, cfg,
                                               tst, tcv)
            assert st2 is tst and cv2 is tcv          # written in place
            _close(ty, jy, err_msg=f"y at {i}")
            _close(tst, jst, err_msg=f"state at {i}")
            _close(tcv, jcv, err_msg=f"conv at {i}")


@pytest.mark.parametrize("dt_bias", [0.0, 4.0], ids=["init", "overflowing"])
def test_ssd_gradients_match_repro(dt_bias):
    """d/dx and d/dparams of sum(ssd_forward * r) at 200 positions; with
    the dt bias raised by 4 the masked decays cum_i - cum_j (j > i) reach
    ~1e4 and overflow exp, which masking before exp keeps out of the
    gradient (no NaN, as in JAX)."""
    cfg, jcfg = _cfgs()
    jp, tp = _block_params(dt_bias)
    x = _x(200, seed=4)
    r = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jssm.ssd_forward(x, p, jcfg) * r)
    (jgp, jgx) = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ssm.ssd_forward(xt, tp, cfg) * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, jgx, err_msg="dx")
    for name, prm in tp.named_parameters():
        assert torch.isfinite(prm.grad).all(), name
        want = jgp
        for part in name.split("."):
            want = want[part]
        _close(prm.grad, want, A_LOG_TOL if name == "a_log" else TOL,
               err_msg=f"d{name}")


@pytest.mark.parametrize("per_block", [1, 3])
def test_ssd_in_blocks_of_chunks_matches_repro(per_block, monkeypatch):
    """The chunks in blocks of 1 and of 3 (13 chunks of 16 at S = 200: the
    last block short), as a long prompt runs them: the prefill's output,
    state and conv window, and d/dx and d/dparams, against the JAX
    package's scan over the same chunks."""
    cfg, jcfg = _cfgs()
    chunk = 16
    monkeypatch.setattr(ssm, "BLOCK_ELEMENTS",
                        per_block * B * chunk * chunk * cfg.n_ssm_heads)
    jp, tp = _block_params()
    x = _x(200, seed=7)
    r = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    wy, wst, wcv = jssm.ssd_prefill(jnp.asarray(x), jp, jcfg, chunk=chunk)
    with torch.no_grad():
        gy, gst, gcv = ssm.ssd_prefill(torch.from_numpy(x), tp, cfg,
                                       chunk=chunk)
    _close(gy, wy)
    _close(gst, wst)
    _close(gcv, wcv)

    def jloss(p, x):
        return jnp.sum(jssm.ssd_forward(x, p, jcfg, chunk=chunk) * r)
    (jgp, jgx) = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ssm.ssd_forward(xt, tp, cfg, chunk=chunk)
     * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, jgx, err_msg="dx")
    for name, prm in tp.named_parameters():
        want = jgp
        for part in name.split("."):
            want = want[part]
        _close(prm.grad, want, A_LOG_TOL if name == "a_log" else TOL,
               err_msg=f"d{name}")


# --------------------------------------------------------------------------
# the mamba2 family: serving through zoo.build
# --------------------------------------------------------------------------

N_DEC, PROMPT = 6, 140


@functools.lru_cache(maxsize=None)
def _jax_serve():
    """JAX: prefill, N_DEC decode steps fed fixed tokens, and the forward
    over prompt + fed tokens, in one jit."""
    _, jcfg = _cfgs()
    model = jzoo.build(jcfg)
    tree = _tree()
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(B, PROMPT + N_DEC)).astype(np.int32)

    @jax.jit
    def run(params, toks):
        cache = model.init_cache(B, PROMPT + N_DEC, dtype=jnp.float32)
        pre, cache = model.prefill(params, toks[:, :PROMPT], cache)
        pre_cache = cache
        dec = []
        for i in range(N_DEC):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, PROMPT + i:PROMPT + i + 1])
            dec.append(lg[:, 0])
        full, _ = model.forward(params, toks)
        return pre, pre_cache, jnp.stack(dec, 1), cache, full

    out = jax.tree.map(np.asarray, run(jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(toks)))
    return toks, out


def test_mamba2_serving_path_matches_repro():
    cfg, _ = _cfgs()
    toks, (pre, pre_cache, dec, cache, full) = _jax_serve()
    model = zoo.build(cfg)
    params = convert.lm_params_from_numpy(_tree(), cfg, device="cpu")
    t = torch.from_numpy(toks)
    with torch.no_grad():
        c = model.init_cache(B, PROMPT + N_DEC, dtype=torch.float32,
                             device="cpu")
        assert c.keys() == {"state", "conv", "length"}
        assert c["state"].dtype == c["conv"].dtype == torch.float32
        tpre, c = model.prefill(params, t[:, :PROMPT], c)
        _close(tpre, pre)
        _close(c["state"], pre_cache["state"])
        _close(c["conv"], pre_cache["conv"])
        assert c["length"] == PROMPT
        tdec = []
        for i in range(N_DEC):
            lg, c = model.decode_step(params, c,
                                      t[:, PROMPT + i:PROMPT + i + 1])
            tdec.append(lg[:, 0])
        _close(torch.stack(tdec, 1), dec)
        _close(c["state"], cache["state"])
        _close(c["conv"], cache["conv"])
        assert c["length"] == PROMPT + N_DEC
        tfull, aux = model.forward(params, t)
    assert aux == {}
    _close(tfull, full)


def test_ssm_cache_bytes_do_not_depend_on_the_prompt():
    """The served cache's bytes after prefills of 16 and 300 tokens (into
    caches sized for them) are equal: the SSM's state is bounded."""
    cfg, _ = _cfgs()
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))

    def served_bytes(prompt):
        c = model.init_cache(B, prompt + N_DEC, device="cpu")
        toks = torch.zeros((B, prompt), dtype=torch.int32)
        with torch.no_grad():
            _, c = model.prefill(params, toks, c)
        assert c["length"] == prompt
        return sum(v.numel() * v.element_size() for v in c.values()
                   if isinstance(v, torch.Tensor))
    assert served_bytes(16) == served_bytes(300)


def test_short_prompt_raises():
    """A prompt shorter than the conv window (W - 1 = 3 tokens) raises
    (the JAX package's decode fails on its shorter window)."""
    cfg, _ = _cfgs()
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad(), pytest.raises(ValueError, match="conv window"):
        model.prefill(params, torch.zeros((1, 2), dtype=torch.int32),
                      model.init_cache(1, 8, device="cpu"))
    assert hybrid.n_shared_calls(cfg) == 0
