"""Shared cases of the LM families' parity tests (``test_torch_ssm.py``,
``test_torch_hybrid.py``, ``test_torch_encdec.py``): the port against the
JAX package on the CPU at a smoke config in float32, and serving also in
the configs' own bfloat16 (``check_serving``'s bounds, stated there).

Parameters and train states come from the JAX package's ``init`` through
``convert``; inputs from numpy seeds (``batch_at``'s batches, with its f32
memory for the enc-dec).  One jitted JAX function per (config, case)
computes the reference; the port runs the same inputs.

``close`` holds an array within ``tol`` relative and ``tol`` of its
largest |value| (``test_torch_train.py``'s ``TOL`` = 1e-5 unless a
caller widens it for a named leaf, with its reason).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import configs, convert
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.data import synthetic
from repro_torch.models import zoo
from repro_torch.optim import adamw
from repro_torch.train import steps

TOL = 1e-5
BATCH, SEQ = 4, 16
# Adam's eps as in tests/test_torch_train.py (its docstring says why)
OPT = dict(lr=1e-3, total_steps=20, warmup_steps=2, eps=1e-5)


def close(got, want, tol=TOL, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def cfgs(arch, remat=False, dtype="float32", **kw):
    """The port's and the JAX package's smoke configs (float32 unless
    ``dtype`` says otherwise)."""
    return (dataclasses.replace(configs.smoke(arch), dtype=dtype,
                                remat=remat, **kw),
            dataclasses.replace(jconfigs.smoke(arch), dtype=dtype, **kw))


def batch(cfg, seed=5):
    gen = synthetic.TokenGenConfig(vocab_size=cfg.vocab_size, batch=BATCH,
                                   seq_len=SEQ, seed=seed,
                                   n_frontend_tokens=cfg.n_frontend_tokens,
                                   d_model=cfg.d_model)
    return synthetic.batch_at(gen, 0)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_train_run(arch):
    """JAX: the initial TrainState, the loss and gradients, and the state
    and metrics after one step with accum_steps 1 and 2, in one jit."""
    _, jcfg = cfgs(arch)
    model = jzoo.build(jcfg)
    opt = jadamw.AdamWConfig(**OPT)
    state = jsteps.init_train_state(model, jax.random.key(3))
    step1 = jsteps.make_train_step(model, opt, accum_steps=1)
    step2 = jsteps.make_train_step(model, opt, accum_steps=2)

    def loss_fn(params, b):
        logits, _ = model.forward(params, b["inputs"], memory=b.get("memory"))
        return jsteps.cross_entropy_loss(logits, b["targets"])

    @jax.jit
    def run(state, b):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, b)
        return loss, grads, step1(state, b), step2(state, b)

    b = {k: jnp.asarray(v) for k, v in batch(jcfg).items()}
    return np_tree(state._asdict()), np_tree(run(state, b))


def port_state(arch, remat):
    cfg, _ = cfgs(arch, remat)
    tree, _ = jax_train_run(arch)
    return cfg, convert.train_state_from_numpy(tree, cfg, device="cpu")


def port_batch(cfg):
    return {k: torch.from_numpy(v) for k, v in batch(cfg).items()}


def check_loss_and_gradients(arch, remat, tol_of=lambda path: TOL):
    cfg, state = port_state(arch, remat)
    _, (loss, grads, _, _) = jax_train_run(arch)
    model = zoo.build(cfg)
    b = port_batch(cfg)
    logits, aux = model.forward(state.params, b["inputs"],
                                memory=b.get("memory"))
    assert aux == {}
    got = steps.cross_entropy_loss(logits, b["targets"])
    got.backward()
    close(got.item(), loss)
    for (path, layer), p in zip(convert.leaf_paths(state.params),
                                state.params.parameters()):
        close(p.grad, convert._leaf(grads, path, layer), tol_of(path),
              err_msg=f"d{path}[{layer}]")


def check_train_step(arch, remat, accum, tol_of=lambda path: TOL):
    cfg, state = port_state(arch, remat)
    _, (_, _, *after) = jax_train_run(arch)
    want_state, want_metrics = after[accum - 1]
    step = steps.make_train_step(zoo.build(cfg), adamw.AdamWConfig(**OPT),
                                 accum_steps=accum)
    new, metrics = step(state, port_batch(cfg))
    assert metrics.keys() == want_metrics.keys()
    for k in metrics:
        close(metrics[k].item(), want_metrics[k], err_msg=k)
    got = convert.train_state_to_numpy(new)
    want = want_state._asdict()
    assert got["step"] == want["step"] == 1
    for top in ("params", "opt/m", "opt/v"):
        g_tree, w_tree = got, want
        for part in top.split("/"):
            g_tree, w_tree = g_tree[part], w_tree[part]
        for path, g in jax.tree_util.tree_leaves_with_path(g_tree):
            key = "/".join(k.key for k in path)
            w = convert._leaf(w_tree, key, -1)
            msg = f"{top}/{key}"
            if top == "params":
                tol = tol_of(key)
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=msg)
            else:
                close(g, w, tol_of(key), err_msg=msg)


def check_checkpoints_round_trip(arch, tmp_path):
    """A port checkpoint of the train state restores in the JAX package,
    and the JAX package's one after a step restores in the port, bit for
    bit; the JAX tree's structure and shapes are the port's."""
    cfg, state = port_state(arch, False)
    _, jcfg = cfgs(arch)
    save_pytree(state, tmp_path / "port", 0)
    template = jsteps.init_train_state(jzoo.build(jcfg), jax.random.key(0))
    restored, _ = jckpt.restore_pytree(template, tmp_path / "port")
    want = convert.train_state_to_numpy(state)
    got = np_tree(restored._asdict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    _, (_, _, (jstate, _), _) = jax_train_run(arch)
    jckpt.save_pytree(jstate, tmp_path / "jax", 1)
    back, manifest = restore_pytree(state, tmp_path / "jax", device="cpu")
    assert manifest["step"] == 1
    got = convert.train_state_to_numpy(back)
    want = jstate._asdict()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def check_init_tree_matches_repro(arch):
    """The port's own init gives the JAX package's tree (structure and
    shapes), and the tree round-trips through the port bit for bit."""
    cfg = configs.smoke(arch)
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0))
    tree = convert.lm_params_to_numpy(params)
    jtree = np_tree(jzoo.build(jconfigs.smoke(arch)).init(jax.random.key(0)))
    assert jax.tree.structure(jtree) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(tree)):
        assert a.shape == b.shape
    again = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tree, cfg, device="cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def check_cache_from_numpy(arch):
    """The JAX package's fresh serving cache (bf16 KV and memory, f32 SSM
    state and conv window), a value set in each array, carried across by
    ``convert.cache_from_numpy``: the port's own ``init_cache``'s keys,
    shapes and dtypes, and the values kept."""
    jcache = dict(np_tree(jzoo.build(jconfigs.smoke(arch)).init_cache(2, 7)))
    for k, v in jcache.items():
        if k != "length":
            jcache[k] = v.copy()
            jcache[k].reshape(-1)[1] = 0.75
    jcache["length"] = np.asarray(3, np.int32)
    got = convert.cache_from_numpy(jcache, device="cpu")
    want = zoo.build(configs.smoke(arch)).init_cache(2, 7, device="cpu")
    assert got.keys() == want.keys() == jcache.keys()
    assert got["length"] == 3
    for k in got.keys() - {"length"}:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(jcache[k], np.float32))


B_SERVE = 2


def serve_inputs(cfg, prompt, n_dec):
    """Tokens [B, prompt + n_dec] and, for the enc-dec, f32 memory."""
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(B_SERVE, prompt + n_dec)).astype(np.int32)
    mem = (rng.normal(size=(B_SERVE, cfg.n_frontend_tokens, cfg.d_model))
           .astype(np.float32) if cfg.n_frontend_tokens else None)
    return toks, mem


@functools.lru_cache(maxsize=None)
def jax_serve_run(arch, prompt, n_dec, dtype="float32"):
    """JAX: prefill, ``n_dec`` decode steps fed the next tokens, and the
    forward over all the tokens, in one jit, with compute and KV cache in
    ``dtype``; with the parameters' tree."""
    _, jcfg = cfgs(arch, dtype=dtype)
    model = jzoo.build(jcfg)
    params = model.init(jax.random.key(7))
    toks, mem = serve_inputs(jcfg, prompt, n_dec)

    @jax.jit
    def run(params, toks, mem):
        cache = model.init_cache(B_SERVE, prompt + n_dec,
                                 dtype=jnp.dtype(dtype))
        pre, cache = model.prefill(params, toks[:, :prompt], cache,
                                   memory=mem)
        pre_cache = cache
        dec = []
        for i in range(n_dec):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, prompt + i:prompt + i + 1])
            dec.append(lg[:, 0])
        full, _ = model.forward(params, toks, memory=mem)
        return pre, pre_cache, jnp.stack(dec, 1), cache, full

    out = run(params, jnp.asarray(toks),
              None if mem is None else jnp.asarray(mem))
    return np_tree(params), np_tree(out)


def _serve_arrays(pre, pre_cache, dec, cache, full, prompt, n_dec):
    """{name: f32 numpy array} of one serving run: the prefill logits and
    cache, the decode logits and the cache after them (k, v: the written
    prefix), the forward's logits."""
    out = {"prefill logits": pre, "decode logits": dec,
           "forward logits": full}
    for tag, c, upto in (("prefill", pre_cache, prompt),
                         ("decode", cache, prompt + n_dec)):
        for k, v in c.items():
            if k == "length":
                continue
            v = (v.float().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v, np.float32))
            out[f"{tag} cache[{k}]"] = v[:, :, :upto] if k in ("k", "v") else v
    return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32)) for k, v in out.items()}


def _port_serve(arch, prompt, n_dec, dtype, tree):
    """The port's run of ``jax_serve_run``'s inputs: (pre, pre_cache,
    dec, cache, full), the prefill cache copied before decode writes it;
    with the caches' dtypes after prefill and after decode."""
    cfg, _ = cfgs(arch, dtype=dtype)
    toks, mem = serve_inputs(cfg, prompt, n_dec)
    model = zoo.build(cfg)
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    t = torch.from_numpy(toks)
    m = None if mem is None else torch.from_numpy(mem)
    with torch.no_grad():
        c = model.init_cache(B_SERVE, prompt + n_dec,
                             dtype=getattr(torch, dtype), device="cpu")
        pre, c = model.prefill(params, t[:, :prompt], c, memory=m)
        assert c["length"] == prompt
        pre_cache = {k: v.clone() for k, v in c.items() if k != "length"}
        dec = []
        for i in range(n_dec):
            lg, c = model.decode_step(params, c,
                                      t[:, prompt + i:prompt + i + 1])
            dec.append(lg[:, 0])
        assert c["length"] == prompt + n_dec
        full, aux = model.forward(params, t, memory=m)
    assert aux == {}
    return pre, pre_cache, torch.stack(dec, 1), c, full


def _check_dtypes(got, want, msg):
    """The port's cache holds the JAX package's keys in its dtypes: the
    KV cache and the enc-dec's memory in the cache dtype, the SSM state
    and conv window f32.  After decode, ``repro``'s conv window comes
    back in the compute dtype (ROADMAP Queue C: the same values)."""
    assert got.keys() - {"length"} == want.keys() - {"length"}, msg
    for k, v in got.items():
        if k == "length" or (msg == "decode" and k == "conv"):
            continue
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), (msg, k)


# bfloat16 serving.  The two frameworks round to bf16 at different places
# (matmul outputs, activations), and the differences grow over the
# layers.  Logits (~N(0, 1)) and every cache array within ``bf16_tol``
# absolute: BF16_TOL = 0.1, test_torch_serve.py's bound for the dense
# configs, for the enc-dec (largest difference seen 0.067); BF16_SSM_TOL
# = 0.2 for the SSM and hybrid families, whose activations pass through
# 24+ layers of bf16 SSD sums: there the JAX package's own bf16 forward
# logits are up to 0.195 (zamba2) and 0.135 (mamba2) from its f32 ones,
# and the port's are up to 0.127 from JAX's.  Each array's RMS distance
# from the JAX package's float32 run is at most BF16_RMS_RATIO times
# JAX's own bf16 one (seen: at most 1.06), so the port rounds no more
# than the reference.  The greedy tokens agree where the top-2 margin
# exceeds twice the bound.
BF16_TOL = 0.1
BF16_SSM_TOL = 0.2
BF16_RMS_RATIO = 1.25


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def check_serving(arch, prompt, n_dec, dtype="float32", bf16_tol=BF16_TOL):
    """Prefill logits and cache, each decode step's logits and the cache
    after them, and the teacher-forced forward, against the JAX package,
    with compute and KV cache in ``dtype`` (the SSM state and conv window
    stay f32; the enc-dec's memory is in the cache's dtype).  float32
    within ``TOL``; bfloat16 as stated above."""
    tree, want = jax_serve_run(arch, prompt, n_dec, dtype)
    assert int(want[1]["length"]) == prompt
    assert int(want[3]["length"]) == prompt + n_dec
    got = _port_serve(arch, prompt, n_dec, dtype, tree)
    _check_dtypes(got[1], want[1], "prefill")
    _check_dtypes(got[3], want[3], "decode")
    got = _serve_arrays(*got, prompt, n_dec)
    want = _serve_arrays(*want, prompt, n_dec)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].shape == want[name].shape, name
        if dtype == "float32":
            close(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=bf16_tol, err_msg=name)
    if dtype == "float32":
        return
    _, truth = jax_serve_run(arch, prompt, n_dec, "float32")
    truth = _serve_arrays(*truth, prompt, n_dec)
    for name in got:
        assert (_rms(got[name] - truth[name])
                <= BF16_RMS_RATIO * _rms(want[name] - truth[name])), name
    logits = np.concatenate([got["prefill logits"], got["decode logits"]], 1)
    ref = np.concatenate([want["prefill logits"], want["decode logits"]], 1)
    srt = np.sort(logits, -1)
    sure = srt[..., -1] - srt[..., -2] > 2 * bf16_tol
    assert sure.any()
    np.testing.assert_array_equal(logits.argmax(-1)[sure],
                                  ref.argmax(-1)[sure])


def check_decode_matches_forward(arch, prompt=20):
    """The port alone: the prefill's last logits and one decode step's
    equal the forward's at the same positions (for the SSM families the
    state-space duality of chunked scan and recurrence,
    tests/test_arch_smoke.py's identity), here within ``TOL``."""
    cfg, _ = cfgs(arch)
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    toks, mem = serve_inputs(cfg, prompt, 1)
    t = torch.from_numpy(toks)
    m = None if mem is None else torch.from_numpy(mem)
    with torch.no_grad():
        full, _ = model.forward(params, t, memory=m)
        c = model.init_cache(B_SERVE, prompt + 1, dtype=torch.float32,
                             device="cpu")
        pre, c = model.prefill(params, t[:, :prompt], c, memory=m)
        step, c = model.decode_step(params, c, t[:, prompt:])
    close(pre[:, 0], full[:, prompt - 1].numpy())
    close(step[:, 0], full[:, prompt].numpy())
