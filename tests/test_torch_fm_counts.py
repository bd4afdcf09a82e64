"""The port against the JAX package where their public surfaces last
differed, on the CPU: the FM estimate at every register count up to 128
but the powers of two up to 64 (``tests/test_torch_fm.py`` holds those),
``linear3_fm_distinct`` at 48 and 128 registers, the decode
attention's window (whole and through a two-way slice of the cache's T),
the decode step's ``sample_greedy=False`` and ``layer_schedule``'s
``n_layers``.

Tolerances: FM registers and estimates exact (the estimate bit for bit,
the reference's float32 value); tokens and schedules exact; attention
outputs and logits in float32 within 1e-5.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import linear3 as jlinear3
from repro.core import sketches as jsk
from repro.core.relation import Relation as JRelation
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models import zoo as jzoo
from repro.train import make_decode_step as jdecode_step
from repro_torch import configs, convert
from repro_torch.core import linear3, sketches
from repro_torch.core.relation import Relation
from repro_torch.models import attention, layers, transformer, zoo
from repro_torch.train.steps import make_decode_step

TOL = 1e-5
# every count 1-128 but 1, 2, 4, ..., 64, which tests/test_torch_fm.py
# holds at every sum
REGISTER_COUNTS = tuple(n for n in range(1, 129) if n > 64 or n & (n - 1))


# --------------------------------------------------------------------------
# fm_estimate at every register count, every reachable sum
# --------------------------------------------------------------------------

def indexes_with_sums(n, rows=None):
    """[rows, n] lowest-zero indexes (each in [0, 32]); row s sums to s
    for s <= 32n, and rows past 32n repeat the last (default 32n + 1
    rows)."""
    s = np.minimum(np.arange(rows or 32 * n + 1), 32 * n)
    q, rem = np.divmod(s, n)
    return q[:, None] + (np.arange(n)[None, :] < rem[:, None])


def registers_with_sums(n):
    """[32n + 1, n] int32 registers; row s's lowest-zero indexes sum to s
    (-1 the register with every bit set)."""
    idx = indexes_with_sums(n)
    regs = np.where(idx < 32, (np.int64(1) << np.minimum(idx, 31)) - 1, -1)
    return regs.astype(np.int32)


# rows a reference call takes at every count, so that the ops after the
# mean compile once
ROWS = 32 * 128 + 1


def _reference_steps(r):
    """The JAX package's ``fm_estimate`` past its integer step: float32
    lowest-zero indexes ``r`` averaged, ``exp2``, over ``PHI``, in its
    eager ops (``test_reference_steps_are_its_fm_estimate``)."""
    return jnp.exp2(jnp.mean(r)) / jsk.PHI


@functools.lru_cache(maxsize=None)
def reference_estimates():
    """{n: the reference's float32 estimate at every sum 0..32n}: one
    vectorised call of ``_reference_steps`` a register count on the
    indexes, which compiles the mean alone for each count (a call of the
    whole ``fm_estimate`` compiles each of its integer ops too, ~10x the
    time)."""
    steps = jax.vmap(_reference_steps)
    return {n: np.asarray(steps(jnp.asarray(
        indexes_with_sums(n, ROWS).astype(np.float32))),
        np.float32)[:32 * n + 1] for n in REGISTER_COUNTS}


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", REGISTER_COUNTS)
def test_fm_estimate_matches_reference_at_every_sum(n):
    want = reference_estimates()[n]
    got = sketches._estimates(torch.arange(32 * n + 1), n).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the public entry point on single bitmaps, the sums' ends and between
    regs = registers_with_sums(n)
    for s in sorted({0, 1, 7 * n // 3, 16 * n + 1, 32 * n - 1, 32 * n}):
        est = sketches.fm_estimate(torch.from_numpy(regs[s]))
        assert _bits(est) == _bits(want[s]), s


@pytest.mark.parametrize("n", [3, 127])
def test_reference_steps_are_its_fm_estimate(n):
    """The reference's whole ``fm_estimate`` on the registers equals its
    steps past the integer one on their indexes, at every sum."""
    whole = jax.vmap(jsk.fm_estimate)(jnp.asarray(registers_with_sums(n)))
    np.testing.assert_array_equal(_bits(whole),
                                  _bits(reference_estimates()[n]))


def test_fm_estimate_single_calls_match_the_reference():
    """The reference called on one [48] bitmap (not under vmap), on a
    [3, 16] array averaged whole, and on random bitmaps of 3, 48 and 128
    registers."""
    regs = registers_with_sums(48)
    for s in (23, 36, 1000, 1500):
        assert (sketches.fm_estimate(torch.from_numpy(regs[s]))
                == float(jsk.fm_estimate(jnp.asarray(regs[s])))), s
    block = regs[700].reshape(3, 16)
    assert (sketches.fm_estimate(torch.from_numpy(block))
            == float(jsk.fm_estimate(jnp.asarray(block))))
    for k in (3, 48, 128):
        rng = np.random.default_rng(k)
        r = rng.integers(-(2**31), 2**31 - 1, size=k,
                         dtype=np.int64).astype(np.int32)
        r[::2] &= (1 << int(rng.integers(1, 30))) - 1
        assert (sketches.fm_estimate(torch.from_numpy(r))
                == float(jsk.fm_estimate(jnp.asarray(r)))), k


def _round_f32(x):
    """The float32 nearest the rational ``x``, ties to even."""
    from fractions import Fraction
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.uint32)) & 1))


# 24-bit odd a, b with a * b = 2^30 + 1 (mod 2^31): with c = 2^54 -
# (a b - 2^30 - 1), a b + c = 2^54 + 2^30 + 1, one above a float32 tie that
# float64 rounds onto; scaled by powers of two and signed below
_TIES = [(8389359, 15559695), (8389399, 10445991), (8389597, 93301)]


def test_fma32_rounds_once():
    """The emulated fused multiply-add against exact rational arithmetic:
    random float32 operands, and sums one unit past a float32 tie, where
    rounding the float64 sum to float32 (twice rounded) lands on the
    wrong side."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a, b, c = (rng.normal(size=500).astype(np.float32) for _ in range(3))
    ties = []
    for (x, y), sign, scale in zip(_TIES * 2, [1, 1, 1, -1, -1, -1],
                                   [-47, -40, -60, -47, -30, -52]):
        z = (1 << 54) - (x * y - (1 << 30) - 1)
        ties.append((np.float32(sign * x * 2.0 ** -23),
                     np.float32(y * 2.0 ** (scale + 23)),
                     np.float32(sign * z * 2.0 ** scale)))
    a, b, c = (np.concatenate([v, np.array(t, np.float32)])
               for v, t in zip((a, b, c), zip(*ties)))
    got = sketches._fma32(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice[-6:] != want[-6:]).all()   # the ties have teeth


# --------------------------------------------------------------------------
# linear3_fm_distinct at 48 and 128 registers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_registers", [48, 128])
def test_linear3_fm_distinct_at_other_register_counts(n_registers):
    rng = np.random.default_rng(n_registers)
    n, d = 160, 50
    cols = [("a", "b"), ("b", "c"), ("c", "d")]
    data = [{c: rng.integers(0, d, n).astype(np.int32) for c in pair}
            for pair in cols]
    plan = jlinear3.default_plan(n, n, n, m_budget=64, u=4, slack=6.0)
    want, want_ovf = jlinear3.linear3_fm_distinct(
        *(JRelation.from_arrays(**x) for x in data), plan,
        n_registers=n_registers)
    got, ovf = linear3.linear3_fm_distinct(
        *(Relation.from_arrays(device="cpu", **x) for x in data),
        linear3.Linear3Plan(*plan), n_registers=n_registers)
    assert not bool(want_ovf) and not bool(ovf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sketches.fm_estimate(got) == float(jsk.fm_estimate(want))


# --------------------------------------------------------------------------
# decode_attention's window
# --------------------------------------------------------------------------

def _attn_params(cfg, seed):
    """Random f32 attention weights as the JAX dict and the port's
    module (the smoke config's q/k norms at their init)."""
    rng = np.random.default_rng(seed)
    hd, nq, nkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    shapes = {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
              "wo": (nq * hd, d)}
    pj, mods = {}, {}
    for name, shape in shapes.items():
        w = (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
        pj[name] = {"w": jnp.asarray(w)}
        mods[name] = layers.Linear(torch.from_numpy(w), None)
    norms = ()
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            sc = (1 + 0.1 * rng.normal(size=hd)).astype(np.float32)
            pj[name] = {"scale": jnp.asarray(sc)}
            norms += (layers.RMSNorm(torch.from_numpy(sc)),)
    return pj, attention.Attention(mods["wq"], mods["wk"], mods["wv"],
                                   mods["wo"], *norms)


def _decode_inputs(cfg, t, seed):
    rng = np.random.default_rng(seed)
    shape = (2, t, cfg.n_kv_heads, cfg.head_dim)
    k = (2.0 * rng.normal(size=shape)).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    x = (2.0 * rng.normal(size=(2, 1, cfg.d_model))).astype(np.float32)
    return x, k, v


def _decode_cfgs():
    cfg = dataclasses.replace(configs.smoke("gemma3-1b"), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke("gemma3-1b"), dtype="float32")
    return cfg, jcfg


class _ThreadSlice:
    """One of two threads' halves of the cache's T in one process: the
    slice's ``max`` / ``sum`` combine the two threads' tensors in place,
    as the mesh's all-reduces over T's axes do."""

    def __init__(self, rank, size, shared):
        self.start, self.size, self.model = rank * size, size, False
        self.rank, self.shared = rank, shared

    def owns(self, pos):
        return self.start <= pos < self.start + self.size

    def _reduce(self, x, op):
        slots, barrier = self.shared
        slots[self.rank] = x.clone()
        barrier.wait()
        x.copy_(op(slots[0], slots[1]))
        barrier.wait()
        return x

    def max(self, x):
        return self._reduce(x, torch.maximum)

    def sum(self, x):
        return self._reduce(x, torch.add)


@pytest.mark.parametrize("window", [0, 3, 8])
def test_decode_attention_window_matches_reference(window):
    cfg, jcfg = _decode_cfgs()
    pj, pt = _attn_params(cfg, 5)
    t = 16
    x, k, v = _decode_inputs(cfg, t, 6)
    for length in (11, 15):
        want = np.asarray(jattn.decode_attention(
            pj, jcfg, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(length, jnp.int32), window=window, theta=1e4))
        with torch.no_grad():
            got = attention.decode_attention(
                pt, cfg, torch.from_numpy(x), torch.from_numpy(k),
                torch.from_numpy(v), length, window=window, theta=1e4)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if window:
        # the window changes the output: the check has teeth
        with torch.no_grad():
            whole = attention.decode_attention(
                pt, cfg, torch.from_numpy(x), torch.from_numpy(k),
                torch.from_numpy(v), 15, theta=1e4)
        assert np.abs(whole.numpy() - got.numpy()).max() > 100 * TOL


@pytest.mark.parametrize("window", [0, 3, 8])
def test_decode_attention_window_through_a_two_way_slice(window):
    """Each half of T scored at its global positions (the window's edge
    falls in the second half at length 13 and window 3, across both at
    window 8), the softmax combined over the halves: the whole cache's
    output on both threads."""
    cfg, jcfg = _decode_cfgs()
    pj, pt = _attn_params(cfg, 7)
    t, length = 16, 13
    x, k, v = _decode_inputs(cfg, t, 8)
    want = np.asarray(jattn.decode_attention(
        pj, jcfg, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(length, jnp.int32), window=window, theta=1e4))
    shared = ([None, None], threading.Barrier(2, timeout=30))
    outs, errs = [None, None], [None, None]

    def half(rank):
        sl = _ThreadSlice(rank, t // 2, shared)
        part = slice(sl.start, sl.start + sl.size)
        try:
            with torch.no_grad():
                outs[rank] = attention.decode_attention(
                    pt, cfg, torch.from_numpy(x),
                    torch.from_numpy(k[:, part].copy()),
                    torch.from_numpy(v[:, part].copy()), length,
                    window=window, theta=1e4, sl=sl)
        except BaseException as e:   # a fault in one half breaks the
            errs[rank] = e           # barrier, so the other half ends too
            shared[1].abort()

    threads = [threading.Thread(target=half, args=(r,), daemon=True)
               for r in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads), "a half hung"
    faults = [e for e in errs if e is not None]
    if faults:   # the fault itself before the other half's broken barrier
        raise min(faults, key=lambda e: isinstance(
            e, threading.BrokenBarrierError))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# the decode step without greedy sampling; layer_schedule's n_layers
# --------------------------------------------------------------------------

def test_decode_step_feeds_the_input_back_as_the_reference():
    arch, b, prompt_len = "qwen2-1.5b", 2, 6
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    jmodel = jzoo.build(jcfg)
    params = jmodel.init(jax.random.key(3))
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (b, prompt_len)).astype(
        np.int32)
    fed = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    decode = jdecode_step(jmodel, sample_greedy=False)

    @jax.jit
    def run(params, prompt, fed):
        cache = jmodel.init_cache(b, prompt_len + 2, dtype=jnp.float32)
        _, cache = jmodel.prefill(params, prompt, cache)
        nxt, logits, _ = decode(params, cache, fed)
        return nxt, logits

    want_nxt, want_logits = (np.asarray(a) for a in run(
        params, jnp.asarray(prompt), jnp.asarray(fed)))

    model = zoo.build(cfg)
    tparams = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    with torch.no_grad():
        cache = model.init_cache(b, prompt_len + 2, dtype=torch.float32,
                                 device="cpu")
        _, cache = model.prefill(tparams, torch.from_numpy(prompt), cache)
        nxt, logits, _ = make_decode_step(model, sample_greedy=False)(
            tparams, cache, torch.from_numpy(fed))
    np.testing.assert_array_equal(nxt.numpy(), want_nxt)
    np.testing.assert_array_equal(nxt.numpy(), fed)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL,
                               atol=TOL)
    # the greedy step on the same cache state picks the argmax instead
    assert not np.array_equal(want_logits[:, -1].argmax(-1)[:, None], fed)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-1.5b", "yi-34b"])
@pytest.mark.parametrize("n_layers", [None, 0, 1, 5, 13])
def test_layer_schedule_n_layers_matches_reference(arch, n_layers):
    w, th = transformer.layer_schedule(configs.get(arch), n_layers)
    jw, jth = jtransformer.layer_schedule(jconfigs.get(arch), n_layers)
    assert w == np.asarray(jw).tolist()
    np.testing.assert_array_equal(np.float32(th), np.asarray(jth))
