"""The port's LM serving path against the JAX package, on the CPU: the
dense configs, the MoE ones and the VLM's (its modality memory passed to
the prefill and the forward).  The SSM, hybrid and enc-dec families'
parity is in ``test_torch_ssm.py``, ``test_torch_hybrid.py`` and
``test_torch_encdec.py``; here each is served and trained once through
the launchers.

The JAX package's ``init_lm`` parameters go through
``convert.lm_params_from_numpy``; both packages then run the same prompts:
prefill, greedy decode (the port is fed the tokens JAX picked) and a
teacher-forced forward over prompt + generated tokens.  One jitted JAX
function per config holds all three, so each config compiles once.

Tolerances.  float32 configs: every logit and the prefill cache within
1e-5 (absolute and relative; logits are ~N(0, 1) at init), the same
greedy tokens.  The configs' own bfloat16: the two frameworks round to
bf16 at different places (matmul outputs, activations), and the
differences grow over the layers.  Logits (~N(0, 1)) and the cached k, v
(~unit scale) agree within 0.1 absolute, about 13 bf16 ulps at 1.0 (the
largest differences seen are 0.071 and 0.0625); the greedy tokens are
compared where the top-2 margin exceeds twice that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import zoo as jzoo
from repro.train import make_decode_step as jdecode_step
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import zoo

B, N_DEC = 2, 8
PROMPT = {"qwen2-1.5b": 20, "gemma3-1b": 24,   # gemma3's smoke window: 16
          "qwen3-moe-30b-a3b": 20, "moonshot-v1-16b-a3b": 20,
          "llama-3.2-vision-11b": 20}
NEW_FAMILIES = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                "llama-3.2-vision-11b"]


def _memory(cfg):
    """The VLM's modality memory [B, n_frontend_tokens, d_model] (f32),
    or None."""
    if not cfg.n_frontend_tokens:
        return None
    return np.random.default_rng(4).normal(
        size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
F32_TOL = 1e-5
BF16_TOL = 0.1


def _jax_run(arch, dtype, prompt):
    """JAX: prefill, N_DEC greedy decode steps, and the teacher-forced
    forward over prompt + fed tokens, in one jit."""
    cfg = dataclasses.replace(jconfigs.smoke(arch), dtype=dtype)
    model = jzoo.build(cfg)
    params = model.init(jax.random.key(7))
    p_len = prompt.shape[1]
    cache_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    decode = jdecode_step(model)

    @jax.jit
    def run(params, prompt, memory):
        cache = model.init_cache(B, p_len + N_DEC, dtype=cache_dt)
        pre, cache = model.prefill(params, prompt, cache, memory=memory)
        tok0 = jnp.argmax(pre[:, -1], axis=-1).astype(jnp.int32)[:, None]

        def step(carry, _):
            c, tok = carry
            nxt, logits, c = decode(params, c, tok)
            return (c, nxt), (logits[:, 0], tok[:, 0])

        (_, last), (dec, fed) = jax.lax.scan(step, (cache, tok0), None,
                                             length=N_DEC)
        seq = jnp.concatenate([prompt, fed.T], axis=1)
        full, _ = model.forward(params, seq, memory=memory)
        return pre, cache, dec.transpose(1, 0, 2), seq, last, full

    memory = _memory(cfg)
    out = jax.tree.map(np.array, run(
        params, jnp.asarray(prompt),
        None if memory is None else jnp.asarray(memory)))
    return jax.tree.map(np.asarray, params), out


def _port_run(arch, dtype, tree, prompt, seq):
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    model = zoo.build(cfg)
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    cache_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    p_len = prompt.shape[1]
    memory = _memory(cfg)
    memory = None if memory is None else torch.from_numpy(memory)
    with torch.no_grad():
        cache = model.init_cache(B, p_len + N_DEC, dtype=cache_dt,
                                 device="cpu")
        pre, cache = model.prefill(params, torch.from_numpy(prompt), cache,
                                   memory=memory)
        pre_cache = {k: cache[k].float().numpy().copy() for k in ("k", "v")}
        seq_t = torch.from_numpy(seq)
        dec = []
        for i in range(N_DEC):
            logits, cache = model.decode_step(
                params, cache, seq_t[:, p_len + i:p_len + i + 1])
            dec.append(logits[:, 0])
        full, _ = model.forward(params, seq_t, memory=memory)
    return (pre.numpy(), pre_cache, torch.stack(dec, 1).numpy(),
            full.numpy(), cache["length"])


def _prompt(arch, vocab):
    return np.random.default_rng(3).integers(
        0, vocab, size=(B, PROMPT[arch])).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b", *NEW_FAMILIES])
def test_serving_path_matches_repro_float32(arch):
    prompt = _prompt(arch, configs.smoke(arch).vocab_size)
    tree, (pre, cache, dec, seq, last, full) = _jax_run(arch, "float32",
                                                        prompt)
    t_pre, t_cache, t_dec, t_full, length = _port_run(arch, "float32", tree,
                                                      prompt, seq)
    tol = dict(rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(t_full, full, **tol)
    np.testing.assert_allclose(t_pre, pre, **tol)
    p_len = prompt.shape[1]
    for k in ("k", "v"):
        np.testing.assert_allclose(t_cache[k][:, :, :p_len],
                                   cache[k][:, :, :p_len], **tol)
    np.testing.assert_allclose(t_dec, dec, **tol)
    assert length == p_len + N_DEC
    # the same greedy tokens: the port's argmax picks what JAX fed next
    greedy = np.concatenate([t_pre[:, :1].argmax(-1), t_dec.argmax(-1)], 1)
    np.testing.assert_array_equal(
        greedy, np.concatenate([seq[:, p_len:], last], 1))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])
def test_serving_path_matches_repro_bfloat16(arch):
    prompt = _prompt(arch, configs.smoke(arch).vocab_size)
    tree, (pre, cache, dec, seq, last, full) = _jax_run(arch, "bfloat16",
                                                        prompt)
    t_pre, t_cache, t_dec, t_full, _ = _port_run(arch, "bfloat16", tree,
                                                 prompt, seq)
    for got, want in ((t_full, full), (t_pre, pre), (t_dec, dec)):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)
    p_len = prompt.shape[1]
    for k in ("k", "v"):
        want = np.asarray(cache[k], np.float32)[:, :, :p_len]
        np.testing.assert_allclose(t_cache[k][:, :, :p_len], want,
                                   rtol=0, atol=BF16_TOL)
    srt = np.sort(t_dec, -1)
    sure = srt[..., -1] - srt[..., -2] > 2 * BF16_TOL
    nxt = np.concatenate([seq[:, p_len + 1:], last], 1)
    assert sure.any()
    np.testing.assert_array_equal(t_dec.argmax(-1)[sure], nxt[sure])


def test_params_round_trip_through_numpy():
    cfg = configs.smoke("gemma3-1b")
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0))
    tree = convert.lm_params_to_numpy(params)
    jtree = jzoo.build(jconfigs.smoke("gemma3-1b")).init(jax.random.key(0))
    assert (jax.tree.structure(jax.tree.map(np.asarray, jtree))
            == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(tree)):
        assert a.shape == b.shape
    again = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tree, cfg, device="cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_init_scales_match_repro():
    """Init draws other bits than JAX, from the same distributions."""
    cfg = configs.smoke("qwen2-1.5b")
    tree = convert.lm_params_to_numpy(
        zoo.build(cfg).init(torch.Generator().manual_seed(1)))
    w = tree["layers"]["mlp"]["down"]["w"]
    assert abs(w.std() * np.sqrt(cfg.d_ff) - 1) < 0.05
    assert abs(tree["embed"]["table"].std() * np.sqrt(cfg.d_model) - 1) < 0.05
    assert not tree["layers"]["attn"]["wq"]["b"].any()
    assert not tree["final_norm"]["scale"].any()


def test_cache_from_numpy_keeps_bfloat16():
    cache = jzoo.build(jconfigs.smoke("qwen2-1.5b")).init_cache(2, 5)
    cache = dict(cache, k=cache["k"].at[0, 0, 1].set(1.5))
    got = convert.cache_from_numpy(jax.tree.map(np.asarray, cache),
                                   device="cpu")
    assert got["k"].dtype == torch.bfloat16 and got["length"] == 0
    assert float(got["k"][0, 0, 1].max()) == 1.5


def test_serve_main_runs_on_the_cpu(capsys):
    waves = serve.main(["--arch", "gemma3-1b", "--smoke", "--batch", "2",
                        "--prompt-len", "20", "--gen", "3", "--requests", "3",
                        "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("wave 0: served 2 requests (3 tokens each)")
    assert out[-1].startswith("served 3 requests, 6 decode steps in ")
    assert len(waves) == 2 and waves[0]["tokens"].shape == (2, 4)


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--smoke", "--gen", "1", "--requests", "1"])
    tree = convert.lm_params_to_numpy(zoo.build(configs.smoke(
        "qwen2-1.5b")).init(torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.lm_params_from_numpy(tree, configs.smoke("qwen2-1.5b"))


SSM_HYBRID_ENCDEC = ["mamba2-370m", "zamba2-1.2b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", SSM_HYBRID_ENCDEC)
def test_ssm_hybrid_and_encdec_families_serve_and_train(arch, capsys):
    """Each smoke config builds, serves one request of two generated tokens
    through ``launch.serve`` (the enc-dec's wave drawing its memory) and
    trains one step through ``launch.train``, on the CPU."""
    from repro_torch.launch import train
    waves = serve.main(["--arch", arch, "--smoke", "--batch", "1",
                        "--prompt-len", "8", "--gen", "2", "--requests", "1",
                        "--device", "cpu"])
    cfg = configs.smoke(arch)
    assert len(waves) == 1 and waves[0]["tokens"].shape == (1, 3)
    assert (waves[0]["memory"] is None) == (cfg.family != "audio")
    state, losses = train.main(["--arch", arch, "--smoke", "--steps", "1",
                                "--batch", "2", "--seq", "8", "--device",
                                "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert int(state.step) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("served 1 requests, 2 decode steps in ")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_config_builds(arch):
    """``zoo.build`` builds every config at full width (the parameters are
    drawn on the card, not here), with the JAX package's ``needs_memory``."""
    cfg = configs.get(arch)
    model = zoo.build(cfg)
    assert model.config is cfg
    assert model.needs_memory == jzoo.build(jconfigs.get(arch)).needs_memory


def test_transformer_families_build_at_full_width():
    """Every MoE and VLM config and the dense configs that set scan_group
    build (the parameters are drawn on the card, not here)."""
    built = [a for a in configs.ARCH_IDS
             if configs.get(a).family in ("moe", "vlm")
             or configs.get(a).scan_group]
    assert sorted(built) == sorted(["moonshot-v1-16b-a3b",
                                    "qwen3-moe-30b-a3b",
                                    "llama-3.2-vision-11b", "qwen2.5-14b",
                                    "yi-34b"])
    for arch in built:
        cfg = configs.get(arch)
        model = zoo.build(cfg)
        assert model.config is cfg
        assert model.needs_memory == jzoo.build(
            jconfigs.get(arch)).needs_memory == (cfg.family == "vlm")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_moe_and_vlm_params_round_trip_through_numpy(arch):
    """``lm_params_to_numpy`` gives the JAX package's ``init_lm`` tree
    (``layers/moe/...``, ``cross_layers/...``), and back."""
    cfg = configs.smoke(arch)
    params = zoo.build(cfg).init(torch.Generator().manual_seed(0))
    tree = convert.lm_params_to_numpy(params)
    jtree = jzoo.build(jconfigs.smoke(arch)).init(jax.random.key(0))
    assert (jax.tree.structure(jax.tree.map(np.asarray, jtree))
            == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(tree)):
        assert a.shape == b.shape
    again = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tree, cfg, device="cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_vlm_cache_carries_the_memory():
    jmodel = jzoo.build(jconfigs.smoke("llama-3.2-vision-11b"))
    cache = jmodel.init_cache(2, 5)
    cache = dict(cache, memory=cache["memory"].at[1, 3].set(0.75))
    got = convert.cache_from_numpy(jax.tree.map(np.asarray, cache),
                                   device="cpu")
    want = zoo.build(configs.smoke("llama-3.2-vision-11b")).init_cache(
        2, 5, device="cpu")
    assert got.keys() == want.keys() == {"k", "v", "length", "memory"}
    for k in ("k", "v", "memory"):
        assert got[k].shape == want[k].shape
        assert got[k].dtype == want[k].dtype == torch.bfloat16
    assert float(got["memory"][1, 3].max()) == 0.75


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_are_copies_of_repro(arch):
    assert (dataclasses.asdict(configs.get(arch))
            == dataclasses.asdict(jconfigs.get(arch)))
    assert (dataclasses.asdict(configs.smoke(arch))
            == dataclasses.asdict(jconfigs.smoke(arch)))
    assert configs.get(arch).param_count() == jconfigs.get(arch).param_count()


def test_serve_draws_each_waves_memory_after_its_prompts():
    """The VLM's waves: prompts, then memory, from one
    ``np.random.default_rng(seed)``, as the JAX launcher draws them."""
    cfg = configs.smoke("llama-3.2-vision-11b")
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    waves = serve.serve(model, params, batch=2, prompt_len=6, gen=2,
                        requests=4, seed=3, device="cpu",
                        log=lambda *_: None)
    rng = np.random.default_rng(3)
    for w in waves:
        np.testing.assert_array_equal(
            w["prompts"], rng.integers(0, cfg.vocab_size, size=(2, 6)))
        np.testing.assert_array_equal(
            w["memory"], rng.normal(0, 1, size=(
                2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    assert len(waves) == 2 and waves[0]["tokens"].shape == (2, 3)
