"""The port's SSM and hybrid language models (``repro_torch.models.hybrid``:
mamba2-370m and zamba2-1.2b) against the JAX package, on the CPU, at the
smoke configs in float32 (``torch_lm_parity`` says how).

Serving: zamba2's prefill (its SSM states and conv windows, and the shared
block's k/v in the cache prefix, one layer per shared call), six decode
steps (``append_kv`` + ``decode_attention``) and the forward, at a prompt
of 140 tokens (past one 128-position chunk); mamba2's is in
``test_torch_ssm.py``.  Both families again in the configs' own
bfloat16, with a bf16 KV cache beside the f32 SSM state
(``torch_lm_parity.BF16_SSM_TOL`` and the RMS bound say how close).  Both families' caches carried across by
``convert.cache_from_numpy``.  Training: the loss and every gradient with remat
off and on (each SSM block and each shared call under its own
checkpoint), and one train step at accum_steps 1 and 2.  Checkpoints of
either package restore in the other.  The state-space duality identity
(prefill and recurrent decode equal the forward) on the port alone.

Tolerance: ``TOL`` = 1e-5 (relative, and of each array's largest |value|),
but ``A_LOG_TOL`` = 2e-4 for the leaves of ``a_log`` (gradient, moments
and parameters after a step): ``test_torch_ssm.py`` says why.  In the
duality identity the forward's chunked scan and the decode's recurrence
sum in other orders, within ``TOL``.
"""

import pytest

import torch_lm_parity as lm

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
A_LOG_TOL = 2e-4


def _tol(path):
    return A_LOG_TOL if path.endswith("a_log") else lm.TOL


def test_zamba2_serving_path_matches_repro():
    lm.check_serving("zamba2-1.2b", prompt=140, n_dec=6)


def test_zamba2_short_prompt_serving_matches_repro():
    lm.check_serving("zamba2-1.2b", prompt=5, n_dec=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_repro_bfloat16(arch):
    lm.check_serving(arch, prompt=140, n_dec=6, dtype="bfloat16",
                     bf16_tol=lm.BF16_SSM_TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_repro(arch, remat):
    lm.check_loss_and_gradients(arch, remat, _tol)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro(arch, remat, accum):
    lm.check_train_step(arch, remat, accum, _tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_round_trip_with_repro(arch, tmp_path):
    lm.check_checkpoints_round_trip(arch, tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_numpy_matches_the_ports_cache(arch):
    lm.check_cache_from_numpy(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_repro(arch):
    lm.check_init_tree_matches_repro(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_space_duality_on_the_port(arch):
    lm.check_decode_matches_forward(arch, prompt=140)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_scores_the_cached_copy(cache_dtype):
    """``append_kv`` + ``decode_attention`` against the JAX package's pair
    on the same f32 inputs (zamba2's shared attention, 4 earlier cache
    slots, inputs scaled so that scores reach ~30): the new token is
    scored from its copy in the cache's dtype.  With a bf16 cache, scoring
    the un-cast k (the transformer's ``decode_attention_append``) moves
    the output by over ten times ``TOL`` of its largest |value| (1.4e-3
    of it at these inputs), so the check has teeth.

    Within ``TOL`` = 1e-5 of the output's largest |value| (4e-8 seen):
    both sum the same f32 products in another order, and with a bf16
    cache both round the weights to bf16 before PV."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import attention as jattn
    from repro_torch import convert
    from repro_torch.models import attention

    length, t = 4, 8
    cfg, jcfg = lm.cfgs("zamba2-1.2b")
    tree, _ = lm.jax_serve_run("zamba2-1.2b", 5, 4)
    jp = jax.tree.map(jnp.asarray, tree["shared_block"]["attn"])
    p = convert.lm_params_from_numpy(tree, cfg,
                                     device="cpu").shared_block.attn
    rng = np.random.default_rng(11)
    x = (4.0 * rng.normal(size=(2, 1, cfg.d_model))).astype(np.float32)
    shape = (2, t, cfg.n_kv_heads, cfg.head_dim)
    k0 = (3.0 * rng.normal(size=shape)).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = jnp.dtype(cache_dtype), getattr(torch, cache_dtype)

    jk, jv = jattn.append_kv(jp, jcfg, jnp.asarray(x), jnp.asarray(k0, jdt),
                             jnp.asarray(v0, jdt), jnp.asarray(length))
    want = np.asarray(jattn.decode_attention(
        jp, jcfg, jnp.asarray(x), jk, jv, jnp.asarray(length)), np.float32)

    xt = torch.from_numpy(x)
    tk, tv = torch.from_numpy(k0).to(tdt), torch.from_numpy(v0).to(tdt)
    with torch.no_grad():
        k_new, v_new = attention.project_kv_token(p, cfg, xt, length)
        uncast = attention.decode_attention_append(p, cfg, xt, tk, tv, k_new,
                                                   v_new, length)
        attention.append_kv(p, cfg, xt, tk, tv, length)
        got = attention.decode_attention(p, cfg, xt, tk, tv, length)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk,
                                                                  np.float32))
    lm.close(got, want)
    moved = np.abs(uncast.numpy() - want).max() / np.abs(want).max()
    if cache_dtype == "bfloat16":
        assert moved > 10 * lm.TOL
    else:
        assert moved <= lm.TOL
