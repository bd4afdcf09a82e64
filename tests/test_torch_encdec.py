"""The port's encoder-decoder (``repro_torch.models.encdec``,
seamless-m4t-medium) against the JAX package, on the CPU, at the smoke
config in float32 (``torch_lm_parity`` says how).

Serving: the prefill (the encoded memory in the cache, the decoder's k/v
in the cache prefix), six decode steps (``append_kv`` +
``decode_attention``, the cross-attention over the cached memory at S =
1) and the teacher-forced forward, over 32 f32 memory frames.  Training:
the loss and every gradient with remat off and on (each encoder and
decoder block under its own checkpoint), over ``batch_at``'s f32 memory,
and one train step at accum_steps 1 and 2.  Checkpoints of either package
restore in the other (``enc_layers``, ``dec_layers``), and its cache
(KV and memory) carries across by ``convert.cache_from_numpy``.  The decode against
the forward on the port alone.  All within ``TOL`` = 1e-5 (relative, and
of each array's largest |value|).
"""

import numpy as np
import pytest
import torch

import torch_lm_parity as lm
from repro_torch import configs
from repro_torch.models import zoo

ARCH = "seamless-m4t-medium"


def test_serving_path_matches_repro():
    lm.check_serving(ARCH, prompt=20, n_dec=6)


def test_serving_path_matches_repro_bfloat16():
    """The configs' own bf16: the frames cast to bf16 before the encoder,
    the memory cached in bf16, the cross-attention's k/v projected from
    it (``torch_lm_parity.BF16_TOL`` and the RMS bound say how close)."""
    lm.check_serving(ARCH, prompt=20, n_dec=6, dtype="bfloat16")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_repro(remat):
    lm.check_loss_and_gradients(ARCH, remat)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_matches_repro(remat, accum):
    lm.check_train_step(ARCH, remat, accum)


def test_checkpoints_round_trip_with_repro(tmp_path):
    lm.check_checkpoints_round_trip(ARCH, tmp_path)


def test_cache_from_numpy_matches_the_ports_cache():
    lm.check_cache_from_numpy(ARCH)


def test_init_tree_matches_repro():
    lm.check_init_tree_matches_repro(ARCH)


def test_decode_matches_forward_on_the_port():
    lm.check_decode_matches_forward(ARCH)


def test_encoder_is_bidirectional_and_memory_is_needed():
    """Changing the last frame changes the first position's logits (the
    encoder sees every frame, the cross-attention every encoded frame);
    no memory raises."""
    cfg, _ = lm.cfgs(ARCH)
    model = zoo.build(cfg)
    assert model.needs_memory
    params = model.init(torch.Generator().manual_seed(0))
    toks, mem = lm.serve_inputs(cfg, 8, 0)
    mem2 = mem.copy()
    mem2[:, -1] += 1.0
    with torch.no_grad():
        a, _ = model.forward(params, torch.from_numpy(toks),
                             memory=torch.from_numpy(mem))
        b, _ = model.forward(params, torch.from_numpy(toks),
                             memory=torch.from_numpy(mem2))
        assert not np.allclose(a[:, 0].numpy(), b[:, 0].numpy())
        with pytest.raises(ValueError, match="memory"):
            model.forward(params, torch.from_numpy(toks))
    assert configs.get(ARCH).n_frontend_tokens == 4096
