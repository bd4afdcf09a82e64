"""Port vs JAX package: the LM's mesh (``models/moe.py``'s
``moe_mlp_sharded``, the meshed train step, ``launch/train.py``,
``launch/mesh.py``, restoring onto placements).

The multi-rank cases run in the launches of ``tests/torch_dist_cases.py``
(``lm_reference`` on 8 forced XLA devices, ``lm_port`` on the 8 gloo
ranks of the 4 x 2 launch), one launch a test session shared with
``tests/test_torch_distributed.py``; both sides mesh as (4, 2) ("data",
"model").  Tolerances:

* ``moe_mlp_sharded`` at capacity factors 8.0 (nothing drops) and 1.25
  (drops occur): ``dropped`` exactly; the output, ``aux_loss`` and the
  gradients of ``sum(out * ct) / 4 + 0.37 aux_loss`` (the tokens' and,
  averaged over "data", the parameters') within 1e-5 relative and 1e-5
  of the array's largest |value| in f32 (the frameworks sum products in
  other orders).  At 8.0 the port's gradients without the aux term also
  equal the unsharded ``moe_mlp``'s (the reference's sharded gradients
  equal its unsharded ones there too: no caveat to record).
* Two train steps (2 microbatches of 8 rows, 2 rows a "data" rank) of
  the qwen2-1.5b, qwen3-moe and gemma3-1b smoke configs and of a config
  none of whose heads, GLU hidden or vocabulary divides "model"
  (``cases.ODD``), in f32, Adam's eps 1e-5 as in
  ``tests/test_torch_train.py``, tensor-parallel over "model" on the
  port's side and under GSPMD on the reference's: loss and grad norm
  within 1e-5 relative; every parameter, gathered over "model", within
  1e-5 relative + 1e-6 absolute (the parameters are O(1) norm scales
  and O(1e-3) biases, and a first Adam step turns a gradient's rounding
  near eps into up to lr / eps times that in the update); each rank's
  parameter shapes are the reference's ``spec_for`` "model" slices, and
  ranks at the same "model" coordinate hold the same slices.
* ``overlap`` gives the same parameters, bit for bit.  A step whose
  microbatch does not divide "data" (replicated over the batch axes,
  still partitioned over "model") gives the reference's metrics and
  parameters within the train steps' tolerances.  The dense run's
  checkpoint, gathered over "model" and written by rank 0, restored onto
  ``state_shardings`` placements holds each rank's slice exactly, its
  whole tensors are the saved ones, and it restores meshless bit for
  bit.  ``launch.train.train`` failing at step 1 under the mesh and
  resumed from its checkpoint ends with the parameters of an
  uninterrupted run, bit for bit.
* Serving, tensor-parallel: qwen2-1.5b's (its KV heads split) and
  gemma3-1b's (one KV head, whole on every rank) smoke configs, prefill
  of 2 x 16 tokens and 4 greedy decode steps, against the reference
  jitted with ``step_and_shardings``' in and out shardings on the mesh:
  every call's logits and the final f32 cache within 1e-5 relative and
  1e-5 of the array's largest |value|, the greedy tokens equal.  One
  forward loss of the llama-3.2-vision, zamba2-1.2b and
  seamless-m4t-medium smoke configs within 1e-5 relative.

In-process on one gloo rank (its process group destroyed in teardown):
the elastic restore of ``tests/test_system.py`` and the launcher on a
world of one; ``--production`` there names the 256 ranks it needs.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_dist_cases as cases

TOL = 1e-5
ARCHS = list(cases.TRAIN_ARCHS)
CFS = [str(cf) for cf in cases.MOE_CFS]
MOE_GRADS = ["x", "router/w", "gate", "up", "down"]


def _close(got, want, tol=TOL, atol=None, err_msg=""):
    want = np.asarray(want, np.float64)
    atol = tol * max(np.abs(want).max(), 1e-30) if atol is None else atol
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=atol, err_msg=err_msg)


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    root, status = cases.shared_launch(tmp_path_factory.getbasetemp())
    if status["bad"]:
        pytest.fail(f"mesh launches failed {status['bad']}:\n" + "\n".join(
            f"--- {n}\n{t}" for n, t in status["tails"].items()))
    ref = root / "ref"
    port = root / "4x2"
    n = cases.ROWS * cases.COLS
    return {"ref": dict(np.load(ref / "lm_ref.npz")),
            "ref_meta": json.loads((ref / "lm_ref.json").read_text()),
            "port": [dict(np.load(port / f"lm_port_{k}.npz"))
                     for k in range(n)],
            "meta": [json.loads((port / f"lm_port_{k}.json").read_text())
                     for k in range(n)]}


def _rows(lm, key):
    """The port's per-rank arrays of ``key`` stacked in "data" order (one
    rank of each "data" row; the "model" ranks must agree)."""
    ports = lm["port"]
    for k in range(0, len(ports), cases.COLS):
        for j in range(1, cases.COLS):
            np.testing.assert_array_equal(ports[k][key], ports[k + j][key],
                                          err_msg=key)
    return np.concatenate([ports[k][key]
                           for k in range(0, len(ports), cases.COLS)])


@pytest.mark.parametrize("cf", CFS)
def test_moe_sharded_forward_matches_reference(lm, cf):
    tag = f"moe/{cf}/aux"
    ref = lm["ref"]
    for p in lm["port"]:
        assert p[f"{tag}/dropped"] == ref[f"{tag}/dropped"]
        _close(p[f"{tag}/aux_loss"], ref[f"{tag}/aux_loss"])
    _close(_rows(lm, f"{tag}/out"), ref[f"{tag}/out"])
    if cf == "1.25":
        assert ref[f"{tag}/dropped"] > 0       # drops occur
    else:
        assert ref[f"{tag}/dropped"] <= 0


@pytest.mark.parametrize("grad", MOE_GRADS)
@pytest.mark.parametrize("cf", CFS)
def test_moe_sharded_grads_match_reference(lm, cf, grad):
    key = f"moe/{cf}/aux/grad/{grad}"
    if grad == "x":
        got = _rows(lm, key)
    else:
        got = lm["port"][0][key]
        for p in lm["port"][1:]:
            np.testing.assert_array_equal(p[key], got)
    _close(got, lm["ref"][key], err_msg=key)


@pytest.mark.parametrize("grad", MOE_GRADS)
def test_moe_sharded_grads_are_the_unsharded_ones(lm, grad):
    """Where nothing drops, the sharded path's gradients (aux term left
    out: it is a per-shard statistic) are ``moe_mlp``'s on the whole
    batch: no factor of the "model" size anywhere."""
    key = f"moe/8.0/noaux/grad/{grad}"
    got = _rows(lm, key) if grad == "x" else lm["port"][0][key]
    _close(got, lm["ref"][key], err_msg=key)
    assert lm["ref"]["moe/8.0/noaux/dropped"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_train_steps_match_reference(lm, arch):
    want = lm["ref_meta"][arch]
    assert len(want) == cases.TRAIN_STEPS
    for meta in lm["meta"]:
        for got, ref in zip(meta[arch], want):
            for k in ("loss", "grad_norm", "lr"):
                _close(got[k], ref[k], err_msg=k)
            if "dropped" in ref:
                _close(got["aux_loss"], ref["aux_loss"])
                assert got["dropped"] == pytest.approx(ref["dropped"],
                                                       abs=1e-7)
        assert meta[f"{arch}/local_shapes"] == \
            lm["ref_meta"][f"{arch}/local_shapes"]
    # ranks at the same "model" coordinate hold the same slices
    for c in range(cases.COLS):
        same = {m[f"{arch}/checksum"] for m in lm["meta"]
                if m["model_rank"] == c}
        assert len(same) == 1
    keys = [k for k in lm["ref"] if k.startswith(f"train/{arch}/")]
    assert len(keys) > 10
    for key in keys:
        for p in lm["port"]:
            np.testing.assert_array_equal(p[key], lm["port"][0][key])
        _close(lm["port"][0][key], lm["ref"][key], atol=1e-6, err_msg=key)


def test_tensor_parallel_splits_what_the_reference_splits(lm):
    """Over the four train configs each rank holds split heads, GLU
    columns, vocabulary rows and experts somewhere, and the non-dividing
    config holds only its wq / wk / wv / wo split (stored split, their
    heads computed whole)."""
    meta = lm["meta"][0]
    split = {a: sorted(k for k, v in meta[f"{a}/local_shapes"].items()
                       if v != list(lm["ref"][f"train/{a}/{k}"].shape))
             for a in ARCHS}
    assert "embed/table" in split["qwen2-1.5b"]
    assert "layers/mlp/gate/w" in split["gemma3-1b"]
    assert "layers/moe/gate" in split["qwen3-moe-30b-a3b"]
    assert split["odd"] == sorted(f"layers/attn/{w}/{leaf}"
                                  for w in ("wq", "wk", "wv", "wo")
                                  for leaf in ("w", "b")
                                  if (w, leaf) != ("wo", "b"))


def test_overlap_gives_the_same_parameters(lm):
    dense = cases.TRAIN_ARCHS[0]
    for p, meta in zip(lm["port"], lm["meta"]):
        keys = [k for k in p if k.startswith(f"train/{dense}/")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(
                p[key.replace(f"train/{dense}/", "train/overlap/")], p[key])
        assert meta["overlap"] == meta[dense]


def test_batch_that_does_not_divide_is_replicated(lm):
    """Microbatches of 3 rows on 4 "data" ranks: every rank takes them
    whole (``repro``'s replicated fallback); the MoE step, still
    partitioned over "model", gives the reference's metrics and
    parameters within the train steps' tolerances, the same on every
    rank."""
    want = lm["ref_meta"]["replicated"]
    assert len(want) == 1
    for meta in lm["meta"]:
        for got, ref in zip(meta["replicated"], want, strict=True):
            for k in ("loss", "grad_norm", "lr", "aux_loss"):
                _close(got[k], ref[k], err_msg=k)
            assert got["dropped"] == pytest.approx(ref["dropped"], abs=1e-7)
    keys = [k for k in lm["ref"] if k.startswith("train/replicated/")]
    assert len(keys) > 10
    for key in keys:
        for p in lm["port"]:
            np.testing.assert_array_equal(p[key], lm["port"][0][key])
        _close(lm["port"][0][key], lm["ref"][key], atol=1e-6, err_msg=key)


@pytest.mark.parametrize("rank", range(cases.ROWS * cases.COLS))
def test_restore_onto_shard_placements(lm, rank):
    got = lm["meta"][rank]["restore"]
    assert got["step"] == cases.TRAIN_STEPS
    assert got["local_equal"] and got["full_equal"]
    assert got["meshless_equal"]
    assert 0 < got["sharded"] < got["leaves"]
    assert got["steps_replicated"] == [cases.TRAIN_STEPS] * 2


@pytest.mark.parametrize("rank", range(cases.ROWS * cases.COLS))
def test_restart_under_the_mesh(lm, rank):
    got = lm["meta"][rank]["restart"]
    assert got["failed"]
    assert (got["start"], got["end"]) == (cases.RESTART["fail_at"],
                                          cases.RESTART["steps"])
    assert got["equal"]


@pytest.mark.parametrize("arch", list(cases.SERVE_ARCHS))
def test_tensor_parallel_serving_matches_reference(lm, arch):
    ref = lm["ref"]
    for p in lm["port"]:
        _close(p[f"serve/{arch}/logits"], ref[f"serve/{arch}/logits"],
               err_msg="logits")
        for k in ("k", "v"):
            key = f"serve/{arch}/cache/{k}"
            _close(p[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(p[f"serve/{arch}/last"],
                                      ref[f"serve/{arch}/last"])
    heads = {m[f"serve/{arch}/cache_heads"] for m in lm["meta"]}
    n_kv = ref[f"serve/{arch}/cache/k"].shape[3]
    assert heads == {n_kv // cases.COLS if n_kv % cases.COLS == 0
                     else n_kv}


@pytest.mark.parametrize("arch", list(cases.FORWARD_ARCHS))
def test_tensor_parallel_forward_losses_match_reference(lm, arch):
    for meta in lm["meta"]:
        _close(meta[f"forward/{arch}"], lm["ref_meta"][f"forward/{arch}"])


# --------------------------------------------------------------------------
# in-process, one gloo rank
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_restore_across_shardings(tmp_path, one_rank):
    """``tests/test_system.py``'s elastic restore: a checkpoint restores
    whatever the saving process's layout, the shardings applied at
    restore (a one-rank host mesh here)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import zoo
    from repro_torch.runtime import elastic_restore
    from repro_torch.train import init_train_state
    model = zoo.build(configs.smoke("qwen2-1.5b"))
    state = init_train_state(model, torch.Generator().manual_seed(0))
    manager = CheckpointManager(tmp_path / "ckpt", every=1)
    manager.save(state, 1)
    mesh = mesh_lib.make_host_mesh(device="cpu")
    shardings = type(state)(
        [(mesh, (Replicate(),))] * len(state.opt["m"]),
        {"m": [(mesh, (Replicate(),))] * len(state.opt["m"]),
         "v": [(mesh, (Replicate(),))] * len(state.opt["v"]),
         "step": (mesh, (Replicate(),))}, (mesh, (Replicate(),)))
    restored, manifest = manager.restore(state, device="cpu",
                                         shardings=shardings)
    assert manifest["step"] == 1
    leaf = next(restored.params.parameters())
    assert isinstance(leaf, DTensor) and leaf.device_mesh is mesh
    for a, b in zip(restored.params.parameters(), state.params.parameters()):
        assert torch.equal(a.full_tensor(), b)
    # elastic_restore: the same, and a None sharding keeps a plain tensor
    shardings.opt["step"] = None
    again, _ = elastic_restore(state, manager.dir, shardings=shardings,
                               device="cpu")
    assert not isinstance(again.opt["step"], DTensor)
    assert isinstance(again.opt["m"][0], DTensor)


def test_production_mesh_needs_256_ranks(one_rank):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="256"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="256"):
        train.main(["--production", "--smoke", "--device", "cpu"])
    assert dist.is_initialized()        # the caller's group is left alone


def test_launcher_on_a_world_of_one(capsys):
    """Not under ``torchrun``: ``main`` makes a world of one rank for the
    host mesh, trains through it, and destroys the group it made; with
    ``--overlap`` the losses are the same."""
    from repro_torch.launch import train
    from repro_torch.parallel import sharding
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16"]
    _, losses = train.main(argv)
    assert not dist.is_initialized()
    assert sharding.current_context() is None
    _, again = train.main(argv + ["--overlap"])
    assert len(losses) == 3 and losses == again
    assert all(np.isfinite(losses))
    assert "done: steps [0,3)" in capsys.readouterr().out
