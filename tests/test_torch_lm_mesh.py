"""Port vs JAX package: the LM's mesh (``models/moe.py``'s
``moe_mlp_sharded``, the meshed train step with FSDP over "data",
tensor parallelism and sequence parallelism over "model",
``launch/train.py``, ``launch/mesh.py``, checkpoints and restoring
onto placements, the rank's slice of the KV cache).

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
  the qwen2-1.5b, qwen3-moe and gemma3-1b (remat on) smoke configs and
  of a config none of whose heads, GLU hidden or vocabulary divides
  "model" and whose d_model does not divide "data" (``cases.ODD``), in
  f32, Adam's eps 1e-5 as in ``tests/test_torch_train.py``, FSDP over
  "data" and tensor-parallel over "model" on the port's side and under
  GSPMD on the reference's: loss and grad norm within 1e-5 relative;
  every parameter and both AdamW moments, gathered over "data" and
  "model", within 1e-5 relative + 1e-6 absolute (the parameters are
  O(1) norm scales and O(1e-3) biases, and a first Adam step turns a
  gradient's rounding near eps into up to lr / eps times that in the
  update); each rank's parameter shapes are the reference's per-device
  shards (``spec_for``'s "data" and "model" entries), and each rank's
  parameters and moments are bit for bit ``local_slice`` of the
  gathered whole tensors.
* The same two steps, tolerances and slices for the families those
  leave out (``cases.FAMILY_TRAIN_ARCHS``): llama-3.2-vision (a cross
  block after every second self block, on a seeded memory whose rows
  split over "data" as the tokens'), zamba2 (its SSD blocks FSDP over
  "data" and replicated over "model", its shared attention block
  called twice a pass; mamba2's SSD block is zamba2's, so this covers
  it) and seamless (its encoder over a seeded frame memory, the
  decoder's cross attention).  The reference side of these is
  ``repro``'s plain one-device step jitted without the mesh, not its
  GSPMD step (the long pole of the shared launch): the same sums,
  unpartitioned.  Each family's cross blocks, shared block, encoder
  and cross attention split over both axes, the SSD projections over
  "data" only.
* ``overlap`` gives the same parameters, bit for bit.  A step whose
  microbatch does not divide "data" (replicated over the batch axes,
  still partitioned over "model"; every data rank takes its slice of
  the whole gradient, no sum) gives the reference's metrics, parameters
  and moments within the train steps' tolerances.  The dense run's
  checkpoint, gathered over "data" and "model" and written by rank 0,
  restored onto ``state_shardings`` placements holds each rank's slice
  exactly (the tensors the FSDP step holds), its whole tensors are the
  saved ones, and it restores meshless bit for bit; a checkpoint
  written meshless, restored and placed, gives the FSDP step's tensors
  bit for bit.  ``launch.train.train`` failing at step 1 under the mesh and
  resumed from its checkpoint ends with the parameters of an
  uninterrupted run, bit for bit.
* Serving, FSDP and tensor-parallel: qwen2-1.5b's (its KV heads split),
  gemma3-1b's (one KV head, whole on every rank), zamba2-1.2b's with
  one KV head (``cases.HYBRID_KV1``: the hybrid's shared-block cache and
  decode), seamless-m4t-medium's (the encoder-decoder's cache and
  decode; a seeded frontend memory), qwen3-moe's (expert-parallel in
  prefill and decode) and llama-3.2-vision's (its cross blocks over a
  seeded memory held in the cache) smoke configs on weights split
  over "data", prefill of 2 x 16 tokens and 4 greedy
  decode steps, against the reference jitted with
  ``step_and_shardings``' in and out shardings on the mesh: every
  call's logits and the final f32 cache within 1e-5 relative and 1e-5
  of the array's largest |value|, the greedy tokens equal.  The
  ``serve_bf16`` deployment (qwen2-1.5b; rules ``p_embed -> ()``, every
  parameter bf16 and whole over "data", activations f32) against the
  reference jitted the same way: the same tolerances, since both sides
  compute in f32 from the same bf16 weights.  One forward loss of the
  llama-3.2-vision, zamba2-1.2b and seamless-m4t-medium smoke configs
  within 1e-5 relative.

* Sequence parallelism: the port under the rule ``seq_res ->
  ("model",)``, the reference's plain runs (the rule moves GSPMD's
  sums, not their values: the reference under it gave the same metrics
  within 1.5e-7 and parameters within these tolerances, and runs of it
  lengthened the shared launch, whose long pole the reference is).  Two
  train steps of the dense smoke config (every region split over
  "model"), of ``cases.ODD`` (every region replicated), of qwen3-moe
  (its MoE one replicated region on the gathered sequence, the aux loss
  in the objective at the train step's weight; against the GSPMD run),
  of llama-3.2-vision (its cross blocks on the split stream) and of
  seamless (its encoder on the whole frames, its decoder on the split
  stream, the memory's gradient summed over "model" once), 32 positions
  (16 a "model" rank), within the train steps' tolerances above (the
  MoE's aux loss and dropped share as in the meshed steps), each rank's
  parameters and moments exactly its slice, the sequence gathered in
  every one; the dense config's
  residual stream entering each block after the first is [2 rows, 16
  positions, d] on every rank and within 1e-5 of the meshless forward's
  at this rank's positions (relative to their largest |value|); one
  zamba2 forward loss (its SSM blocks gather the sequence for the scan)
  within 1e-5 relative; the ``SERVE_ARCHS`` prefill (split over
  "model": the dense blocks, the hybrid's SSM blocks and shared block,
  the encoder-decoder's decoder) and decode within the serving
  tolerances, the greedy tokens equal.  In every serving case, with and
  without the rule, each rank's k / v cache is its ``cache_specs``
  slice (gemma3's and the one-KV-head zamba2's leave T to ("data",
  "model"), 8 ways of 3 positions, which gemma3's window of 16 crosses;
  seamless's T over "data", its KV heads over "model") of the
  reference's cache
  within those tolerances, exactly the slice of the port's gathered
  cache, and placing the gathered cache again gives it back bit for
  bit.

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

from repro_torch import configs

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


@pytest.mark.parametrize("arch", ARCHS + list(cases.FAMILY_TRAIN_ARCHS))
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
        # each rank holds exactly its slice of every parameter and moment
        assert meta[f"{arch}/local_is_slice"]
    keys = [k for k in lm["ref"] if k.startswith(f"train/{arch}/")]
    assert len(keys) > 10
    assert any("/opt/m/" in k for k in keys)
    assert any("/opt/v/" in k for k in keys)
    for key in keys:
        for p in lm["port"]:
            np.testing.assert_array_equal(p[key], lm["port"][0][key])
        _close(lm["port"][0][key], lm["ref"][key], atol=1e-6, err_msg=key)


def _split_over(meta, arch, axis):
    return sorted(k for k, v in meta[f"{arch}/split_axes"].items()
                  if axis in v)


def test_tensor_parallel_splits_what_the_reference_splits(lm):
    """Over the four train configs each rank holds split heads, GLU
    columns, vocabulary rows and experts somewhere, and the non-dividing
    config holds only its wq / wk / wv / wo split (stored split, their
    heads computed whole)."""
    meta = lm["meta"][0]
    split = {a: _split_over(meta, a, "model") for a in ARCHS}
    assert "embed/table" in split["qwen2-1.5b"]
    assert "layers/mlp/gate/w" in split["gemma3-1b"]
    assert "layers/moe/gate" in split["qwen3-moe-30b-a3b"]
    assert split["odd"] == sorted(f"layers/attn/{w}/{leaf}"
                                  for w in ("wq", "wk", "wv", "wo")
                                  for leaf in ("w", "b")
                                  if (w, leaf) != ("wo", "b"))


def test_fsdp_splits_what_the_reference_splits(lm):
    """FSDP over "data": the tables, every projection's d_model dim, the
    MoE's experts and router hold a quarter of that dim on each rank;
    norm scales and biases stay whole; ``cases.ODD``'s d_model (90)
    does not divide 4 and nothing of it splits over "data"."""
    meta = lm["meta"][0]
    data = {a: _split_over(meta, a, "data") for a in ARCHS}
    assert data["odd"] == []
    for key in ("embed/table", "layers/attn/wq/w", "layers/attn/wo/w",
                "layers/mlp/gate/w", "layers/mlp/down/w"):
        assert key in data["qwen2-1.5b"], key
    for key in ("layers/moe/gate", "layers/moe/down", "layers/moe/router/w",
                "lm_head/table"):
        assert key in data["qwen3-moe-30b-a3b"], key
    for a in ARCHS:
        assert not [k for k in data[a] if k.endswith(("scale", "/b"))]
        for k in data[a]:
            assert meta[f"{a}/local_shapes"][k] != \
                list(lm["ref"][f"train/{a}/{k}"].shape)


# per family, tensors the (4, 2) placement splits over both axes, and over
# "data" alone (the SSD block is replicated over "model", as GSPMD
# leaves it: no logical axis of its weights maps there)
FAMILY_SPLITS = {
    "llama-3.2-vision-11b": ({"cross_layers/xattn/wq/w",
                              "cross_layers/xattn/wk/w",
                              "cross_layers/xattn/wo/w"}, set()),
    "zamba2-1.2b": ({"shared_block/attn/wq/w", "shared_block/mlp/down/w"},
                    {"layers/ssm/in_proj/w", "layers/ssm/out_proj/w"}),
    "seamless-m4t-medium": ({"enc_layers/attn/wq/w", "enc_layers/mlp/up/w",
                             "dec_layers/xattn/wk/w",
                             "dec_layers/xattn/wo/w"}, set())}


@pytest.mark.parametrize("arch", list(cases.FAMILY_TRAIN_ARCHS))
def test_family_placements_split_both_axes(lm, arch):
    """The families' train states on the (4, 2) mesh: the VLM's cross
    blocks, the hybrid's shared block and the encoder-decoder's encoder
    and cross attention split over "data" and "model", the SSD block's
    projections over "data" only, norm scales whole."""
    both, data_only = FAMILY_SPLITS[arch]
    for meta in lm["meta"]:
        split = meta[f"{arch}/split_axes"]
        for k in both:
            assert split[k] == ["data", "model"], k
        for k in data_only:
            assert split[k] == ["data"], k
        assert all(not v for k, v in split.items() if k.endswith("scale"))


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
    assert all(m["replicated/local_is_slice"] for m in lm["meta"])
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
    assert got["fsdp_equal"] and got["placed_equal"]
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


@pytest.mark.parametrize("key,split", [("restart", ["data", "model"]),
                                       ("restart/odd", ["model"])])
def test_checkpoint_written_by_one_rank(lm, key, split):
    """Every rank of the (4, 2) mesh calls save; only rank 0 writes, also
    where the state is not split over "data" (``cases.ODD``), and the
    resumed run equals the uninterrupted one."""
    got = [m[key] for m in lm["meta"]]
    assert all(g["split"] == split for g in got)
    assert [g["writes"] > 0 for g in got] == [True] + [False] * (len(got)
                                                                  - 1)
    g = got[0]
    assert g["failed"] and g["equal"]
    assert (g["start"], g["end"]) == (cases.RESTART["fail_at"],
                                      cases.RESTART["steps"])


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
    assert all(m[f"serve/{arch}/data_split"] > 0 for m in lm["meta"])


def test_serve_bf16_matches_reference(lm):
    """The serve_bf16 deployment: bf16 weights, none split over "data",
    the reference's logits, caches and tokens within the serving
    tolerances."""
    tag, ref = cases.SERVE_BF16_TAG, lm["ref"]
    for p, meta in zip(lm["port"], lm["meta"]):
        assert meta[f"serve/{tag}/data_split"] == 0
        assert meta[f"serve/{tag}/dtypes"] == ["torch.bfloat16"]
        _close(p[f"serve/{tag}/logits"], ref[f"serve/{tag}/logits"],
               err_msg="logits")
        for k in ("k", "v"):
            key = f"serve/{tag}/cache/{k}"
            _close(p[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(p[f"serve/{tag}/last"],
                                      ref[f"serve/{tag}/last"])
    # the bf16 weights give other logits than the f32 ones
    f32 = ref[f"serve/{cases.SERVE_BF16_ARCH}/logits"]
    assert not np.allclose(ref[f"serve/{tag}/logits"], f32, rtol=1e-5,
                           atol=1e-5)


@pytest.mark.parametrize("arch", list(cases.FORWARD_ARCHS))
def test_tensor_parallel_forward_losses_match_reference(lm, arch):
    for meta in lm["meta"]:
        _close(meta[f"forward/{arch}"], lm["ref_meta"][f"forward/{arch}"])


# --------------------------------------------------------------------------
# sequence parallelism (the rule seq_res -> ("model",)) and the cache's T
# --------------------------------------------------------------------------

SERVE_TAGS = ([a for a in cases.SERVE_ARCHS] + [cases.SERVE_BF16_TAG]
              + [f"seq/{a}" for a in cases.SERVE_ARCHS])


@pytest.mark.parametrize("arch", list(cases.SEQ_TRAIN_ARCHS))
def test_seq_train_steps_match_reference(lm, arch):
    tag = f"seq/{arch}"
    want = lm["ref_meta"][arch]
    assert len(want) == cases.TRAIN_STEPS
    for meta in lm["meta"]:
        for got, ref in zip(meta[tag], want, strict=True):
            for k in ("loss", "grad_norm", "lr"):
                _close(got[k], ref[k], err_msg=k)
            if "dropped" in ref:
                _close(got["aux_loss"], ref["aux_loss"])
                assert got["dropped"] == pytest.approx(ref["dropped"],
                                                       abs=1e-7)
        assert meta[f"{tag}/local_is_slice"]
        # the stream split: the regions gathered the sequence
        assert meta[f"{tag}/seq_collectives"]["all_gather"] > 0
    keys = [k for k in lm["ref"] if k.startswith(f"train/{arch}/")]
    assert len(keys) > 10
    assert any("/opt/m/" in k for k in keys)
    assert any("/opt/v/" in k for k in keys)
    for key in keys:
        got = key.replace(f"train/{arch}/", f"train/{tag}/")
        for p in lm["port"]:
            np.testing.assert_array_equal(p[got], lm["port"][0][got])
        _close(lm["port"][0][got], lm["ref"][key], atol=1e-6, err_msg=got)


def test_residual_stream_is_the_rank_slice(lm):
    cfg = cases.smoke_cfg(cases.SEQ_TRAIN_ARCHS[0], configs)
    rows = cases.TRAIN_BATCH // cases.ROWS
    for meta in lm["meta"]:
        got = meta["seq/residual"]
        assert got["shapes"] == [[rows, cases.TRAIN_SEQ // cases.COLS,
                                  cfg.d_model]]
        assert got["blocks"] == cfg.n_layers - 1
        assert got["max_rel"] <= TOL


def test_seq_forward_loss_matches_reference(lm):
    arch = cases.SEQ_FORWARD_ARCH
    for meta in lm["meta"]:
        _close(meta[f"seq/forward/{arch}"], lm["ref_meta"][f"forward/{arch}"])


@pytest.mark.parametrize("arch", list(cases.SERVE_ARCHS))
def test_seq_serving_matches_reference(lm, arch):
    tag, ref = f"seq/{arch}", lm["ref"]
    for p, meta in zip(lm["port"], lm["meta"]):
        assert meta[f"serve/{tag}/prefill_split"]
        _close(p[f"serve/{tag}/logits"], ref[f"serve/{arch}/logits"],
               err_msg="logits")
        for k in ("k", "v"):
            _close(p[f"serve/{tag}/cache/{k}"], ref[f"serve/{arch}/cache/{k}"],
                   err_msg=k)
        np.testing.assert_array_equal(p[f"serve/{tag}/last"],
                                      ref[f"serve/{arch}/last"])


def _slice(whole, spec, rank):
    """Rank ``rank``'s slice of ``whole`` under ``spec`` (lists of axis
    names) on the (ROWS, COLS) mesh, the first axis of an entry major."""
    sizes = {"data": cases.ROWS, "model": cases.COLS}
    coords = {"data": rank // cases.COLS, "model": rank % cases.COLS}
    for d, axes in enumerate(spec):
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coords[a], n * sizes[a]
        whole = np.split(whole, n, axis=d)[idx]
    return whole


@pytest.mark.parametrize("tag", SERVE_TAGS)
def test_cache_is_the_rank_slice(lm, tag):
    ref, ref_tag = lm["ref"], tag.removeprefix("seq/")
    specs = {tuple(map(tuple, m[f"serve/{tag}/cache_spec"]))
             for m in lm["meta"]}
    assert len(specs) == 1
    spec = specs.pop()
    if "gemma3-1b" in tag or "zamba2-kv1" in tag:
        assert spec == ((), (), ("data", "model"), (), ())
    if "seamless" in tag:
        assert spec == ((), (), ("data",), ("model",), ())
    assert any(spec[2]), spec          # T splits in every case
    for rank, (p, meta) in enumerate(zip(lm["port"], lm["meta"])):
        assert meta[f"serve/{tag}/cache_round_trip"]
        for k in ("k", "v"):
            local = p[f"serve/{tag}/cache_local/{k}"]
            np.testing.assert_array_equal(
                local, _slice(p[f"serve/{tag}/cache/{k}"], spec, rank))
            want = ref[f"serve/{ref_tag}/cache/{k}"]
            _close(local, _slice(want, spec, rank),
                   atol=TOL * np.abs(want).max(),
                   err_msg=f"{tag} {k} rank {rank}")


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
