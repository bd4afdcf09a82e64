"""FSDP over "data" (``parallel/fsdp.py``, ``launch/specs.py``'s
placement, ``optim.clip_by_global_norm``) and the ``serve_bf16``
deployment, without the shared mesh launch.

* ``fsdp.gather`` on a one-rank gloo group (the identity both ways; a
  reduce-scatter backward, or a slice under ``replicated_batch``) and
  on the dry-run's fake world (16 ranks: the gathered shape, the
  gradient's shard shape, both collectives counted).
* Two gloo ranks on (2, 1) (``tests/torch_fsdp_cases.py``): the placed
  model's losses are the meshless ones; each data-split gradient is
  the rank's slice of the sum of the ranks' meshless gradients, each
  unsplit one the rank's own, bit for bit (zamba2's shared block, called
  at every group, sums each call's reduce-scatter: within 1e-6 of the
  slice's largest |value|); under ``replicated_batch`` the slice of the
  whole gradient, no sum; the global norm of tensors split over "data",
  "model", both and neither is the whole tensors' (1e-6 relative).
  gemma3 runs under remat and scan_group 2, so the recompute gathers
  again inside the checkpoints.
* The same two ranks on (1, 2), sequence parallelism over "model"
  (the rule ``seq_res -> ("model",)``, the whole batch on each rank):
  every gradient of the dense smoke config under remat (each region
  split) and of ``torch_dist_cases.ODD`` (each replicated) is the
  rank's slice of the meshless one within 1e-5 of the slice's largest
  |value| (f32 sums in another order); a planted fault fails that check
  by far: the sequence gather's backward as the rank's slice instead of
  the reduce-scatter (the dense config), a replicated region's exit
  keeping its own positions' gradient instead of the all-gather (ODD),
  a norm's scale gradient left unsummed over "model" (both).
* A width that 4 does not divide stays whole over "data"; an unplaced
  block is not copied.
* The dry-run's qwen2-1.5b x train_4k at (16, 16), cut to 2 layers: its
  argument bytes are exactly the reference's per-device shard sizes of
  the train state (``param_logical`` / ``spec_for``) plus the global
  batch every rank is handed; its wire over the 16-rank "data" groups
  holds all-gathers and reduce-scatters, and its all-reduce there is
  exactly the unsplit gradients' and the loss's.
* ``serve_bf16``: ``specs.serve_bf16_params`` casts every f32 parameter
  to bf16; the dry-run's serve_bf16 decode cell holds bf16 weights whole
  over "data"; meshless prefill and decode at smoke width (the configs'
  own bf16 compute) against the JAX package's with the same bf16
  parameters, within ``tests/test_torch_serve.py``'s bf16 limits (0.1
  absolute on logits ~N(0, 1); the greedy tokens where the top-2 margin
  exceeds twice that).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_fsdp_cases as cases
from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import zoo as jzoo
from repro.parallel import sharding as jshd
from repro.train import make_decode_step as jdecode_step
from repro_torch import configs, convert
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import zoo
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tpl

BF16_TOL = 0.1
B, PROMPT, N_DEC = 2, 20, 6


# --------------------------------------------------------------------------
# the gather, in one process
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("replicated", [False, True])
def test_gather_data_on_one_rank(one_rank, replicated):
    ax = tpl.TP(None, 1, 0, dist.group.WORLD)
    w = torch.randn((6, 4), requires_grad=True)
    g = torch.randn((6, 4))
    fsdp.reset_counts()
    if replicated:
        with shd.replicated_batch():
            out = fsdp.gather(w, 0, ax)
    else:
        out = fsdp.gather(w, 0, ax)
    assert torch.equal(out, w)
    out.backward(g)
    assert torch.equal(w.grad, g)
    assert fsdp.COUNTS["all_gather"] == [1, 96]
    assert fsdp.COUNTS["reduce_scatter"] == ([0, 0] if replicated
                                             else [1, 96])


def test_gather_data_on_the_fake_world():
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("data",))
        ax = tpl.TP(None, 16, 0, mesh.get_group("data"))
        w = torch.randn((3, 8), requires_grad=True)
        fsdp.reset_counts()
        out = fsdp.gather(w, 1, ax)
        assert out.shape == (3, 128)
        out.sum().backward()
        assert w.grad.shape == (3, 8)
        assert fsdp.COUNTS == {"all_gather": [1, 3 * 128 * 4],
                               "reduce_scatter": [1, 3 * 128 * 4]}
    assert not dist.is_initialized()


def test_width_that_does_not_divide_stays_whole():
    """d_model 90 on a (4, 2) mesh: ``spec_for`` drops ``p_embed``, so
    nothing is placed over "data" and no block is gathered; qwen2's 96
    splits."""
    mesh = shd.AbstractMesh((4, 2), ("data", "model"))
    for d, split in ((90, False), (96, True)):
        cfg = dataclasses.replace(configs.smoke("qwen2-1.5b"), d_model=d)
        params = zoo.build(cfg).init(torch.Generator().manual_seed(0))
        specs.place(params, mesh)
        assert ("data" in (specs.placement(params) or {})) == split
        assert fsdp.is_split(params.blocks[0]) == split
        if not split:
            assert fsdp.gathered(params.blocks[0]) is params.blocks[0]


def test_unplaced_block_is_not_copied():
    params = zoo.build(configs.smoke("qwen2-1.5b")).init(
        torch.Generator().manual_seed(0))
    assert fsdp.gathered(params.blocks[1]) is params.blocks[1]
    assert fsdp.ends(params) == (params.embed, params.embed)


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp") / "ranks.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(cases.ROOT / "tests"
                                            / "torch_fsdp_cases.py"),
                        "--out", str(out)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(out.read_text()),
            json.loads(out.with_name(out.name + ".1").read_text())]


ARCHS = list(cases.CONFIGS)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_are_the_meshless_ones(two_ranks, arch):
    for r in two_ranks:
        assert r[arch]["loss_equal"]
        assert 0 < r[arch]["split"] < r[arch]["tensors"]


@pytest.mark.parametrize("arch", ARCHS)
def test_block_gather_gradient_is_the_reduce_scatter(two_ranks, arch):
    """A data-split gradient is the rank's slice of the ranks' summed
    gradients: a sum (each data rank computed the whole tensor's
    gradient from its rows), not the rank's own slice."""
    for r in two_ranks:
        got = r[arch]
        if arch == "zamba2-1.2b":
            assert got["split_grads_max_rel"] <= 1e-6
        else:
            assert got["split_grads_equal"]
            assert got["split_grads_max_rel"] == 0.0
        # one reduce-scatter a split tensor and use: gemma3's blocks and
        # table once, zamba2's shared block once a call
        assert got["counts"]["reduce_scatter"][0] >= got["split"]


@pytest.mark.parametrize("arch", ARCHS)
def test_unsplit_gradients_are_the_ranks_own(two_ranks, arch):
    for r in two_ranks:
        assert r[arch]["unsplit_grads_equal"]


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_batch_takes_a_slice(two_ranks, arch):
    for r in two_ranks:
        assert r[arch]["replicated_grads_equal"]


def test_remat_gathers_again(two_ranks):
    """gemma3 under remat and scan_group gk = 2: a block's split tensors
    are gathered as often as the block runs, 3 - 1/gk times (the
    forward, the group's recompute, the block's own recompute, which
    torch's checkpoint stops early in one block of each group; the
    flash kernel's count, ``chip_smoke.train_flash_passes``); the table
    once."""
    got = two_ranks[0]["gemma3-1b"]
    gk, n_table = cases.CONFIGS["gemma3-1b"]["scan_group"], 1
    assert got["counts"]["all_gather"][0] == \
        (3 * gk - 1) * (got["split"] - n_table) // gk + n_table


SEQ_TOL = 1e-5


@pytest.mark.parametrize("arch", list(cases.SEQ_CONFIGS))
def test_sequence_parallel_gradients_are_the_meshless_ones(two_ranks, arch):
    for r in two_ranks:
        assert r["seq"][arch]["none"] <= SEQ_TOL


@pytest.mark.parametrize("plant,arch", [("seq_gather_slice", "qwen2-1.5b"),
                                        ("seq_scatter_local", "odd"),
                                        ("norm_unsummed", "qwen2-1.5b"),
                                        ("norm_unsummed", "odd")])
def test_planted_sequence_fault_fails_the_gradient_check(two_ranks, plant,
                                                         arch):
    """Each half of the convention (a split region's gather sums its
    gradient, a replicated region's exit all-gathers its) and the norm
    scales' sum over "model", held by a fault that the sound check
    catches."""
    for r in two_ranks:
        assert r["seq"][arch][plant] > 1e3 * SEQ_TOL


def test_global_norm_over_both_groups(two_ranks):
    for r in two_ranks:
        n = r["norm"]
        assert n["norm"] == pytest.approx(n["whole_norm"], rel=1e-6)


# --------------------------------------------------------------------------
# the dry-run's train cell
# --------------------------------------------------------------------------

def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _reference_shard_bytes(arch, shape, over, sizes):
    """The reference's train state, each leaf's per-device shard bytes
    under its ``state_shardings`` spec, summed; and its batch's bytes."""
    _, jargs = jspecs.input_specs(arch, shape, overrides=over)
    ctx = jshd.MeshContext(types.SimpleNamespace(shape=sizes),
                           jshd.DEFAULT_RULES)
    total = 0
    flat, _ = jax.tree_util.tree_flatten_with_path(jargs[0])
    for path, leaf in flat:
        names = tuple(n for n in (_key(k) for k in path)
                      if n not in ("params", "opt", "m", "v"))
        logical = ((None,) * len(leaf.shape)
                   if not names or names[-1] == "step"
                   else jspecs.param_logical(names, len(leaf.shape)))
        n = math.prod(leaf.shape)
        for e in jshd.spec_for(leaf.shape, logical, ctx):
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                n //= sizes[a]
        total += n * leaf.dtype.itemsize
    batch = sum(math.prod(x.shape) * x.dtype.itemsize
                for x in jax.tree.leaves(jargs[1]))
    return total, batch


@pytest.fixture(scope="module")
def train_cell():
    over = {"n_layers": 2}
    cell = specs.build_cell("qwen2-1.5b", "train_4k", overrides=over)
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device="cpu")
        est, stats = dryrun.estimate(cell, mesh)
        groups = {a: tuple(dist.get_process_group_ranks(mesh.get_group(a)))
                  for a in ("data", "model")}
        placed = specs.place(specs.abstract_state(cell.model), mesh)
    return over, est, stats, groups, placed


def test_dryrun_state_bytes_are_the_reference_shards(train_cell):
    over, est, _, _, _ = train_cell
    state, batch = _reference_shard_bytes("qwen2-1.5b", "train_4k", over,
                                          {"data": 16, "model": 16})
    assert est["memory"]["argument_bytes"] == state + batch
    assert est["ran"]["fsdp"]["data"] == 16
    assert est["ran"]["fsdp"]["split_tensors"] > 0


def test_dryrun_wire_over_the_data_groups(train_cell):
    """All-gathers and reduce-scatters over the 16-rank "data" groups; the
    all-reduce there is the unsplit gradients' and the loss's only (no
    data-split gradient is all-reduced over "data")."""
    _, _, stats, groups, placed = train_cell
    data = stats.groups[groups["data"]]
    assert data["size"] == 16
    kinds = data["wire_by_kind"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0
    split = specs.placement(placed)
    dims, mdims = split["data"][1], split["model"][1]
    unsplit = sum(p.numel() * 4 for p, d in
                  zip(placed.params.parameters(), dims) if d is None)
    # the loss, and one f32 partial of the gradient norm for each set of
    # axes with "data" that splits some tensor
    norm_parts = len({m is not None for d, m in zip(dims, mdims)
                      if d is not None})
    n = 16
    assert kinds["all-reduce"] == 2.0 * (n - 1) / n * (
        unsplit + 4 + 4 * norm_parts)
    assert "reduce-scatter" not in stats.groups[groups["model"]][
        "wire_by_kind"]


# --------------------------------------------------------------------------
# serve_bf16
# --------------------------------------------------------------------------

def test_serve_bf16_params_cast_every_f32_parameter():
    params = zoo.build(configs.smoke("qwen3-moe-30b-a3b")).init(
        torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in params.parameters()]
    specs.serve_bf16_params(params)
    for p, b in zip(params.parameters(), before):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, b.to(torch.bfloat16))


def test_dryrun_serve_bf16_cell():
    art = dryrun.run_cell("qwen2-1.5b", "decode_32k", False,
                          overrides={"serve_bf16": True, "n_layers": 2})
    assert art["ok"] and art["overrides"]["serve_bf16"]
    assert art["ran"]["serve_bf16"]
    assert art["ran"]["fsdp"]["split_tensors"] == 0
    assert "all-reduce" not in {k for g in art["collective_groups"]
                                if tuple(g["first_ranks"][:2]) == (0, 16)
                                for k in g["wire_by_kind"]}
    # a train cell ignores it
    art = dryrun.run_cell("qwen2-1.5b", "train_4k", False,
                          overrides={"serve_bf16": True, "n_layers": 1})
    assert not art["ran"]["serve_bf16"]
    assert art["ran"]["fsdp"]["split_tensors"] > 0
    assert not dist.is_initialized()


def _bf16_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16)
                        if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])
def test_serve_bf16_matches_reference(arch):
    cfg = configs.smoke(arch)
    jcfg = jconfigs.smoke(arch)
    jmodel = jzoo.build(jcfg)
    whole = zoo.build(cfg).init(torch.Generator().manual_seed(7))
    tree = convert.lm_params_to_numpy(whole)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    decode = jdecode_step(jmodel)

    @jax.jit
    def run(params, prompt):
        cache = jmodel.init_cache(B, PROMPT + N_DEC, dtype=jnp.bfloat16)
        pre, cache = jmodel.prefill(params, prompt, cache)
        tok = jnp.argmax(pre[:, -1], axis=-1).astype(jnp.int32)[:, None]
        fed, logits = [], []
        for _ in range(N_DEC):
            fed.append(tok)
            tok, lg, cache = decode(params, cache, tok)
            logits.append(lg[:, 0])
        return pre, jnp.concatenate(fed, 1), jnp.stack(logits, 1)

    jparams = jax.tree.map(jnp.asarray, _bf16_tree(tree))
    pre, fed, dec = map(np.array, run(jparams, jnp.asarray(prompt)))
    model = zoo.build(cfg)
    params = specs.serve_bf16_params(
        convert.lm_params_from_numpy(tree, cfg, device="cpu"))
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        cache = model.init_cache(B, PROMPT + N_DEC, device="cpu")
        t_pre, cache = model.prefill(params, torch.from_numpy(prompt), cache)
        t_dec = []
        for i in range(N_DEC):
            lg, cache = model.decode_step(params, cache,
                                          torch.from_numpy(fed[:, i:i + 1]))
            t_dec.append(lg[:, 0])
    t_pre, t_dec = t_pre.numpy(), torch.stack(t_dec, 1).numpy()
    assert t_pre.dtype == np.float32       # the unembed in f32
    np.testing.assert_allclose(t_pre, np.asarray(pre, np.float32), rtol=0,
                               atol=BF16_TOL)
    np.testing.assert_allclose(t_dec, np.asarray(dec, np.float32), rtol=0,
                               atol=BF16_TOL)
    srt = np.sort(t_dec, -1)
    sure = srt[..., -1] - srt[..., -2] > 2 * BF16_TOL
    nxt = np.concatenate([fed[:, 1:], np.asarray(dec).argmax(-1)[:, -1:]],
                         1)
    assert sure.any()
    np.testing.assert_array_equal(t_dec.argmax(-1)[sure], nxt[sure])
