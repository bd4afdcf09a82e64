"""Port vs JAX package: the LM's placement rules (``parallel/sharding.py``,
``launch/specs.py``, ``launch/mesh.py``), in-process and without devices.

Both sides evaluate the rules against a mesh's shape only: the port's
``AbstractMesh`` and, for the reference, a stand-in whose ``shape`` maps
axis names to sizes (its ``spec_for`` reads nothing else; its
``NamedSharding`` is swapped for the bare PartitionSpec).  Shapes come
from ``jax.eval_shape`` on the reference side and from the meta device
on the port's.

* Every parameter of every config (and the train state's moments and
  step counters) at the (16, 16) and (2, 16, 16) production shapes: the
  port's spec is the reference's ``spec_for(param_logical(...))`` of the
  same leaf, minus the stacked-layer entry.
* Batch and cache specs at each config's applicable ``configs.SHAPES``
  cell; the dry-run's rule overrides (``seq_res -> ("model",)``,
  ``p_embed -> ()``); the spec -> placements mapping; ``shard`` as the
  identity on plain tensors.
Tolerance: none (every output is a tuple of axis names).
"""

import dataclasses
import functools
import types

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import zoo as jzoo
from repro.parallel import sharding as jshd
from repro.train import init_train_state as jinit_train_state
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import zoo
from repro_torch.parallel import sharding as shd

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list(configs.ARCH_IDS)


def _ctxs(mesh, rules=None):
    shape, names = MESHES[mesh]
    rules = dict(rules or shd.DEFAULT_RULES)
    port = shd.MeshContext(shd.AbstractMesh(shape, names), rules)
    ref = jshd.MeshContext(types.SimpleNamespace(shape=dict(zip(names,
                                                                shape))),
                           rules)
    return port, ref


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's shardings builders, returning PartitionSpecs."""
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)


def _cfg(arch, shape=None):
    cfg = configs.get(arch)
    jcfg = jconfigs.get(arch)
    if shape is not None and configs.SHAPES[shape]["kind"] != "train":
        n = configs.SHAPES[shape]["seq_len"]
        cfg = dataclasses.replace(cfg, max_cache_len=n)
        jcfg = dataclasses.replace(jcfg, max_cache_len=n)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg, jcfg = _cfg(arch)
    jstate = jax.eval_shape(lambda k: jinit_train_state(jzoo.build(jcfg), k),
                            jax.random.key(0))
    return specs.abstract_state(zoo.build(cfg)), jstate


def _node(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _port_vs_ref(params, got, jtree):
    """(port spec, the reference's spec of the leaf less its stack entry)
    for every parameter."""
    from repro_torch import convert
    for (path, layer), spec in zip(convert.leaf_paths(params), got):
        want = tuple(_node(jtree, path))
        yield path, spec, want[1:] if layer >= 0 else want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, mesh, bare_specs):
    state, jstate = _abstract(arch)
    ctx, jctx = _ctxs(mesh)
    got = specs.state_specs(state, ctx)
    want = jspecs.state_shardings(jstate, jctx)
    assert len(got.params) == len(list(state.params.parameters()))
    for tree, jtree in ((got.params, want.params),
                        (got.opt["m"], want.opt["m"]),
                        (got.opt["v"], want.opt["v"])):
        for path, spec, ref in _port_vs_ref(state.params, tree, jtree):
            assert spec == ref, (path, spec, ref)
    assert got.step == tuple(want.step) == ()
    assert got.opt["step"] == tuple(want.opt["step"]) == ()
    # the same through param_specs and the reference's param_shardings
    jp = jspecs.param_shardings(jstate.params, jctx)
    for path, spec, ref in _port_vs_ref(
            state.params, specs.param_specs(state.params, ctx), jp):
        assert spec == ref, (path, spec, ref)


def _cells():
    out = []
    for arch in ARCHS:
        for shape in configs.SHAPES:
            if configs.shape_applicable(configs.get(arch), shape):
                out.append((arch, shape))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_batch_and_cache_specs_match_reference(arch, shape, mesh,
                                               bare_specs):
    cfg, jcfg = _cfg(arch, shape)
    sh = configs.SHAPES[shape]
    assert sh == jconfigs.SHAPES[shape]
    b, s = sh["global_batch"], sh["seq_len"]
    ctx, jctx = _ctxs(mesh)
    meta = torch.device("meta")
    batch = {"inputs": torch.empty((b, s), dtype=torch.int32, device=meta),
             "targets": torch.empty((b, s), dtype=torch.int32, device=meta)}
    if cfg.n_frontend_tokens:
        batch["memory"] = torch.empty((b, cfg.n_frontend_tokens,
                                       cfg.d_model), device=meta)
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jax.numpy.int32)
              for k, v in batch.items()}
    want = jspecs.batch_shardings(jbatch, jctx)
    got = specs.batch_specs(batch, ctx)
    assert got == {k: tuple(v) for k, v in want.items()}
    if sh["kind"] == "train":
        return
    cache = zoo.build(cfg).init_cache(b, s, device=meta)
    jcache = jax.eval_shape(lambda: jzoo.build(jcfg).init_cache(b, s))
    assert set(cache) == set(jcache)
    for k, v in cache.items():
        if k != "length":
            assert tuple(v.shape) == tuple(jcache[k].shape), k
    want = jspecs.cache_shardings(jcache, jctx)
    got = specs.cache_specs(cache, ctx)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m"])
def test_dryrun_overrides_match_reference(arch, mesh, bare_specs):
    """The dry-run's per-launch rules: Megatron sequence parallelism on
    the residual stream, and no FSDP when serving."""
    rules = dict(shd.DEFAULT_RULES, seq_res=("model",), p_embed=())
    ctx, jctx = _ctxs(mesh, rules)
    for shape, logical in (((256, 4096, 2048), ("batch", "seq_res",
                                                "embed")),
                           ((32, 32768, 2048), ("batch", "seq_res",
                                                "embed")),
                           ((1, 4096, 2048), ("batch", "seq", "embed")),
                           ((4096, 151936), (None, "vocab"))):
        assert shd.spec_for(shape, logical, ctx) == tuple(
            jshd.spec_for(shape, logical, jctx))
    state, jstate = _abstract(arch)
    got = specs.param_specs(state.params, ctx)
    jp = jspecs.param_shardings(jstate.params, jctx)
    for path, spec, ref in _port_vs_ref(state.params, got, jp):
        assert spec == ref, (path, spec, ref)
        assert "data" not in str(spec)


@pytest.mark.parametrize("shape,logical", [
    ((56, 128), ("heads", None)),               # yi-34b's 56 heads
    ((8, 4096), ("batch", "seq")),              # batch under pod x data
    ((2, 4096), ("batch", "seq")),              # a prefix divides
    ((3, 4096), ("batch", "seq")),              # nothing divides
    ((128, 2048, 768), ("p_experts", "p_embed", None)),
    ((4096, 4096), ("p_embed", "p_heads")),
    ((1, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", None)),
])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_matches_reference(shape, logical, mesh):
    ctx, jctx = _ctxs(mesh)
    assert shd.spec_for(shape, logical, ctx) == tuple(
        jshd.spec_for(shape, logical, jctx))


def test_placements_follow_mesh_dims():
    """A dim split over ("pod", "data") is Shard(d) on both mesh dims
    (pod major, as XLA orders a PartitionSpec entry's axes); an entry
    against the mesh's dim order has no placement form."""
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements_for((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements_for((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements_for((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="dim order"):
        shd.placements_for((("data", "pod"),), mesh)
    ctx = shd.MeshContext(mesh, shd.DEFAULT_RULES)
    got_mesh, placements = shd.sharding_for((32, 16), ("batch", "mlp"), ctx)
    assert got_mesh is mesh
    assert placements == (Shard(0), Shard(0), Shard(1))
    # 8 rows do not divide pod x data: the prefix ("pod",) keeps its shard
    assert shd.sharding_for((8, 16), ("batch", None), ctx)[1] == (
        Shard(0), Replicate(), Replicate())


def test_context_and_shard_identity():
    x = torch.arange(12.0).reshape(3, 4)
    assert shd.current_context() is None
    assert shd.sharding_for((3, 4), ("batch", None)) is None
    assert shd.shard(x, ("batch", None)) is x
    mesh = shd.AbstractMesh((4, 2), ("data", "model"))
    try:
        shd.set_context(mesh)
        ctx = shd.current_context()
        assert ctx.axis_size(("data", "model")) == 8
        assert ctx.rules == shd.DEFAULT_RULES
        assert shd.shard(x, ("batch", None)) is x
        with shd.manual_mode():
            assert shd.shard(x, ("batch", None)) is x
        assert not shd.batch_is_replicated()
        with shd.replicated_batch():
            assert shd.batch_is_replicated()
        assert not shd.batch_is_replicated()
    finally:
        shd.set_context(None)
    assert shd.current_context() is None


def test_state_shardings_are_placements():
    state, _ = _abstract("qwen2-1.5b")
    ctx, _ = _ctxs("16x16")
    sh = specs.state_shardings(state, ctx)
    mesh, placements = sh.params[0]            # embed/table
    assert mesh is ctx.mesh
    assert placements == (Shard(1), Shard(0))  # [vocab, d]: d on data
    assert sh.step == (ctx.mesh, (Replicate(), Replicate()))
