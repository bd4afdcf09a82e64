"""Port vs JAX package: tensor parallelism over "model", in one process
(``parallel/tensor_parallel.py``, ``launch/specs.py``'s placement).

* ``tensor_parallel.plan`` says "split" for a tensor exactly where the
  JAX package's ``spec_for`` keeps "model" on the annotated activation
  (q ``[B,S,H,D]`` by heads, k/v by kv_heads, the GLU hidden by mlp,
  the logits by vocab, the MoE's dispatched ``[E, C, d]`` by experts),
  for every config at m in {2, 16}.
* ``place`` gives each rank of a (2, 2) ("data", "model") mesh
  ``local_slice`` of each tensor under its ``param_specs`` "data" and
  "model" entries (params and both moments), and ``gather_state`` of the
  ranks' slices is the whole state, bit for bit, on a shape-only
  ``AbstractMesh``.
* With no mesh, and on a one-rank gloo mesh of ("data" 1, "model" 1),
  a forward of qwen2-1.5b's smoke config issues no collective, runs the
  same aten ops, and gives bit-equal logits.

The multi-rank values (train steps, serve steps, forward losses,
checkpoints) are held against the JAX package's GSPMD on the (4, 2)
launch of ``tests/torch_dist_cases.py`` (``tests/test_torch_lm_mesh.py``).
Tolerance: none (every comparison here is exact).
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.parallel import sharding as jshd
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import zoo
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tpl
from repro_torch.train import init_train_state


def _ctxs(m):
    names, shape = ("data", "model"), (16, m)
    port = shd.MeshContext(shd.AbstractMesh(shape, names), shd.DEFAULT_RULES)
    ref = jshd.MeshContext(types.SimpleNamespace(shape=dict(zip(names, shape))),
                           shd.DEFAULT_RULES)
    return port, ref


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_plan_is_the_reference_spec(arch, m):
    cfg = configs.get(arch)
    port, ref = _ctxs(m)
    b, s = 256, 4096
    shapes = {
        "heads": ((b, s, cfg.n_heads, cfg.head_dim),
                  ("batch", "seq", "heads", None), 2),
        "kv_heads": ((b, s, cfg.n_kv_heads, cfg.head_dim),
                     ("batch", "seq", "kv_heads", None), 2),
        "mlp": ((b, s, cfg.d_ff), ("batch", "seq", "mlp"), 2),
        "vocab": ((b, s, cfg.vocab_size), ("batch", "seq", "vocab"), 2)}
    if cfg.is_moe:
        shapes["experts"] = ((cfg.n_experts, 64, cfg.d_model),
                             ("experts", None, None), 0)
        if cfg.n_shared_experts:
            shapes["shared_mlp"] = (
                (b * s, cfg.moe_d_ff * cfg.n_shared_experts),
                ("batch", "mlp"), 1)
    got = tpl.plan(cfg, port)
    assert set(got) == set(shapes)
    for k, (shape, logical, d) in shapes.items():
        entry = jshd.spec_for(shape, logical, ref)[d]
        want = "split" if shape[d] and entry == "model" else "replicated"
        assert got[k] == want, (k, shape, entry)


def test_plan_at_sixteen_is_the_documented_table():
    """A few rows of the rule at the production m = 16."""
    port, _ = _ctxs(16)
    q = {a: tpl.plan(configs.get(a), port) for a in configs.ARCH_IDS}
    assert q["qwen3-moe-30b-a3b"]["heads"] == "split"
    assert q["qwen2-1.5b"]["heads"] == "replicated"        # 12 heads
    assert q["qwen2-1.5b"]["mlp"] == q["qwen2-1.5b"]["vocab"] == "split"
    assert q["seamless-m4t-medium"]["vocab"] == "replicated"   # 256,206
    assert all(p["kv_heads"] == "replicated" for a, p in q.items()
               if configs.get(a).n_kv_heads < 16)


def test_local_slice_is_the_chunk_of_each_mesh_dim():
    mesh = shd.AbstractMesh((2, 2), ("data", "model"))
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for c in ((0, 0), (0, 1), (1, 0), (1, 1)):
        got = specs.local_slice(t, (("data", "model"), None), mesh, c)
        assert torch.equal(got, t.chunk(4, 0)[2 * c[0] + c[1]])
        got = specs.local_slice(t, ("data", "model"), mesh, c)
        assert torch.equal(got, t.chunk(2, 0)[c[0]].chunk(2, 1)[c[1]])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b",
                                  "gemma3-1b"])
def test_place_and_gather_round_trip(arch):
    """Every rank's placed state holds ``local_slice`` of the whole
    tensors under their "data" and "model" entries; gathering the ranks'
    slices ("data" first, then "model") gives the whole state back, bit
    for bit (unsplit tensors shared, not copied)."""
    n = m = 2
    mesh = shd.AbstractMesh((n, m), ("data", "model"))
    cfg = configs.smoke(arch)
    state = init_train_state(zoo.build(cfg),
                             torch.Generator().manual_seed(0))
    state.opt["m"][:] = [torch.rand_like(t) for t in state.opt["m"]]
    state.opt["v"][:] = [torch.rand_like(t) for t in state.opt["v"]]
    ctx = shd.MeshContext(mesh, shd.DEFAULT_RULES)
    dims = specs.split_dims(state.params, ctx, "model")
    ddims = specs.split_dims(state.params, ctx, "data")
    assert any(d is not None for d in dims)
    assert any(d is None for d in dims)
    assert any(d is not None for d in ddims)
    whole = ([p.detach() for p in state.params.parameters()]
             + state.opt["m"] + state.opt["v"])
    coords = [(c, r) for c in range(n) for r in range(m)]
    parts = {c: specs.place(copy.deepcopy(state), mesh, coords=c)
             for c in coords}
    for c, part in parts.items():
        assert specs.placement(part) == {"data": (n, tuple(ddims)),
                                         "model": (m, tuple(dims))}
        got = (list(part.params.parameters()) + part.opt["m"]
               + part.opt["v"])
        for w, g, d, dd in zip(whole, got, dims * 3, ddims * 3):
            spec = tuple("model" if i == d else "data" if i == dd else None
                         for i in range(w.dim()))
            assert torch.equal(g.detach(), specs.local_slice(
                w, spec, mesh, c))
    by_id = {}
    for rank_tensors in zip(*[list(p.params.parameters()) + p.opt["m"]
                              + p.opt["v"] for p in parts.values()]):
        by_id[id(rank_tensors[0])] = dict(zip(coords, rank_tensors))

    made = {}          # id of a tensor gathered over "data" -> its source

    def gather(t, d, axis):
        # rank (0, 0)'s tensor whole over "data"; then, from that, whole
        # over "model" too (each model rank's slice whole over "data")
        key, dd, _ = made.get(id(t)) or (next(
            k for k, v in by_id.items() if v[0, 0] is t), None, None)
        ranks = by_id[key]
        if axis == "data":
            out = torch.cat([ranks[c, 0].detach() for c in range(n)], dim=d)
            made[id(out)] = (key, d, out)
            return out
        return torch.cat([ranks[0, r].detach() if dd is None else torch.cat(
            [ranks[c, r].detach() for c in range(n)], dim=dd)
            for r in range(m)], dim=d)

    back = specs.gather_state(parts[0, 0], gather=gather)
    assert specs.placement(back) is None
    assert specs.placement(parts[0, 0]) is not None
    assert not any(hasattr(mod, "data_dims") for mod in back.params.modules())
    got = list(back.params.parameters()) + back.opt["m"] + back.opt["v"]
    for w, g in zip(whole, got):
        assert torch.equal(g.detach(), w)
    # placing again is a no-op; a mesh of size-1 axes places nothing
    assert specs.place(parts[0, 0], mesh) is parts[0, 0]
    alone = copy.deepcopy(state)
    specs.place(alone, shd.AbstractMesh((1, 1), ("data", "model")))
    assert specs.placement(alone) is None


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_model_axis_of_one_is_the_meshless_forward(one_rank, monkeypatch):
    """No mesh, and a ("data" 1, "model" 1) gloo mesh: no collective, the
    same aten ops, bit-equal logits; placing on it changes nothing."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = dataclasses.replace(configs.smoke("qwen2-1.5b"), dtype="float32")
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    calls = []
    for fn in ("all_reduce", "all_gather_into_tensor", "broadcast"):
        monkeypatch.setattr(dist, fn, lambda *a, _fn=fn, **k:
                            calls.append(_fn))
    out = {}
    for tag, m in (("none", None), ("one", mesh)):
        shd.set_context(m)
        try:
            assert tpl.active() is None
            if m is not None:
                specs.place(params, m)
                assert specs.placement(params) is None
            with _Ops() as rec:
                logits, _ = model.forward(params, toks)
            out[tag] = (logits, rec.ops)
        finally:
            shd.set_context(None)
    assert not calls
    assert torch.equal(out["none"][0], out["one"][0])
    assert out["none"][1] == out["one"][1]
    assert out["none"][0].shape[-1] == cfg.vocab_size
