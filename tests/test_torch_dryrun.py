"""Port vs JAX package: the dry-run (``launch/dryrun.py``,
``launch/hlo_analysis.py``, ``launch/step_stats.py``, ``launch/specs.py``'s
cell builders, ``kernels/flash_attention.py``'s custom ops and
``hbm_bytes``), on the CPU.

* Exact parity with the reference: ``hbm_bytes`` over every config x
  {train, prefill}; ``model_flops_per_device`` over every applicable cell
  at 256 and 512 chips; ``Roofline.to_json()`` handed the reference's
  rates; ``_parse_overrides``; ``build_cell``'s config fields and its skip
  error; ``input_specs``' leaf shapes and dtypes (a stacked ``[L, ...]``
  leaf is L port tensors, paired through ``convert.leaf_paths``; the
  cache's ``length`` is a host int in the port, an int32 scalar in the
  reference); ``_collective_wire`` for every kind at n in {1, 2, 16,
  256, 512}; ``CollectiveStats.to_json()``; ``step_and_shardings``'
  in / out placements, the reference's specs (less a stacked leaf's
  layer entry) through ``placements_for``.
* The flash custom ops: the CPU result bit-equal to the plain version,
  the fake outputs' shapes and dtypes equal to the plain outputs', the
  flop formula equal to the bound's count (4·D / 10·D a visible pair).
* For each family (dense, MoE, VLM, SSM, hybrid, enc-dec), a train,
  prefill and decode cell as rank 0 of a fake (16, 16) world: at the
  smoke config, ``step_stats``' flops equal ``FlopCounterMode`` on the
  same step run for real on the CPU; at full width and cut depth, fake
  only, the train step's all-reduce over each batch axis equals
  2(n-1)/n x (the f32 gradient bytes it reduces: over "data" those not
  split over "data", which are reduce-scattered there, + the loss and
  the gradient norm's partials), the HBM floor under the eager traffic
  (the train step writing its parameters and both AdamW moments once),
  and no op of a flash cell returns a tensor of S x T scores.
* ``seq_shard`` and ``seq_shard_rule`` (the rule ``seq_res ->
  ("model",)``) at full width and one layer: flops and argument bytes
  equal to the plain cell's, the peak no higher, the activations'
  all-reduces over "model" turned into reduce-scatters of half their
  ring bytes plus all-gathers.  A decode cell's cache bytes are the
  reference's per-device shard of ``cache_shardings``.  A real
  CPU step at full width would hold
  gigabytes, so none runs here; full production cells belong to the CLI
  and ``chip_smoke.py``.

Tolerance: none (every comparison is exact).
"""

import dataclasses
import math
import os
import types

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.kernels import flash_attention as jfa
from repro.launch import hlo_analysis as jha
from repro.launch import hlo_stats as jhs
from repro.launch import specs as jspecs
from repro.parallel import sharding as jshd
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, hlo_analysis, specs, step_stats
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import zoo
from repro_torch.parallel import sharding as shd

ARCHS = list(configs.ARCH_IDS)
CELLS = [(a, s) for a in ARCHS for s in configs.SHAPES]
APPLICABLE = [(a, s) for a, s in CELLS
              if configs.shape_applicable(configs.get(a), s)]
# each family at full width, cut to one layer (the VLM to one cross
# group of two, the hybrid to one SSD layer and one shared-block call, the
# enc-dec to one encoder and one decoder layer)
FAMILIES = {"dense": ("qwen2-1.5b", {"n_layers": 1}),
            "moe": ("qwen3-moe-30b-a3b", {"n_layers": 1}),
            "vlm": ("llama-3.2-vision-11b",
                    {"n_layers": 2, "cross_attn_every": 2}),
            "ssm": ("mamba2-370m", {"n_layers": 1}),
            "hybrid": ("zamba2-1.2b", {"n_layers": 1, "hybrid_every": 1}),
            "encdec": ("seamless-m4t-medium",
                       {"n_layers": 1, "n_enc_layers": 1})}
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
SMOKE_SEQ, SMOKE_BATCH = 16, 32       # 2 rows a rank of the data axis


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module, whose import sets XLA_FLAGS to 512
    host devices: restored at once, before anything initialises JAX."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdr
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdr


# --------------------------------------------------------------------------
# exact parity with the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_bytes(arch):
    for train in (True, False):
        for batch, seq in ((8, 1024), (256, 4096), (32, 32768)):
            assert fa.hbm_bytes(configs.get(arch), batch, seq,
                                train=train) == jfa.hbm_bytes(
                jconfigs.get(arch), batch, seq, train=train)


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_model_flops_per_device(arch, shape):
    sh = configs.SHAPES[shape]
    for n_chips in (256, 512):
        args = (sh["kind"], sh["global_batch"], sh["seq_len"], n_chips)
        assert hlo_analysis.model_flops_per_device(
            configs.get(arch), *args) == jha.model_flops_per_device(
            jconfigs.get(arch), *args)


@pytest.mark.parametrize("terms", [
    (3.1e14, 2.2e12, 4.4e9, 1.7e14), (1e12, 9e12, 0.0, 5e11),
    (1e10, 1e8, 7e11, 3e9), (0.0, 0.0, 0.0, 0.0)])
def test_roofline_at_the_reference_rates(terms):
    port = hlo_analysis.Roofline(
        *terms, peak_flops=jha.PEAK_FLOPS, hbm_bw=jha.HBM_BW,
        link_bw=jha.ICI_BW)
    assert port.to_json() == jha.Roofline(*terms).to_json()


def test_roofline_cross_node_hop():
    """A group across nodes runs at the network's rate, one within a node
    at NVLink's; the defaults are the H100's."""
    r = hlo_analysis.Roofline(0.0, 0.0, 9e9, 0.0, cross_node_wire_bytes=5e9)
    assert r.t_collective == 4e9 / hlo_analysis.NVLINK_BW + 5e9 / 50e9
    assert (r.peak_flops, r.hbm_bw) == (989e12, 3.35e12)
    assert hlo_analysis.crosses_nodes(range(16))
    assert not hlo_analysis.crosses_nodes(range(8, 16))


@pytest.mark.parametrize("items", [
    None, [], ["scan_group=8", "seq_shard=1"], ["remat=0", "lr=3e-4"],
    ["remat=True", "dtype=bfloat16", "n_layers=4"],
    ["seq_shard=false", "moe_impl=dense", "capacity_factor=1.25"]])
def test_parse_overrides(jdryrun, items):
    got = dryrun._parse_overrides(items)
    want = jdryrun._parse_overrides(items)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v)
                                               for v in want.values()]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell(arch, shape):
    over = {"remat": False} if shape == "train_4k" else None
    try:
        want = jspecs.build_cell(arch, shape, overrides=over)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            specs.build_cell(arch, shape, overrides=over)
        assert str(got.value) == str(exc)
        return
    cell = specs.build_cell(arch, shape, overrides=over)
    assert dataclasses.asdict(cell.cfg) == dataclasses.asdict(want.cfg)
    assert ((cell.arch, cell.shape, cell.kind, cell.seq_len,
             cell.global_batch) == (want.arch, want.shape, want.kind,
                                    want.seq_len, want.global_batch))


def _leaf(x) -> tuple:
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _param_leaves(params, tensors, prefix: str) -> dict:
    """The JAX tree's leaves of port tensors aligned with
    ``params.parameters()``: a stack's L tensors as one [L, ...] leaf."""
    out: dict = {}
    for (path, layer), x in zip(convert.leaf_paths(params), tensors):
        shape, dtype = _leaf(x)
        key = f"{prefix}{path}"
        if layer < 0:
            out[key] = (shape, dtype)
            continue
        n, (shp, dt) = out.get(key, (0, (shape, dtype)))
        assert (shp, dt) == (shape, dtype), key
        out[key] = (n + 1, (shp, dt))
    return {k: ((v[0],) + v[1][0], v[1][1]) if isinstance(v[0], int)
            else v for k, v in out.items()}


def _port_leaves(cell, args) -> dict:
    out: dict = {}
    if cell.kind == "train":
        state, batch = args
        ps = state.params
        out.update(_param_leaves(ps, ps.parameters(), "0/params/"))
        out.update(_param_leaves(ps, state.opt["m"], "0/opt/m/"))
        out.update(_param_leaves(ps, state.opt["v"], "0/opt/v/"))
        out["0/opt/step"] = _leaf(state.opt["step"])
        out["0/step"] = _leaf(state.step)
        out.update({f"1/{k}": _leaf(v) for k, v in batch.items()})
        return out
    params = args[0]
    out.update(_param_leaves(params, params.parameters(), "0/"))
    for i, a in enumerate(args[1:], 1):
        if isinstance(a, dict):
            out.update({f"{i}/{k}": _leaf(v) for k, v in a.items()
                        if k != "length"})
        else:
            out[str(i)] = _leaf(a)
    return out


def _ref_leaves(cell, args) -> dict:
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(args)[0]:
        keys = []
        for k in path:
            keys.append(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name",
                                                              k)))))
        if len(keys) > 1 and keys[-1] == "length":
            assert (x.shape, str(x.dtype)) == ((), "int32")
            continue
        out["/".join(keys)] = (tuple(x.shape), str(x.dtype))
    return out


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_input_specs(arch, shape):
    jcell, jargs = jspecs.input_specs(arch, shape)
    with FakeTensorMode():
        cell, args = specs.input_specs(arch, shape)
        got = _port_leaves(cell, args)
        if cell.kind == "decode":
            assert args[1]["length"] == cell.seq_len - 1
    assert got == _ref_leaves(jcell, jargs)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 16, 256, 512])
def test_collective_wire(kind, n):
    for nbytes in (0, 4, 1 << 20, 6_172_442_624):
        assert step_stats._collective_wire(kind, nbytes, n) == \
            jhs._collective_wire(kind, nbytes, n)


@pytest.mark.parametrize("fields", [
    ({}, {}, {}, 0),
    ({"all-reduce": 6.0e9, "all-gather": 1.5e8},
     {"all-reduce": 1.125e10, "all-gather": 1.40625e8},
     {16: 1.1390625e10}, 339)])
def test_collective_stats_json(fields):
    assert hlo_analysis.CollectiveStats(*fields).to_json() == \
        jha.CollectiveStats(*fields).to_json()


# --------------------------------------------------------------------------
# the flash custom ops
# --------------------------------------------------------------------------

FLASH = [  # b, s, t, h, kvh, d, causal, window, dtype
    (2, 64, 64, 4, 2, 16, True, 0, torch.float32),
    (1, 96, 96, 6, 1, 32, True, 24, torch.float32),
    (2, 33, 70, 4, 4, 16, False, 0, torch.float32),
    (1, 48, 48, 8, 2, 64, True, 0, torch.bfloat16),
    (2, 1, 40, 4, 2, 16, False, 0, torch.float64)]


def _flash_args(case, seed=0):
    b, s, t, h, kvh, d, causal, window, dtype = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    k = torch.randn((b, t, kvh, d), generator=g).to(dtype)
    v = torch.randn((b, t, kvh, d), generator=g).to(dtype)
    do = torch.randn((b, s, h, d), generator=g).to(dtype)
    return q, k, v, do, dict(causal=causal, window=window)


def _visible_by_mask(s, t, causal, window):
    return int(fa._visible(s, t, causal, window).sum())


@pytest.fixture
def one_thread():
    """One intra-op thread for a bitwise comparison of two CPU calls: with
    more, MKL's threaded GEMM may split a sum differently between calls
    (one run of this file saw the op's output differ from the plain
    version's in the last bits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_ops(case, one_thread):
    q, k, v, do, kw = _flash_args(case)
    b, s, h, d = q.shape
    t = k.shape[1]
    o, m, l = fa.flash_fwd(q, k, v, **kw)
    want = fa._flash_fwd_ref(q, k, v, **kw)
    grads = fa.flash_bwd(q, k, v, o, m, l, do, **kw)
    want_g = fa._flash_bwd_ref(q, k, v, o, m, l, do, **kw)
    for got_x, want_x in zip((o, m, l) + grads, want + want_g):
        assert got_x.dtype == want_x.dtype
        assert torch.equal(got_x, want_x)
    with FakeTensorMode() as mode:
        fq, fk, fv, fdo = (mode.from_tensor(x) for x in (q, k, v, do))
        fake = fa.flash_fwd(fq, fk, fv, **kw)
        fake_g = fa.flash_bwd(fq, fk, fv, *fake, fdo, **kw)
    for got_x, want_x in zip(fake + fake_g, want + want_g):
        assert (got_x.shape, got_x.dtype) == (want_x.shape, want_x.dtype)
    visible = _visible_by_mask(s, t, **kw)
    assert fa.visible_pairs(s, t, **kw) == visible
    with FlopCounterMode(display=False) as fc:
        fa.flash_fwd(q, k, v, **kw)
    assert fc.get_total_flops() == 4 * d * visible * b * h
    with FlopCounterMode(display=False) as fc:
        fa.flash_bwd(q, k, v, o, m, l, do, **kw)
    assert fc.get_total_flops() == 10 * d * visible * b * h


def test_flash_ops_on_meta_give_shapes_only():
    """A meta tensor takes the fake implementation: the outputs' shapes
    and dtypes, nothing computed."""
    q = torch.zeros((1, 4, 2, 8), device="meta")
    o, m, l = fa.flash_fwd(q, q, q)
    assert (o.device.type, o.shape, m.shape, l.dtype) == (
        "meta", q.shape, (1, 2, 4, 1), torch.float32)


# --------------------------------------------------------------------------
# each family's cells on a fake world
# --------------------------------------------------------------------------

def _smoke_cell(arch, kind):
    cfg = configs.smoke(arch)
    if kind != "train":
        cfg = dataclasses.replace(cfg, max_cache_len=SMOKE_SEQ)
    return specs.Cell(arch, KINDS[kind], cfg, zoo.build(cfg), kind,
                      SMOKE_SEQ, SMOKE_BATCH)


class TestFamilies:
    """Each family's cells as rank 0 of a fake (16, 16) world, which is
    taken down after the class (the tests below bring up their own)."""

    @pytest.fixture(scope="class")
    def world(self):
        with dryrun.fake_world(256):
            yield mesh_lib.make_production_mesh(device="cpu")

    @pytest.mark.parametrize("kind", list(KINDS))
    @pytest.mark.parametrize("family", list(FAMILIES))
    def test_smoke_flops_equal_a_real_step(self, world, family, kind):
        cell = _smoke_cell(FAMILIES[family][0], kind)
        est, _ = dryrun.estimate(cell, world)
        step, args, context, ran = dryrun.prepare(cell, world)
        assert ran == est["ran"]
        with context, FlopCounterMode(display=False) as fc:
            step(*args)
        assert est["hlo_stats"]["flops"] == fc.get_total_flops() > 0
        assert not torch.cuda.is_initialized()


    @pytest.mark.parametrize("kind", list(KINDS))
    @pytest.mark.parametrize("family", list(FAMILIES))
    def test_full_width_cells(self, world, family, kind):
        arch, over = FAMILIES[family]
        cell = specs.build_cell(arch, KINDS[kind], overrides=over)
        flash = cell.cfg.family != "ssm" and kind != "decode"
        est, stats = dryrun.estimate(cell, world, trace=flash)
        hs = est["hlo_stats"]
        assert hs["flops"] > 0 and hs["traffic_bytes"] > 0
        floor = est["hbm_floor"]
        assert 0 < floor["bytes"] < hs["traffic_bytes"]
        assert est["roofline"]["hbm_bytes_per_device"] == floor["bytes"]
        assert floor["argument_read_bytes"] <= est["memory"]["argument_bytes"]
        assert (est["attn_substitution"] is not None) == flash
        if flash:
            sxt = (cell.seq_len, cell.seq_len)
            assert stats.traffic_by_op["repro_torch.flash_fwd"] > 0
            top = step_stats.trace_contributors(stats, top=3)
            assert len(top) == 3 and all(".py:" in row[4] for row in top)
            assert not [sh for sh in stats.output_shapes()
                        if len(sh) >= 4 and sh[-2:] == sxt]
        data = tuple(dist.get_process_group_ranks(world.get_group("data")))
        model = tuple(dist.get_process_group_ranks(world.get_group("model")))
        assert set(stats.groups) <= {data, model}
        # tensor parallelism's collectives over "model" (and the MoE's
        # expert-parallel ones) wherever a weight is placed split: the
        # SSM's vocabulary (50,280) and its layers split nothing
        placed = specs.place(specs.abstract_state(cell.model), world)
        split = (specs.placement(placed) or {}).get("model")
        assert (model in stats.groups) == (split is not None) \
            == (family != "ssm")
        reduced = (stats.groups[data]["wire_by_kind"].get("all-reduce", 0.0)
                   if data in stats.groups else 0.0)
        if kind == "train":
            # each rank's "data" and "model" slices of the gradients; only
            # those not split over "data" all-reduced over it (the rest
            # reduce-scattered), with the loss and the norm's partials
            grads = sum(p.numel() * 4 for p in placed.params.parameters())
            ddims = specs.placement(placed)["data"][1]
            mdims = (split or (1, [None] * len(ddims)))[1]
            unsplit = sum(p.numel() * 4 for p, d in zip(
                placed.params.parameters(), ddims) if d is None)
            parts = len({m is not None for d, m in zip(ddims, mdims)
                         if d is not None})
            n = 16
            assert reduced == 2.0 * (n - 1) / n * (unsplit + 4 + 4 * parts)
            assert stats.groups[data]["wire_by_kind"]["reduce-scatter"] > 0
            # AdamW writes every parameter and both moments once
            assert floor["argument_written_bytes"] == 3 * grads
            assert stats.groups[data]["crosses_nodes"]
            assert est["ran"]["rows_per_rank"] == cell.global_batch
        else:
            assert reduced == 0.0
            assert est["ran"]["rows_per_rank"] == cell.global_batch // 16
        mem = est["memory"]
        if kind == "prefill":   # the prompt fills the whole cache
            assert floor["argument_written_bytes"] == mem["alias_bytes"]
        # a decode step reads every argument byte (each weight's slice
        # is gathered over "data", the rank's whole slice of the cache is
        # scored: the MoE's and the VLM's caches, whose KV heads do not
        # divide "model", split T over it, and each rank reads its slice
        # with every q head), but the enc-dec's encoder weights, which
        # decode does not run
        reads_all = family != "encdec"
        if kind == "decode":
            assert (floor["argument_read_bytes"] == mem["argument_bytes"]) \
                == reads_all
        assert est["per_device_peak_bytes_est"] == (
            mem["temp_bytes"] + mem["argument_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"])
        assert not torch.cuda.is_initialized()


    @pytest.mark.parametrize("arch,shape", [
        ("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
        ("qwen2-1.5b", "decode_32k"), ("llama-3.2-vision-11b", "prefill_32k")])
    def test_step_and_shardings_match_reference(self, world, arch, shape,
                                                monkeypatch):
        """Every in / out placement is the reference's spec of the same
        leaf (a stacked leaf's less its layer entry) on the mesh."""
        monkeypatch.setattr(jspecs, "NamedSharding",
                            lambda mesh, spec: types.SimpleNamespace(spec=spec))
        over = {"n_layers": 2, "cross_attn_every": 2} \
            if arch.startswith("llama") else {"n_layers": 1}
        jcell, jargs = jspecs.input_specs(arch, shape, overrides=over)
        names = tuple(world.mesh_dim_names)
        jctx = jshd.MeshContext(types.SimpleNamespace(shape=dict(zip(
            names, world.shape))), shd.DEFAULT_RULES)
        _, jin, jout, _ = jspecs.step_and_shardings(jcell, jctx, jargs)
        with FakeTensorMode():
            cell, args = specs.input_specs(arch, shape, overrides=over)
        ctx = shd.MeshContext(world, shd.DEFAULT_RULES)
        _, got_in, got_out = specs.step_and_shardings(cell, ctx, args)

        def same(got, want, drop=0):
            spec = tuple(want.spec)[drop:]
            assert got == (world, shd.placements_for(spec, world))

        def params(got, jtree, ps):
            for (path, layer), g in zip(convert.leaf_paths(ps), got):
                want = jtree
                for part in path.split("/"):
                    want = want[part]
                same(g, want, drop=1 if layer >= 0 else 0)

        def tree(got, want):
            assert set(got) == set(want)
            for k in got:
                same(got[k], want[k])

        if cell.kind == "train":
            ps = args[0].params
            for g_st, j_st in ((got_in[0], jin[0]), (got_out[0], jout[0])):
                params(g_st.params, j_st.params, ps)
                params(g_st.opt["m"], j_st.opt["m"], ps)
                params(g_st.opt["v"], j_st.opt["v"], ps)
                same(g_st.opt["step"], j_st.opt["step"])
                same(g_st.step, j_st.step)
            tree(got_in[1], jin[1])
            for spec in jax.tree.leaves(jout[1]):   # the metrics
                same(got_out[1], spec)
            return
        params(got_in[0], jin[0], args[0])
        if cell.kind == "prefill":
            same(got_in[1], jin[1])
            tree(got_in[2], jin[2])
            assert len(got_in) == len(jin) == len(args)
            if len(args) == 4:
                same(got_in[3], jin[3])
            same(got_out[0], jout[0])
            tree(got_out[1], jout[1])
        else:
            tree(got_in[1], jin[1])
            same(got_in[2], jin[2])
            same(got_out[0], jout[0])
            same(got_out[1], jout[1])
            tree(got_out[2], jout[2])


def test_tensor_parallel_cuts_the_state_by_its_split_weights():
    """gemma3-1b x train_4k at (16, 16), cut to 2 layers: its vocabulary
    (262,144), GLU hidden (6,912) and flattened q / k / v / o dims (1,024
    and 256) all divide 16, so each rank's argument bytes are those of
    "model" replicated less 15/16 of those weights' parameter and both
    AdamW moments' f32 bytes, computed from the config."""
    over = {"n_layers": 2}
    cell = specs.build_cell("gemma3-1b", "train_4k", overrides=over)
    c = cell.cfg
    q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    split = c.vocab_size * c.d_model + c.n_layers * (
        3 * c.d_model * c.d_ff + 2 * c.d_model * q + 2 * c.d_model * kv)
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device="cpu")
        # tensor parallelism alone: the placement's p_embed rule off
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(specs, "DEFAULT_RULES",
                       {**shd.DEFAULT_RULES, "p_embed": ()})
            est, _ = dryrun.estimate(cell, mesh)
        # "model" replicated: nothing placed, the model code in manual
        # mode (``tensor_parallel.active()`` is None there)
        with pytest.MonkeyPatch.context() as mp, shd.manual_mode():
            mp.setattr(specs, "place", lambda obj, *a, **k: obj)
            whole, _ = dryrun.estimate(cell, mesh)
    assert est["ran"]["tensor_parallel"] == {
        "heads": "replicated", "kv_heads": "replicated", "mlp": "split",
        "vocab": "split"}
    assert whole["memory"]["argument_bytes"] \
        - est["memory"]["argument_bytes"] == 3 * 4 * split * 15 // 16
    assert est["per_device_peak_bytes_est"] < \
        whole["per_device_peak_bytes_est"]
    assert not dist.is_initialized()


# qwen2-1.5b with 16 q and KV heads: every region splits over a 16-way
# "model" axis (its own 12 q heads would leave attention replicated)
SEQ_OVER = {"n_layers": 1, "n_heads": 16, "n_kv_heads": 16}


@pytest.mark.parametrize("shape,over", [
    ("train_4k", {"seq_shard": True}),
    ("prefill_32k", {"seq_shard_rule": "model"})])
def test_seq_shard_cells_run(shape, over):
    """The JAX package's sequence-sharding overrides add the rule
    ``seq_res -> ("model",)``: the cell's flops and argument bytes are
    the plain cell's, its peak no higher; over "model" each all-reduce
    of an activation's partial sums (f32) becomes a reduce-scatter of
    half its ring bytes, with the sequence all-gathered in the compute
    dtype, and the rule adds only the all-reduces of the norms' scale
    gradients (train: three norms a microbatch) or of the prefill's
    last position (f32)."""
    arts = [dryrun.run_cell("qwen2-1.5b", shape, False, overrides=o)
            for o in ({**SEQ_OVER, **over}, SEQ_OVER)]
    est, plain = arts
    assert est["ran"]["sequence_parallel"]
    assert not plain["ran"]["sequence_parallel"]
    assert est["xla_cost"]["flops"] == plain["xla_cost"]["flops"]
    assert est["memory"]["argument_bytes"] == \
        plain["memory"]["argument_bytes"]
    assert est["per_device_peak_bytes_est"] <= \
        plain["per_device_peak_bytes_est"]
    # rank 0's "model" group: ranks 0-15 of the (16, 16) mesh
    got, want = ({k: v for g in a["collective_groups"]
                  if g["first_ranks"] == [0, 1, 2, 3]
                  for k, v in g["wire_by_kind"].items()} for a in arts)
    assert set(want) == {"all-reduce"}
    assert got["all-gather"] > 0
    ring = 2.0 * 15 / 16
    cell = specs.build_cell("qwen2-1.5b", shape, overrides=SEQ_OVER)
    d = cell.cfg.d_model
    extra = (3 * cell.cfg.accum_steps * ring * d * 4 if shape == "train_4k"
             else ring * (cell.global_batch // 16) * d * 4)
    assert 2 * got["reduce-scatter"] == \
        want["all-reduce"] - got["all-reduce"] + extra
    assert not dist.is_initialized()


def test_decode_cache_bytes_are_the_reference_shard():
    """yi-34b x decode_32k: its 8 KV heads do not divide "model", so the
    cache's T splits over it; each rank's k / v bytes are the
    reference's per-device shard of ``cache_shardings``
    (``NamedSharding.shard_shape`` on a (16, 16) ``AbstractMesh``)."""
    from jax.sharding import AbstractMesh
    over = {"n_layers": 1}
    jcell, jargs = jspecs.input_specs("yi-34b", "decode_32k", overrides=over)
    jctx = jshd.MeshContext(AbstractMesh((16, 16), ("data", "model")),
                            jshd.DEFAULT_RULES)
    want = sum(
        math.prod(sh.shard_shape(jargs[1][k].shape))
        * jargs[1][k].dtype.itemsize
        for k, sh in jspecs.cache_shardings(jargs[1], jctx).items()
        if k in ("k", "v"))
    cell = specs.build_cell("yi-34b", "decode_32k", overrides=over)
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device="cpu")
        est, _ = dryrun.estimate(cell, mesh)
    shapes = est["ran"]["inputs"]
    assert shapes["1/shard"]["k"][2] == "model"
    got = sum(math.prod(shapes[f"1/{k}"]) * 2 for k in ("k", "v"))
    assert got == want
    assert not dist.is_initialized()


def test_multi_pod_wire_per_batch_axis():
    """On (2, 16, 16) the train step all-reduces every gradient (each
    rank's "data" and "model" slices, those split over "data" after
    their reduce-scatter there) and the loss over "pod", and over "data"
    the gradients not split over it, the loss and the norm's partials:
    2(n-1)/n of their bytes each; tensor parallelism's collectives run
    over "model"."""
    arch, over = FAMILIES["dense"]
    with dryrun.fake_world(512):
        mesh = mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
        cell = specs.build_cell(arch, "train_4k", overrides=over)
        _, stats = dryrun.estimate(cell, mesh)
        groups = {a: tuple(dist.get_process_group_ranks(mesh.get_group(a)))
                  for a in ("pod", "data", "model")}
        placed = specs.place(specs.abstract_state(cell.model), mesh)
    params = list(placed.params.parameters())
    split = specs.placement(placed)
    ddims, mdims = split["data"][1], split["model"][1]
    grads = sum(p.numel() * 4 for p in params)
    unsplit = sum(p.numel() * 4 for p, d in zip(params, ddims) if d is None)
    parts = len({m is not None for d, m in zip(ddims, mdims)
                 if d is not None})
    for axis, n, nbytes in (("pod", 2, grads + 4),
                            ("data", 16, unsplit + 4 + 4 * parts)):
        assert stats.groups[groups[axis]]["wire_by_kind"]["all-reduce"] \
            == 2.0 * (n - 1) / n * nbytes
    assert stats.groups[groups["pod"]]["wire_by_kind"].keys() == {
        "all-reduce"}
    assert set(stats.groups) == set(groups.values())
    assert not dist.is_initialized()


def test_run_cell_artifact(jdryrun):
    """The artifact carries the reference's top-level keys (``fits_16gb``
    is the card's ``fits_80gb``), and the world is down afterwards."""
    art = dryrun.run_cell("gemma3-1b", "decode_32k", False,
                          overrides={"n_layers": 2})
    assert not dist.is_initialized()
    want = {"arch", "shape", "kind", "mesh", "n_chips", "overrides", "ok",
            "lower_s", "compile_s", "memory", "per_device_peak_bytes_est",
            "fits_16gb", "xla_cost", "hlo_stats", "attn_substitution",
            "roofline", "param_count", "active_param_count"}
    assert want - {"fits_16gb"} | {"fits_80gb"} <= set(art)
    assert art["roofline"]["hbm_bytes_per_device"] == \
        art["hbm_floor"]["bytes"]
    assert set(art["hlo_stats"]) == {
        "flops", "traffic_bytes", "collective_wire_bytes", "wire_by_kind",
        "wire_by_group_size", "n_collectives"}
    assert set(art["roofline"]) == set(jha.Roofline(1, 1, 1, 1).to_json())
    assert art["ok"] and art["n_chips"] == 256 and art["mesh"] == "16x16"
    assert art["overrides"] == {"n_layers": 2}


def test_run_cell_save_hlo(jdryrun, tmp_path):
    """``run_cell(..., save_hlo=)`` (the reference's ``--save-hlo``) writes
    the step's op trace, one line an op: its ``c10d`` lines are the
    artifact's collectives, their wire bytes its wire, and the flops of
    every line its flops; ``--save-hlo`` is the CLI's flag for it."""
    import inspect
    assert "save_hlo" in inspect.signature(jdryrun.run_cell).parameters
    path = tmp_path / "trace.txt"
    art = dryrun.run_cell("gemma3-1b", "decode_32k", False,
                          overrides={"n_layers": 2}, save_hlo=str(path))
    assert not dist.is_initialized()
    lines = path.read_text().splitlines()
    assert lines and all(ln.split()[0] == str(i)
                         for i, ln in enumerate(lines))
    coll = [ln for ln in lines if " group_size=" in ln]
    assert len(coll) == art["hlo_stats"]["n_collectives"] > 0
    assert all(ln.split()[1].startswith("c10d.") for ln in coll)
    wire = sum(float(ln.rsplit("wire_bytes=", 1)[1]) for ln in coll)
    assert wire == pytest.approx(art["hlo_stats"]["collective_wire_bytes"],
                                 rel=1e-9)
    flops = sum(float(ln.split(" flops=", 1)[1].split()[0]) for ln in lines)
    assert flops == art["xla_cost"]["flops"]
    out = tmp_path / "out"
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--set",
                 "n_layers=2", "--out", str(out), "--save-hlo",
                 str(tmp_path / "cli.txt")])
    assert (tmp_path / "cli.txt").read_text().splitlines() == lines
