"""The port's training path against the JAX package, on the CPU.

The JAX package's ``init_train_state`` goes through
``convert.train_state_from_numpy``; both packages then take the same
``batch_at`` batch.  One jitted JAX function per config computes the loss
and its gradients (``jax.value_and_grad``) and one ``make_train_step``
step with ``accum_steps`` 1 and 2; the port runs with remat off and on
(its ``torch.utils.checkpoint`` changes no value, as ``jax.checkpoint``
changes none).  The configs are the smoke configs in float32.

Tolerances: the loss, the gradients, the moments m and v and the step's
metrics within 1e-5 relative and 1e-5 of each array's largest |value|
(``_close``): the two frameworks sum over tokens, keys, heads and
microbatches in other orders.  The parameters after a step within 1e-5
relative and 1e-5 absolute.  The optimizer pieces on random trees within
1e-6; the data and checkpoint paths exactly.

The step comparisons use Adam's ``eps = 1e-5`` (``OPT``).  The first Adam
step moves each entry by ``lr g / (|g| + eps)``: where |g| is near eps the
move is decided by the gradient's last bits, which the two frameworks sum
differently (d/dg of that ratio is 1/eps at g = 0).  At the default 1e-8
the parameters after one step differ by up to 4.2e-5 (qwen2's key bias,
whose low-frequency rope dimensions get |g| ~ 1e-8) while the gradients
agree within 1e-5 of their largest; at 1e-5 by at most 5.5e-7.
``adamw_update`` itself is held at the default eps.

The system tests mirror ``tests/test_system.py``: restart, torn writes,
stragglers, the launcher, and a loss that drops on a fixed batch.
"""

import copy
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.core.relation import Relation as JRelation
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import zoo as jzoo
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.train import steps as jsteps
from repro_torch import configs, convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.data import pipeline, synthetic
from repro_torch.models import zoo
from repro_torch.optim import adamw, compression
from repro_torch.runtime import (RestartableLoop, StragglerMonitor,
                                 elastic_restore)
from repro_torch.train import steps

TOL = 1e-5
# the dense smoke configs; the MoE ones (qwen3-moe: top-2 of 8 experts
# with QK-norm; moonshot: a shared expert); the VLM's (a cross block
# after every 2 self blocks, over batch_at's f32 memory); and qwen2.5-14b's
# and qwen3-moe's cut to 4 layers with scan_group 2 (sqrt-L remat, nested
# checkpoints; for the MoE, its aux carried through the group's checkpoint)
ARCHS = ["qwen2-1.5b", "gemma3-1b", "qwen3-moe-30b-a3b",
         "moonshot-v1-16b-a3b", "llama-3.2-vision-11b", "qwen2.5-14b/sg2",
         "qwen3-moe-30b-a3b/sg2"]
VARIANTS = {"sg2": dict(n_layers=4, scan_group=2)}
BATCH, SEQ = 4, 16
OPT = dict(lr=1e-3, total_steps=20, warmup_steps=2, eps=1e-5)


def _close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _cfgs(arch, remat=False, **kw):
    """The port's and the JAX package's smoke configs of ``arch`` (with a
    ``/variant`` of VARIANTS) in float32."""
    name, _, variant = arch.partition("/")
    kw = VARIANTS.get(variant, {}) | kw
    return (dataclasses.replace(configs.smoke(name), dtype="float32",
                                remat=remat, **kw),
            dataclasses.replace(jconfigs.smoke(name), dtype="float32", **kw))


def _batch(cfg, step=0, seed=5):
    gen = synthetic.TokenGenConfig(vocab_size=cfg.vocab_size, batch=BATCH,
                                   seq_len=SEQ, seed=seed,
                                   n_frontend_tokens=cfg.n_frontend_tokens,
                                   d_model=cfg.d_model)
    return synthetic.batch_at(gen, step)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX: the initial TrainState, the loss and gradients, and the state
    and metrics after one step with accum_steps 1 and 2, in one jit."""
    _, jcfg = _cfgs(arch)
    model = jzoo.build(jcfg)
    opt = jadamw.AdamWConfig(**OPT)
    state = jsteps.init_train_state(model, jax.random.key(3))
    step1 = jsteps.make_train_step(model, opt, accum_steps=1)
    step2 = jsteps.make_train_step(model, opt, accum_steps=2)

    def loss_fn(params, batch):
        # the train step's loss: + 1e-2 aux_loss for MoE
        logits, aux = model.forward(params, batch["inputs"],
                                    memory=batch.get("memory"))
        loss = jsteps.cross_entropy_loss(logits, batch["targets"])
        if aux:
            loss = loss + 1e-2 * aux["aux_loss"]
        return loss

    @jax.jit
    def run(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        return loss, grads, step1(state, batch), step2(state, batch)

    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    out = run(state, batch)
    return _np_tree(state._asdict()), _np_tree(out)


def _port_state(arch, remat):
    cfg, _ = _cfgs(arch, remat)
    tree, _ = _jax_run(arch)
    return cfg, convert.train_state_from_numpy(tree, cfg, device="cpu")


def _port_batch(cfg):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}


def _port_loss(model, params, batch):
    """The train step's loss (``make_train_step``'s, moe_aux_weight
    1e-2) and the forward's aux."""
    logits, aux = model.forward(params, batch["inputs"],
                                memory=batch.get("memory"))
    loss = steps.cross_entropy_loss(logits, batch["targets"])
    if aux:
        loss = loss + 1e-2 * aux["aux_loss"]
    return loss, aux


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_repro(arch, remat):
    cfg, state = _port_state(arch, remat)
    _, (loss, grads, _, _) = _jax_run(arch)
    model = zoo.build(cfg)
    got, _ = _port_loss(model, state.params, _port_batch(cfg))
    got.backward()
    _close(got.item(), loss)
    paths = convert.leaf_paths(state.params)
    for (path, layer), p in zip(paths, state.params.parameters()):
        _close(p.grad.numpy(), convert._leaf(grads, path, layer),
               err_msg=f"d{path}[{layer}]")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro(arch, remat, accum):
    cfg, state = _port_state(arch, remat)
    _, (_, _, *after) = _jax_run(arch)
    want_state, want_metrics = after[accum - 1]
    step = steps.make_train_step(zoo.build(cfg), adamw.AdamWConfig(**OPT),
                                 accum_steps=accum)
    new, metrics = step(state, _port_batch(cfg))
    assert metrics.keys() == want_metrics.keys()
    for k in ("loss", "lr", "grad_norm", "aux_loss"):
        if k in want_metrics:
            _close(metrics[k].item(), want_metrics[k], err_msg=k)
    if "dropped" in want_metrics:
        assert metrics["dropped"].item() == float(want_metrics["dropped"])
    got = convert.train_state_to_numpy(new)
    want = want_state._asdict()
    assert got["step"] == want["step"] == 1
    assert got["opt"]["step"] == want["opt"]["step"] == 1
    for top in ("params", "opt/m", "opt/v"):
        g_tree, w_tree = got, want
        for part in top.split("/"):
            g_tree, w_tree = g_tree[part], w_tree[part]
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(g_tree),
                                jax.tree.leaves(w_tree)):
            msg = f"{top} {jax.tree_util.keystr(path)}"
            if top == "params":
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                           err_msg=msg)
            else:
                _close(g, w, err_msg=msg)


def _random_tree(rng):
    return {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32),
                  "d": rng.normal(size=(3, 4, 2)).astype(np.float32)}}


def _leaves(tree):
    return [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(tree)]


def test_adamw_update_matches_repro():
    rng = np.random.default_rng(0)
    cfg = OPT | dict(warmup_steps=2, total_steps=5, clip_norm=3.0,
                     eps=1e-8)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    params = _random_tree(rng)
    jstate = jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    tparams = _leaves(params)
    tstate = adamw.adamw_init(tparams)
    jparams = jax.tree.map(jnp.asarray, params)
    for i in range(4):                   # clipped and unclipped steps
        grads = jax.tree.map(lambda x: x * (0.5 + 2 * (i % 2)),
                             _random_tree(rng))
        jparams, jstate, jm = jadamw.adamw_update(
            jparams, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        tparams, tstate, tm = adamw.adamw_update(tparams, _leaves(grads),
                                                 tstate, tcfg)
        for k in ("lr", "grad_norm"):
            _close(tm[k].item(), jm[k], tol=1e-6)
        for name, want in (("params", jparams), ("m", jstate["m"]),
                           ("v", jstate["v"])):
            got = tparams if name == "params" else tstate[name]
            for g, w in zip(got, jax.tree.leaves(want)):
                _close(g.numpy(), w, tol=1e-6, err_msg=f"{name} step {i}")
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert tstate["step"].dtype == torch.int32


def test_cosine_schedule_and_clip_match_repro():
    cfg = dict(lr=2e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.2)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _close(adamw.cosine_schedule(
            tcfg, torch.tensor(step, dtype=torch.int32)).item(),
            jadamw.cosine_schedule(jcfg, jnp.asarray(step, jnp.int32)),
            tol=1e-6, err_msg=str(step))
    rng = np.random.default_rng(1)
    for max_norm in (0.5, 1e3):          # clipped, and left as it is
        tree = _random_tree(rng)
        jclipped, jgn = jadamw.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        tclipped, tgn = adamw.clip_by_global_norm(_leaves(tree), max_norm)
        _close(tgn.item(), jgn, tol=1e-6)
        for g, w in zip(tclipped, jax.tree.leaves(jclipped)):
            _close(g.numpy(), w, tol=1e-6)


def test_adamw_update_refuses_non_float32_masters():
    p = [torch.zeros(3, dtype=torch.bfloat16)]
    with pytest.raises(TypeError, match="float32"):
        adamw.adamw_update(p, [torch.zeros(3)], adamw.adamw_init(p),
                           adamw.AdamWConfig())


def test_cross_entropy_loss_matches_repro():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    for z in (0.0, 1e-4, 1e-1):
        _close(steps.cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(targets), z).item(),
               jsteps.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(targets), z), tol=1e-6)


def test_compression_matches_repro():
    rng = np.random.default_rng(3)
    grads = _random_tree(rng)
    res = jax.tree.map(lambda x: x * 0.01, _random_tree(rng))
    jq, js, jr = jcompression.compress_grads(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    tq, ts, tr = compression.compress_grads(_leaves(grads), _leaves(res))
    for a, b in zip(tq, jax.tree.leaves(jq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ts + tr, jax.tree.leaves(js) + jax.tree.leaves(jr)):
        _close(a.numpy(), b, tol=1e-6)
    jd, _ = jcompression.simulate_roundtrip(
        jax.tree.map(jnp.asarray, grads),
        jcompression.ef_init(jax.tree.map(jnp.asarray, grads)))
    td, _ = compression.simulate_roundtrip(
        _leaves(grads), compression.ef_init(_leaves(grads)))
    for a, b in zip(td, jax.tree.leaves(jd)):
        _close(a.numpy(), b, tol=1e-6)


def test_gradient_compression_error_feedback():
    """Error feedback keeps compressed SGD unbiased over steps (the
    counterpart of tests/test_system.py's)."""
    g = [torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (64, 64)).astype(np.float32))]
    residual = compression.ef_init(g)
    applied = torch.zeros_like(g[0])
    for _ in range(20):
        out, residual = compression.simulate_roundtrip(g, residual)
        applied += out[0]
    rel = float(torch.linalg.norm(applied - 20 * g[0])
                / torch.linalg.norm(20 * g[0]))
    assert rel < 0.01, rel
    one, _ = compression.simulate_roundtrip(g, compression.ef_init(g))
    assert float(torch.linalg.norm(one[0] - g[0])
                 / torch.linalg.norm(g[0])) > 1e-4


def test_batch_at_matches_repro_exactly():
    for kw in (dict(vocab_size=1000, batch=3, seq_len=17, seed=4),
               dict(vocab_size=151936, batch=2, seq_len=8, seed=0,
                    n_frontend_tokens=3, d_model=5)):
        tcfg = synthetic.TokenGenConfig(**kw)
        jcfg = jsynthetic.TokenGenConfig(**kw)
        for step in (0, 1, 17):
            got, want = synthetic.batch_at(tcfg, step), jsynthetic.batch_at(
                jcfg, step)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
        tit = synthetic.token_batches(tcfg, 5)
        jit = jsynthetic.token_batches(jcfg, 5)
        for _ in range(2):
            (ts, tb), (js, jb) = next(tit), next(jit)
            assert ts == js
            np.testing.assert_array_equal(tb["inputs"], jb["inputs"])


def test_join_enriched_pipeline_matches_repro():
    rng = np.random.default_rng(6)
    doc = rng.integers(0, 40, size=60).astype(np.int32)
    tier = rng.integers(-1, 6, size=60).astype(np.int32)
    probe = np.concatenate([rng.integers(0, 50, size=30),
                            [doc[0], 999]]).astype(np.int32)
    jp = jpipeline.JoinEnrichedPipeline(JRelation.from_arrays(
        capacity=64, doc=doc, tier=tier))
    tp = pipeline.JoinEnrichedPipeline(convert.relation_from_numpy(
        {"doc": doc, "tier": tier}, capacity=64, device="cpu"))
    got, want = tp.weights_for(probe), jp.weights_for(probe)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batch = tp.enrich({"inputs": probe}, probe)
    np.testing.assert_array_equal(batch["example_weight"].numpy(),
                                  np.asarray(want))


# --------------------------------------------------------------------------
# checkpoints, restart and the launcher (tests/test_system.py's
# counterparts)
# --------------------------------------------------------------------------

def _setup(tmp_path, arch="qwen2-1.5b", every=2):
    cfg = configs.smoke(arch)
    model = zoo.build(cfg)
    gen = synthetic.TokenGenConfig(vocab_size=cfg.vocab_size, batch=2,
                                   seq_len=16, seed=7)
    step_fn = steps.make_train_step(model, adamw.AdamWConfig(
        lr=1e-3, total_steps=20))

    def batch(s):
        return {k: torch.from_numpy(v)
                for k, v in synthetic.batch_at(gen, s).items()}

    manager = CheckpointManager(tmp_path / "ckpt", every=every, keep=2)
    return model, step_fn, batch, manager


def _init(model, seed=0):
    return steps.init_train_state(model, torch.Generator().manual_seed(seed))


def test_restart_resumes_identically(tmp_path):
    """Crash at step 5 -> resume from the newest committed checkpoint ->
    the same final parameters as an uninterrupted run."""
    model, step_fn, batch, manager = _setup(tmp_path)
    state0 = _init(model)
    ref = copy.deepcopy(state0)
    for s in range(8):
        ref, _ = step_fn(ref, batch(s))
    loop = RestartableLoop(manager, log=lambda *_: None)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        loop.run(copy.deepcopy(state0), step_fn, batch, 8, fail_at=5)
    last = manager.latest_step()
    assert last is not None and last <= 5
    loop2 = RestartableLoop(manager, log=lambda *_: None)
    resumed, start = loop2.resume_step(state0, device="cpu")
    assert start == last
    final, end = loop2.run(resumed, step_fn, batch, 8, start_step=start)
    assert end == 8 and int(final.step) == 8
    for a, b in zip(ref.params.parameters(), final.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_checkpoint_atomicity_ignores_torn_write(tmp_path):
    model, _, _, manager = _setup(tmp_path)
    manager.save(_init(model), 2)
    torn = manager.dir / "step_00000004"
    torn.mkdir(parents=True)
    (torn / "manifest.json").write_text("{}")
    assert latest_step(manager.dir) == 2


def test_elastic_restore_places_on_the_device(tmp_path):
    model, step_fn, batch, manager = _setup(tmp_path)
    state, _ = step_fn(_init(model), batch(0))
    manager.save(state, 1)
    restored, manifest = elastic_restore(state, manager.dir, device="cpu")
    assert manifest["step"] == 1 and int(restored.step) == 1
    for a, b in zip(state.params.parameters(), restored.params.parameters()):
        assert torch.equal(a, b) and b.device.type == "cpu"
    for a, b in zip(state.opt["v"], restored.opt["v"]):
        assert torch.equal(a, b)


def test_checkpoint_of_a_tree_of_mappings_round_trips(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "v": torch.ones(4)}}
    save_pytree(tree, tmp_path, 7, extra_meta={"note": "x"})
    restored, manifest = restore_pytree(tree, tmp_path, device="cpu")
    assert manifest["step"] == 7 and manifest["note"] == "x"
    assert manifest["keys"] == ["opt/step", "opt/v", "w"]
    assert torch.equal(restored["w"], torch.from_numpy(tree["w"]))
    assert restored["opt"]["step"].dtype == torch.int32
    assert torch.equal(restored["opt"]["v"], tree["opt"]["v"])
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({"w": np.zeros(3)}, tmp_path, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        restore_pytree({"u": np.zeros(3)}, tmp_path, device="cpu")
    (tmp_path / "step_00000007" / "arrays.npz").write_bytes(b"torn")
    with pytest.raises(IOError, match="corrupt"):
        restore_pytree(tree, tmp_path, device="cpu")


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=4.0, warmup=3)
    for s in range(10):
        mon.observe(s, 0.10 + 0.001 * (s % 2))
    st = mon.observe(10, 1.5)
    assert st.flagged and 10 in mon.flags
    assert not mon.observe(11, 0.10).flagged


def test_train_launcher_smoke(tmp_path):
    from repro_torch.launch.train import main as train_main
    state, losses = train_main([
        "--arch", "qwen2-1.5b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
        "3", "--log-every", "100", "--device", "cpu"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert latest_step(tmp_path / "ck") == 6 and int(state.step) == 6


def test_train_launcher_refuses_the_mesh_flags():
    """The production meshes need their 256 / 512 ranks (a launcher not
    under torchrun is a world of one); ``--multi-pod`` without
    ``--production`` and ``--overlap`` train on the host mesh."""
    from repro_torch.launch.train import main as train_main
    small = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
             "--seq", "16"]
    for flags, ranks in ((["--production"], "256"),
                         (["--production", "--multi-pod"], "512")):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            train_main(small + flags)
    for flag in ("--multi-pod", "--overlap"):
        _, losses = train_main(small + [flag])
        assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_entry_points_need_the_card_unless_asked_for_cpu():
    from repro_torch.launch.train import main as train_main
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_scan_group_gradients_do_not_depend_on_the_group(remat):
    """The port's loss and gradients with scan_group 2 (an outer
    checkpoint a group of 2 blocks) equal its own with scan_group 0, and
    a grad-enabled forward of the dense configs that set scan_group
    runs."""
    for arch in ("qwen2.5-14b", "yi-34b"):
        assert configs.get(arch).family == "dense"
        assert configs.get(arch).scan_group > 0
    _, state = _port_state("qwen2.5-14b/sg2", remat)
    out = {}
    for gk in (0, 2):
        cfg, _ = _cfgs("qwen2.5-14b/sg2", remat, scan_group=gk)
        loss, _ = _port_loss(zoo.build(cfg), state.params,
                             _port_batch(cfg))
        loss.backward()
        out[gk] = (loss.item(), [p.grad.clone()
                                 for p in state.params.parameters()])
        for p in state.params.parameters():
            p.grad = None
    _close(out[2][0], out[0][0])
    for (name, _), g2, g0 in zip(state.params.named_parameters(), out[2][1],
                                 out[0][1]):
        _close(g2.numpy(), g0.numpy(), err_msg=name)


def _smoke_module():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (arch, n_layers, scan_group, remat): flat, remat, the groups with and
# without remat (gk 2 and 4), the VLM's cross groups, and T3's and T4's
# cut configs' shapes; the hybrid's shared calls (2 calls and a tail
# layer, and 3 calls), the pure SSM (none), and the enc-dec's encoder,
# decoder self and cross layers
FLASH_COUNT_CASES = [("qwen2.5-14b", 4, 0, False), ("qwen2.5-14b", 4, 0, True),
                     ("qwen2.5-14b", 4, 2, False), ("qwen2.5-14b", 4, 2, True),
                     ("qwen2.5-14b", 8, 4, True),
                     ("qwen3-moe-30b-a3b", 4, 2, True),
                     ("llama-3.2-vision-11b", 4, 0, True),
                     ("llama-3.2-vision-11b", 4, 0, False),
                     ("zamba2-1.2b", 5, 0, True), ("zamba2-1.2b", 5, 0, False),
                     ("zamba2-1.2b", 6, 0, True), ("mamba2-370m", 4, 0, True),
                     ("seamless-m4t-medium", 2, 0, True),
                     ("seamless-m4t-medium", 3, 0, False)]


@pytest.mark.parametrize("arch,n_layers,gk,remat", FLASH_COUNT_CASES)
def test_flash_passes_a_microbatch_match_the_smokes_count(
        arch, n_layers, gk, remat, monkeypatch):
    """The flash forwards and backwards one forward + backward runs, as
    ``chip_smoke.train_flash_passes`` derives them for the card's launch
    checks: torch's non-reentrant checkpoint stops a group's recompute
    once the last block's input is saved again, so under remat a group
    of gk blocks runs gk - 1 forwards there, then each block one more in
    its own backward."""
    from repro_torch.kernels import flash_attention as fa
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_fwd, fa.flash_bwd

    def counted(key, fn):
        def call(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fa, "flash_fwd", counted("fwd", fwd))
    monkeypatch.setattr(fa, "flash_bwd", counted("bwd", bwd))
    cfg, _ = _cfgs(arch, remat, n_layers=n_layers, scan_group=gk)
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    loss, _ = _port_loss(model, params, _port_batch(cfg))
    loss.backward()
    want = _smoke_module().train_flash_passes(cfg)
    assert (counts["fwd"], counts["bwd"]) == (want["flash_fwd"],
                                              want["flash_bwd"])


def test_train_loss_decreases():
    """Training on a fixed batch must memorize it (loss drops > 1 nat)."""
    cfg = configs.smoke("qwen2-1.5b")
    model = zoo.build(cfg)
    gen = synthetic.TokenGenConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=32, seed=11)
    step_fn = steps.make_train_step(model, adamw.AdamWConfig(
        lr=3e-3, total_steps=60, warmup_steps=10))
    state = _init(model, 1)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic.batch_at(gen, 0).items()}
    losses = []
    for _ in range(60):
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


# --------------------------------------------------------------------------
# cross-format checkpoints
# --------------------------------------------------------------------------

def test_port_checkpoint_restores_in_repro(tmp_path):
    cfg, state = _port_state("gemma3-1b", False)
    step = steps.make_train_step(zoo.build(cfg), adamw.AdamWConfig(**OPT))
    state, _ = step(state, _port_batch(cfg))
    save_pytree(state, tmp_path, 1)
    _, jcfg = _cfgs("gemma3-1b")
    template = jsteps.init_train_state(jzoo.build(jcfg), jax.random.key(0))
    restored, manifest = jckpt.restore_pytree(template, tmp_path)
    assert manifest["step"] == 1
    want = convert.train_state_to_numpy(state)
    got = _np_tree(restored._asdict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_repro_checkpoint_restores_in_port(tmp_path):
    _, jcfg = _cfgs("qwen2-1.5b")
    _, (_, _, (jstate, _), _) = _jax_run("qwen2-1.5b")
    jckpt.save_pytree(jstate, tmp_path, 1)
    cfg, template = _port_state("qwen2-1.5b", False)
    restored, manifest = restore_pytree(template, tmp_path, device="cpu")
    assert manifest["step"] == 1
    got = convert.train_state_to_numpy(restored)
    want = jstate._asdict()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_train_state_round_trips_through_numpy():
    tree, _ = _jax_run("gemma3-1b")
    cfg, _ = _cfgs("gemma3-1b")
    state = convert.train_state_from_numpy(tree, cfg, device="cpu")
    again = convert.train_state_to_numpy(state)
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert all(p.requires_grad for p in state.params.parameters())
    assert [m.shape for m in state.opt["m"]] == [
        p.shape for p in state.params.parameters()]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                                  "llama-3.2-vision-11b"])
def test_moe_and_vlm_checkpoints_round_trip_with_repro(arch, tmp_path):
    """A port checkpoint of an MoE or VLM train state restores in the JAX
    package (``layers/moe/...``, ``cross_layers/...``), and the JAX
    package's one after a step restores in the port, bit for bit."""
    cfg, state = _port_state(arch, False)
    _, jcfg = _cfgs(arch)
    save_pytree(state, tmp_path / "port", 0)
    template = jsteps.init_train_state(jzoo.build(jcfg), jax.random.key(0))
    restored, _ = jckpt.restore_pytree(template, tmp_path / "port")
    want = convert.train_state_to_numpy(state)
    got = _np_tree(restored._asdict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    _, (_, _, (jstate, _), _) = _jax_run(arch)
    jckpt.save_pytree(jstate, tmp_path / "jax", 1)
    back, manifest = restore_pytree(state, tmp_path / "jax", device="cpu")
    assert manifest["step"] == 1
    got = convert.train_state_to_numpy(back)
    want = jstate._asdict()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
