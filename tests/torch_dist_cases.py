"""The mesh path's cases, run by either package in its own processes.

    python torch_dist_cases.py reference --out DIR
    python torch_dist_cases.py port --suite parity|oracle --rank K \
        --rows R --cols C --store FILE --out DIR [--timeout S] [--stall]

``reference`` runs the JAX package on 8 forced XLA host devices in a
(4, 2) mesh (the flag is set before jax is imported, as
``dist_runner.py`` does).  ``port`` is one rank of the port's mesh: gloo
over a ``FileStore``, the rank's stripes of the same relations.  Both
build their inputs from the numpy seeds below, so the two sides (and the
test that reads their JSON and npz outputs) see the same rows.  Every
case's result is ``[count, overflowed, rounds, kind]`` (``rounds`` None
for the one-shot wrappers, which have no rounds).

The ``parity`` suite is ``dist_runner.py``'s join cases with its data
(the same seeds and draws), plus the all-pairs triangle form, plus the
shuffle primitives' outputs per rank.  The ``oracle`` suite holds odd
capacities (padded to the mesh) and a heavy-key linear case whose count,
and one rank's partial, passes 2^31; at 1 × 1 it also runs
``JoinSession.execute``.  ``--stall`` makes rank 1 sit out the first
collective for longer than the groups' timeout.

The parity launches also run the LM's mesh cases (``lm_reference`` /
``lm_port``) on a (4, 2) ("data", "model") mesh, the reference under
GSPMD and the port tensor-parallel over "model": the expert-parallel
MoE FFN at two capacity factors with its gradients, two train steps of
four smoke configs (dense, MoE, gemma3's GQA with one KV head, and
``ODD``, which divides nothing; 2 microbatches), the port's ``overlap``
path, a checkpoint gathered over "model" and restored onto ``Shard``
placements and meshless, a failed and resumed ``launch.train`` run,
prefill and decode steps (jitted with ``step_and_shardings``' shardings
on the reference's side) and three families' forward losses.  Their
inputs are numpy draws and the port's own seeded initialisation (the
reference carries it across with ``convert``), written to
``lm_ref.npz`` / ``lm_ref.json`` and ``lm_port_<rank>.npz`` /
``lm_port_<rank>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS, COLS = 4, 2                  # the parity suite's mesh
HEAVY_N = 4000                     # rows of each heavy-key relation


# --------------------------------------------------------------------------
# inputs (numpy only: both packages read these)
# --------------------------------------------------------------------------

def skewed_keys(rng, n, d, frac, heavy=1):
    """``conftest.skewed_keys``: a heavy hitter owning ``frac`` of the rows,
    the rest uniform over [0, d)."""
    n_heavy = int(n * frac)
    vals = np.concatenate([
        np.full(n_heavy, heavy, np.int32),
        rng.integers(0, d, size=n - n_heavy).astype(np.int32)])
    rng.shuffle(vals)
    return vals


def rel(rng, n, cols, d, zipf=None):
    """``conftest.make_rel``'s draws, as a dict of numpy columns."""
    out = {}
    for c in cols:
        if zipf is None:
            out[c] = rng.integers(0, d, size=n).astype(np.int32)
        else:
            out[c] = (np.minimum(rng.zipf(zipf, size=n), d) - 1).astype(
                np.int32)
    return out


LIN_PREDS = [("r.b", "s.b"), ("s.c", "t.c")]
CYC_PREDS = [("r.b", "s.b"), ("s.c", "t.c"), ("t.a", "r.a")]
STAR_PREDS = [("dim1.b", "fact.b"), ("fact.c", "dim2.c")]
SLACK = dict(shuffle_slack=4.0, local_slack=5.0)
TIGHT = dict(shuffle_slack=1.2, local_slack=1.0, max_rounds=2)
LIN_DIMS = dict(local_u=4, local_g=2)


def case(name, call, kind, tables, **kw):
    """``call``: "oneshot" (the ``*_count_sharded`` wrappers), "engine"
    (``engine_count_sharded``), "session" (``execute_sharded``; then
    ``tables`` maps query names to tables and ``kw["preds"]`` holds the
    predicates) or "execute" (``JoinSession.execute`` on the whole
    relations, the single-card path)."""
    return {"name": name, "call": call, "kind": kind, "tables": tables,
            "kw": kw}


def parity_suite():
    """``dist_runner.py``'s join cases on its data: the same seeds and the
    same order of draws."""
    rng = np.random.default_rng(42)
    t = {}
    t["r"], t["s"], t["t"] = (rel(rng, 160, ("a", "b"), 30),
                              rel(rng, 176, ("b", "c"), 30),
                              rel(rng, 168, ("c", "a"), 30))
    t["r2"], t["s2"], t["t2"] = (rel(rng, 144, ("a", "b"), 40),
                                 rel(rng, 160, ("b", "c"), 40),
                                 rel(rng, 152, ("c", "d"), 40))
    t["r3"], t["s3"], t["t3"] = (rel(rng, 64, ("a", "b"), 25),
                                 rel(rng, 320, ("b", "c"), 25),
                                 rel(rng, 72, ("c", "d"), 25))
    cyc, lin, star = ("r", "s", "t"), ("r2", "s2", "t2"), ("r3", "s3", "t3")
    cases = [
        case("oneshot_cyclic", "oneshot", "cyclic", cyc, **SLACK),
        case("oneshot_linear", "oneshot", "linear", lin, **SLACK,
             **LIN_DIMS),
        case("oneshot_star", "oneshot", "star", star, **SLACK),
        case("engine_linear", "engine", "linear", lin, **SLACK, **LIN_DIMS),
        case("engine_cyclic", "engine", "cyclic", cyc, **SLACK),
        case("engine_star", "engine", "star", star, **SLACK),
        case("engine_cyclic_allpairs", "engine", "cyclic", cyc, **SLACK,
             pair_index=False),
        case("session_linear", "session", None,
             dict(zip("rst", lin)), preds=LIN_PREDS, **SLACK, **LIN_DIMS),
        case("session_cyclic", "session", None,
             dict(zip("rst", cyc)), preds=CYC_PREDS, **SLACK),
        case("session_star", "session", None,
             dict(zip(("dim1", "fact", "dim2"), star)), preds=STAR_PREDS,
             **SLACK)]
    for seed in (0, 1):
        srng = np.random.default_rng(1000 + seed)

        def skewed(n, d, frac, heavy=1):
            return skewed_keys(srng, n, d, frac, heavy)

        ra5, rb5 = skewed(160, 25, 0.5), skewed(160, 25, 0.5, 3)
        sb5, sc5 = skewed(176, 25, 0.5, 3), skewed(176, 25, 0.5, 5)
        tc5, ta5 = skewed(168, 25, 0.5, 5), skewed(168, 25, 0.5)
        t[f"r5_{seed}"], t[f"s5_{seed}"], t[f"t5_{seed}"] = (
            {"a": ra5, "b": rb5}, {"b": sb5, "c": sc5}, {"c": tc5, "a": ta5})
        cases.append(case(f"skew_cyclic_{seed}", "engine", "cyclic",
                          (f"r5_{seed}", f"s5_{seed}", f"t5_{seed}"),
                          **TIGHT))
        rb6 = skewed(144, 30, 0.6)
        sb6, sc6 = skewed(160, 30, 0.6), skewed(160, 30, 0.4, 7)
        tc6 = skewed(152, 30, 0.4, 7)
        t[f"r6_{seed}"] = {"a": rng.integers(0, 99, 144).astype(np.int32),
                           "b": rb6}
        t[f"s6_{seed}"] = {"b": sb6, "c": sc6}
        t[f"t6_{seed}"] = {"c": tc6,
                           "d": rng.integers(0, 99, 152).astype(np.int32)}
        cases.append(case(f"skew_linear_{seed}", "engine", "linear",
                          (f"r6_{seed}", f"s6_{seed}", f"t6_{seed}"),
                          **TIGHT, **LIN_DIMS))
    t["s7"] = {"b": skewed_keys(rng, 320, 25, 0.6, 9),
               "c": skewed_keys(rng, 320, 25, 0.6, 11)}
    cases.append(case("skew_star", "engine", "star", ("r3", "s7", "t3"),
                      **TIGHT))
    t["r4"], t["s4"], t["t4"] = (rel(rng, 160, ("a", "b"), 30, zipf=1.5),
                                 rel(rng, 160, ("b", "c"), 30, zipf=1.5),
                                 rel(rng, 160, ("c", "d"), 30, zipf=1.5))
    cases.append(case("oneshot_linear_zipf", "oneshot", "linear",
                      ("r4", "s4", "t4"), shuffle_slack=8.0, local_u=2,
                      local_g=2, local_slack=8.0))
    return t, cases


def heavy_tables():
    """A linear chain whose count, 4e9, passes 2^31 on ONE rank of a 2 × 2
    mesh: 8 keys b that all route to mesh position (0, 0), each in its own
    local h bucket (u = 8, salt 0), so every fused cell stays below 2^31;
    2 keys c in distinct g buckets (g = 4)."""
    import torch

    from repro_torch.core.hashing import hash_bucket
    cand = torch.arange(1, 100_000, dtype=torch.int32)

    def first_per_bucket(keys, nb, fn, want):
        ids = hash_bucket(keys, nb, fn).tolist()
        picked = {}
        for k, i in zip(keys.tolist(), ids):
            picked.setdefault(i, k)
        return sorted(picked.values())[:want]

    at00 = cand[(hash_bucket(cand, 2, "H") == 0)
                & (hash_bucket(cand, 2, "G") == 0)]
    bs = np.array(first_per_bucket(at00, 8, "h", 8), np.int32)
    cs = np.array(first_per_bucket(cand, 4, "g", 2), np.int32)
    i = np.arange(HEAVY_N)
    return {"hr": {"a": i.astype(np.int32), "b": bs[i % 8]},
            "hs": {"b": bs[i % 8], "c": cs[(i // 8) % 2]},
            "ht": {"c": cs[i % 2], "d": i.astype(np.int32)}}


def oracle_suite(rows, cols):
    """Odd capacities (padded to the mesh) against the oracles; the heavy
    case; at 1 × 1 also the single-card ``JoinSession.execute``."""
    rng = np.random.default_rng(7)
    t = {"lr": rel(rng, 203, ("a", "b"), 35),
         "ls": rel(rng, 181, ("b", "c"), 35),
         "lt": rel(rng, 197, ("c", "d"), 35),
         "cr": rel(rng, 211, ("a", "b"), 20),
         "cs": rel(rng, 189, ("b", "c"), 20),
         "ct": rel(rng, 199, ("c", "a"), 20),
         "sr": rel(rng, 57, ("a", "b"), 20),
         "ss": rel(rng, 333, ("b", "c"), 20),
         "st": rel(rng, 61, ("c", "d"), 20)}
    t["lr"]["b"][rng.random(203) < 0.3] = 5          # a hot key
    t.update(heavy_tables())
    lin, cyc, star = ("lr", "ls", "lt"), ("cr", "cs", "ct"), ("sr", "ss", "st")
    cases = [
        case("oneshot_linear", "oneshot", "linear", lin, **SLACK),
        case("oneshot_cyclic", "oneshot", "cyclic", cyc, **SLACK),
        case("oneshot_star", "oneshot", "star", star, **SLACK),
        case("engine_linear_tight", "engine", "linear", lin, **TIGHT),
        case("engine_cyclic_tight", "engine", "cyclic", cyc, **TIGHT),
        case("engine_star_tight", "engine", "star", star, **TIGHT),
        case("session_linear", "session", None, dict(zip("rst", lin)),
             preds=LIN_PREDS),
        case("session_cyclic", "session", None, dict(zip("rst", cyc)),
             preds=CYC_PREDS),
        case("session_star", "session", None,
             dict(zip(("dim1", "fact", "dim2"), star)), preds=STAR_PREDS),
        case("heavy_linear", "engine", "linear", ("hr", "hs", "ht"))]
    if rows * cols == 1:
        cases += [case(f"execute_{c['name'][8:]}", "execute", None,
                       c["tables"], preds=c["kw"]["preds"])
                  for c in cases if c["call"] == "session"]
    return t, cases


def suite(name, rows=ROWS, cols=COLS):
    return parity_suite() if name == "parity" else oracle_suite(rows, cols)


# --------------------------------------------------------------------------
# the shuffle primitives: two-phase routing, both broadcasts, OR, any
# --------------------------------------------------------------------------

PRIM_TABLE = "r"                    # parity suite's cyclic R (160 rows)


def prim_caps(suggest_capacity, local_rows, nrow, ncol):
    """Tight send buffers (slack 1.0) so that some buckets drop rows:
    the order of the received rows decides which."""
    cap1 = suggest_capacity(local_rows, nrow, 1.0)
    return cap1, suggest_capacity(nrow * cap1, ncol, 1.0)


# --------------------------------------------------------------------------
# the port: one rank
# --------------------------------------------------------------------------

def _result(count, overflowed, rounds, kind):
    return [int(count), bool(overflowed),
            None if rounds is None else int(rounds), kind]


def run_port(args):
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import distributed as D
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession

    world = args.rows * args.cols
    dist.init_process_group(
        "gloo", store=dist.FileStore(args.store, world), rank=args.rank,
        world_size=world, timeout=datetime.timedelta(seconds=args.timeout))
    mesh = D.make_mesh(args.rows, args.cols, device="cpu",
                       timeout=args.timeout)
    tables, cases = suite(args.suite, args.rows, args.cols)
    out = pathlib.Path(args.out)

    def whole(name):
        return relation_from_numpy(tables[name], device="cpu")

    def place(name):
        return D.shard_relation(D.pad_to_multiple(whole(name), world), mesh,
                                "row", "col")

    if args.stall and args.rank == 1:
        time.sleep(args.timeout + 30)       # never joins in time
        return
    results = {}
    for c in cases:
        kw = dict(c["kw"])
        if c["call"] == "oneshot":
            fn = getattr(D, f"{c['kind']}3_count_sharded")(
                mesh, "row", "col", **kw)
            res = fn(*map(place, c["tables"]))
            results[c["name"]] = _result(res.count, res.overflowed, None,
                                         c["kind"])
        elif c["call"] == "engine":
            fn = D.engine_count_sharded(mesh, "row", "col", c["kind"], **kw)
            res = fn(*map(place, c["tables"]))
            results[c["name"]] = _result(res.count, res.overflowed,
                                         res.rounds, c["kind"])
        else:
            preds = [tuple(p) for p in kw.pop("preds")]
            if c["call"] == "session":
                q = Query({k: place(v) for k, v in c["tables"].items()},
                          preds)
                res = JoinSession().execute_sharded(q, mesh, "row", "col",
                                                    **kw)
            else:
                q = Query({k: whole(v) for k, v in c["tables"].items()},
                          preds)
                res = JoinSession(m_budget=64).execute(q, strategy="3way")
            results[c["name"]] = _result(res.count, res.overflowed,
                                         res.rounds, res.kind)
    if args.suite == "parity":
        np.savez(out / f"prims_{args.rank}.npz",
                 **port_primitives(D, mesh, place(PRIM_TABLE)))
        lm_port(D.make_mesh(ROWS, COLS, "data", "model", device="cpu",
                            timeout=args.timeout), args.rank, out)
    (out / f"port_{args.rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()


def port_primitives(D, mesh, r):
    import torch

    from repro_torch.core.partition import suggest_capacity
    ax = D._axes(mesh, "row", "col")
    cap1, cap2 = prim_caps(suggest_capacity, r.capacity, ax.nrow, ax.ncol)
    r1, ovf1 = D._shuffle(r, "a", ax.row, ax.nrow, cap1, "H")
    r2, ovf2 = D._shuffle(r1, "b", ax.col, ax.ncol, cap2, "G")
    rep_row = D._replicate(r1, ax.row)
    rep_col = D._replicate(r, ax.col)
    bits = torch.bitwise_left_shift(torch.ones_like(r.col("a")[:4]),
                                     r.col("a")[:4] % 31)
    out = {"ovf1": ovf1.reshape(1), "ovf2": ovf2.reshape(1),
           "or_all": D._or_all(bits, (ax.row, ax.col)),
           "any": D._psum_bool(r.col("b")[:1] == 3, (ax.row, ax.col))}
    for tag, x in (("r1", r1), ("r2", r2), ("rep_row", rep_row),
                   ("rep_col", rep_col)):
        out.update({f"{tag}_{k}": v for k, v in x.columns.items()})
        out[f"{tag}_valid"] = x.valid
    return {k: v.numpy() for k, v in out.items()}


# --------------------------------------------------------------------------
# the LM's mesh: (4, 2) ("data", "model")
# --------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_X = (8, 64)                    # global [B, S]: 2 x 64 tokens a shard
MOE_CFS = (8.0, 1.25)              # nothing dropped at 8.0 (>= E/k)
MOE_AUX_W = 0.37                   # the aux loss's weight in the objective
TRAIN_ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b", "gemma3-1b", "odd")
# a config none of whose heads, GLU hidden or vocabulary divides m = 2
# (its wq / wk / wv / wo still divide: stored split, gathered for use)
ODD = ("qwen2-1.5b", dict(n_heads=3, n_kv_heads=1, d_ff=255,
                          vocab_size=511))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 16, 32, 2, 2
TRAIN_OPT = dict(lr=1e-3, total_steps=20, warmup_steps=2, eps=1e-5)
REPLICATED_MB = 3                  # rows of a microbatch that 4 cannot split
INIT_SEED = 3
SERVE_ARCHS = ("qwen2-1.5b", "gemma3-1b")
SERVE_B, SERVE_PROMPT, SERVE_STEPS, SERVE_LEN = 2, 16, 4, 24
FORWARD_ARCHS = ("llama-3.2-vision-11b", "zamba2-1.2b",
                 "seamless-m4t-medium")
FORWARD_B, FORWARD_S = 8, 16
RESTART = dict(steps=2, batch=8, seq=16, fail_at=1)


def moe_inputs(cfg):
    rng = np.random.default_rng(5)
    shape = MOE_X + (cfg.d_model,)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def train_batches(cfg):
    rng = np.random.default_rng(17)
    out = []
    for _ in range(TRAIN_STEPS):
        toks = rng.integers(0, cfg.vocab_size,
                            (TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)
        out.append({"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def replicated_batches(cfg):
    """The first train batch cut to two microbatches of REPLICATED_MB."""
    return [{k: v[:2 * REPLICATED_MB]
             for k, v in train_batches(cfg)[0].items()}]


def smoke_cfg(arch, configs):
    """``arch``'s smoke config in float32 (``"odd"``: ``ODD``'s), from
    either package's ``configs``."""
    import dataclasses
    base, over = ODD if arch == "odd" else (arch, {})
    return dataclasses.replace(configs.smoke(base), dtype="float32", **over)


def port_init(arch):
    """The port's seeded MoE layer or train state (its smoke config, in
    float32)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import moe, zoo
    from repro_torch.train import init_train_state
    gen = torch.Generator().manual_seed(INIT_SEED)
    if arch == "moe":
        cfg = configs.smoke(MOE_ARCH)
        return cfg, moe.init_moe(gen, cfg)
    cfg = smoke_cfg(arch, configs)
    return cfg, init_train_state(zoo.build(cfg), gen)


def serve_tokens(cfg):
    rng = np.random.default_rng(23)
    return rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)).astype(
        np.int32)


def forward_batch(cfg):
    """inputs, targets [B, S] and the frontend's memory [B, F, d]."""
    rng = np.random.default_rng(29)
    toks = rng.integers(0, cfg.vocab_size,
                        (FORWARD_B, FORWARD_S + 1)).astype(np.int32)
    out = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_frontend_tokens:
        out["memory"] = rng.normal(size=(
            FORWARD_B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def lm_reference(out: pathlib.Path):
    """The JAX package on the (4, 2) ("data", "model") mesh of the 8
    forced devices: ``moe_mlp_sharded`` (output, aux, gradients of
    ``sum(out * ct) / 4 + MOE_AUX_W * aux_loss``; also ``moe_mlp``'s
    gradients of the aux-free objective), and ``make_train_step`` jitted
    under the mesh context for TRAIN_STEPS steps, and for one step of the
    MoE config on ``replicated_batches``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import mesh as mesh_lib
    from repro.models import moe as jmoe
    from repro.models import zoo as jzoo
    from repro.optim import AdamWConfig
    from repro.parallel import sharding as jshd
    from repro.train import steps as jsteps
    from repro import compat
    from repro_torch import convert
    mesh = compat.make_mesh((ROWS, COLS), ("data", "model"))
    arrays, meta = {}, {}

    _, layer = port_init("moe")
    cfg = jconfigs.smoke(MOE_ARCH)
    p = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(layer))
    x, ct = map(jnp.asarray, moe_inputs(cfg))
    for cf in MOE_CFS:
        # "aux": the sharded function with the aux term; "noaux": the
        # unsharded moe_mlp without it where nothing drops (the port's
        # sharded path must give its gradients there)
        for sharded, w in ((True, MOE_AUX_W),) + (
                ((False, 0.0),) if cf == MOE_CFS[0] else ()):
            fn = jmoe.moe_mlp_sharded if sharded else jmoe.moe_mlp

            def objective(x, p, fn=fn, cf=cf, w=w):
                y, aux = fn(x, p, cfg, capacity_factor=cf)
                return jnp.sum(y * ct) / ROWS + w * aux["aux_loss"], (y, aux)

            if sharded:
                mesh_lib.activate(mesh)
            try:
                (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                    objective, argnums=(0, 1), has_aux=True))(x, p)
            finally:
                jshd.set_context(None)
            tag = f"moe/{cf}/{'aux' if sharded else 'noaux'}"
            arrays[f"{tag}/out"] = np.asarray(y)
            arrays[f"{tag}/aux_loss"] = np.asarray(aux["aux_loss"])
            arrays[f"{tag}/dropped"] = np.asarray(aux["dropped"])
            arrays[f"{tag}/grad/x"] = np.asarray(gx)
            for k, v in _flat(jax.tree.map(np.asarray, gp)).items():
                arrays[f"{tag}/grad/{k}"] = v

    def train(arch, tag, batches, accum):
        cfg, state = port_init(arch)
        tree = convert.train_state_to_numpy(state)
        jstate = jsteps.TrainState(
            jax.tree.map(jnp.asarray, tree["params"]),
            jax.tree.map(jnp.asarray, tree["opt"]), jnp.asarray(tree["step"]))
        step = jsteps.make_train_step(
            jzoo.build(smoke_cfg(arch, jconfigs)), AdamWConfig(**TRAIN_OPT),
            accum_steps=accum)
        mesh_lib.activate(mesh)
        try:
            step = jax.jit(step)
            recs = []
            for batch in batches(cfg):
                jstate, m = step(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
                recs.append({k: float(v) for k, v in m.items()})
        finally:
            jshd.set_context(None)
        meta[tag] = recs
        for k, v in _flat(jax.tree.map(np.asarray, jstate.params)).items():
            arrays[f"train/{tag}/{k}"] = v
        return tree

    for arch in TRAIN_ARCHS:
        tree = train(arch, arch, train_batches, TRAIN_ACCUM)
        meta[f"{arch}/local_shapes"] = ref_local_shapes(
            jax.tree.map(np.asarray, tree["params"]), mesh)
    # microbatches of REPLICATED_MB rows, which the 4 "data" ranks cannot
    # split: GSPMD replicates them
    train(TRAIN_ARCHS[1], "replicated", replicated_batches, 2)
    t0 = time.perf_counter()
    ref_serve(mesh, arrays)
    ref_forwards(mesh, meta)
    print(f"lm_reference serving, forwards {time.perf_counter() - t0:.1f}s",
          flush=True)
    np.savez(out / "lm_ref.npz", **arrays)
    (out / "lm_ref.json").write_text(json.dumps(meta))


def ref_local_shapes(params, mesh) -> dict:
    """Each parameter leaf's shape on one rank, from the reference's
    ``param_logical`` and ``spec_for`` on the mesh: its "model" entry
    divides the dim (the "data" entries, FSDP, are left whole, as the
    port's placement leaves them)."""
    from repro.launch import specs as jspecs
    from repro.parallel import sharding as jshd
    ctx = jshd.MeshContext(mesh, jshd.DEFAULT_RULES)
    out = {}
    for k, v in _flat(params).items():
        spec = jshd.spec_for(v.shape, jspecs.param_logical(
            tuple(k.split("/")), v.ndim), ctx)
        out[k] = [n // COLS if e == "model" or (isinstance(e, tuple)
                                                  and "model" in e) else n
                  for n, e in zip(v.shape, spec)]
    return out


def ref_serve(mesh, arrays):
    """Prefill of ``SERVE_B`` x ``SERVE_PROMPT`` tokens, then
    ``SERVE_STEPS`` greedy decode steps, each jitted with
    ``step_and_shardings``' in and out shardings on the mesh (f32 cache
    of ``SERVE_LEN`` positions); the logits of each call and the final
    cache arrays."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import mesh as mesh_lib
    from repro.launch import specs as jspecs
    from repro.models import zoo as jzoo
    from repro.parallel import sharding as jshd
    from repro_torch import convert
    ctx = jshd.MeshContext(mesh, jshd.DEFAULT_RULES)
    for arch in SERVE_ARCHS:
        _, state = port_init(arch)
        jcfg = smoke_cfg(arch, jconfigs)
        model = jzoo.build(jcfg)
        params = jax.tree.map(jnp.asarray,
                              convert.lm_params_to_numpy(state.params))
        cache = model.init_cache(SERVE_B, SERVE_LEN, dtype=jnp.float32)
        toks = jnp.asarray(serve_tokens(jcfg))
        mesh_lib.activate(mesh)
        try:
            cell = jspecs.Cell(arch, "prefill", jcfg, model, "prefill",
                               SERVE_PROMPT, SERVE_B)
            step, in_sh, out_sh, _ = jspecs.step_and_shardings(
                cell, ctx, (params, toks, cache))
            logits, cache = jax.jit(step, in_shardings=in_sh,
                                    out_shardings=out_sh)(params, toks, cache)
            got = [np.asarray(logits)]
            cell = dataclasses.replace(cell, kind="decode")
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(
                jnp.int32)[:, None]
            step, in_sh, out_sh, _ = jspecs.step_and_shardings(
                cell, ctx, (params, cache, nxt))
            decode = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
            for _ in range(SERVE_STEPS):
                nxt, logits, cache = decode(params, cache, nxt)
                got.append(np.asarray(logits))
        finally:
            jshd.set_context(None)
        arrays[f"serve/{arch}/logits"] = np.stack(got)
        for k in ("k", "v"):
            arrays[f"serve/{arch}/cache/{k}"] = np.asarray(cache[k])
        arrays[f"serve/{arch}/last"] = np.asarray(nxt)


def ref_forwards(mesh, meta):
    """``cross_entropy_loss`` of one forward of each ``FORWARD_ARCHS``
    smoke config (f32), jitted under the mesh's sharding context."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import mesh as mesh_lib
    from repro.models import zoo as jzoo
    from repro.parallel import sharding as jshd
    from repro.train import steps as jsteps
    from repro_torch import convert
    for arch in FORWARD_ARCHS:
        _, state = port_init(arch)
        jcfg = smoke_cfg(arch, jconfigs)
        model = jzoo.build(jcfg)
        params = jax.tree.map(jnp.asarray,
                              convert.lm_params_to_numpy(state.params))
        batch = {k: jnp.asarray(v) for k, v in forward_batch(jcfg).items()}

        def loss(params, batch, model=model):
            logits, _ = model.forward(params, batch["inputs"],
                                      memory=batch.get("memory"))
            return jsteps.cross_entropy_loss(logits, batch["targets"])

        mesh_lib.activate(mesh)
        try:
            meta[f"forward/{arch}"] = float(jax.jit(loss)(params, batch))
        finally:
            jshd.set_context(None)


def _expected_local(full, placements, coords, sizes):
    """This rank's shard of ``full`` under ``placements``: mesh dims in
    order, each ``Shard(d)`` taking its coordinate's ``torch.chunk``."""
    for pl, c, n in zip(placements, coords, sizes):
        if pl.is_shard():
            full = full.chunk(n, dim=pl.dim)[c]
    return full


def lm_port(mesh, rank, out: pathlib.Path):
    """One rank of the port on the (4, 2) ("data", "model") mesh: its rows
    of the MoE input through ``moe_mlp_sharded`` (and its gradients, the
    parameters' averaged over "data"), the train steps on the global
    batches (tensor-parallel over "model": each rank's parameters are its
    "model" slices, gathered for the comparison), the same dense run with
    ``overlap``, an MoE step whose microbatch does not divide "data"
    (``replicated_batches``), the dense run's checkpoint (gathered over
    "model", written by rank 0) restored onto ``state_shardings``
    placements and meshless, the serve steps and forwards of
    ``lm_port_serving``, and ``lm_port_restart``."""
    import copy

    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import specs
    from repro_torch.models import moe, zoo
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding
    from repro_torch.train import make_train_step
    arrays, meta = {}, {"rank": rank, "model_rank":
                        mesh.get_local_rank("model")}
    data_group = mesh.get_group("data")
    row = mesh.get_local_rank("data")

    cfg, layer = port_init("moe")
    x, ct = moe_inputs(cfg)
    lb = MOE_X[0] // ROWS
    rows = slice(row * lb, (row + 1) * lb)
    for cf in MOE_CFS:
        for tag, w in (("aux", MOE_AUX_W),) + (
                (("noaux", 0.0),) if cf == MOE_CFS[0] else ()):
            tag = f"moe/{cf}/{tag}"
            lay = copy.deepcopy(layer)
            xt = torch.from_numpy(x[rows]).requires_grad_(True)
            sharding.set_context(mesh)
            try:
                y, aux = moe.moe_mlp_sharded(xt, lay, cfg,
                                             capacity_factor=cf)
            finally:
                sharding.set_context(None)
            obj = (y * torch.from_numpy(ct[rows])).sum() + \
                w * aux["aux_loss"]
            obj.backward()
            grads = dict(zip((pth for pth, _ in convert.leaf_paths(lay)),
                             (q.grad for q in lay.parameters())))
            for g in grads.values():
                dist.all_reduce(g, group=data_group)
                g /= ROWS
            arrays[f"{tag}/out"] = y.detach().numpy()
            arrays[f"{tag}/aux_loss"] = aux["aux_loss"].detach().numpy()
            arrays[f"{tag}/dropped"] = aux["dropped"].numpy()
            arrays[f"{tag}/grad/x"] = (xt.grad / ROWS).numpy()
            for k, g in grads.items():
                arrays[f"{tag}/grad/{k}"] = g.numpy()

    ctx = sharding.MeshContext(mesh, sharding.DEFAULT_RULES)
    for arch in TRAIN_ARCHS + ("overlap",):
        cfg, state = port_init(TRAIN_ARCHS[0] if arch == "overlap"
                               else arch)
        step = make_train_step(zoo.build(cfg), AdamWConfig(**TRAIN_OPT),
                               accum_steps=TRAIN_ACCUM, mesh=mesh,
                               overlap=arch == "overlap")
        recs = []
        for batch in train_batches(cfg):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
            recs.append({k: float(v) for k, v in m.items()})
        meta[arch] = recs
        local = list(state.params.parameters())
        meta[f"{arch}/checksum"] = float(sum(
            np.float64(p.detach().numpy()).sum() for p in local))
        shapes = {}
        for (path, layer_i), p in zip(convert.leaf_paths(state.params),
                                      local):
            n = convert.stack_length(cfg, path)
            shapes[path] = ([n] if layer_i >= 0 else []) + list(p.shape)
        meta[f"{arch}/local_shapes"] = shapes
        flat = _flat(convert.lm_params_to_numpy(state.params, mesh))
        for k, v in flat.items():
            arrays[f"train/{arch}/{k}"] = v
        if arch == TRAIN_ARCHS[0]:
            dense = state

    # a microbatch of 3 rows does not divide the 4 "data" ranks: every
    # rank takes it whole (replicated), still partitioned over "model"
    cfg, state = port_init(TRAIN_ARCHS[1])
    step = make_train_step(zoo.build(cfg), AdamWConfig(**TRAIN_OPT),
                           accum_steps=2, mesh=mesh)
    meta["replicated"] = []
    for batch in replicated_batches(cfg):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        meta["replicated"].append({k: float(v) for k, v in m.items()})
    for k, v in _flat(convert.lm_params_to_numpy(state.params, mesh)).items():
        arrays[f"train/replicated/{k}"] = v

    # the dense run's state, gathered over "model" by data row 0 and
    # written by rank 0; every rank restores it sharded and meshless
    ckpt = out / "ckpt"
    whole = specs.gather_model_state(dense, mesh)
    if row == 0:
        CheckpointManager(ckpt, mesh=mesh).save(dense, TRAIN_STEPS)
    dist.barrier()
    shardings = specs.state_shardings(whole, ctx)
    restored, manifest = CheckpointManager(ckpt).restore(
        whole, device="cpu", shardings=shardings)
    coords = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    saved = ([p.detach() for p in whole.params.parameters()]
             + list(whole.opt["m"]) + list(whole.opt["v"]))
    got = (list(restored.params.parameters()) + list(restored.opt["m"])
           + list(restored.opt["v"]))
    placed = (list(shardings.params) + list(shardings.opt["m"])
              + list(shardings.opt["v"]))
    local_ok = whole_ok = True
    n_sharded = 0
    for want, dt, (_, placements) in zip(saved, got, placed):
        n_sharded += any(pl.is_shard() for pl in dt.placements)
        local_ok &= tuple(dt.placements) == tuple(placements)
        local_ok &= torch.equal(dt.to_local(), _expected_local(
            want, placements, coords, sizes))
        whole_ok &= torch.equal(dt.full_tensor(), want)
    meshless, _ = CheckpointManager(ckpt).restore(whole, device="cpu")
    back = ([p.detach() for p in meshless.params.parameters()]
            + list(meshless.opt["m"]) + list(meshless.opt["v"]))
    meta["restore"] = {
        "step": manifest["step"], "leaves": len(got),
        "sharded": int(n_sharded), "local_equal": bool(local_ok),
        "full_equal": bool(whole_ok),
        "meshless_equal": all(torch.equal(a, b) for a, b in
                              zip(back, saved)),
        "steps_replicated": [restored.step.full_tensor().item(),
                             restored.opt["step"].full_tensor().item()]}
    lm_port_serving(mesh, arrays, meta)
    meta["restart"] = lm_port_restart(mesh, out)
    np.savez(out / f"lm_port_{rank}.npz", **arrays)
    (out / f"lm_port_{rank}.json").write_text(json.dumps(meta))


def lm_port_serving(mesh, arrays, meta):
    """Tensor-parallel serving and forwards: the ``SERVE_ARCHS`` smoke
    configs' prefill and greedy decode steps on placed parameters and a
    cache of the rank's KV heads (logits and caches gathered over
    "model"), and one forward loss of each ``FORWARD_ARCHS`` config on
    the whole batch (every rank), under the mesh's sharding context."""
    import torch

    from repro_torch import convert
    from repro_torch.models import zoo
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor_parallel as tpl
    from repro_torch.train.steps import (cross_entropy_loss,
                                         make_decode_step, make_prefill_step)

    def placed(arch):
        """The seeded parameters as the reference's tree, carried onto
        this rank's "model" slices."""
        cfg, state = port_init(arch)
        return cfg, zoo.build(cfg), convert.lm_params_from_numpy(
            convert.lm_params_to_numpy(state.params), cfg, device="cpu",
            mesh=mesh)

    sharding.set_context(mesh)
    try:
        tp = tpl.active()
        for arch in SERVE_ARCHS:
            cfg, model, params = placed(arch)
            cache = model.init_cache(SERVE_B, SERVE_LEN, dtype=torch.float32,
                                     device="cpu")
            meta[f"serve/{arch}/cache_heads"] = cache["k"].shape[3]
            logits, cache = make_prefill_step(model)(
                params, torch.from_numpy(serve_tokens(cfg)), cache)
            got = [logits]
            decode = make_decode_step(model)
            nxt = tpl.argmax(logits[:, -1], cfg.vocab_size, tp).to(
                torch.int32)[:, None]
            for _ in range(SERVE_STEPS):
                nxt, logits, cache = decode(params, cache, nxt)
                got.append(logits)
            arrays[f"serve/{arch}/logits"] = torch.stack([
                tpl.all_gather(lg, 2, tp) for lg in got]).numpy()
            for k in ("k", "v"):
                c = cache[k]
                if c.shape[3] != cfg.n_kv_heads:
                    c = tpl.all_gather(c, 3, tp)
                arrays[f"serve/{arch}/cache/{k}"] = c.numpy()
            arrays[f"serve/{arch}/last"] = nxt.numpy()
        with torch.no_grad():
            for arch in FORWARD_ARCHS:
                cfg, model, params = placed(arch)
                batch = {k: torch.from_numpy(v)
                         for k, v in forward_batch(cfg).items()}
                logits, _ = model.forward(params, batch["inputs"],
                                          memory=batch.get("memory"))
                if tp.splits("vocab", cfg.vocab_size):
                    loss = tpl.cross_entropy(logits, batch["targets"],
                                             cfg.vocab_size, tp)
                else:
                    loss = cross_entropy_loss(logits, batch["targets"])
                meta[f"forward/{arch}"] = float(loss)
    finally:
        sharding.set_context(None)


def lm_port_restart(mesh, out: pathlib.Path) -> dict:
    """``launch.train.train`` on the mesh, failing at step
    ``RESTART["fail_at"]`` after a checkpoint a step, then resumed, beside
    an uninterrupted run: whether their parameters, gathered over
    "model", are equal."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.launch.train import train
    from repro_torch.models import zoo
    model = zoo.build(smoke_cfg(TRAIN_ARCHS[0], configs))
    kw = dict(steps=RESTART["steps"], batch=RESTART["batch"],
              seq=RESTART["seq"], device="cpu", mesh=mesh, log=lambda _: None)
    ckpt = out / "restart_ckpt"
    failed = False
    try:
        train(model, ckpt_dir=str(ckpt), ckpt_every=1,
              fail_at=RESTART["fail_at"], **kw)
    except RuntimeError:
        failed = True
    resumed = train(model, ckpt_dir=str(ckpt), ckpt_every=1, **kw)
    straight = train(model, **kw)
    dist.barrier()
    a, b = (specs.gather_model_state(r["state"], mesh)
            for r in (resumed, straight))
    return {"failed": failed, "start": resumed["start"],
            "end": resumed["end"],
            "equal": all(torch.equal(x, y) for x, y in zip(
                a.params.parameters(), b.params.parameters()))}


# --------------------------------------------------------------------------
# the JAX package on 8 forced host devices
# --------------------------------------------------------------------------

def run_reference(args):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro.core import distributed as D
    from repro.core.query import Query
    from repro.core.relation import Relation
    from repro.core.session import JoinSession

    assert len(jax.devices()) == 8, jax.devices()
    mesh = jax.make_mesh((ROWS, COLS), ("row", "col"))
    tables, cases = parity_suite()

    def place(name):
        r = Relation.from_arrays(**tables[name])
        return D.shard_relation(D.pad_to_multiple(r, ROWS * COLS), mesh,
                                "row", "col")

    results = {}
    for c in cases:
        kw = dict(c["kw"])
        if c["call"] == "oneshot":
            fn = getattr(D, f"{c['kind']}3_count_sharded")(
                mesh, "row", "col", **kw)
            res = jax.jit(fn)(*map(place, c["tables"]))
            results[c["name"]] = _result(res.count, res.overflowed, None,
                                         c["kind"])
        elif c["call"] == "engine":
            fn = D.engine_count_sharded(mesh, "row", "col", c["kind"], **kw)
            res = fn(*map(place, c["tables"]))
            results[c["name"]] = _result(res.count, res.overflowed,
                                         res.rounds, c["kind"])
        else:
            preds = [tuple(p) for p in kw.pop("preds")]
            q = Query({k: place(v) for k, v in c["tables"].items()}, preds)
            res = JoinSession().execute_sharded(q, mesh, "row", "col", **kw)
            results[c["name"]] = _result(res.count, res.overflowed,
                                         res.rounds, res.kind)
    out = pathlib.Path(args.out)
    np.savez(out / "prims_ref.npz",
             **reference_primitives(jax, D, mesh, place(PRIM_TABLE)))
    t0 = time.perf_counter()
    lm_reference(out)
    print(f"lm_reference {time.perf_counter() - t0:.1f}s", flush=True)
    (out / "reference.json").write_text(json.dumps(results))


def reference_primitives(jax, D, mesh, r):
    """The same primitives in one ``shard_map``; each output is per device,
    so the global arrays stack the devices in (row, col) order."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.partition import suggest_capacity
    spec = P(("row", "col"))
    cap1, cap2 = prim_caps(suggest_capacity, r.capacity // (ROWS * COLS),
                           ROWS, COLS)

    def local(cols, valid):
        c1, v1, ovf1 = D._shuffle(cols, valid, "a", "row", ROWS, cap1, "H")
        c2, v2, ovf2 = D._shuffle(c1, v1, "b", "col", COLS, cap2, "G")
        rr, rrv = D._replicate(c1, v1, "row")
        rc, rcv = D._replicate(cols, valid, "col")
        a4 = cols["a"][:4]
        bits = jnp.left_shift(jnp.ones_like(a4), a4 % 31)
        out = {"ovf1": ovf1.reshape(1), "ovf2": ovf2.reshape(1),
               "or_all": D._or_all(bits, ("row", "col")),
               "any": D._psum_bool(cols["b"][:1] == 3, ("row", "col"))}
        for tag, cs, v in (("r1", c1, v1), ("r2", c2, v2),
                           ("rep_row", rr, rrv), ("rep_col", rc, rcv)):
            out.update({f"{tag}_{k}": x for k, x in cs.items()})
            out[f"{tag}_valid"] = v
        return out

    fn = compat.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                          out_specs=spec)
    res = jax.jit(fn)(dict(r.columns), r.valid)
    return {k: np.asarray(v).reshape(ROWS * COLS, -1) for k, v in res.items()}


# --------------------------------------------------------------------------
# launching: every mesh shape's ranks and the reference at once, once a
# test session (the test files that read them share one launch)
# --------------------------------------------------------------------------

SHAPES = {"4x2": (4, 2), "2x2": (2, 2), "1x1": (1, 1)}
WALL_S = 420             # every launch of a session, together
RANK_TIMEOUT_S = 120     # a collective's limit in the launched ranks


def child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def start(argv, log: pathlib.Path):
    import subprocess
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, str(pathlib.Path(__file__)),
                                 *argv], stdout=f, stderr=subprocess.STDOUT,
                                env=child_env())


def port_argv(out, rows, cols, suite, rank, timeout):
    return ["port", "--suite", suite, "--rank", str(rank), "--rows",
            str(rows), "--cols", str(cols), "--store", str(out / "store"),
            "--out", str(out), "--timeout", str(timeout)]


def wait(procs: dict, wall: float) -> dict:
    """Exit codes by name; a process still running at the wall-clock limit
    is killed and reported as None."""
    import subprocess
    deadline = time.monotonic() + wall
    codes = {}
    try:
        for name, p in procs.items():
            try:
                codes[name] = p.wait(timeout=max(0.1, deadline
                                                 - time.monotonic()))
            except subprocess.TimeoutExpired:
                codes[name] = None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes


def tail(path: pathlib.Path, n=30) -> str:
    return "\n".join(path.read_text(errors="replace").splitlines()[-n:])


def launch_all(root: pathlib.Path) -> dict:
    """The reference and the port's three mesh shapes, all at once, their
    outputs under ``root``; returns the failed launches' exit codes and
    log tails."""
    procs, logs = {}, {}
    (root / "ref").mkdir()
    logs["ref"] = root / "ref" / "log"
    procs["ref"] = start(["reference", "--out", str(root / "ref")],
                         logs["ref"])
    for shape, (rows, cols) in SHAPES.items():
        out = root / shape
        out.mkdir()
        suite = "parity" if shape == "4x2" else "oracle"
        for k in range(rows * cols):
            name = f"{shape}/{k}"
            logs[name] = out / f"log{k}"
            procs[name] = start(port_argv(out, rows, cols, suite, k,
                                          RANK_TIMEOUT_S), logs[name])
    codes = wait(procs, WALL_S)
    bad = {n: c for n, c in codes.items() if c != 0}
    return {"bad": bad, "tails": {n: tail(logs[n]) for n in bad}}


def shared_launch(basetemp: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """``launch_all`` once a test session: the first caller launches, a
    caller on another xdist worker of the same run waits for its status
    (the directory is keyed by the run's id, beside the workers' own
    temporary directories).  Returns (the outputs' root, the status)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = basetemp.parent / f"mesh-{uid}" if uid else basetemp / "mesh"
    root.mkdir(parents=True, exist_ok=True)
    status = root / "status.json"
    try:
        (root / "lock").mkdir()
    except FileExistsError:
        deadline = time.monotonic() + WALL_S + 300
        while not status.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no launch status in {root}")
            time.sleep(1.0)
        return root, json.loads(status.read_text())
    try:
        got = launch_all(root)
    except BaseException as exc:
        got = {"bad": {"launch": repr(exc)}, "tails": {}}
        raise
    finally:
        tmp = root / "status.tmp"
        tmp.write_text(json.dumps(got))
        tmp.rename(status)
    return root, got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", choices=("reference", "port"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--suite", default="parity",
                    choices=("parity", "oracle"))
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    ap.add_argument("--store", default="")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--stall", action="store_true")
    args = ap.parse_args(argv)
    (run_reference if args.side == "reference" else run_port)(args)


if __name__ == "__main__":
    main()
