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
"""

from __future__ import annotations

import argparse
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
