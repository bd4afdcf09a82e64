#!/usr/bin/env python3
"""Time the join kernels of one checkout on the card.

    python3 tools/join_timing.py [--tree DIR] [--tag NAME] [--seed N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and the
smoke's data and layout helpers from this checkout's ``chip_smoke.py``.
Builds the smoke's data (``chip_smoke.make_data``: Q1's 4e6 edges over
14,000 users, Q2's star of a 2e7-row fact table, Q5's four 1e6-row
relations over 1e6 keys, Q6's 1e6 edges over 3,500 users), runs Q1
(linear, ``strategy="3way"``), Q2 (star, ``"3way"``), Q3 (triangles), Q4
(skewed linear), Q5 (the 4-relation chain, ``strategy="3way"``: a binary
join feeding a linear 3-way step whose R and T rows hold ~10,000
distinct keys each) and Q6 (per-R, ``per_r=True``) through
``JoinSession(m_budget=16384).execute`` once to plan them, then times
the op as the main path calls it (``ops.fused_*`` on raw columns plus
validity) at these layouts: the linear op at Q1's round 1
(``chip_smoke.first_round_layout``) and at Q5's linear step (its
arguments as the execute passed them); the per-R op at Q6's and Q1's
round 1; the star op at Q2's round 1; the pair-index op at Q3's round 1
and at "Q3 shape, 600 a": Q3's round-1 shape filled with uniform seeded
keys (``chip_smoke.hard_layout``) so that each T row holds ~600
distinct a (the pair-index kernel's multimap tier, past its bit rows'
256).  Per layout: ``op_ms`` (median of 5 CUDA-event timings after a
warm-up call), ``kernel_ms`` (the device time of the kernels one call
launches, ``chip_smoke.kernel_ms``; null when the trace is incomplete),
each kernel's ms by name, ``host_ms`` (the host's milliseconds a call,
the mean of 20 calls issued back to back with no synchronisation between
them: what an op costs the host beside its kernels) and the sum of the
counts (equal across trees).
Then the warm execute seconds of Q1-Q6 (median of 5 after the planning
call).  Then the baselines B1 (``linear3_count_auto`` on Q1's graph), B2
(``star3_count_auto`` on Q2's data) and B3 (``linear3_per_r_counts_auto``
on Q6's graph): their counts, final plans and warm seconds (median of 3
after a cold run), and the bucket-row ops at their layouts as the scan
scans call them: ``bucket_count3_linear`` at B1's first H partition and
at B2's first S chunk, ``bucket_per_r_counts`` at B3's first H
partition, each with its ``op_ms``, ``kernel_ms`` and kernel ms by name,
and the names of any sort or elementwise kernel one call launched
(``sorts_and_masks``).  Then the all-pairs triangle baselines on B4's
graph (``chip_smoke``'s 1e5 edges over 350 users) and on Q3's (B4q3):
the warm seconds (median of 3 after a cold run) of the scan
(``cyclic3_count_auto(pair_index=False)``) and of the fused all-pairs
sweep (``engine.cyclic3_count_fused(pair_index=False)``) at the scan's
final plan; where a warm scan's time goes (``scan_breakdown``: its wall
seconds, the host seconds inside the layouts and inside the bucket-row
op's calls, the device ms of its kernels by name); and, at that plan,
``bucket_count3_cyclic`` at the first (H, G) cell as the scan passes it
and ``fused_count3_cyclic(pair_index=False)`` over the whole sweep, timed
as above.  Then B6 (``bucketed_join_count`` on Q1's graph at 4,096
buckets, the capacity doubled until nothing overflows, as the smoke runs
it): its count against the numpy oracle and its warm seconds, then
``bucket_pair_count`` at B6's layout and ``radix_histogram`` at R (Q1's
``F.src`` keys, ~10% dead, at 4,096 and 65,536 buckets), timed as above.
Prints the card's name and power limit first.

To compare two trees on one card, run them in turns in one call, e.g. a
parent exported with ``git archive`` into a git-ignored directory:
``for t in build/parent . . build/parent; do python3 tools/join_timing.py
--tree $t --tag $t; done``.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
WARM = 5


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    smoke = load_smoke()   # puts this checkout's src/ on sys.path ...
    sys.path.insert(0, str(tree / "src"))   # ... behind the tree's
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("join_timing: needs a CUDA device")
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda, ops
    import repro_torch
    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != \
            tree / "src":
        raise SystemExit(f"join_timing: imported {repro_torch.__file__}, "
                         f"not the tree's")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    tag = args.tag or tree.name
    build_s = cuda.build()
    print(json.dumps({"tag": tag, "card": card, "build_s": build_s}),
          flush=True)

    data = smoke.make_data(args.seed)
    F, F4 = relation_from_numpy(data["F"]), relation_from_numpy(data["F4"])
    F6 = relation_from_numpy(data["F6"])
    lin = [("f1.dst", "f2.src"), ("f2.dst", "f3.src")]
    queries = {"Q1": Query({"f1": F, "f2": F, "f3": F}, lin),
               "Q2": Query({k: relation_from_numpy(v)
                            for k, v in data["star"].items()},
                           [("r.b", "s.b"), ("s.c", "t.c")]),
               "Q3": Query({"f1": F, "f2": F, "f3": F},
                           lin + [("f3.dst", "f1.src")]),
               "Q4": Query({"f1": F4, "f2": F4, "f3": F4}, lin),
               "Q5": Query({k: relation_from_numpy(v)
                            for k, v in data["chain"].items()},
                           [("r1.b", "r2.b"), ("r2.c", "r3.c"),
                            ("r3.d", "r4.d")]),
               "Q6": Query({"f1": F6, "f2": F6, "f3": F6}, lin)}
    strategy = {"Q1": "3way", "Q2": "3way", "Q3": "default", "Q4": "3way",
                "Q5": "3way", "Q6": "default"}
    extra = {"Q6": dict(per_r=True, key_col="src")}
    sess = JoinSession(m_budget=smoke.M_BUDGET)
    results, execute = {}, {}
    for label, q in queries.items():
        kw = {} if strategy[label] == "default" else {
            "strategy": strategy[label]}
        kw.update(extra.get(label, {}))
        res, _ = smoke.timed_execute(torch, sess, q, **kw)
        results[label, strategy[label]] = res
        warm = [smoke.timed_execute(torch, sess, q, **kw)[1]
                for _ in range(WARM)]
        execute[label] = {"count": int(res.count), "rounds": res.rounds,
                          "warm_median_s": statistics.median(warm),
                          "warm_s": warm}

    def cold_warm(fn, reps=3):
        """fn's result, its cold seconds and ``reps`` warm seconds."""
        secs = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, secs[0], secs[1:]

    def raw(label, names):
        """The raw columns named by ``names`` and the three validity masks
        of ``label``'s round-1 layout, in the op's argument order."""
        _, (rg, sg, tg), cols = smoke.first_round_layout(
            results, queries, label, strategy[label])
        side = {"r": rg, "s": sg, "t": tg}
        out = []
        for i, n in enumerate(names):
            out.append(side[n[0]].columns[cols[n]])
            if i + 1 == len(names) or names[i + 1][0] != n[0]:
                out.append(side[n[0]].valid)   # after the side's last column
        return tuple(out)

    def layouts():
        """(label, op name, op args) of each timed layout."""
        lin_cols = ("rb", "sb", "sc", "tc")
        yield "Q1 round 1", "fused_count3_linear", raw("Q1", lin_cols)
        yield "Q1 round 1", "fused_per_r_counts", raw("Q1", lin_cols)
        yield "Q6 round 1", "fused_per_r_counts", raw("Q6", lin_cols)
        yield "Q2 round 1", "fused_count3_star", raw("Q2", lin_cols)
        a = raw("Q3", ("ra", "rb", "sb", "sc", "tc", "ta"))
        shape3 = (a[2].shape, a[5].shape, a[8].shape)
        yield "Q3 round 1", "fused_count3_cyclic_pairidx", a
        del a
        # Q5's linear step: the arguments of its call in one execute
        calls, op = [], ops.fused_count3_linear

        def capture(*a):
            calls.append(a)
            return op(*a)
        ops.fused_count3_linear = capture
        try:
            sess.execute(queries["Q5"], strategy=strategy["Q5"])
        finally:
            ops.fused_count3_linear = op
        if len(calls) != 1:
            raise SystemExit(f"join_timing: Q5 made {len(calls)} linear "
                             f"calls, expected 1")
        yield "Q5 linear step", "fused_count3_linear", calls.pop()
        gen = torch.Generator().manual_seed(args.seed + 5)
        k, v = smoke.hard_layout(torch, gen, "a600", {
            "r": (shape3[0], ("rb", "ra")), "s": (shape3[1], ("sb", "sc")),
            "t": (shape3[2], ("tc", "ta"))},
            dict(rb=100, ra=600, sb=100, sc=800, tc=800, ta=600))
        k = {c: x.cuda() for c, x in k.items()}
        v = {c: x.cuda() for c, x in v.items()}
        yield "Q3 shape, 600 a", "fused_count3_cyclic_pairidx", (
            k["ra"], k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"],
            k["ta"], v["t"])

    def baselines():
        """B1-B3 timed warm, then (label, op name, op args) of the bucket
        ops at their first step's layout of the final plans."""
        from repro_torch.core import linear3, reference, star3
        F6_ = queries["Q6"].relations["f1"]
        st = queries["Q2"].relations
        n1, n6 = len(data["F"]["src"]), len(data["F6"]["src"])
        plan1 = linear3.default_plan(n1, n1, n1, m_budget=smoke.M_BUDGET)
        plan6 = linear3.default_plan(n6, n6, n6, m_budget=smoke.M_BUDGET)
        plan2 = star3.default_plan(*(len(data["star"][k][c]) for k, c in
                                     (("r", "b"), ("s", "b"), ("t", "c"))))

        def b1():
            res, plan = reference.linear3_count_auto(F, F, F, plan1,
                                                     **smoke.LIN)
            return int(res.count), bool(res.overflowed), plan

        def b2():
            res, plan = reference.star3_count_auto(st["r"], st["s"], st["t"],
                                                   plan2, **smoke.STAR)
            return int(res.count), bool(res.overflowed), plan

        def b3():
            (_, counts, valid), plan = reference.linear3_per_r_counts_auto(
                F6_, F6_, F6_, plan6, key_col="src", **smoke.LIN)
            return int(counts[valid].sum()), False, plan

        final, rows = {}, {}
        for label, fn in (("B1", b1), ("B2", b2), ("B3", b3)):
            (count, overflowed, plan), cold, warm = cold_warm(fn)
            final[label] = plan
            rows[label] = {"count": count, "overflowed": overflowed,
                           "plan": list(plan), "cold_s": cold,
                           "warm_median_s": statistics.median(warm),
                           "warm_s": warm}
        print(json.dumps({"tag": tag, "baselines": rows}), flush=True)
        for label, rel in (("B1", F), ("B3", F6_)):
            rg, sg, tg = linear3.layouts(rel, rel, rel, final[label],
                                         **smoke.LIN)
            name = ("bucket_count3_linear" if label == "B1"
                    else "bucket_per_r_counts")
            yield f"{label} first step", name, linear3._partition_rows(
                rg, sg, tg, 0, **smoke.LIN)
            del rg, sg, tg
        rg, sg, tg = star3.layouts(st["r"], st["s"], st["t"], final["B2"],
                                   **smoke.STAR)
        yield "B2 first chunk", "bucket_count3_linear", (
            rg.columns["b"][:, None], rg.valid[:, None], sg.columns["b"][0],
            sg.columns["c"][0], sg.valid[0], tg.columns["c"][None],
            tg.valid[None])

    def scan_breakdown(scan):
        """Where a warm triangle scan's time goes: per scan (median of
        WARM), its wall seconds, the host seconds spent inside
        ``cyclic3.layouts`` and inside the bucket-row op's calls (neither
        synchronises: the host's own time, or its waits where the code
        itself waits on the card), and the op's calls; then the device ms
        of one scan's kernels, in all and by name (``kernel_ms``), and
        their share of the wall time."""
        from repro_torch.core import cyclic3
        spent = {}
        lay0, op0 = cyclic3.layouts, ops.bucket_count3_cyclic

        def timed(key, fn):
            def wrap(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spent[key + "_s"] += time.perf_counter() - t0
                    spent[key + "_calls"] += 1
            return wrap
        cyclic3.layouts = timed("layouts", lay0)
        ops.bucket_count3_cyclic = timed("op", op0)
        runs = []
        try:
            for _ in range(WARM):
                spent.update(layouts_s=0.0, layouts_calls=0, op_s=0.0,
                             op_calls=0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scan()
                torch.cuda.synchronize()
                runs.append({"wall_s": time.perf_counter() - t0, **spent})
        finally:
            cyclic3.layouts, ops.bucket_count3_cyclic = lay0, op0
        out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        k_ms, by_name, missing = smoke.kernel_ms(torch, scan, reps=3)
        out.update(device_ms=k_ms, device_share=(
            k_ms / (1e3 * out["wall_s"]) if k_ms is not None else None),
            device_ms_by_name=dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:8]),
            **({"device_ms_missing": missing} if missing else {}))
        return out

    def cyclic_baselines():
        """B4 and B4q3's scan and fused all-pairs sweep timed warm, then
        (label, op name, op args) of the all-pairs ops at their layouts."""
        import numpy as np
        from repro_torch.core import cyclic3, engine, reference
        rng = np.random.default_rng(args.seed + 1)
        G = {c: rng.integers(0, smoke.B4_USERS, smoke.B4_EDGES).astype(
            np.int32) for c in ("src", "dst")}
        rows, cells, breakdown = {}, [], {}
        for label, rel, n in (("B4", relation_from_numpy(G), smoke.B4_EDGES),
                              ("B4q3", F, len(data["F"]["src"]))):
            plan0 = cyclic3.default_plan(n, n, n, m_budget=smoke.M_BUDGET)
            final = {}

            def scan(rel=rel, plan0=plan0, final=final):
                res, final["plan"] = reference.cyclic3_count_auto(
                    rel, rel, rel, plan0, pair_index=False, **smoke.CYC)
                return int(res.count), bool(res.overflowed)

            def fused(rel=rel, final=final):
                res = engine.cyclic3_count_fused(
                    rel, rel, rel, final["plan"], pair_index=False,
                    **smoke.CYC)
                return int(res.count), bool(res.overflowed)
            for form, fn in (("scan", scan), ("fused all-pairs", fused)):
                (count, overflowed), cold, warm = cold_warm(fn)
                rows[f"{label} {form}"] = {
                    "count": count, "overflowed": overflowed,
                    "plan": list(final["plan"]), "cold_s": cold,
                    "warm_median_s": statistics.median(warm), "warm_s": warm}
            cells.append((label, rel, final["plan"]))
            breakdown[label] = scan_breakdown(scan)
        print(json.dumps({"tag": tag, "baselines": rows}), flush=True)
        print(json.dumps({"tag": tag, "scan_breakdown": breakdown}),
              flush=True)
        for label, rel, plan in cells:
            rg, sg, tg = cyclic3.layouts(rel, rel, rel, plan, **smoke.CYC)
            raw = [rg.columns[smoke.CYC["ra"]], rg.columns[smoke.CYC["rb"]],
                   rg.valid, sg.columns[smoke.CYC["sb"]],
                   sg.columns[smoke.CYC["sc"]], sg.valid,
                   tg.columns[smoke.CYC["tc"]], tg.columns[smoke.CYC["ta"]],
                   tg.valid]
            yield f"{label} first cell", "bucket_count3_cyclic", tuple(
                [x[0, 0] for x in raw[:3]] + [x[0][:, None] for x in raw[3:6]]
                + [x[0][..., None, :] for x in raw[6:]])
            yield f"{label} sweep", "fused_count3_cyclic", tuple(raw)
            del rg, sg, tg, raw

    def binary_and_radix():
        """B6 timed warm against its numpy oracle, then (label, op name, op
        args) of the pair count at B6's layout and of the radix histogram
        at R's two bucket counts."""
        import numpy as np
        from repro_torch.core import binary_join, partition
        n_buckets = 4096
        cap = partition.suggest_capacity(len(data["F"]["src"]), n_buckets,
                                         2.5)
        while bool(binary_join.bucketed_join_count(
                F, "dst", F, "src", n_buckets, cap, cap)[1]):
            cap *= 2
        d1 = data["d"]["F"]
        oracle = int(np.sum(
            np.bincount(data["F"]["dst"], minlength=d1).astype(np.int64)
            * np.bincount(data["F"]["src"], minlength=d1)))

        def b6():
            count, ovf = binary_join.bucketed_join_count(
                F, "dst", F, "src", n_buckets, cap, cap)
            return int(count), bool(ovf)
        (count, overflowed), cold, warm = cold_warm(b6, reps=WARM)
        if count != oracle or overflowed:
            raise SystemExit(f"join_timing: B6 counted {count} "
                             f"(overflowed {overflowed}), oracle {oracle}")
        print(json.dumps({"tag": tag, "baselines": {"B6": {
            "count": count, "n_buckets": n_buckets, "cap": cap,
            "cold_s": cold, "warm_median_s": statistics.median(warm),
            "warm_s": warm}}}), flush=True)
        b = partition.bucketize(F, "dst", n_buckets, cap, fn="h")
        p = partition.bucketize(F, "src", n_buckets, cap, fn="h")
        yield "B6", "bucket_pair_count", (b.columns["dst"], b.valid,
                                          p.columns["src"], p.valid)
        del b, p
        src = data["F"]["src"]
        keys = torch.as_tensor(src).cuda()
        valid = torch.as_tensor(np.random.default_rng(args.seed + 2).random(
            len(src)) >= smoke.RADIX_DEAD).cuda()
        for nb in smoke.RADIX_BUCKETS:
            yield f"R, {nb} buckets", f"radix_histogram {nb}", (keys, valid)

    op_of = {"fused_count3_linear": ops.fused_count3_linear,
             "fused_per_r_counts": ops.fused_per_r_counts,
             "fused_count3_star": ops.fused_count3_star,
             "fused_count3_cyclic_pairidx": ops.fused_count3_cyclic,
             "bucket_count3_linear": ops.bucket_count3_linear,
             "bucket_per_r_counts": ops.bucket_per_r_counts,
             "bucket_count3_cyclic": ops.bucket_count3_cyclic,
             "fused_count3_cyclic": lambda *a: ops.fused_count3_cyclic(
                 *a, pair_index=False),
             "bucket_pair_count": ops.bucket_pair_count,
             **{f"radix_histogram {nb}": lambda k, v, nb=nb:
                ops.radix_histogram(k, v, n_buckets=nb)
                for nb in smoke.RADIX_BUCKETS}}
    for label, name, a in itertools.chain(layouts(), baselines(),
                                          cyclic_baselines(),
                                          binary_and_radix()):
        fn = op_of[name]

        def run(a=a, fn=fn):
            return fn(*a)
        valid = [x for x in a if x.dtype == torch.bool]
        shape = [list(x.shape) for x in valid]
        total = int(run().to(torch.int64).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_ms, by_name, missing = smoke.kernel_ms(torch, run)
        print(json.dumps({"tag": tag, "layout": label, "op": name,
                          "shape": shape, "sum": total,
                          "op_ms": smoke.time_ms(torch, run),
                          "host_ms": host_ms,
                          "kernel_ms": k_ms, "kernel_ms_by_name": by_name,
                          "sorts_and_masks": smoke.sorts_and_masks(by_name),
                          **({"kernel_ms_missing": missing} if missing
                             else {}),
                          "profile_s": time.perf_counter() - t0}),
              flush=True)
        del a, run, valid
        torch.cuda.empty_cache()
    print(json.dumps({"tag": tag, "execute": execute}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
