#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases (each failure raises; the script then exits non-zero and prints no
result line):

  1. device  — requires CUDA and a compute capability 9.0 card; prints the
     card's name and power limit from nvidia-smi;
  2. build   — compiles the nine Hopper kernels from ``src/repro_torch/
     kernels/csrc`` (one nvcc per source, all in parallel) and prints the
     seconds;
  3. kernels — each kernel against its plain PyTorch version on the card,
     exactly, on seeded layouts with unaligned capacities, invalid slots,
     hot keys, shared (broadcast) bucket rows and 1 x 1 edge cases;
  4. main path — six queries through ``JoinSession(m_budget=16384)
     .execute``, each checked against an oracle independent of the port
     (numpy histograms, a float64 trace(A^3) on the card, a numpy
     weight-backflow), with ``overflowed == False``.  The launch counters
     are zeroed just before and read just after: each of the four fused
     kernels must have launched;
  5. baselines — the paper's baselines on the same data, each against its
     oracle with ``overflowed == False``, cold and warm (median of 3):
     B1 the linear scan driver with whole-query retry on Q1's graph, B2 the
     star scan on Q2's, B3 the per-R scan on Q6's, B4 the all-pairs cyclic
     forms (scan with retry, fused, and the pair-index scan) on a graph of
     1e5 edges over 350 users (Q3's N/d) and on Q3's graph, B5 the cascade
     of binary joins on Q6 and Q2, B6 the bucketed binary join on Q1.  The
     counters are zeroed before the phase: each of the five baseline
     kernels must have launched in it;
  6. timings — each kernel at its layout (the main path's first round;
     the baselines' first step), against its plain version (exact) and its
     bound.  Prints one ``kernels`` JSON line with all nine kernels;
  7. the last line: ``{"ok": true, "device": {...}}``.

Sizes are cut from the paper's (Fig 4: N = 2e8 friends edges, a 1e9-row
fact table) to N = 4e6 edges over 14,000 users (the paper's N/d of about
286) and a 2e7-row fact table: the layout grows as N^2 / m_budget^2.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

M_BUDGET = 16384
WARM = 5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# 32-bit scalar operations: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
# boost clock = 33.5e12 lane-instructions/s, the most a compare-and-add
# loop can issue (the 67 TFLOP/s float32 rate counts an FMA as two).
INT32_OPS_PER_S = 132 * 128 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an H100")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    if cap != (9, 0):
        fail(f"{name} has compute capability {cap}; the kernels are sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} capability {cap} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")
    return name, card


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _grid(torch, gen, shape, d, hot):
    keys = torch.randint(0, d, shape, generator=gen, dtype=torch.int32)
    if hot:
        keys[torch.rand(shape, generator=gen) < 0.3] = 3
    valid = torch.rand(shape, generator=gen) < 0.8
    return keys.cuda(), valid.cuda()


def _masked(ops, pairs):
    return [ops._mask(k, v, side) for k, v, side in pairs]


def kernel_cases(torch, ops, seed):
    """Seeded random layouts: (name, kernel call, plain call) triples."""
    gen = torch.Generator().manual_seed(seed)
    cases = []
    for shape, d, hot in [((3, 5, 7, 37, 19, 9001), 13, True),
                          ((2, 3, 4, 2100, 300, 130), 7, False),
                          ((2, 9, 3, 50, 301, 77), 5, True),
                          ((1, 1, 1, 3, 1, 1), 2, False)]:
        hp, gp, u, cr, cs, ct = shape
        rb, rv = _grid(torch, gen, (hp, u, cr), d, hot)
        sb, sv = _grid(torch, gen, (hp, gp, u, cs), d, hot)
        sc, _ = _grid(torch, gen, (hp, gp, u, cs), d, hot)
        tc, tv = _grid(torch, gen, (gp, ct), d, hot)
        args = (rb, rv, sb, sc, sv, tc, tv)
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("fused_count3_linear",
                      lambda a=args: ops.fused_count3_linear(*a),
                      lambda m=m: ops._fused_linear_ref(*m)))
        cases.append(("fused_per_r_counts",
                      lambda a=args: ops.fused_per_r_counts(*a),
                      lambda m=m: ops._fused_per_r_ref(*m)))
    for shape, d, hot in [((3, 5, 2, 4999, 3001, 8193), 11, True),
                          ((1, 1, 1, 5, 3, 2), 2, False)]:
        uh, ug, ch, cr, cs, ct = shape
        rb, rv = _grid(torch, gen, (uh, cr), d, hot)
        sb, sv = _grid(torch, gen, (ch, uh, ug, cs), d, hot)
        sc, _ = _grid(torch, gen, (ch, uh, ug, cs), d, hot)
        tc, tv = _grid(torch, gen, (ug, ct), d, hot)
        args = (rb, rv, sb, sc, sv, tc, tv)
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("fused_count3_star",
                      lambda a=args: ops.fused_count3_star(*a),
                      lambda m=m: ops._fused_star_ref(*m)))
    for shape, d, hot in [((2, 3, 2, 3, 2, 1500, 1100, 700), 9, True),
                          ((1, 1, 1, 1, 1, 5, 3, 2), 2, False)]:
        hp, gp, uh, ug, fp, cr, cs, ct = shape
        ra, rv = _grid(torch, gen, (hp, gp, uh, ug, cr), d, hot)
        rb, _ = _grid(torch, gen, (hp, gp, uh, ug, cr), d, hot)
        sb, sv = _grid(torch, gen, (gp, fp, ug, cs), d, hot)
        sc, _ = _grid(torch, gen, (gp, fp, ug, cs), d, hot)
        tc, tv = _grid(torch, gen, (hp, fp, uh, ct), d, hot)
        ta, _ = _grid(torch, gen, (hp, fp, uh, ct), d, hot)
        args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
        m = _masked(ops, [(ra, rv, "r"), (rb, rv, "r"), (sb, sv, "s"),
                          (sc, sv, "s"), (tc, tv, "t"), (ta, tv, "t")])
        cases.append(("fused_count3_cyclic_pairidx",
                      lambda a=args: ops.fused_count3_cyclic(*a),
                      lambda m=m: ops._fused_cyclic_pairidx_ref(*m)))
        cases.append(("fused_count3_cyclic",
                      lambda a=args: ops.fused_count3_cyclic(
                          *a, pair_index=False),
                      lambda m=m: ops._fused_cyclic_pairidx_ref(*m)))
    return cases + bucket_cases(torch, ops, gen)


def bucket_cases(torch, ops, gen):
    """The bucket-row kernels of the baselines, on [*batch, C] rows whose
    size-1 batch dimensions share one row (as the scan drivers pass them)
    and on plain [B, C] rows."""
    cases = []
    # (ka batch, kb batch, Ca, Cb, key range, hot)
    for ba, bb, ca, cb, d, hot in [((7,), (7,), 37, 130, 11, True),
                                   ((300,), (300,), 259, 61, 400, False),
                                   ((3, 4), (3, 1), 50, 33, 9, True),
                                   ((1,), (1,), 1, 1, 2, False)]:
        ka, va = _grid(torch, gen, (*ba, ca), d, hot)
        kb, vb = _grid(torch, gen, (*bb, cb), d, hot)
        m = _masked(ops, [(ka, va, "a"), (kb, vb, "b")])
        cases.append(("bucket_pair_count",
                      lambda a=(ka, va, kb, vb): ops.bucket_pair_count(*a),
                      lambda m=m: ops._bucket_pair_ref(*m)))
    # (R batch, S batch, T batch, Cr, Cs, Ct, key range, hot): the linear
    # driver's (g, h) grid, the star driver's (h, g) grid, plain rows, 1 x 1
    for br, bs, bt, cr, cs, ct, d, hot in [
            ((1, 7), (5, 7), (5, 1), 37, 19, 9001, 13, True),
            ((1, 4), (3, 4), (3, 1), 2100, 300, 130, 7, False),
            ((3, 1), (3, 5), (1, 5), 4999, 3001, 8193, 11, True),
            ((50,), (50,), (50,), 301, 77, 5, 5, True),
            ((1,), (1,), (1,), 3, 1, 1, 2, False)]:
        rb, rv = _grid(torch, gen, (*br, cr), d, hot)
        sb, sv = _grid(torch, gen, (*bs, cs), d, hot)
        sc, _ = _grid(torch, gen, (*bs, cs), d, hot)
        tc, tv = _grid(torch, gen, (*bt, ct), d, hot)
        args = (rb, rv, sb, sc, sv, tc, tv)
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("bucket_count3_linear",
                      lambda a=args: ops.bucket_count3_linear(*a),
                      lambda m=m: ops._bucket_linear_ref(*m)))
        cases.append(("bucket_per_r_counts",
                      lambda a=args: ops.bucket_per_r_counts(*a),
                      lambda m=m: ops._bucket_per_r_ref(*m)))
    # the cyclic driver's (f, a, b) grid: R [uh, ug], S shared along a,
    # T shared along b; plain rows; 1 x 1
    for br, bs, bt, cr, cs, ct, d, hot in [
            ((3, 2), (2, 1, 2), (2, 3, 1), 150, 1100, 700, 9, True),
            ((20,), (20,), (20,), 33, 41, 57, 6, False),
            ((1,), (1,), (1,), 5, 3, 2, 2, False)]:
        ra, rv = _grid(torch, gen, (*br, cr), d, hot)
        rb, _ = _grid(torch, gen, (*br, cr), d, hot)
        sb, sv = _grid(torch, gen, (*bs, cs), d, hot)
        sc, _ = _grid(torch, gen, (*bs, cs), d, hot)
        tc, tv = _grid(torch, gen, (*bt, ct), d, hot)
        ta, _ = _grid(torch, gen, (*bt, ct), d, hot)
        args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
        m = _masked(ops, [(ra, rv, "r"), (rb, rv, "r"), (sb, sv, "s"),
                          (sc, sv, "s"), (tc, tv, "t"), (ta, tv, "t")])
        cases.append(("bucket_count3_cyclic",
                      lambda a=args: ops.bucket_count3_cyclic(*a),
                      lambda m=m: ops._bucket_cyclic_ref(*m)))
    return cases


def compare(torch, name, got, want, errs):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
             f"version {tuple(want.shape)} {want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    if err != 0:
        fail(f"{name}: kernel differs from its plain version "
             f"(max |diff| = {err})")


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def make_data(seed):
    rng = np.random.default_rng(seed)
    d1, n1 = 14_000, 4_000_000
    F = {"src": rng.integers(0, d1, n1).astype(np.int32),
         "dst": rng.integers(0, d1, n1).astype(np.int32)}
    hot = 7
    extra = 1500
    F4 = {"src": np.concatenate([F["src"], np.full(extra, hot, np.int32),
                                 rng.integers(0, d1, extra).astype(np.int32)]),
          "dst": np.concatenate([F["dst"],
                                 rng.integers(0, d1, extra).astype(np.int32),
                                 np.full(extra, hot, np.int32)])}
    d2 = 100_000
    star = {"r": {"a": rng.integers(0, d2, 100_000).astype(np.int32),
                  "b": rng.integers(0, d2, 100_000).astype(np.int32)},
            "s": {"b": rng.integers(0, d2, 20_000_000).astype(np.int32),
                  "c": rng.integers(0, d2, 20_000_000).astype(np.int32)},
            "t": {"c": rng.integers(0, d2, 100_000).astype(np.int32),
                  "d": rng.integers(0, d2, 100_000).astype(np.int32)}}
    d5, n5 = 1_000_000, 1_000_000
    chain = {f"r{i + 1}": {k1: rng.integers(0, d5, n5).astype(np.int32),
                           k2: rng.integers(0, d5, n5).astype(np.int32)}
             for i, (k1, k2) in enumerate(["ab", "bc", "cd", "de"])}
    d6, n6 = 3_500, 1_000_000
    F6 = {"src": rng.integers(0, d6, n6).astype(np.int32),
          "dst": rng.integers(0, d6, n6).astype(np.int32)}
    return {"F": F, "F4": F4, "star": star, "chain": chain, "F6": F6,
            "d": {"F": d1, "star": d2, "chain": d5, "F6": d6}}


def linear_oracle(F, d):
    """Σ over f2's rows of indeg(src) · outdeg(dst) for f1.dst = f2.src,
    f2.dst = f3.src over one edge list F (int64, numpy)."""
    indeg = np.bincount(F["dst"], minlength=d).astype(np.int64)
    outdeg = np.bincount(F["src"], minlength=d).astype(np.int64)
    return int(np.sum(indeg[F["src"]] * outdeg[F["dst"]]))


def star_oracle(star, d):
    cnt_r = np.bincount(star["r"]["b"], minlength=d).astype(np.int64)
    cnt_t = np.bincount(star["t"]["c"], minlength=d).astype(np.int64)
    return int(np.sum(cnt_r[star["s"]["b"]] * cnt_t[star["s"]["c"]]))


def triangle_oracle(torch, F, d):
    """trace(A^3) with A the d x d edge-count matrix, in float64 on the
    card: every value is an integer far below 2^53, so it is exact."""
    A = torch.zeros((d, d), dtype=torch.float64, device="cuda")
    src = torch.as_tensor(F["src"], device="cuda").long()
    dst = torch.as_tensor(F["dst"], device="cuda").long()
    A.index_put_((src, dst), torch.ones_like(src, dtype=torch.float64),
                 accumulate=True)
    total = float(((A @ A) * A.T).sum())
    del A
    if total >= 2**53:
        fail("triangle oracle left the exact float64 range")
    return int(round(total))


def chain_oracle(chain, d):
    """Weight backflow r4 -> r1 over r1.b=r2.b, r2.c=r3.c, r3.d=r4.d."""
    w4 = np.bincount(chain["r4"]["d"], minlength=d).astype(np.int64)
    w3 = w4[chain["r3"]["d"]]
    w3c = np.zeros(d, np.int64)
    np.add.at(w3c, chain["r3"]["c"], w3)
    w2 = w3c[chain["r2"]["c"]]
    w2b = np.zeros(d, np.int64)
    np.add.at(w2b, chain["r2"]["b"], w2)
    return int(np.sum(w2b[chain["r1"]["b"]]))


def per_key_oracle(F, d):
    """Per f1.src key: Σ over its f1 rows of the linear counts."""
    outdeg = np.bincount(F["src"], minlength=d).astype(np.int64)
    w2 = np.zeros(d, np.int64)
    np.add.at(w2, F["src"], outdeg[F["dst"]])
    per_row = w2[F["dst"]]
    out = np.zeros(d, np.int64)
    np.add.at(out, F["src"], per_row)
    return out


def timed_execute(torch, sess, query, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.execute(query, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_query(torch, sess, label, query, want, checks=(), **kw):
    res, cold = timed_execute(torch, sess, query, **kw)
    warm = []
    for _ in range(WARM):
        r2, t = timed_execute(torch, sess, query, **kw)
        warm.append(t)
        if int(r2.count) != int(res.count) or r2.rounds != res.rounds:
            fail(f"{label}: warm execute disagrees with the cold one")
    if bool(res.overflowed):
        fail(f"{label}: overflowed")
    if int(res.count) != want:
        fail(f"{label}: count {int(res.count)} != oracle {want}")
    for check in checks:
        check(res)
    row = {"query": label, "kind": res.kind, "strategy": res.strategy,
           "count": int(res.count), "oracle": want, "rounds": res.rounds,
           "tuples_read": int(res.tuples_read), "cold_s": cold,
           "warm_median_s": statistics.median(warm), "warm_s": warm}
    log(f"[main] {json.dumps(row)}")
    return res, row


def main_path(torch, data):
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda

    def rels(d):
        return relation_from_numpy(d)

    F = rels(data["F"])
    lin = Query({"f1": F, "f2": F, "f3": F},
                [("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    st = data["star"]
    star = Query({k: rels(v) for k, v in st.items()},
                 [("r.b", "s.b"), ("s.c", "t.c")])
    tri = Query({"f1": F, "f2": F, "f3": F},
                [("f1.dst", "f2.src"), ("f2.dst", "f3.src"),
                 ("f3.dst", "f1.src")])
    F4 = rels(data["F4"])
    skew = Query({"f1": F4, "f2": F4, "f3": F4},
                 [("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    chain = Query({k: rels(v) for k, v in data["chain"].items()},
                  [("r1.b", "r2.b"), ("r2.c", "r3.c"), ("r3.d", "r4.d")])
    F6 = rels(data["F6"])
    per_r = Query({"f1": F6, "f2": F6, "f3": F6},
                  [("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    torch.cuda.synchronize()

    log("[main] oracles ...")
    t0 = time.perf_counter()
    want = {"Q1": linear_oracle(data["F"], data["d"]["F"]),
            "Q2": star_oracle(st, data["d"]["star"]),
            "Q3": triangle_oracle(torch, data["F"], data["d"]["F"]),
            "Q4": linear_oracle(data["F4"], data["d"]["F"]),
            "Q5": chain_oracle(data["chain"], data["d"]["chain"]),
            "Q6": linear_oracle(data["F6"], data["d"]["F6"])}
    key_sums = per_key_oracle(data["F6"], data["d"]["F6"])
    log(f"[main] oracles {json.dumps(want)} in "
        f"{time.perf_counter() - t0:.1f}s")

    def rounds_at_least_2(res):
        if res.rounds < 2:
            fail(f"Q4: expected recovery rounds >= 2, got {res.rounds}")

    def binary_feeds_fused3(res):
        ops_ = [s.op for s in res.plan.steps]
        if not (ops_[-1] == "fused3" and "binary" in ops_[:-1]):
            fail(f"Q5 3way: plan is {ops_}, expected binary -> fused3")

    def per_key_sums(res):
        p = res.per_r
        keys = p.keys[p.valid].long()
        sums = torch.zeros(len(key_sums), dtype=torch.int64, device="cuda")
        sums.index_add_(0, keys, p.counts[p.valid])
        if not np.array_equal(sums.cpu().numpy(), key_sums):
            fail("Q6: per-key sums differ from the numpy oracle")

    sess = JoinSession(m_budget=M_BUDGET)
    cuda.reset_launch_counts()
    rows, results = [], {}
    for label, q, kw, checks in [
            ("Q1", lin, dict(strategy="3way"), ()),
            ("Q2", star, dict(strategy="3way"), ()),
            ("Q3", tri, {}, ()),
            ("Q4", skew, dict(strategy="3way"), (rounds_at_least_2,)),
            ("Q5", chain, dict(strategy="3way"), (binary_feeds_fused3,)),
            ("Q5", chain, dict(strategy=None), ()),
            ("Q6", per_r, dict(per_r=True, key_col="src"),
             (per_key_sums,))]:
        res, row = run_query(torch, sess, label, q, want[label], checks, **kw)
        row["strategy_arg"] = kw.get("strategy", "default")
        rows.append(row)
        results[label, row["strategy_arg"]] = res
        if label == "Q5" and kw["strategy"] is None:
            log(f"[main] Q5 strategy=None: planner chose "
                f"{res.strategy}:\n{res.plan.describe()}")
    launches = dict(cuda.LAUNCHES)
    log(f"[main] kernel launches on the main path: {json.dumps(launches)}")
    for name in cuda.FUSED_KERNELS:
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main path")
    queries = {"Q1": lin, "Q2": star, "Q3": tri, "Q6": per_r}
    return rows, launches, results, queries, want, key_sums


# --------------------------------------------------------------------------
# phase 5: kernels at the main path's first-round layouts
# --------------------------------------------------------------------------

def time_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def first_round_layout(results, queries, label, strategy):
    """The round-1 layouts the engine built for a single-fused-step query,
    rebuilt by the recovery loop's own round pass (same plan, same salt,
    same capacity sizing)."""
    from repro_torch.core import recovery
    step = results[label, strategy].plan.root
    rels = {role: queries[label].relations[name] for role, name in step.roles}
    cols = dict(step.cols)
    ops_ = recovery.OPS[step.kind](**cols)
    plan, _, lay = recovery._round_pass(ops_, rels, step.shape_plan,
                                        salt=0, final=False)
    return plan, (lay["r"], lay["s"], lay["t"]), cols


def n_live(torch, ops, x, side, dims):
    return (x != ops._SENT[side]).to(torch.int64).sum(dims)


def search_steps(torch, n):
    """Binary-search steps over sorted rows of n live entries."""
    return torch.ceil(torch.log2(n.to(torch.float64) + 1)).to(torch.int64)


def record_kernel(torch, lines, errs, launches, name, shape_note, kern,
                  plain, out_bytes, steps, line=True):
    """Hold one kernel against its plain version at a layout, time both,
    and put its entry (with its bound) in the ``kernels`` line."""
    from repro_torch.kernels import cuda
    got = kern()
    want = plain()
    compare(torch, name, got, want, errs)
    ms = time_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=3)
    t_bytes = out_bytes / HBM_BYTES_PER_S
    t_ops = steps / INT32_OPS_PER_S
    src, replaces = cuda.SOURCES[name]
    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "shape": shape_note,
             "search_steps": steps, "bytes": out_bytes}
    log(f"[kernel] {json.dumps(entry)}")
    if line:
        lines.append(entry)


def kernel_phase(torch, ops, errs, launches, results, queries):
    """Each fused kernel at its main-path layout, against its plain version
    and its bound.  The bound is the larger of two times: the bytes of the
    function's inputs (each read once) and output (written once) over the
    HBM rate, and the search steps the sorted-bucket formulation needs on
    this run's data over the 32-bit issue rate: two binary searches
    (ceil(log2(n + 1)) steps each, n the live entries of the row) per live
    probing slot and probed row, plus, for cyclic, two steps per matching
    (s, r) pair."""
    lines = []

    def live(x, side, dims):
        return n_live(torch, ops, x, side, dims)

    def _steps(n):
        return search_steps(torch, n)

    def record(*a, **kw):
        record_kernel(torch, lines, errs, launches, *a, **kw)

    def linear_layout(label, strategy):
        _, (rg, sg, tg), cols = first_round_layout(results, queries, label,
                                                   strategy)
        rb, sb, sc, tc = (rg.columns[cols["rb"]], sg.columns[cols["sb"]],
                          sg.columns[cols["sc"]], tg.columns[cols["tc"]])
        args = (rb, rg.valid, sb, sc, sg.valid, tc, tg.valid)
        m = _masked(ops, [(rb, rg.valid, "r"), (sb, sg.valid, "s"),
                          (sc, sg.valid, "s"), (tc, tg.valid, "t")])
        hp, u, cr = rb.shape
        _, gp, _, cs = sb.shape
        ct = tc.shape[1]
        n_s = live(m[1], "s", -1)                       # [hp, gp, u]
        n_r = live(m[0], "r", -1)                       # [hp, u]
        lg_r = _steps(n_r)
        lg_t = _steps(live(m[3], "t", -1))              # [gp]
        t_steps = int((n_s * 2 * lg_t[None, :, None]).sum())
        r_steps = int((n_s * 2 * lg_r[:, None, :]).sum())
        note = (f"{label} round 1: hp={hp} gp={gp} u={u} Cr={cr} Cs={cs} "
                f"Ct={ct}")
        return args, m, note, t_steps, r_steps, int((n_r * lg_r).sum()), \
            hp * u * 4, hp * u * cr * 4

    # Q1: linear; the per-R kernel is also timed on Q1's layout (printed,
    # not in the kernels line: its main-path layout is Q6's)
    args, m, note, t_steps, r_steps, gather_steps, out_b, per_r_out_b = \
        linear_layout("Q1", "3way")
    record("fused_count3_linear", note,
           lambda: ops.fused_count3_linear(*args),
           lambda: ops._fused_linear_ref(*m),
           nbytes(*m) + out_b, t_steps + r_steps)
    record("fused_per_r_counts", note,
           lambda: ops.fused_per_r_counts(*args),
           lambda: ops._fused_per_r_ref(*m),
           nbytes(*m) + per_r_out_b, t_steps + r_steps // 2 + gather_steps,
           line=False)
    del args, m

    # Q6: the per-R kernel at its own main-path layout: two searches of
    # the T row and one of the R row per live S slot, one of the R row per
    # live R slot to gather
    args, m, note, t_steps, r_steps, gather_steps, _, per_r_out_b = \
        linear_layout("Q6", "default")
    record("fused_per_r_counts", note,
           lambda: ops.fused_per_r_counts(*args),
           lambda: ops._fused_per_r_ref(*m),
           nbytes(*m) + per_r_out_b, t_steps + r_steps // 2 + gather_steps)
    del args, m

    # Q2: star
    _, (rg, sg, tg), cols = first_round_layout(results, queries, "Q2", "3way")
    rb, sb, sc, tc = (rg.columns[cols["rb"]], sg.columns[cols["sb"]],
                      sg.columns[cols["sc"]], tg.columns[cols["tc"]])
    args = (rb, rg.valid, sb, sc, sg.valid, tc, tg.valid)
    m = _masked(ops, [(rb, rg.valid, "r"), (sb, sg.valid, "s"),
                      (sc, sg.valid, "s"), (tc, tg.valid, "t")])
    uh, cr = rb.shape
    ch, _, ug, cs = sb.shape
    ct = tc.shape[1]
    n_s = live(m[1], "s", -1).sum(0)                    # [uh, ug]
    lg_r = _steps(live(m[0], "r", -1))                  # [uh]
    lg_t = _steps(live(m[3], "t", -1))                  # [ug]
    steps = int((n_s * 2 * (lg_r[:, None] + lg_t[None, :])).sum())
    record("fused_count3_star",
           f"Q2 round 1: uh={uh} ug={ug} chunks={ch} Cr={cr} Cs={cs} Ct={ct}",
           lambda: ops.fused_count3_star(*args),
           lambda: ops._fused_star_ref(*m),
           nbytes(*m) + uh * ug * 4, steps)
    del args, m, rg, sg, tg

    # Q3: cyclic.  Every live S slot of bucket (j, f, b) is visited by the
    # hp * uh cells (i, a): two searches of the R cell (i, j, a, b) and two
    # of the T row (i, f, a) per visit, and two steps per matching pair.
    _, (rg, sg, tg), cols = first_round_layout(results, queries, "Q3",
                                               "default")
    names = ("ra", "rb", "sb", "sc", "tc", "ta")
    src = {"ra": rg, "rb": rg, "sb": sg, "sc": sg, "tc": tg, "ta": tg}
    side = {"ra": "r", "rb": "r", "sb": "s", "sc": "s", "tc": "t", "ta": "t"}
    raw = {k: src[k].columns[cols[k]] for k in names}
    args = (raw["ra"], raw["rb"], rg.valid, raw["sb"], raw["sc"], sg.valid,
            raw["tc"], raw["ta"], tg.valid)
    m = _masked(ops, [(raw[k], src[k].valid, side[k]) for k in names])
    hp, gp, uh, ug, cr = raw["ra"].shape
    _, fp, _, cs = raw["sb"].shape
    ct = raw["tc"].shape[-1]
    rkeys = raw["rb"][rg.valid].long()
    skeys = raw["sb"][sg.valid].long()
    top = int(max(rkeys.max(), skeys.max())) + 1
    pairs = int((torch.bincount(rkeys, minlength=top)
                 * torch.bincount(skeys, minlength=top)).sum())
    n_s = live(m[2], "s", -1)                           # [gp, fp, ug]
    lg_r = _steps(live(m[0], "r", -1))                  # [hp, gp, uh, ug]
    lg_t = _steps(live(m[4], "t", -1))                  # [hp, fp, uh]
    r_visit = int((lg_r * n_s.sum(1)[None, :, None, :]).sum())
    t_visit = int((lg_t * n_s.sum((0, 2))[None, :, None]).sum())
    steps = 2 * (r_visit + t_visit) + 2 * pairs
    record("fused_count3_cyclic_pairidx",
           f"Q3 round 1: hp={hp} gp={gp} uh={uh} ug={ug} fp={fp} Cr={cr} "
           f"Cs={cs} Ct={ct}; matching (s, r) pairs={pairs}",
           lambda: ops.fused_count3_cyclic(*args),
           lambda: ops._fused_cyclic_pairidx_ref(*m),
           nbytes(*m) + hp * gp * uh * ug * 4, steps)
    return lines


# --------------------------------------------------------------------------
# phase 5: the paper's baselines on the same data
# --------------------------------------------------------------------------

BASELINE_WARM = 3
# B4's graph: Q3's N/d of about 286 at a size the all-pairs forms finish
B4_USERS, B4_EDGES = 350, 100_000
LIN = dict(rb="dst", sb="src", sc="dst", tc="src")       # f1.dst = f2.src, ...
CYC = dict(ra="src", rb="dst", sb="src", sc="dst", tc="src", ta="dst")
STAR = dict(rb="b", sb="b", sc="c", tc="c")


def retries(plan0, final):
    """Whole-query retries from ``plan0`` to ``final`` (each doubles every
    capacity)."""
    from repro_torch.core import recovery
    n, p = 0, plan0
    while tuple(p) != tuple(final):
        p, n = recovery.grown(p, 2.0), n + 1
        if n > 8:
            fail(f"plan {final} is not a growth of {plan0}")
    return n


def run_baseline(torch, label, fn, want, fused_warm_s=None):
    """Run ``fn`` cold and BASELINE_WARM times warm.  ``fn`` returns a dict
    with at least ``count``; the count must equal ``want`` and nothing may
    have overflowed.  Prints one ``[baseline]`` line."""
    from repro_torch.kernels import cuda
    before = dict(cuda.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k: cuda.LAUNCHES[k] - before[k] for k in cuda.KERNELS
                if cuda.LAUNCHES[k] != before[k]}
    if row.pop("overflowed"):
        fail(f"{label}: overflowed")
    if row["count"] != want:
        fail(f"{label}: count {row['count']} != oracle {want}")
    warm = []
    for _ in range(BASELINE_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again["count"] != want:
            fail(f"{label}: a warm run disagrees with the cold one")
    row = {"baseline": label, "count": row.pop("count"), "oracle": want,
           **row, "launches": launches, "cold_s": cold,
           "warm_median_s": statistics.median(warm), "warm_s": warm}
    if fused_warm_s is not None:
        row["fused_execute_warm_s"] = fused_warm_s
    log(f"[baseline] {json.dumps(row)}")
    return row


def fused_count_s(torch, query, want):
    """Median warm seconds of the fused COUNT execute of ``query``."""
    from repro_torch.core.session import JoinSession
    sess = JoinSession(m_budget=M_BUDGET)
    times = []
    for _ in range(1 + BASELINE_WARM):
        res, t = timed_execute(torch, sess, query, strategy="3way")
        if int(res.count) != want or bool(res.overflowed):
            fail(f"fused COUNT execute gave {int(res.count)}, oracle {want}")
        times.append(t)
    return statistics.median(times[1:])


def baseline_phase(torch, data, main_rows, queries, want, key_sums, seed):
    """B1-B6: the scan drivers with their whole-query retry, the all-pairs
    cyclic forms and the binary baselines, each against an oracle
    independent of the port.  The launch counters are zeroed before the
    phase; every baseline kernel must have launched in it."""
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import (binary_join, cyclic3, engine, linear3,
                                  partition, reference, star3)
    from repro_torch.kernels import cuda

    fused = {(r["query"], r["strategy_arg"]): r["warm_median_s"]
             for r in main_rows}
    F = queries["Q1"].relations["f1"]
    st = queries["Q2"].relations
    F6 = queries["Q6"].relations["f1"]
    rows, layouts = [], {}
    cuda.reset_launch_counts()

    # B1: linear scan with whole-query retry on Q1's F
    n1 = len(data["F"]["src"])
    plan0 = linear3.default_plan(n1, n1, n1, m_budget=M_BUDGET)

    def b1():
        res, plan = reference.linear3_count_auto(F, F, F, plan0, **LIN)
        layouts["linear"] = plan
        return {"count": int(res.count), "overflowed": bool(res.overflowed),
                "tuples_read": int(res.tuples_read),
                "retries": retries(plan0, plan), "plan": list(plan)}

    rows.append(run_baseline(torch, "B1 linear3_count_auto on Q1", b1,
                             want["Q1"], fused["Q1", "3way"]))

    # B2: star scan on Q2's data
    plan0 = star3.default_plan(*(len(data["star"][k][c])
                                 for k, c in (("r", "b"), ("s", "b"),
                                              ("t", "c"))))

    def b2():
        res, plan = reference.star3_count_auto(st["r"], st["s"], st["t"],
                                               plan0, **STAR)
        return {"count": int(res.count), "overflowed": bool(res.overflowed),
                "tuples_read": int(res.tuples_read),
                "retries": retries(plan0, plan), "plan": list(plan)}

    rows.append(run_baseline(torch, "B2 star3_count_auto on Q2", b2,
                             want["Q2"], fused["Q2", "3way"]))

    # B3: per-R scan on Q6's F6, per-key sums against the numpy oracle
    n6 = len(data["F6"]["src"])
    plan0 = linear3.default_plan(n6, n6, n6, m_budget=M_BUDGET)

    def b3():
        (keys, counts, valid), plan = reference.linear3_per_r_counts_auto(
            F6, F6, F6, plan0, key_col="src", **LIN)
        layouts["per_r"] = plan
        sums = torch.zeros(len(key_sums), dtype=torch.int64, device="cuda")
        sums.index_add_(0, keys[valid].long(), counts[valid])
        if not np.array_equal(sums.cpu().numpy(), key_sums):
            fail("B3: per-key sums differ from the numpy oracle")
        return {"count": int(counts[valid].sum()), "overflowed": False,
                "retries": retries(plan0, plan), "plan": list(plan)}

    rows.append(run_baseline(torch, "B3 linear3_per_r_counts_auto on Q6",
                             b3, want["Q6"], fused["Q6", "default"]))

    # B4: the all-pairs cyclic forms on a graph cut from Q3's (N/d kept)
    rng = np.random.default_rng(seed + 1)
    d4, n4 = B4_USERS, B4_EDGES
    G = {"src": rng.integers(0, d4, n4).astype(np.int32),
         "dst": rng.integers(0, d4, n4).astype(np.int32)}
    E = relation_from_numpy(G)
    tri4 = triangle_oracle(torch, G, d4)
    for label, rel, n, oracle, fused_s in [
            ("B4", E, n4, tri4, None),
            ("B4q3", F, n1, want["Q3"], fused["Q3", "default"])]:
        plan0 = cyclic3.default_plan(n, n, n, m_budget=M_BUDGET)
        final = {}

        def scan(rel=rel, plan0=plan0, final=final, label=label):
            res, plan = reference.cyclic3_count_auto(
                rel, rel, rel, plan0, pair_index=False, **CYC)
            final["plan"] = plan
            layouts[label] = (rel, plan)
            return {"count": int(res.count),
                    "overflowed": bool(res.overflowed),
                    "tuples_read": int(res.tuples_read),
                    "retries": retries(plan0, plan), "plan": list(plan)}

        rows.append(run_baseline(
            torch, f"{label} cyclic3_count_auto(pair_index=False)", scan,
            oracle, fused_s))

        def fused_all_pairs(rel=rel, final=final):
            res = engine.cyclic3_count_fused(rel, rel, rel, final["plan"],
                                             pair_index=False, **CYC)
            return {"count": int(res.count),
                    "overflowed": bool(res.overflowed),
                    "tuples_read": int(res.tuples_read)}

        rows.append(run_baseline(
            torch, f"{label} engine.cyclic3_count_fused(pair_index=False)",
            fused_all_pairs, oracle))
        if label == "B4":
            def pair_index_scan(rel=rel, final=final):
                res = cyclic3.cyclic3_count(rel, rel, rel, final["plan"],
                                            pair_index=True, **CYC)
                return {"count": int(res.count),
                        "overflowed": bool(res.overflowed),
                        "tuples_read": int(res.tuples_read)}

            rows.append(run_baseline(
                torch, "B4 cyclic3_count(pair_index=True)", pair_index_scan,
                oracle))

    # B5: the cascade, intermediate sized exactly.  The main path runs Q6
    # per R; its fused COUNT is timed here for the comparison.
    q6_count_s = fused_count_s(torch, queries["Q6"], want["Q6"])
    for label, (r, s, t), cols, oracle, fused_s in [
            ("B5 cascaded_binary_count on Q6", (F6, F6, F6), LIN,
             want["Q6"], q6_count_s),
            ("B5 cascaded_binary_count on Q2", (st["r"], st["s"], st["t"]),
             STAR, want["Q2"], fused["Q2", "3way"])]:
        cap = binary_join.exact_join_count(r, cols["rb"], s, cols["sb"])

        def cascade(r=r, s=s, t=t, cols=cols, cap=cap, label=label):
            res = binary_join.cascaded_binary_count(r, s, t, cap, **cols)
            if res.intermediate_total != cap:
                fail(f"{label}: intermediate_total {res.intermediate_total}"
                     f" != exact pair count {cap}")
            return {"count": int(res.count),
                    "overflowed": bool(res.intermediate_overflowed),
                    "intermediate_total": res.intermediate_total}

        rows.append(run_baseline(torch, label, cascade, oracle, fused_s))

    # B6: bucketed binary join F.dst ⋈ F.src
    n_buckets = 4096
    cap = partition.suggest_capacity(n1, n_buckets, 2.5)
    while bool(binary_join.bucketed_join_count(F, "dst", F, "src", n_buckets,
                                               cap, cap)[1]):
        cap *= 2
    layouts["pair"] = (n_buckets, cap)
    d1 = data["d"]["F"]
    indeg = np.bincount(data["F"]["dst"], minlength=d1).astype(np.int64)
    outdeg = np.bincount(data["F"]["src"], minlength=d1).astype(np.int64)

    def b6():
        count, ovf = binary_join.bucketed_join_count(F, "dst", F, "src",
                                                     n_buckets, cap, cap)
        return {"count": int(count), "overflowed": bool(ovf),
                "n_buckets": n_buckets, "cap": cap}

    rows.append(run_baseline(torch, "B6 bucketed_join_count on Q1", b6,
                             int(np.sum(indeg * outdeg))))

    launches = dict(cuda.LAUNCHES)
    log(f"[baseline] kernel launches in the phase: {json.dumps(launches)}")
    for name in cuda.BASELINE_KERNELS:
        if launches[name] <= 0:
            fail(f"{name} was never launched in the baseline phase")
    layouts["relations"] = {"F": F, "F6": F6}
    return rows, launches, layouts


def baseline_kernel_phase(torch, ops, errs, launches, layouts):
    """Each baseline kernel at the layout of its phase (the first step's
    layout for the scan kernels, at the plan that did not overflow),
    against its plain version and its bound (as in ``kernel_phase``; the
    all-pairs cyclic kernels add, per live R slot, the steps of its merge
    over the S run with b = r.b and the T run with a = r.a)."""
    from repro_torch.core import cyclic3, linear3, partition
    lines = []

    def live(x, side):
        return n_live(torch, ops, x, side, -1)

    def steps(x, side):
        return search_steps(torch, live(x, side))

    def record(*a, **kw):
        record_kernel(torch, lines, errs, launches, *a, **kw)

    rels = layouts["relations"]
    # the scan kernels at the first H partition of B1 and B3
    for name, key, rel, kern, plain in [
            ("bucket_count3_linear", "linear", rels["F"],
             ops.bucket_count3_linear, ops._bucket_linear_ref),
            ("bucket_per_r_counts", "per_r", rels["F6"],
             ops.bucket_per_r_counts, ops._bucket_per_r_ref)]:
        plan = layouts[key]
        rg, sg, tg = linear3.layouts(rel, rel, rel, plan, **LIN)
        args = linear3._partition_rows(rg, sg, tg, 0, **LIN)
        rb, rv, sb, sc, sv, tc, tv = args
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        n_s = live(m[1], "s")                              # [gp, u]
        lg_r, lg_t = steps(m[0], "r"), steps(m[3], "t")    # [1, u], [gp, 1]
        gp, u = n_s.shape
        if name == "bucket_count3_linear":
            n_steps = int((n_s * 2 * (lg_r + lg_t)).sum())
            out_b = gp * u * 4
        else:   # + one search per R slot of every bucket to gather
            n_steps = int((n_s * (2 * lg_t + lg_r)).sum()
                          + gp * (live(m[0], "r") * lg_r).sum())
            out_b = gp * u * plan.r_cap * 4
        record(name, f"first H partition of the final plan {list(plan)}",
               lambda k=kern, a=args: k(*a), lambda p=plain, m=m: p(*m),
               nbytes(*m) + out_b, n_steps)

    # the all-pairs cyclic kernels at B4's final plan (the fused sweep also
    # at Q3's graph, printed, not in the kernels line)
    def merge_steps(ra, rb, sb, ta, batch):
        """Per R-slot visit: two searches of its S row and two of its T row,
        then one step per entry of its S run (b = r.b) and T run
        (a = r.a)."""
        visits = live(rb, "r").expand(batch).reshape(-1)
        lg = steps(sb, "s").expand(batch) + steps(ta, "t").expand(batch)
        runs = (ops._multiplicity(sb, rb, batch).to(torch.int64).sum()
                + ops._multiplicity(ta, ra, batch).to(torch.int64).sum())
        return int((visits * 2 * lg.reshape(-1)).sum() + runs)

    for label in ("B4", "B4q3"):
        rel, plan = layouts[label]
        rg, sg, tg = cyclic3.layouts(rel, rel, rel, plan, **CYC)
        raw = [rg.columns[CYC["ra"]], rg.columns[CYC["rb"]], rg.valid,
               sg.columns[CYC["sb"]], sg.columns[CYC["sc"]], sg.valid,
               tg.columns[CYC["tc"]], tg.columns[CYC["ta"]], tg.valid]
        ra, rb, sb, sc, tc, ta = _masked(ops, [
            (raw[0], raw[2], "r"), (raw[1], raw[2], "r"),
            (raw[3], raw[5], "s"), (raw[4], raw[5], "s"),
            (raw[6], raw[8], "t"), (raw[7], raw[8], "t")])
        if label == "B4":
            # bucket-row: the first (H, G) cell on its (f, a, b) grid
            cell = [ra[0, 0], rb[0, 0], sb[0][:, None], sc[0][:, None],
                    tc[0][..., None, :], ta[0][..., None, :]]
            batch = ops.batch_shape(*cell)
            masks = [raw[2][0, 0], raw[5][0][:, None],
                     raw[8][0][..., None, :]]
            record("bucket_count3_cyclic",
                   f"first (H, G) cell of the final plan {list(plan)}",
                   lambda: ops.bucket_count3_cyclic(
                       raw[0][0, 0], raw[1][0, 0], masks[0],
                       raw[3][0][:, None], raw[4][0][:, None], masks[1],
                       raw[6][0][..., None, :], raw[7][0][..., None, :],
                       masks[2]),
                   lambda: ops._bucket_cyclic_ref(*cell),
                   nbytes(*cell) + math.prod(batch) * 4,
                   merge_steps(cell[0], cell[1], cell[2], cell[5], batch))
        # fused: the whole sweep, S rows (j, f, b), T rows (i, f, a) per f
        hp, gp, uh, ug, _ = ra.shape
        fused_steps = sum(
            merge_steps(ra, rb, sb[:, f][None, :, None],
                        ta[:, f][:, None, :, None], (hp, gp, uh, ug))
            for f in range(plan.f_parts))
        record("fused_count3_cyclic", f"{label} at the final plan "
               f"{list(plan)}",
               lambda raw=raw: ops.fused_count3_cyclic(*raw, pair_index=False),
               lambda m=(ra, rb, sb, sc, tc, ta):
                   ops._fused_cyclic_pairidx_ref(*m),
               nbytes(ra, rb, sb, sc, tc, ta) + hp * gp * uh * ug * 4,
               fused_steps, line=label == "B4")
        del raw, ra, rb, sb, sc, tc, ta, rg, sg, tg

    # the pair count at B6's layout
    n_buckets, cap = layouts["pair"]
    F = rels["F"]
    b = partition.bucketize(F, "dst", n_buckets, cap, fn="h")
    p = partition.bucketize(F, "src", n_buckets, cap, fn="h")
    ka, kb = _masked(ops, [(b.columns["dst"], b.valid, "a"),
                           (p.columns["src"], p.valid, "b")])
    record("bucket_pair_count",
           f"B6: {n_buckets} buckets x {cap} slots a side",
           lambda: ops.bucket_pair_count(b.columns["dst"], b.valid,
                                         p.columns["src"], p.valid),
           lambda: ops._bucket_pair_ref(ka, kb),
           nbytes(ka, kb) + n_buckets * 4,
           int((live(ka, "a") * 2 * steps(kb, "b")).sum()))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: FAILED: torch is not importable ({exc})",
              file=sys.stderr)
        return 2
    name, card = device_phase(torch)
    try:
        from repro_torch.kernels import cuda, ops
    except ImportError as exc:
        print(f"chip_smoke: FAILED: the port is not importable here ({exc});"
              " run from the root of a checkout", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    build_s = cuda.build()
    log(f"[build] {len(cuda.KERNELS)} kernels built in {build_s:.1f}s "
        f"(phase {time.perf_counter() - t0:.1f}s)")
    for stem, text in cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {stem}: {line.strip()}")

    errs = {}
    t0 = time.perf_counter()
    cases = kernel_cases(torch, ops, args.seed)
    for kname, kern, plain in cases:
        compare(torch, kname, kern(), plain(), errs)
    log(f"[kernels] {len(cases)} random layouts exact against the plain "
        f"versions in {time.perf_counter() - t0:.1f}s: {json.dumps(errs)}")

    t0 = time.perf_counter()
    data = make_data(args.seed)
    log(f"[data] generated in {time.perf_counter() - t0:.1f}s")
    rows, launches, results, queries, want, key_sums = main_path(torch,
                                                                  data)
    t0 = time.perf_counter()
    b_rows, b_launches, b_layouts = baseline_phase(
        torch, data, rows, queries, want, key_sums, args.seed)
    log(f"[baseline] phase took {time.perf_counter() - t0:.1f}s")
    del data

    lines = kernel_phase(torch, ops, errs, launches, results, queries)
    lines += baseline_kernel_phase(torch, ops, errs, b_launches, b_layouts)
    log(json.dumps({"queries": rows, "baselines": b_rows}))
    print(card, flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
