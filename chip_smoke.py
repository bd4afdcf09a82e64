#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases (each failure raises; the script then exits non-zero and prints no
result line):

  1. device  — requires CUDA and a compute capability 9.0 card; prints the
     card's name and power limit from nvidia-smi;
  2. build   — compiles the four Hopper kernels from ``src/repro_torch/
     kernels/csrc`` (one nvcc each, in parallel) and prints the seconds;
  3. kernels — each kernel against its plain PyTorch version on the card,
     exactly, on seeded layouts with unaligned capacities, invalid slots and
     hot keys;
  4. main path — six queries through ``JoinSession(m_budget=16384)
     .execute``, each checked against an oracle independent of the port
     (numpy histograms, a float64 trace(A^3) on the card, a numpy
     weight-backflow), with ``overflowed == False``.  The kernels' launch
     counters are zeroed just before and read just after;
  5. timings — each query's cold and warm execute times; each kernel at the
     first-round layouts of the main path, against its plain version
     (exact) and its bound.  Prints one ``kernels`` JSON line;
  6. the last line: ``{"ok": true, "device": {...}}``.

Sizes are cut from the paper's (Fig 4: N = 2e8 friends edges, a 1e9-row
fact table) to N = 4e6 edges over 14,000 users (the paper's N/d of about
286) and a 2e7-row fact table: the layout grows as N^2 / m_budget^2.
"""

from __future__ import annotations

import argparse
import json
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
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the main path")
    queries = {"Q1": lin, "Q2": star, "Q3": tri, "Q6": per_r}
    return rows, launches, results, queries


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


def kernel_phase(torch, ops, errs, launches, results, queries):
    """Each kernel at its main-path layout, against its plain version and
    its bound.  The bound is the larger of two times: the bytes of the
    function's inputs (each read once) and output (written once) over the
    HBM rate, and the search steps the sorted-bucket formulation needs on
    this run's data over the 32-bit issue rate: two binary searches
    (ceil(log2(n + 1)) steps each, n the live entries of the row) per live
    probing slot and probed row, plus, for cyclic, two steps per matching
    (s, r) pair."""
    from repro_torch.kernels import cuda
    lines = []

    def n_live(x, side, dims):
        return (x != ops._SENT[side]).to(torch.int64).sum(dims)

    def _steps(n):
        """Binary-search steps over sorted rows of n live entries."""
        return torch.ceil(torch.log2(n.to(torch.float64) + 1)).to(torch.int64)

    def record(name, shape_note, kern, plain, out_bytes, steps, line=True):
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
        n_s = n_live(m[1], "s", -1)                       # [hp, gp, u]
        n_r = n_live(m[0], "r", -1)                       # [hp, u]
        lg_r = _steps(n_r)
        lg_t = _steps(n_live(m[3], "t", -1))              # [gp]
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
    n_s = n_live(m[1], "s", -1).sum(0)                    # [uh, ug]
    lg_r = _steps(n_live(m[0], "r", -1))                  # [uh]
    lg_t = _steps(n_live(m[3], "t", -1))                  # [ug]
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
    n_s = n_live(m[2], "s", -1)                           # [gp, fp, ug]
    lg_r = _steps(n_live(m[0], "r", -1))                  # [hp, gp, uh, ug]
    lg_t = _steps(n_live(m[4], "t", -1))                  # [hp, fp, uh]
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
    rows, launches, results, queries = main_path(torch, data)
    del data

    lines = kernel_phase(torch, ops, errs, launches, results, queries)
    log(json.dumps({"queries": rows}))
    print(card, flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
