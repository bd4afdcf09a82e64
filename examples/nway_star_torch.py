"""N-way query graphs on the PyTorch/CUDA port: a star-schema fact table
joined to four dimensions.

    PYTHONPATH=src python examples/nway_star_torch.py [--device cpu]

The port's counterpart of ``examples/nway_star.py`` (same lines, same
counts; runs on the card unless ``--device cpu``).  Declares a
5-relation acyclic query (fact + 4 dims), lets ``planner.plan_query``
decompose it into binary materialize steps feeding a fused,
recovery-wrapped 3-way root, prints the plan, and checks the count
against a brute-force oracle.  It then shows ``execute_many`` amortizing
planning over the plan cache, and the log-bucketed cache keys surviving a
±5% data refresh.
"""

import argparse
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import JoinSession, Query, Relation  # noqa: E402


def _rel(rng, n, cols, d, device):
    return Relation.from_arrays(
        device=device,
        **{c: rng.integers(0, d, size=n).astype(np.int32) for c in cols})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    dev = ap.parse_args(argv).device

    rng = np.random.default_rng(29)
    n_fact, n_dim, d = 40000, 1500, 600
    fact = _rel(rng, n_fact, ("k1", "k2", "k3", "k4"), d, dev)
    dims = {f"d{i}": _rel(rng, n_dim, (f"k{i}", "x"), d, dev)
            for i in (1, 2, 3, 4)}

    q = Query(relations={"fact": fact, **dims},
              predicates=[(f"fact.k{i}", f"d{i}.k{i}")
                          for i in (1, 2, 3, 4)])
    sess = JoinSession(m_budget=4096)
    res = sess.execute(q)

    # oracle: per-fact-row product of dimension match counts
    want = np.ones(n_fact, np.int64)
    for i in (1, 2, 3, 4):
        cnt = defaultdict(int)
        for v in dims[f"d{i}"].col(f"k{i}").cpu().numpy().tolist():
            cnt[v] += 1
        want *= np.array([cnt.get(v, 0) for v in
                          fact.col(f"k{i}").cpu().numpy().tolist()],
                         np.int64)
    oracle = int(want.sum())

    print(res.plan.describe())
    print(f"\n5-way star COUNT = {int(res.count)}  (oracle {oracle})  "
          f"strategy={res.strategy}  rounds={res.rounds}  "
          f"tuples read = {int(res.tuples_read)}")
    for st in res.step_stats:
        print(f"  step {st.out}: {st.op}, {st.rows} rows, "
              f"{st.tuples_read} tuples, {st.exec_s * 1e3:.1f} ms")
    assert int(res.count) == oracle and not res.overflowed

    # batched execution over the plan cache: plans once, hits thereafter
    batch = sess.execute_many([q] * 4)
    print(f"\nexecute_many(4): cache hits = "
          f"{[r.cache_hit for r in batch]}, "
          f"plan ms = {[f'{r.plan_s * 1e3:.2f}' for r in batch]}")
    assert all(int(r.count) == oracle for r in batch)

    # log-bucketed cache keys: a ±5% refresh of the fact table still hits
    fact2 = _rel(rng, int(n_fact * 1.05), ("k1", "k2", "k3", "k4"), d, dev)
    q2 = Query(relations={"fact": fact2, **dims},
               predicates=[(f"fact.k{i}", f"d{i}.k{i}")
                           for i in (1, 2, 3, 4)])
    drifted = sess.execute(q2)
    print(f"+5% fact refresh: cache_hit={drifted.cache_hit} "
          f"(exact count {int(drifted.count)}, overflowed="
          f"{drifted.overflowed})")
    assert drifted.cache_hit and not drifted.overflowed
    print("\nnway_star OK")


if __name__ == "__main__":
    main()
