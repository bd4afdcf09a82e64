"""Quickstart: the multiway-join engine of the PyTorch/CUDA port in five
minutes.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``: declares the
paper's three join shapes as query graphs (the engine classifies
linear/cyclic/star from the predicates — no kind strings), executes them
through one ``JoinSession``, checks the counts against a brute-force
oracle, shows the planner's 3-way vs cascaded-binary decision on the
paper's own workloads (Examples 3/4), and runs one join kernel directly:
``ops.bucket_pair_count``, the ``pair_count.cu`` kernel on the card and
its plain version on the CPU.  Runs on the card unless ``--device cpu``.
"""

import argparse
import pathlib
import sys
from collections import Counter, defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import JoinSession, Query, cost_model  # noqa: E402
from repro_torch.data.relations import (  # noqa: E402
    RelGenConfig, gen_relation)


def col(rel, name):
    return rel.col(name).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    rng_n, d = 4000, 300
    r = gen_relation(RelGenConfig(n=rng_n, d=d, columns=("a", "b"), seed=1),
                     device=dev)
    s = gen_relation(RelGenConfig(n=rng_n, d=d, columns=("b", "c"), seed=2),
                     device=dev)
    t = gen_relation(RelGenConfig(n=rng_n, d=d, columns=("c", "d"), seed=3),
                     device=dev)
    sess = JoinSession(m_budget=1024)

    # --- linear 3-way: R(AB) ⋈ S(BC) ⋈ T(CD), COUNT aggregated ---------
    q = Query(relations={"r": r, "s": s, "t": t},
              predicates=[("r.b", "s.b"), ("s.c", "t.c")])
    res = sess.execute(q)
    rb, sb, sc, tc = col(r, "b"), col(s, "b"), col(s, "c"), col(t, "c")
    oracle = int(((rb[:, None] == sb[None, :]).sum(0).astype(np.int64)
                  * (sc[:, None] == tc[None, :]).sum(1)).sum())
    print(f"{res.kind} 3-way COUNT = {int(res.count)}  (oracle {oracle})  "
          f"strategy={res.strategy}  tuples read = {int(res.tuples_read)}")
    assert res.kind == "linear" and int(res.count) == oracle
    warm = sess.execute(q)       # same structure + sizes: plan-cache hit
    print(f"warm re-execute: cache_hit={warm.cache_hit} "
          f"(plan {warm.plan_s * 1e3:.2f} ms vs cold "
          f"{res.plan_s * 1e3:.2f} ms)")

    # --- cyclic 3-way (triangles): a 3-cycle in the predicate graph -----
    t_cyc = gen_relation(RelGenConfig(n=rng_n, d=d, columns=("c", "a"),
                                      seed=3), device=dev)
    cres = sess.execute(Query(
        relations={"r": r, "s": s, "t": t_cyc},
        predicates=[("r.b", "s.b"), ("s.c", "t.c"), ("t.a", "r.a")]),
        m_budget=2048)
    # dict-based oracle: O(n * avg-degree)
    ra = col(r, "a")
    ta_c, ta_a = col(t_cyc, "c"), col(t_cyc, "a")
    s_by_b = defaultdict(list)
    for b, c in zip(sb.tolist(), sc.tolist()):
        s_by_b[b].append(c)
    t_by_ca = Counter(zip(ta_c.tolist(), ta_a.tolist()))
    tri = sum(t_by_ca.get((c, a), 0)
              for a, b in zip(ra.tolist(), rb.tolist())
              for c in s_by_b.get(b, ()))
    print(f"{cres.kind} 3-way (triangle) COUNT = {int(cres.count)}  "
          f"(oracle {tri})")
    assert cres.kind == "cyclic" and int(cres.count) == tri

    # --- star 3-way: same path graph, hub cardinality ≫ endpoints -------
    dim1 = gen_relation(RelGenConfig(n=500, d=d, columns=("a", "b"), seed=4),
                        device=dev)
    dim2 = gen_relation(RelGenConfig(n=500, d=d, columns=("c", "e"), seed=5),
                        device=dev)
    sres = sess.execute(Query(
        relations={"dim1": dim1, "fact": s, "dim2": dim2},
        predicates=[("dim1.b", "fact.b"), ("fact.c", "dim2.c")]))
    db, dc = col(dim1, "b"), col(dim2, "c")
    s_oracle = int(((db[:, None] == sb[None, :]).sum(0).astype(np.int64)
                    * (sc[:, None] == dc[None, :]).sum(1)).sum())
    print(f"{sres.kind} 3-way COUNT = {int(sres.count)} "
          f"(oracle {s_oracle})")
    assert sres.kind == "star" and int(sres.count) == s_oracle

    # --- the paper's planner decisions (Examples 3 and 4) ----------------
    m3_thresh = cost_model.example3_threshold_m()
    m4_thresh = cost_model.example4_threshold_m()
    print(f"\nExample 3 (Facebook linear self-join): 3-way wins iff "
          f"M > {m3_thresh:.3e} tuples (paper: 1.003e9)")
    print(f"Example 4 (cyclic/triangles): M threshold ≈ {m4_thresh:.2e} "
          "tuples (paper: ~7e6)")
    pick = cost_model.choose_linear_strategy(2e8, 2e8, 2e8, m=1e6, d=7e5)
    print(f"planner @ N=2e8,d=7e5,M=1e6: {pick.strategy} "
          f"(traffic ratio {pick.speed_ratio:.1f}x)")

    # --- one join kernel: the bucket pair count -------------------------
    from repro_torch.core import partition
    from repro_torch.kernels import ops as kops
    b = partition.bucketize(r, "b", 8, 1024, fn="h")
    p2 = partition.bucketize(s, "b", 8, 1024, fn="h")
    counts = kops.bucket_pair_count(b.columns["b"], b.valid,
                                    p2.columns["b"], p2.valid)
    pairs = int(counts.long().sum())
    where = ("pair_count.cu on the card" if counts.is_cuda
             else "plain version on the CPU")
    print(f"\nbucket_pair_count ({where}): R⋈S pairs = {pairs}")
    assert pairs == int((rb[:, None] == sb[None, :]).sum())
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
