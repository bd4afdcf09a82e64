"""End-to-end analytics driver on the PyTorch/CUDA port: the paper's
Example 1 (friends-of-friends-of-friends) and Example 2 (triangles) on a
synthetic social graph.

    PYTHONPATH=src python examples/analytics_3way_torch.py [--users 2000] \
        [--friends 40] [--device cpu]

The port's counterpart of ``examples/analytics_3way.py`` (same arguments,
same lines, same counts; runs on the card unless ``--device cpu``).
Pipeline (all on the join engine, aggregates only — nothing materialized):
  1. generate a friends relation F (n = users·friends edges),
  2. declare the self 3-way F ⋈ F ⋈ F as a query graph (three aliases of
     one relation) and execute it with per-user COUNT through ONE
     JoinSession, plus the Flajolet-Martin DISTINCT sketch (the paper's
     footnote-4 aggregation, ``linear3_fm_distinct`` over 64 registers),
  3. declare the triangle query (a 3-cycle in the predicate graph) —
     community cohesion metric — on the same session,
  4. planner report: what the cost model would pick at Facebook scale.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (JoinSession, Query, cost_model,  # noqa: E402
                              linear3, sketches)
from repro_torch.core.relation import Relation  # noqa: E402


def friends_graph(users: int, friends: int, seed: int = 0):
    """Symmetric friendship edges, ~friends per user."""
    rng = np.random.default_rng(seed)
    n_edges = users * friends // 2
    a = rng.integers(0, users, size=n_edges).astype(np.int32)
    b = rng.integers(0, users, size=n_edges).astype(np.int32)
    keep = a != b
    a, b = a[keep], b[keep]
    src = np.concatenate([a, b])
    dst = np.concatenate([b, a])
    return src, dst


def _sync(rel):
    if rel.device.type == "cuda":
        import torch
        torch.cuda.synchronize(rel.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--friends", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    src, dst = friends_graph(args.users, args.friends)
    n = len(src)
    print(f"friends relation: {n} edges over {args.users} users "
          f"(f ≈ {n / args.users:.0f})")

    friends = Relation.from_arrays(src=src, dst=dst, device=dev)
    sess = JoinSession(m_budget=max(n // 4, 2048))

    # --- Example 1: friends-of-friends-of-friends ------------------------
    fofof = Query(
        relations={"f1": friends, "f2": friends, "f3": friends},
        predicates=[("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    t0 = time.time()
    res = sess.execute(fofof, per_r=True, key_col="src")
    _sync(friends)
    print(f"\nFoFoF paths (COUNT, with duplicates): {int(res.count):,} "
          f"in {time.time() - t0:.2f}s; classified {res.kind}, strategy "
          f"{res.strategy}; tuples read on-chip = {int(res.tuples_read):,}")

    # oracle: Σ over f2's rows of indeg(src) · outdeg(dst), numpy int64
    indeg = np.bincount(dst, minlength=args.users).astype(np.int64)
    outdeg = np.bincount(src, minlength=args.users).astype(np.int64)
    assert int(res.count) == int(np.sum(indeg[src] * outdeg[dst]))

    valid = res.per_r.valid.cpu().numpy()
    k = res.per_r.keys.cpu().numpy()[valid]
    c = res.per_r.counts.cpu().numpy()[valid]
    top = np.argsort(c)[-5:][::-1]
    print("top-5 users by FoFoF reach (edge-endpoint aggregation):")
    for i in top:
        print(f"   user-edge src={k[i]}: {c[i]:,} paths")

    # FM sketch: approximate DISTINCT (a, d) pairs over the whole join
    # (same relations, legacy column names)
    r = Relation.from_arrays(a=src, b=dst, device=dev)
    s = Relation.from_arrays(b=src, c=dst, device=dev)
    t = Relation.from_arrays(c=src, d=dst, device=dev)
    plan = linear3.default_plan(n, n, n, m_budget=max(n // 4, 2048))
    regs, _fm_ovf = linear3.linear3_fm_distinct(r, s, t, plan,
                                                n_registers=64)
    est = sketches.fm_estimate(regs)
    # the reference prints the distinct d-endpoints beside the estimate of
    # distinct (a, d) pairs; kept as it is for parity
    exact_d = int(np.count_nonzero(np.bincount(dst)))
    print(f"FM-sketch distinct d-endpoints ≈ {est:,.0f} "
          f"(exact {exact_d}; sketch bytes = {64 * 4})")

    # --- Example 2: triangles -------------------------------------------
    triangles = Query(
        relations={"f1": friends, "f2": friends, "f3": friends},
        predicates=[("f1.dst", "f2.src"), ("f2.dst", "f3.src"),
                    ("f3.dst", "f1.src")])
    t0 = time.time()
    cres = sess.execute(triangles)
    _sync(friends)
    tri = int(cres.count) // 6        # each triangle counted 6x (3! orders)
    print(f"\ntriangles: {tri:,} (raw oriented count {int(cres.count):,}; "
          f"classified {cres.kind}) in {time.time() - t0:.2f}s")
    adj = np.zeros((args.users, args.users), np.float64)
    np.add.at(adj, (src, dst), 1.0)
    assert int(cres.count) == int(round(np.trace(adj @ adj @ adj)))

    # --- planner at Facebook scale (paper Examples 3/4) ------------------
    print("\nplanner at paper scale (N=6e11, M=16MB-chip -> 1e6 tuples):")
    lin = cost_model.choose_linear_strategy(6e11, 6e11, 6e11, 1e6, 2e9)
    cyc = cost_model.choose_cyclic_strategy(6e11, 6e11, 6e11, 1e6, 2e9)
    print(f"   linear: {lin.strategy} (3way traffic {lin.tuples_3way:.2e} "
          f"vs cascade {lin.tuples_cascade:.2e})")
    print(f"   cyclic: {cyc.strategy} (3way traffic {cyc.tuples_3way:.2e} "
          f"vs cascade {cyc.tuples_cascade:.2e})")
    print("\nanalytics_3way OK")


if __name__ == "__main__":
    main()
