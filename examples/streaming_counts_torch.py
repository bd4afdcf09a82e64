"""Standing queries under continuous ingest on the PyTorch/CUDA port, end
to end.

    PYTHONPATH=src python examples/streaming_counts_torch.py [--device cpu]

The port's counterpart of ``examples/streaming_counts.py`` (same lines,
same counts; runs on the card unless ``--device cpu``).  Registers a
standing 3-way join count, streams delta batches into each relation, and
shows the delta plans keeping the count exact (verified against a
from-scratch execution at the end) without ever re-reading the full
inputs.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import JoinSession, Query, Relation  # noqa: E402

N, D = 20_000, 2_048


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    dev = ap.parse_args(argv).device
    rng = np.random.default_rng(0)

    def fresh(n, *cols):
        return Relation.from_arrays(
            device=dev,
            **{c: rng.integers(0, D, n).astype(np.int32) for c in cols})

    # orders ⋈ users ⋈ items: count qualifying (order, user, item) triples
    orders = fresh(N, "user", "item")
    users = fresh(N // 4, "user", "region")
    items = fresh(N // 8, "item", "vendor")

    q = Query({"orders": orders, "users": users, "items": items},
              [("orders.user", "users.user"), ("orders.item", "items.item")])

    sess = JoinSession(m_budget=1024)
    sq = sess.watch(q)
    print(f"standing count at registration: {sq.count:,}")

    # stream ingest: small delta batches, rotating over the relations
    for step in range(6):
        k = 200
        if step % 3 == 0:
            orders.append(user=rng.integers(0, D, k),
                          item=rng.integers(0, D, k))
        elif step % 3 == 1:
            users.append(user=rng.integers(0, D, k),
                         region=rng.integers(0, D, k))
        else:
            items.append(item=rng.integers(0, D, k),
                         vendor=rng.integers(0, D, k))
        rec = sq.delta_rounds[-1]
        print(f"  +{rec.delta_rows} rows into {rec.relation:<6} → "
              f"Δcount={rec.count_delta:+,}  ({rec.exec_s * 1e3:.1f} ms, "
              f"rounds={rec.rounds}, overflowed={rec.overflowed})")

    snap = sq.snapshot()
    oracle = JoinSession(m_budget=1024).execute(q)
    print(f"standing count: {int(snap.count):,}")
    print(f"from scratch:   {int(oracle.count):,}  "
          f"(match={int(snap.count) == int(oracle.count)})")
    assert int(snap.count) == int(oracle.count)
    assert not bool(snap.overflowed)
    sq.close()
    return int(snap.count)


if __name__ == "__main__":
    main()
