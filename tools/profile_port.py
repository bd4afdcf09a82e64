#!/usr/bin/env python3
"""Where the time of a warm ``JoinSession.execute`` goes, on the card.

    python3 tools/profile_port.py [--seed N]

Builds the smoke's Q1 (linear), Q2 (star) and Q3 (triangles) data
(``chip_smoke.make_data``), runs each query once to warm the plan cache,
then traces one more execute with ``torch.profiler`` and prints, per query:
the host wall time, the summed device kernel time, the device busy share
(kernel time over wall time; kernels on one stream do not overlap), and
the device kernels that took the most time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_port: needs a CUDA device")
    import chip_smoke
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession

    data = chip_smoke.make_data(args.seed)
    F = relation_from_numpy(data["F"])
    queries = {
        "Q1": (Query({"f1": F, "f2": F, "f3": F},
                     [("f1.dst", "f2.src"), ("f2.dst", "f3.src")]),
               dict(strategy="3way")),
        "Q2": (Query({k: relation_from_numpy(v)
                      for k, v in data["star"].items()},
                     [("r.b", "s.b"), ("s.c", "t.c")]), dict(strategy="3way")),
        "Q3": (Query({"f1": F, "f2": F, "f3": F},
                     [("f1.dst", "f2.src"), ("f2.dst", "f3.src"),
                      ("f3.dst", "f1.src")]), {}),
    }
    sess = JoinSession(m_budget=chip_smoke.M_BUDGET)
    for label, (q, kw) in queries.items():
        sess.execute(q, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = sess.execute(q, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"]
        dev_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        row = {"query": label, "rounds": res.rounds, "wall_s": wall,
               "device_kernel_s": dev_us / 1e6,
               "device_busy_share": dev_us / 1e6 / wall,
               "top_kernels": [
                   {"name": e.key[:90], "calls": e.count,
                    "device_s": e.self_device_time_total / 1e6}
                   for e in top[:args.top]]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
