#!/usr/bin/env python3
"""Time one kernel library against other builds of it in one process.

    python3 tools/kernel_variants.py --stem STEM [--parent DIR]
                                     [--variant FILE.cu ...] [--rounds N]
                                     [--seed N]

Builds this checkout's kernels (``kernels/cuda.py``) and, beside the built
library ``STEM`` (one of ``LAYOUTS``), compiles with ``cuda.NVCC_FLAGS``
and ``-I csrc`` into ``build/kernel_variants/``:

* ``--parent DIR``: the same source in another checkout (e.g. a parent
  exported with ``git archive`` into a git-ignored directory), its
  ``#include``s resolved beside it, so its own headers;
* ``--variant FILE.cu``: a copy of the source with a change.

Each must keep this checkout's C entry point: it is swapped in for the
built library while the op (``ops.*``, through this checkout's wrapper) is
timed.  The layouts per stem:

* ``pair_count``: B6, Q1's graph (``chip_smoke.make_data``: 4e6 edges
  over 14,000 users) bucketized on ``dst`` and ``src`` into 4,096 buckets
  at the capacity the smoke's B6 settles on (``suggest_capacity`` doubled
  until nothing overflows), through ``ops.bucket_pair_count``;
* ``radix_hist``: R (Q1's ``F.src``, ~10% dead, as the smoke's radix phase
  makes it) and a hot stream (4e6 keys all 7, the same rows dead: one
  bucket), each at ``chip_smoke.RADIX_BUCKETS``, through
  ``ops.radix_histogram``;
* ``cyclic_sweep``: Q3's round 1, "Q3 shape, 600 a" (Q3's round-1 shape
  filled with uniform seeded keys so that each T row holds ~600 distinct
  a: the multimap tier) and B4's fused grid (1e5 edges over 350 users at
  the plan ``B4_PLAN``), through ``ops.fused_count3_cyclic``.

The contenders run in turns (in order, then in reverse, ``--rounds``
times) so that a drift of the card's clocks hits them alike.  Per
contender and layout a JSON line: ``exact`` (counts equal to the built
library's), ``op_ms`` (median of 5 CUDA-event timings after a warm-up
call), ``kernel_ms`` and each kernel's ms (``chip_smoke.kernel_ms``).
Prints the card's name and power limit and each build's ptxas register
and spill lines first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
B4_PLAN = (2, 4, 8, 8, 4, 496, 1960, 3912)


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "spill" in ln or "registers" in ln]


def pair_layouts(smoke, torch, ops, seed):
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import binary_join, partition
    edges = smoke.make_data(seed)["F"]
    F = relation_from_numpy(edges)
    n_buckets = 4096
    cap = partition.suggest_capacity(len(edges["src"]), n_buckets, 2.5)
    while bool(binary_join.bucketed_join_count(F, "dst", F, "src",
                                               n_buckets, cap, cap)[1]):
        cap *= 2
    b = partition.bucketize(F, "dst", n_buckets, cap, fn="h")
    p = partition.bucketize(F, "src", n_buckets, cap, fn="h")
    a = (b.columns["dst"], b.valid, p.columns["src"], p.valid)
    return {f"B6, {cap} slots": lambda: ops.bucket_pair_count(*a)}


def radix_layouts(smoke, torch, ops, seed):
    import numpy as np
    src = smoke.make_data(seed)["F"]["src"]
    valid = torch.as_tensor(np.random.default_rng(seed + 2).random(
        len(src)) >= smoke.RADIX_DEAD).cuda()
    streams = {"R": torch.as_tensor(src).cuda(),
               "hot": torch.full((len(src),), 7, dtype=torch.int32,
                                 device="cuda")}
    return {f"{name}, {nb} buckets":
            (lambda keys=keys, nb=nb:
             ops.radix_histogram(keys, valid, n_buckets=nb))
            for name, keys in streams.items() for nb in smoke.RADIX_BUCKETS}


def cyclic_layouts(smoke, torch, ops, seed):
    import numpy as np
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import cyclic3
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession

    def cyclic_args(rg, sg, tg, cols):
        return (rg.columns[cols["ra"]], rg.columns[cols["rb"]], rg.valid,
                sg.columns[cols["sb"]], sg.columns[cols["sc"]], sg.valid,
                tg.columns[cols["tc"]], tg.columns[cols["ta"]], tg.valid)

    F = relation_from_numpy(smoke.make_data(seed)["F"])
    q3 = Query({"f1": F, "f2": F, "f3": F},
               [("f1.dst", "f2.src"), ("f2.dst", "f3.src"),
                ("f3.dst", "f1.src")])
    res = JoinSession(m_budget=smoke.M_BUDGET).execute(q3)
    _, lay, cols = smoke.first_round_layout({("Q3", "default"): res},
                                            {"Q3": q3}, "Q3", "default")
    args = {"Q3 round 1": cyclic_args(*lay, cols)}
    shape = [x.shape for x in args["Q3 round 1"][2::3]]
    gen = torch.Generator().manual_seed(seed + 5)
    k, v = smoke.hard_layout(torch, gen, "a600", {
        "r": (shape[0], ("rb", "ra")), "s": (shape[1], ("sb", "sc")),
        "t": (shape[2], ("tc", "ta"))},
        dict(rb=100, ra=600, sb=100, sc=800, tc=800, ta=600))
    k = {c: x.cuda() for c, x in k.items()}
    v = {c: x.cuda() for c, x in v.items()}
    args["Q3 shape, 600 a"] = (k["ra"], k["rb"], v["r"], k["sb"], k["sc"],
                               v["s"], k["tc"], k["ta"], v["t"])
    rng = np.random.default_rng(seed + 1)
    G = relation_from_numpy({c: rng.integers(
        0, smoke.B4_USERS, smoke.B4_EDGES).astype(np.int32)
        for c in ("src", "dst")})
    b4 = cyclic3.layouts(G, G, G, cyclic3.Cyclic3Plan(*B4_PLAN), **smoke.CYC)
    args["B4"] = cyclic_args(*b4, smoke.CYC)
    return {label: (lambda a=a: ops.fused_count3_cyclic(*a))
            for label, a in args.items()}


LAYOUTS = {"pair_count": pair_layouts, "radix_hist": radix_layouts,
           "cyclic_sweep": cyclic_layouts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stem", required=True, choices=sorted(LAYOUTS))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)   # puts src/ on the path
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    from repro_torch.kernels import cuda, ops
    stem = args.stem
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "stem": stem, "build_s": cuda.build(),
                      "ptxas": ptxas_lines(cuda.BUILD_LOG.get(stem, ""))}),
          flush=True)

    sources = {}
    if args.parent:
        sources["parent"] = (pathlib.Path(args.parent).resolve()
                             / "src/repro_torch/kernels/csrc" / f"{stem}.cu")
    for src in map(pathlib.Path, args.variant):
        sources[src.stem] = src.resolve()
    out_dir = ROOT / "build" / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: (subprocess.Popen(
        [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
         str(out_dir / f"lib{stem}_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        out_dir / f"lib{stem}_{name}.so") for name, src in sources.items()}
    libs = {"built": cuda._loaded[stem]}
    fn_name, argtypes = cuda._LIBS[stem]
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        print(json.dumps({"contender": name, "source": str(sources[name]),
                          "rc": proc.returncode, "ptxas": ptxas_lines(log)}),
              flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: nvcc failed for {name}:\n"
                             f"{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
        lib.rj_error_string.argtypes = [ctypes.c_int]
        lib.rj_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    layouts = LAYOUTS[stem](smoke, torch, ops, args.seed)
    want = {label: call() for label, call in layouts.items()}
    order = list(libs)
    try:
        for rnd in range(args.rounds):
            for name in order + order[::-1]:
                cuda._loaded[stem] = libs[name]
                for label, call in layouts.items():
                    exact = bool(torch.equal(call(), want[label]))
                    k_ms, by_name, missing = smoke.kernel_ms(torch, call)
                    print(json.dumps({
                        "round": rnd, "contender": name, "layout": label,
                        "exact": exact, "op_ms": smoke.time_ms(torch, call),
                        "kernel_ms": k_ms, "kernel_ms_by_name": by_name,
                        **({"kernel_ms_missing": missing} if missing
                           else {})}), flush=True)
    finally:
        cuda._loaded[stem] = libs["built"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
