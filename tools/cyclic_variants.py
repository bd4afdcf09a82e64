#!/usr/bin/env python3
"""Time the triangle sweep against another build of it in one process.

    python3 tools/cyclic_variants.py [--parent DIR] [--variant FILE.cu ...]
                                     [--rounds N] [--seed N]

Builds this checkout's kernels (``kernels/cuda.py``) and times the
pair-index op (``ops.fused_count3_cyclic``, the library
``csrc/cyclic_sweep.cu``) at three layouts: Q3's round 1 (the smoke's data,
``chip_smoke.make_data``: 4e6 edges over 14,000 users), "Q3 shape, 600 a"
(Q3's round-1 shape filled with uniform seeded keys so that each T row
holds ~600 distinct a: the multimap tier) and B4's fused grid (1e5 edges
over 350 users at the plan [2, 4, 8, 8, 4, 496, 1960, 3912]).  Beside it:

* ``--parent DIR``: the pair-index wrapper of another checkout's
  ``kernels/cuda.py`` (e.g. a parent exported with ``git archive`` into a
  git-ignored directory), loaded as a module of its own and built into
  that checkout's ``_build/`` (its pair-index library only);
* ``--variant FILE.cu``: a copy of ``cyclic_sweep.cu`` with a change,
  compiled with ``cuda.NVCC_FLAGS`` and ``-I csrc`` and swapped in for the
  built library while it is timed.

Every contender runs in turns (each in order, then in reverse, ``--rounds``
times) so that a drift of the card's clocks hits them alike.  Per
contender and layout a JSON line: whether its counts equal the built op's
(``exact``), ``op_ms`` (median of 5 CUDA-event timings after a warm-up
call), ``kernel_ms`` and the sweep kernel's ms (``chip_smoke.kernel_ms``).
Prints the card's name and power limit and each build's ptxas register and
spill lines first.
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


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "spill" in ln or "registers" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smoke = load("chip_smoke", ROOT / "chip_smoke.py")  # puts src/ on the path
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cyclic_variants: needs a CUDA device")
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import cyclic3
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda, ops
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "build_s": cuda.build(),
                      "ptxas": ptxas_lines(cuda.BUILD_LOG.get(
                          "cyclic_sweep", ""))}), flush=True)

    built = cuda._loaded["cyclic_sweep"]
    contenders = {"built": lambda *a: ops.fused_count3_cyclic(*a)}
    if args.parent:
        pdir = pathlib.Path(args.parent).resolve()
        pcuda = load("parent_cuda", pdir / "src/repro_torch/kernels/cuda.py")
        pcuda._LIBS = {"fused_cyclic_pairidx":
                       pcuda._LIBS["fused_cyclic_pairidx"]}
        print(json.dumps({"parent": str(pdir), "build_s": pcuda.build(),
                          "ptxas": ptxas_lines(pcuda.BUILD_LOG.get(
                              "fused_cyclic_pairidx", ""))}), flush=True)
        contenders["parent"] = pcuda.fused_count3_cyclic_pairidx
    out_dir = ROOT / "build" / "cyclic_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in map(pathlib.Path, args.variant):
        so = out_dir / f"lib{src.stem}.so"
        procs[src.stem] = (subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
             str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        print(json.dumps({"variant": name, "rc": proc.returncode,
                          "ptxas": ptxas_lines(log)}), flush=True)
        if proc.returncode != 0:
            print(log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        fn, argtypes = cuda._LIBS["cyclic_sweep"]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.rj_error_string.argtypes = [ctypes.c_int]
        lib.rj_error_string.restype = ctypes.c_char_p

        def run(*a, lib=lib):
            cuda._loaded["cyclic_sweep"] = lib
            try:
                return ops.fused_count3_cyclic(*a)
            finally:
                cuda._loaded["cyclic_sweep"] = built
        contenders[name] = run

    def cyclic_args(rg, sg, tg, cols):
        return (rg.columns[cols["ra"]], rg.columns[cols["rb"]], rg.valid,
                sg.columns[cols["sb"]], sg.columns[cols["sc"]], sg.valid,
                tg.columns[cols["tc"]], tg.columns[cols["ta"]], tg.valid)

    data = smoke.make_data(args.seed)
    F = relation_from_numpy(data["F"])
    q3 = Query({"f1": F, "f2": F, "f3": F},
               [("f1.dst", "f2.src"), ("f2.dst", "f3.src"),
                ("f3.dst", "f1.src")])
    res = JoinSession(m_budget=smoke.M_BUDGET).execute(q3)
    _, lay, cols = smoke.first_round_layout({("Q3", "default"): res},
                                            {"Q3": q3}, "Q3", "default")
    layouts = {"Q3 round 1": cyclic_args(*lay, cols)}
    shape = [x.shape for x in layouts["Q3 round 1"][2::3]]
    gen = torch.Generator().manual_seed(args.seed + 5)
    k, v = smoke.hard_layout(torch, gen, "a600", {
        "r": (shape[0], ("rb", "ra")), "s": (shape[1], ("sb", "sc")),
        "t": (shape[2], ("tc", "ta"))},
        dict(rb=100, ra=600, sb=100, sc=800, tc=800, ta=600))
    k = {c: x.cuda() for c, x in k.items()}
    v = {c: x.cuda() for c, x in v.items()}
    layouts["Q3 shape, 600 a"] = (k["ra"], k["rb"], v["r"], k["sb"],
                                  k["sc"], v["s"], k["tc"], k["ta"], v["t"])
    rng = np.random.default_rng(args.seed + 1)
    G = relation_from_numpy({c: rng.integers(
        0, smoke.B4_USERS, smoke.B4_EDGES).astype(np.int32)
        for c in ("src", "dst")})
    b4 = cyclic3.layouts(G, G, G, cyclic3.Cyclic3Plan(*B4_PLAN), **smoke.CYC)
    layouts["B4"] = cyclic_args(*b4, smoke.CYC)
    want = {name: ops.fused_count3_cyclic(*a) for name, a in layouts.items()}

    order = list(contenders)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            fn = contenders[name]
            for label, a in layouts.items():
                def call(fn=fn, a=a):
                    return fn(*a)
                exact = bool(torch.equal(call(), want[label]))
                k_ms, by_name, _ = smoke.kernel_ms(torch, call)
                print(json.dumps({
                    "contender": name, "layout": label, "exact": exact,
                    "op_ms": smoke.time_ms(torch, call), "kernel_ms": k_ms,
                    "sweep_ms": sum(ms for kn, ms in by_name.items()
                                    if "cyclic_" in kn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
