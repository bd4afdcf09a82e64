#!/usr/bin/env python3
"""Where the time of a warm ``JoinSession.execute``, or of serving, goes,
on the card.

    python3 tools/profile_port.py [--seed N] [--serve]

Default: builds the smoke's Q1 (linear), Q2 (star) and Q3 (triangles)
data (``chip_smoke.make_data``), runs each query once to warm the plan
cache, then traces one more execute with ``torch.profiler``.  With
``--serve``: for each of the smoke's serving runs (``chip_smoke.SERVE``:
S1 qwen2-1.5b, S2 gemma3-1b at full width, random weights), one warm-up
wave, then a traced prefill of a fresh wave and a traced run of
``DECODE_STEPS`` decode steps.  Prints, per traced span: the host wall
time, the summed device kernel time, the device busy share (kernel time
over wall time; kernels on one stream do not overlap), the kernel
launches, and the device kernels that took the most time.  Needs a CUDA
device.
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


DECODE_STEPS = 4


def traced(torch, fn, top):
    """Run ``fn`` under ``torch.profiler``; wall time, device kernel time,
    busy share, kernel launches and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return out, {"wall_s": wall, "device_kernel_s": dev_us / 1e6,
                 "device_busy_share": dev_us / 1e6 / wall,
                 "device_launches": sum(e.count for e in kernels),
                 "top_kernels": [
                     {"name": e.key[:90], "calls": e.count,
                      "device_s": e.self_device_time_total / 1e6}
                     for e in ranked[:top]]}


def profile_serving(torch, chip_smoke, seed, top):
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import zoo
    from repro_torch.train import make_decode_step, make_prefill_step
    for label, arch, batch, prompt, gen, _ in chip_smoke.SERVE:
        model = zoo.build(configs.get(arch))
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        serve.serve(model, params, batch=batch, prompt_len=prompt, gen=gen,
                    requests=batch, seed=seed, device="cuda",
                    log=lambda m: None)
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        prompts = np.random.default_rng(seed + 1).integers(
            0, model.config.vocab_size, size=(batch, prompt)).astype(np.int32)
        cache = model.init_cache(batch, prompt + gen, device="cuda")
        (logits, cache), row = traced(torch, lambda: prefill(
            params, torch.from_numpy(prompts).cuda(), cache), top)
        print(json.dumps({"serve": label, "span": "prefill", "batch": batch,
                          "prompt_len": prompt, **row}), flush=True)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

        def steps(tok=tok, cache=cache):
            for _ in range(DECODE_STEPS):
                tok, _, cache = decode(params, cache, tok)
            return tok
        _, row = traced(torch, steps, top)
        print(json.dumps({"serve": label, "span": f"{DECODE_STEPS} decode "
                          "steps", "batch": batch, **row}), flush=True)
        del params, cache, logits
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--serve", action="store_true",
                    help="profile the serving runs instead of the joins")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_port: needs a CUDA device")
    import chip_smoke
    if args.serve:
        profile_serving(torch, chip_smoke, args.seed, args.top)
        return 0
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
        res, row = traced(torch, lambda q=q, kw=kw: sess.execute(q, **kw),
                          args.top)
        print(json.dumps({"query": label, "rounds": res.rounds, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
