#!/usr/bin/env python3
"""Check that torch.profiler records every kernel of a short traced call.

    python3 tools/trace_probe.py

Traces 5 calls of ``flash_fwd`` at S1's prefill shape (bf16, [8, 1024,
12, 128], GQA 6:1) and prints, per trace, each kernel's number of records
and device ms: once early in the process, then after ``chip_smoke``'s
serving and training phases (the state in which the smoke times the
flash kernels), each way three times: a plain trace, and a trace whose
first step is the profiler's warm-up (2 calls, their records dropped), as
``chip_smoke.kernel_ms`` traces.  A complete trace shows 5 records of
``flash_fwd_tc_kernel``.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe: needs a CUDA device")
    from repro_torch.kernels import cuda, flash_attention as fa
    cuda.build()
    gen = torch.Generator().manual_seed(3)
    q, k, v = smoke._flash_inputs(torch, gen, 8, 1024, 1024, 12, 2, 128,
                                  "bfloat16")

    def fn():
        return fa.flash_fwd(q, k, v, causal=True)

    def trace(warm):
        fn()
        torch.cuda.synchronize()
        kw = dict(schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                  ) if warm else {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **kw) as prof:
            for calls in ((2, 5) if warm else (5,)):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                if warm:
                    prof.step()
        return {e.key[:40]: [e.count, e.self_device_time_total / 1e3]
                for e in prof.key_averages()
                if e.device_type.name == "CUDA"
                and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")}

    def report(when):
        for warm in (False, True):
            for _ in range(3):
                print(json.dumps({"when": when, "warm_up_step": warm,
                                  "kernels": trace(warm)}), flush=True)

    report("early")
    smoke.serve_phase(torch, 0)
    smoke.train_phase(torch, 0)
    report("after serving and training")
    return 0


if __name__ == "__main__":
    sys.exit(main())
