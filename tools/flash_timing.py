#!/usr/bin/env python3
"""Time the flash attention kernels of one checkout on the card.

    python3 tools/flash_timing.py [--tree DIR] [--tag NAME] [--seed N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels, and times ``flash_fwd`` and ``flash_bwd`` (bf16, causal) at
the shapes the LM runs them: S1's prefill (q [8, 1024, 12, 128], k/v
[8, 1024, 2, 128]), T1's microbatch (q [2, 1024, 12, 128], GQA 6:1), and
S2's local (window 512) and global layers (q [4, 2048, 4, 256], MQA),
beside ``scaled_dot_product_attention``'s forward and backward on the same
tensors.  Times are medians of 5 CUDA-event timings of one call after a
warm-up call; the device kernels of one backward call (the dq, dkv and
reduce kernels) are timed apart with ``torch.profiler``.  Prints one JSON
line per shape and, first, the card's name and power limit.

To compare two trees on one card, run them in turns in one call, e.g. a
parent exported with ``git archive`` into a git-ignored directory:
``for t in parent . . parent; do python3 tools/flash_timing.py --tree $t;
done``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (label, B, S, H, KVH, D, window)
SHAPES = [("S1 prefill", 8, 1024, 12, 2, 128, 0),
          ("T1 microbatch", 2, 1024, 12, 2, 128, 0),
          ("S2 local layer", 4, 2048, 4, 1, 256, 512),
          ("S2 global layer", 4, 2048, 4, 1, 256, 0)]


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


def kernel_ms(torch, fn):
    """Device ms of each kernel one call of ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            out[e.key[:60]] = us / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("flash_timing: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    tag = args.tag or tree.name
    build_s = cuda.build()
    print(json.dumps({"tag": tag, "card": card, "build_s": build_s}),
          flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    for label, b, s, h, kvh, d, window in SHAPES:
        q = torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
        k, v = (torch.randn((b, s, kvh, d), generator=gen)
                .to("cuda", torch.bfloat16) for _ in range(2))
        do = torch.randn((b, s, h, d), generator=gen).to("cuda",
                                                         torch.bfloat16)
        kw = dict(causal=True, window=window)
        o, m, l = fa.flash_fwd(q, k, v, **kw)
        a = (q, k, v, o, m, l, do)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        pos = torch.arange(s, device="cuda")
        skw = (dict(attn_mask=(pos[None] <= pos[:, None])
                    & (pos[None] > pos[:, None] - window)) if window
               else dict(is_causal=True))

        def sdpa(qt=qt, kt=kt, vt=vt, skw=skw):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **skw)
        out = sdpa()
        dot = do.transpose(1, 2)
        row = {"tag": tag, "shape": label,
               "fwd_ms": time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw)),
               "bwd_ms": time_ms(torch, lambda: fa.flash_bwd(*a, **kw)),
               "sdpa_fwd_ms": time_ms(torch, sdpa),
               "sdpa_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
                   out, (qt, kt, vt), dot, retain_graph=True)),
               "bwd_kernels_ms": kernel_ms(torch,
                                           lambda: fa.flash_bwd(*a, **kw))}
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, m, l, a, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
