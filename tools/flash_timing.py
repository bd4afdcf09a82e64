#!/usr/bin/env python3
"""Time the flash attention kernels of one checkout on the card.

    python3 tools/flash_timing.py [--tree DIR] [--tag NAME] [--seed N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels, and times ``flash_fwd`` (and ``flash_bwd`` where training
runs the shape) in bf16 at the shapes the LM runs them (``SHAPES``): S1's
prefill, T1's microbatch, S2's local (window 512) and global layers, S7's
encoder (non-causal, S = T = 4096), its prefill's and decode's cross
attention over the 4,096 frames, S4's prefill's and decode's cross
attention over the 1,601 patches, and T7's encoder microbatch (forward and
backward), beside ``scaled_dot_product_attention`` on the same tensors
(its backward alone on a retained graph).  Times are medians of 5
CUDA-event timings of one call after a warm-up call; the device kernels of
one backward call (the dq, dkv and reduce kernels) are timed apart with
``torch.profiler``.  Each row also gives the call's bound as
``chip_smoke.py``'s ``record_kernel`` takes it: the larger of the bytes
(forward: q, k, v read once, o and the f32 m, l written once; backward:
q, k, v, o, do, m, l read once, dq, dk, dv written once) over the HBM
rate and 4 D (forward) or 10 D (backward) flops a visible (q, k) pair
over the bf16 tensor-core rate.  Prints one JSON line per shape and,
first, the card's name and power limit.

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

# (label, B, S, T, H, KVH, D, causal, window, backward timed)
SHAPES = [("S1 prefill", 8, 1024, 1024, 12, 2, 128, True, 0, True),
          ("T1 microbatch", 2, 1024, 1024, 12, 2, 128, True, 0, True),
          ("S2 local layer", 4, 2048, 2048, 4, 1, 256, True, 512, True),
          ("S2 global layer", 4, 2048, 2048, 4, 1, 256, True, 0, True),
          ("S7 encoder", 4, 4096, 4096, 16, 16, 64, False, 0, False),
          ("S7 prefill cross", 4, 256, 4096, 16, 16, 64, False, 0, False),
          ("S7 decode cross", 4, 1, 4096, 16, 16, 64, False, 0, False),
          ("S4 prefill cross", 4, 1024, 1601, 32, 8, 128, False, 0, False),
          ("S4 decode cross", 4, 1, 1601, 32, 8, 128, False, 0, False),
          ("T7 encoder microbatch", 2, 4096, 4096, 16, 16, 64, False, 0,
           True)]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores


def visible_pairs(s, t, causal, window):
    """(q, k) pairs a head's softmax reads: every pair without a mask,
    else key j <= query i (and j > i - window), queries and keys aligned
    (S = T)."""
    if not causal:
        return s * t
    rows = range(s)
    return sum(min(i + 1, window) if window else i + 1 for i in rows)


def bound_ms(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    for label, b, s, t, h, kvh, d, causal, window, bwd in SHAPES:
        q = torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
        k, v = (torch.randn((b, t, kvh, d), generator=gen)
                .to("cuda", torch.bfloat16) for _ in range(2))
        do = torch.randn((b, s, h, d), generator=gen).to("cuda",
                                                         torch.bfloat16)
        kw = dict(causal=causal, window=window)
        o, m, l = fa.flash_fwd(q, k, v, **kw)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        pos = torch.arange(s, device="cuda")
        skw = (dict(attn_mask=(pos[None] <= pos[:, None])
                    & (pos[None] > pos[:, None] - window)) if window
               else dict(is_causal=causal))

        def sdpa(qt=qt, kt=kt, vt=vt, skw=skw):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **skw)
        out = sdpa()
        pairs = visible_pairs(s, t, causal, window) * b * h
        stats = 2 * 4 * b * h * s                 # m and l, f32
        fwd_bound = bound_ms(2 * q.nbytes + k.nbytes + v.nbytes + stats,
                             4 * d * pairs)
        row = {"tag": tag, "shape": label,
               "q": [b, s, h, d], "kv": [b, t, kvh, d], "causal": causal,
               "window": window, "visible_pairs": pairs,
               "fwd_ms": time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw)),
               "fwd_bound_ms": fwd_bound[0], "fwd_bound_by": fwd_bound[1],
               "sdpa_fwd_ms": time_ms(torch, sdpa),
               "max_abs_diff_vs_sdpa": float(
                   (o.float() - out.detach().transpose(1, 2).float())
                   .abs().max())}
        if bwd:
            a = (q, k, v, o, m, l, do)
            dot = do.transpose(1, 2)
            bwd_bound = bound_ms(
                4 * q.nbytes + 2 * (k.nbytes + v.nbytes) + stats,
                10 * d * pairs)
            row.update({
                "bwd_ms": time_ms(torch, lambda: fa.flash_bwd(*a, **kw)),
                "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
                "sdpa_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)),
                "bwd_kernels_ms": kernel_ms(
                    torch, lambda: fa.flash_bwd(*a, **kw))})
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, m, l, qt, kt, vt, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
