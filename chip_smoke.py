#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases (each failure raises; the script then exits non-zero and prints no
result line):

  1. device  — requires CUDA and a compute capability 9.0 card; prints the
     card's name and power limit from nvidia-smi;
  2. build   — compiles the twelve Hopper kernels from ``src/repro_torch/
     kernels/csrc`` (one nvcc per source, all in parallel) and prints the
     seconds;
  3. kernels — each kernel against its plain PyTorch version on the card
     on seeded layouts: the join kernels exactly (unaligned capacities,
     invalid slots, hot keys, shared bucket rows, 1 x 1 edge cases; for the
     linear, per-R, pair-index, all-pairs cyclic and star kernels also
     ``LINEAR_HARD`` / ``CYCLIC_HARD`` / ``STAR_HARD``, for the bucket-row
     linear and per-R kernels ``BUCKET_HARD`` in both scans' layouts, and
     for the bucket-row cyclic kernel ``BUCKET_CYCLIC_HARD`` in the cyclic
     scan's layout and with one T row shared by every bucket: rows of
     distinct keys past their shared-memory tables' budgets, a hot key
     whose cell counts wrap int32, dead rows, buckets and chunks, long S
     buckets, unaligned capacities), the pair count exactly on
     ``PAIR_HARD`` (rows of distinct keys past its shared budget, B6-like
     rows, a hot key whose count wraps int32, dead rows, shared rows,
     capacities 1, 257 and 4,099, keys just above the sentinels), the
     radix histogram exactly on ``RADIX_HARD`` (each of its three paths,
     the cluster path among them, unaligned views, one hot bucket, dead
     streams, negative keys), the flash forward within
     ``FLASH_TOL`` (the flash kernel tests' cases, ragged S, D = 128 and
     256, bf16 and f32, strided views, the VLM's cross-attention at S =
     1024 and S = 1 over T = 1601, the enc-dec's encoder at S = T = 4096
     non-causal and its cross-attention at S = 256 and 1 over T = 4096,
     its decoder's causal self-attention at S = 256 and 512, zamba2's
     32-head MHA at S = 2048 and 1024, each at its row's batch), the
     flash backward within
     ``FLASH_BWD_TOL`` against its plain version and against autograd of
     the plain forward (``FLASH_BWD_CASES``);
  4. main path — six queries through ``JoinSession(m_budget=16384)
     .execute``, each checked against an oracle independent of the port
     (numpy histograms, a float64 trace(A^3) on the card, a numpy
     weight-backflow), with ``overflowed == False``.  The launch counters
     are zeroed just before and read just after: each of the four fused
     kernels must have launched;
  5. baselines — the paper's baselines on the same data, each against its
     oracle with ``overflowed == False``, cold and warm (median of 3):
     B1 the linear scan driver with whole-query retry on Q1's graph, B2 the
     star scan on Q2's, B3 the per-R scan on Q6's, B4 the all-pairs cyclic
     forms (scan with retry, fused, and the pair-index scan) on a graph of
     1e5 edges over 350 users (Q3's N/d) and on Q3's graph, B5 the cascade
     of binary joins on Q6 and Q2, B6 the bucketed binary join on Q1.  The
     counters are zeroed before the phase: each of the five baseline
     kernels must have launched in it;
  6. radix — ``ops.radix_histogram`` over Q1's 4e6 source keys (~10%
     dead) at 4,096 and 65,536 buckets, exact against the plain version,
     the counter zeroed before the phase;
  7. stream — standing queries under ingest (``JoinSession.watch``,
     ``Relation.append``), each delta timed with the host clock around the
     append and a synchronise: W1 a triangle count over three distinct
     4e6-row edge relations (Q1's N and d), 3 warm-up and 6 timed deltas
     of 40,000 rows (1%) rotating over them, then 3 deltas of 400 rows
     that the family mask applies to (touched share printed); W2 Q5's
     chain under ``strategy="3way"``, the binary step's intermediate
     resident and feeding the fused root, 4 warm-up and 8 timed deltas of
     10,000 rows (the resident must grow on deltas into its inputs); W3
     the reference bench's streaming shape (its linear query and N/d, at
     ~4e6 rows a relation) through ``launch.join_service`` on its
     background thread, one tenant watching and ingesting 9 deltas of 1%,
     another's executes in the first and last waves.  Each run's snapshot
     must equal an oracle independent of the port (W1 a float64
     trace(A_R A_S A_T) on the card, W2 the weight backflow, W3 numpy
     bincounts) and a fresh session's execute (``full_ms``, median of 3
     warm; W3's ``full_ms`` is tenant t2's executes through the service,
     the deltas' own path, and the fresh session's ``direct_full_ms``),
     no delta round may overflow, not every timed delta may re-plan, the
     counters zeroed before the deltas must show
     ``fused_count3_cyclic_pairidx`` in W1's and ``fused_count3_linear``
     in W2's, and each of W1's 400-row deltas must mask a sibling to
     fewer live rows (``streaming.mask_to_families`` spied).  The delta
     root's kernel is held against its plain version (exact) and timed
     against its bound at the layouts the deltas gave it (W1's first
     timed and first 400-row delta, W2's first timed deltas into r1 and
     r3), printed beside the kernels line.  One ``[stream]`` line a run,
     with ``speedup`` = full_ms / delta_ms (the reference's
     ``claim_streaming_delta_ge_5x`` read on the card);
  8. mesh — the mesh path (``JoinSession.execute_sharded``) on a mesh of
     every visible card, NCCL, one card a rank (1 x 1 on one card: the
     multi-rank parity is the CPU tests' gloo 4 x 2): M1-M4 are Q1-Q4 at
     full size, each with the rank-local buckets of its single-card plan
     and ``shuffle_slack=1.0`` at 1 x 1 (M4 ``local_slack=1.0``,
     ``max_rounds=2``), one cold and 3 warm runs (host clock around the
     call and a synchronise), each equal to the oracle and to the
     single-card ``execute`` of the same query (its warm seconds beside),
     never overflowed, M4 in at least 2 rounds; then the one-shot
     wrappers on a graph of B4's size (and three 1e5-row relations for the
     star), exact.  The counters zeroed before the sharded runs must show
     the fused linear, star and pair-index kernels and the bucket-row
     linear kernel (the one-shot linear and star wrappers);
  9. timings — each join kernel at its layout (the main path's first
     round; the baselines' first step, and, printed, the linear scan
     kernel also at B2's and both all-pairs cyclic kernels also at B4q3's)
     and the radix kernel at Q1's
     keys, against its plain version (exact) and its bound: ``ms`` one op
     call as the main path makes it, ``kernel_ms`` the device time of the
     kernels that call launches (``torch.profiler`` after its warm-up
     step, the trace taken again, up to 3 times, where it came back
     incomplete; null when every try was; ``sorts_and_masks`` names
     any sort or elementwise kernel among them, and must be empty for the
     pair count and the radix histogram);
  10. analytics — A1: ``linear3.linear3_fm_distinct`` (the FM DISTINCT
     sketch of Example 1, never materializing the join) at Q6's data as
     R(a, b), S(b, c), T(c, d) under ``linear3.default_plan(n, n, n,
     m_budget=16384)``, grown as the whole-query retry drivers grow it
     while a bucket overflows (the tries printed), at 32 and 64
     registers: each call's registers equal an oracle independent of the
     FM path (the distinct (a, d) pairs as the non-zeros of a float64
     A·A·A on the card, folded with ``sketches.add`` on the CPU), never
     overflowed; first and warm seconds (median of 3), peak GiB
     (``max_memory_allocated``, and above the phase's start, which must
     stay under 16), the estimate and the exact distinct pairs.  E: each
     ported example (``examples/*_torch.py``) at its defaults on the card
     (``train_lm`` cut to 200 steps, its crash and resume kept), each
     asserting its counts against its own oracles; one ``[example]``
     line each with its seconds and printed lines;
  11. serve — the LM served at full width through
     ``repro_torch.launch.serve``: S1 qwen2-1.5b (batch 8, prompt 1024,
     32 generated tokens, 16 requests), S2 gemma3-1b (batch 4, prompt 2048,
     16 tokens, 4 requests), S3 qwen3-moe-30b-a3b cut to 24 of its 48
     layers (as S1's traffic), S4 llama-3.2-vision-11b whole (batch 4,
     prompt 1024, 16 tokens, 8 requests, each wave's memory [4, 1601,
     4096]), S5 mamba2-370m whole (batch 4, prompt 8192, 32 tokens, 8
     requests; the served cache's bytes after prefills of 8,192 and
     32,768 tokens must be equal, and the two peaks give the longest
     prompt that fits),
     S6 zamba2-1.2b whole (batch 8, prompt 2048, 32 tokens, 16
     requests), S7 seamless-m4t-medium whole (batch 4, prompt 256, 32
     tokens, 8 requests, each wave's memory [4, 4096, 1024] f32), random
     weights from the seed; each run's model freed after it.  The flash
     counter is zeroed before each and must equal its attention layers x
     (prefills + checking forwards) + cross-attention layers x decode
     steps (``serve_flash_passes``) after the serving and the checks:
     the teacher-forced ``forward`` of two rows over prompt + generated
     tokens (S4's and S7's with the wave's memory) must match the served
     prefill/decode logits within ``SERVE_TOL``, the served tokens must be
     the argmax of the served logits, and at every checked position the
     forward's logit for the served token must be within
     ``SERVE_TOL["max"]`` of the forward's largest logit.  S3
     (``moe_serve_checks``): the last wave's prefill logits against
     ``forward`` over its 8 prompts, no decode step dropping an
     assignment, and the teacher-forced check of two rows served with
     nothing able to drop (``capacity_factor`` = E / k); the dropped
     shares and the expert-weight casts' ms a decode step printed;
 12. train — the LM trained at full width through
     ``repro_torch.launch.train``: T1 qwen2-1.5b (batch 8, seq 1024, 4
     microbatches, remat, 6 steps), T2 gemma3-1b (batch 4, seq 2048, 2
     microbatches, 2 steps), T3 qwen3-moe-30b-a3b cut to 4 layers with
     ``scan_group`` 2 (batch 8 x 1024, 4 microbatches, 3 steps), T4
     llama-3.2-vision-11b cut to 5 layers, one cross group (batch 4 x
     1024 and ``batch_at``'s f32 memory, 4 microbatches, 2 steps), T5
     mamba2-370m and T6 zamba2-1.2b whole (batch 8 x 1024, 2
     microbatches, 3 steps), T7 seamless-m4t-medium whole (batch 4 x 512
     and ``batch_at``'s f32 memory [4, 4096, 1024], 2 microbatches, 2
     steps), random weights and ``batch_at`` data from the seed.  The
     flash counters are zeroed before each and read after every step:
     ``train_flash_passes`` x microbatches a step (remat and the groups'
     recomputes derived there); losses, gradient norms and the MoE's aux
     loss finite, T3's dropped share printed.  Then the gradient check on
     T1's model (``GRAD_TOL``), and the restart check at the qwen2-1.5b
     smoke config: a run that fails at step 5 and resumes from its newest
     committed checkpoint ends with the parameters of an uninterrupted
     run;
 13. lm mesh — the LM's mesh on one NCCL rank: L1 ``moe_mlp_sharded``
     at qwen3-moe-30b-a3b's width (d 2048, 128 experts top-8, expert ff
     768) on a 1 x 1 ("data", "model") mesh over x [8, 1024, 2048],
     against ``moe_mlp`` in f32 within ``LM_MOE_TOL`` with ``dropped``
     equal, then the bf16 ms of each; L2 T1 for 3 steps through
     ``launch.train`` on ``make_host_mesh()`` from T1's seed, each
     step's loss and gradient norm against the meshless T1's first
     steps within ``LM_TRAIN_TOL``, the flash counters zeroed before and
     read after every step (``train_flash_passes`` x microbatches), the
     step seconds beside T1's and the gradients' ``all_reduce`` timed
     apart; L3 L2's checkpoint restored with ``specs.state_shardings``
     onto the host mesh, every leaf a DTensor whose ``full_tensor()`` is
     the saved array, bit for bit;
 14. the flash forward and backward at S1's, T1's microbatch and S2's
     shapes against their plain versions, their bounds and
     ``scaled_dot_product_attention`` (its backward alone on a retained
     graph).  Prints one ``kernels`` JSON line with all twelve kernels
     (a ``kernel_ms`` whose trace is incomplete is null, with
     ``kernel_ms_missing`` saying why); the join kernels' launches are
     the main path's (the stream deltas' are in the ``[stream]`` lines),
     the flash kernels' those of serving, training and L2;
 15. the last line: ``{"ok": true, "device": {...}}``.

Join sizes are cut from the paper's (Fig 4: N = 2e8
friends edges, a 1e9-row fact table) to N = 4e6 edges over 14,000 users
(the paper's N/d of about 286) and a 2e7-row fact table: the layout grows
as N^2 / m_budget^2.  The LM widths are the published configs'; only the
traffic (requests, prompt and generation lengths; training batch,
sequence length and steps) is chosen here, and depth is cut only where
80 GB forces it (S3, T3, T4; each row prints its layers beside the
config's; S5-S7 and T5-T7 are whole).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

M_BUDGET = 16384
WARM = 5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# 32-bit scalar operations: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
# boost clock = 33.5e12 lane-instructions/s, the most a compare-and-add
# loop can issue (the 67 TFLOP/s float32 rate counts an FMA as two).
INT32_OPS_PER_S = 132 * 128 * 1.98e9
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an H100")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    if cap != (9, 0):
        fail(f"{name} has compute capability {cap}; the kernels are sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} capability {cap} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")
    return name, card


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _grid(torch, gen, shape, d, hot):
    keys = torch.randint(0, d, shape, generator=gen, dtype=torch.int32)
    if hot:
        keys[torch.rand(shape, generator=gen) < 0.3] = 3
    valid = torch.rand(shape, generator=gen) < 0.8
    return keys.cuda(), valid.cuda()


def _masked(ops, pairs):
    return [ops._mask(k, v, side) for k, v, side in pairs]


def kernel_cases(torch, ops, seed):
    """Seeded random layouts: (name, kernel call, plain call) triples."""
    gen = torch.Generator().manual_seed(seed)
    cases = []
    for shape, d, hot in [((3, 5, 7, 37, 19, 9001), 13, True),
                          ((2, 3, 4, 2100, 300, 130), 7, False),
                          ((2, 9, 3, 50, 301, 77), 5, True),
                          ((1, 1, 1, 3, 1, 1), 2, False)]:
        hp, gp, u, cr, cs, ct = shape
        rb, rv = _grid(torch, gen, (hp, u, cr), d, hot)
        sb, sv = _grid(torch, gen, (hp, gp, u, cs), d, hot)
        sc, _ = _grid(torch, gen, (hp, gp, u, cs), d, hot)
        tc, tv = _grid(torch, gen, (gp, ct), d, hot)
        args = (rb, rv, sb, sc, sv, tc, tv)
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("fused_count3_linear",
                      lambda a=args: ops.fused_count3_linear(*a),
                      lambda m=m: ops._fused_linear_ref(*m)))
        cases.append(("fused_per_r_counts",
                      lambda a=args: ops.fused_per_r_counts(*a),
                      lambda m=m: ops._fused_per_r_ref(*m)))
    for shape, d, hot in [((3, 5, 2, 4999, 3001, 8193), 11, True),
                          ((1, 1, 1, 5, 3, 2), 2, False)]:
        uh, ug, ch, cr, cs, ct = shape
        rb, rv = _grid(torch, gen, (uh, cr), d, hot)
        sb, sv = _grid(torch, gen, (ch, uh, ug, cs), d, hot)
        sc, _ = _grid(torch, gen, (ch, uh, ug, cs), d, hot)
        tc, tv = _grid(torch, gen, (ug, ct), d, hot)
        args = (rb, rv, sb, sc, sv, tc, tv)
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("fused_count3_star",
                      lambda a=args: ops.fused_count3_star(*a),
                      lambda m=m: ops._fused_star_ref(*m)))
    for shape, d, hot in [((2, 3, 2, 3, 2, 1500, 1100, 700), 9, True),
                          ((1, 1, 1, 1, 1, 5, 3, 2), 2, False)]:
        hp, gp, uh, ug, fp, cr, cs, ct = shape
        ra, rv = _grid(torch, gen, (hp, gp, uh, ug, cr), d, hot)
        rb, _ = _grid(torch, gen, (hp, gp, uh, ug, cr), d, hot)
        sb, sv = _grid(torch, gen, (gp, fp, ug, cs), d, hot)
        sc, _ = _grid(torch, gen, (gp, fp, ug, cs), d, hot)
        tc, tv = _grid(torch, gen, (hp, fp, uh, ct), d, hot)
        ta, _ = _grid(torch, gen, (hp, fp, uh, ct), d, hot)
        args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
        m = _masked(ops, [(ra, rv, "r"), (rb, rv, "r"), (sb, sv, "s"),
                          (sc, sv, "s"), (tc, tv, "t"), (ta, tv, "t")])
        cases.append(("fused_count3_cyclic_pairidx",
                      lambda a=args: ops.fused_count3_cyclic(*a),
                      lambda m=m: ops._fused_cyclic_pairidx_ref(*m)))
        cases.append(("fused_count3_cyclic",
                      lambda a=args: ops.fused_count3_cyclic(
                          *a, pair_index=False),
                      lambda m=m: ops._fused_cyclic_pairidx_ref(*m)))
    return (cases + hard_join_cases(torch, ops, gen)
            + bucket_cases(torch, ops, gen) + radix_cases(torch, ops, gen)
            + flash_cases(torch, gen) + flash_bwd_cases(torch, gen))


def _distinct_rows(torch, gen, shape, d):
    """Keys [*rows, C]: each row holds C distinct keys of [0, d)."""
    *rows, c = shape
    keys = [torch.randperm(d, generator=gen)[:c] for _ in range(math.prod(rows))]
    return torch.stack(keys).to(torch.int32).reshape(shape)


def hard_layout(torch, gen, kind, sides, d):
    """Seeded (keys, validity) per column of one join layout, on the CPU.

    ``sides`` maps each side to (its shape, its key columns); ``kind``:
    "distinct" — the first key column of the R and T sides (b, and c) holds
    distinct keys in every row, the others uniform keys, 90% live; "hot" —
    every key 7 and every slot live, so per-cell counts pass 2^32;
    "dead" — uniform keys with whole rows and buckets dead on every side;
    "long" / "unaligned" — uniform keys with a hot key, 80% live; any other
    kind ("a200", "a600", "chunks", "repeats") — uniform keys, 80% live.
    Returns {column: keys} and {side: validity}."""
    keys, valid = {}, {}
    for side, (shape, cols) in sides.items():
        for n, col in enumerate(cols):
            if kind == "hot":
                keys[col] = torch.full(shape, 7, dtype=torch.int32)
            elif kind == "distinct" and n == 0 and side in "rt":
                keys[col] = _distinct_rows(torch, gen, shape, d[col])
            else:
                keys[col] = torch.randint(0, d[col], shape, generator=gen,
                                          dtype=torch.int32)
                if kind in ("long", "unaligned"):
                    keys[col][torch.rand(shape, generator=gen) < 0.3] = 3
        p = {"hot": 1.0, "distinct": 0.9}.get(kind, 0.8)
        valid[side] = torch.rand(shape, generator=gen) < p
        if kind == "dead":
            # a whole leading row, and a whole row of every second leading
            # index, dead
            valid[side][0, ...] = False
            valid[side][1::2, -1, ...] = False
    return keys, valid


# (hp, gp, u, Cr, Cs, Ct, kind, key range per column): every key of a row
# distinct past the shared tables' budgets (T rows of ~8,100 live keys,
# R lists of ~10,800 an H); one hot key whose cell counts wrap int32; dead
# rows and buckets on every side; S blocks of 9,003 slots; capacities 1
# and 4097
LINEAR_HARD = [
    ((2, 3, 4, 3000, 700, 9000), "distinct",
     dict(rb=20_000, sb=20_000, sc=20_000, tc=20_000)),
    ((1, 2, 2, 3000, 60, 30_000), "hot", dict(rb=1, sb=1, sc=1, tc=1)),
    ((3, 4, 5, 40, 33, 500), "dead", dict(rb=13, sb=13, sc=13, tc=13)),
    ((2, 2, 3, 50, 3001, 700), "long", dict(rb=31, sb=31, sc=31, tc=31)),
    ((3, 2, 5, 1, 129, 4097), "unaligned", dict(rb=3, sb=3, sc=3, tc=3)),
]
# (hp, gp, uh, ug, fp, Cr, Cs, Ct, kind, key range per column): T rows of
# ~9,000 distinct (c, a) pairs and R cells of ~2,250 distinct b past the
# table and multimap budgets; a hot key with 2048 x 2100 x 1100 per cell;
# dead rows and buckets; S buckets of 4,000 slots (eight 512-thread
# passes); capacities 1, 513 and 4099; T rows of ~200 distinct a (bit rows
# of 8 words) and of ~600 (a first chunk past the bit rows' 256 a, so a
# multimap of 4,096 entries, then ~140 entries as bit rows)
CYCLIC_HARD = [
    ((1, 2, 1, 2, 2, 2500, 3000, 10_000), "distinct",
     dict(rb=5000, ra=40, sb=5000, sc=12_000, tc=12_000, ta=40)),
    ((1, 1, 1, 1, 1, 2048, 2100, 1100), "hot",
     dict(rb=1, ra=1, sb=1, sc=1, tc=1, ta=1)),
    ((2, 3, 2, 3, 2, 50, 40, 60), "dead",
     dict(rb=6, ra=6, sb=6, sc=6, tc=6, ta=6)),
    ((1, 2, 2, 2, 2, 30, 4000, 200), "long",
     dict(rb=9, ra=9, sb=9, sc=9, tc=9, ta=9)),
    ((2, 1, 3, 1, 2, 1, 513, 4099), "unaligned",
     dict(rb=4, ra=4, sb=4, sc=4, tc=4, ta=4)),
    ((1, 2, 2, 2, 1, 300, 1000, 2000), "a200",
     dict(rb=50, ra=200, sb=50, sc=500, tc=500, ta=200)),
    ((1, 2, 2, 2, 1, 300, 1000, 5300), "a600",
     dict(rb=50, ra=600, sb=50, sc=500, tc=500, ta=600)),
]


# (uh, ug, chunks, Cr, Cs, Ct, kind, key range per column): R and T rows
# of distinct keys (T's ~10,800 a row, past the sweep's shared table of
# 4,096 keys); one hot key whose cell counts wrap int32; dead rows and
# chunks; an S cell of 9,003 slots (two splits); capacities 1, 129 and
# 4097; three chunks of 50,000-slot cells (twelve splits) summed into each
# cell; T rows whose lists repeat keys across segments (~12,600 entries,
# spilled) but hold ~3,000 distinct keys, so the shared table is staged
# from a list that repeats them
STAR_HARD = [
    ((2, 3, 1, 10_000, 3000, 12_000), "distinct",
     dict(rb=40_000, sb=40_000, sc=40_000, tc=40_000)),
    ((1, 2, 2, 3000, 2000, 30_000), "hot", dict(rb=1, sb=1, sc=1, tc=1)),
    ((3, 4, 2, 40, 33, 500), "dead", dict(rb=13, sb=13, sc=13, tc=13)),
    ((2, 2, 1, 50, 9003, 700), "long", dict(rb=31, sb=31, sc=31, tc=31)),
    ((3, 2, 1, 1, 129, 4097), "unaligned", dict(rb=3, sb=3, sc=3, tc=3)),
    ((2, 3, 3, 300, 50_000, 400), "chunks",
     dict(rb=200, sb=200, sc=200, tc=200)),
    ((2, 2, 1, 20_000, 3000, 20_000), "repeats",
     dict(rb=3000, sb=3000, sc=3000, tc=3000)),
]


def hard_join_cases(torch, ops, gen):
    """The redesigned linear, per-R, pair-index and star kernels on the
    layouts that exercise their tiers: LINEAR_HARD (linear and per-R),
    CYCLIC_HARD and STAR_HARD."""
    cases = []

    def on_card(k, v):
        return ({c: x.cuda() for c, x in k.items()},
                {c: x.cuda() for c, x in v.items()})

    for (hp, gp, u, cr, cs, ct), kind, d in LINEAR_HARD:
        k, v = on_card(*hard_layout(torch, gen, kind, {
            "r": ((hp, u, cr), ("rb",)), "s": ((hp, gp, u, cs), ("sb", "sc")),
            "t": ((gp, ct), ("tc",))}, d))
        args = (k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"], v["t"])
        m = _masked(ops, [(k["rb"], v["r"], "r"), (k["sb"], v["s"], "s"),
                          (k["sc"], v["s"], "s"), (k["tc"], v["t"], "t")])
        cases.append(("fused_count3_linear",
                      lambda a=args: ops.fused_count3_linear(*a),
                      lambda m=m: ops._fused_linear_ref(*m)))
        cases.append(("fused_per_r_counts",
                      lambda a=args: ops.fused_per_r_counts(*a),
                      lambda m=m: ops._fused_per_r_ref(*m)))
    for (uh, ug, ch, cr, cs, ct), kind, d in STAR_HARD:
        k, v = on_card(*hard_layout(torch, gen, kind, {
            "r": ((uh, cr), ("rb",)), "s": ((ch, uh, ug, cs), ("sb", "sc")),
            "t": ((ug, ct), ("tc",))}, d))
        args = (k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"], v["t"])
        m = _masked(ops, [(k["rb"], v["r"], "r"), (k["sb"], v["s"], "s"),
                          (k["sc"], v["s"], "s"), (k["tc"], v["t"], "t")])
        cases.append(("fused_count3_star",
                      lambda a=args: ops.fused_count3_star(*a),
                      lambda m=m: ops._fused_star_ref(*m)))
    for (hp, gp, uh, ug, fp, cr, cs, ct), kind, d in CYCLIC_HARD:
        k, v = hard_layout(torch, gen, kind, {
            "r": ((hp, gp, uh, ug, cr), ("rb", "ra")),
            "s": ((gp, fp, ug, cs), ("sb", "sc")),
            "t": ((hp, fp, uh, ct), ("tc", "ta"))}, d)
        k, v = on_card(k, v)
        args = (k["ra"], k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"],
                k["ta"], v["t"])
        m = _masked(ops, [(k[c], v[c[0]], c[0]) for c in
                          ("ra", "rb", "sb", "sc", "tc", "ta")])
        cases.append(("fused_count3_cyclic_pairidx",
                      lambda a=args: ops.fused_count3_cyclic(*a),
                      lambda m=m: ops._fused_cyclic_pairidx_ref(*m)))
        cases.append(("fused_count3_cyclic",
                      lambda a=args: ops.fused_count3_cyclic(
                          *a, pair_index=False),
                      lambda m=m: ops._fused_cyclic_pairidx_ref(*m)))
    return cases


# (scan layout, its sizes, kind, key range per column): the linear
# scans' rows R [1, u, Cr] shared along g, S [gp, u, Cs], T [gp, 1, Ct]
# shared along h; the star scan's R [uh, 1, Cr], S [uh, ug, Cs], T
# [1, ug, Ct].  Kinds as ``hard_layout``'s, on the distinct rows (dead:
# the whole shared R row h = 0 and T row 0, every bucket of g = 0 or h = 0,
# and the last slot or bucket of every second row); "shared_r": keys of
# three values, so one R slot of a row shared along g gets different sums
# in different g buckets.  R lists of ~2,700 and ~9,000 keys and T rows
# of ~8,100 and ~10,800 distinct keys pass the sweeps' shared budgets
# (128 list entries, 2,048 and 4,096 keys); hot keys wrap the count (and,
# at Cs x Ct = 4.5e9, the per-R sums); S rows of 20,003 and 9,000 slots
# take the split sweep (from 8,192); capacities 1 and 4,097.
BUCKET_HARD = [
    ("linear", (3, 4, 3000, 700, 9000), "distinct",
     dict(rb=20_000, sb=20_000, sc=20_000, tc=20_000)),
    ("star", (2, 3, 10_000, 3000, 12_000), "distinct",
     dict(rb=40_000, sb=40_000, sc=40_000, tc=40_000)),
    ("linear", (2, 2, 3000, 60, 30_000), "hot", dict(rb=1, sb=1, sc=1, tc=1)),
    ("star", (1, 2, 3000, 9000, 500_000), "hot",
     dict(rb=1, sb=1, sc=1, tc=1)),
    ("linear", (4, 5, 40, 33, 500), "dead", dict(rb=13, sb=13, sc=13, tc=13)),
    ("star", (3, 4, 40, 33, 500), "dead", dict(rb=13, sb=13, sc=13, tc=13)),
    ("linear", (2, 3, 50, 3001, 700), "long", dict(rb=31, sb=31, sc=31, tc=31)),
    ("star", (2, 2, 50, 20_003, 700), "long",
     dict(rb=31, sb=31, sc=31, tc=31)),
    ("linear", (3, 5, 1, 129, 4097), "unaligned", dict(rb=3, sb=3, sc=3, tc=3)),
    ("star", (3, 2, 4097, 9000, 1), "unaligned", dict(rb=3, sb=3, sc=3, tc=3)),
    ("linear", (4, 3, 20, 50, 60), "shared_r", dict(rb=3, sb=3, sc=3, tc=3)),
]


def bucket_layout(torch, gen, layout, sizes, kind, d):
    """The seven operands (rb, rv, sb, sc, sv, tc, tv) of a ``BUCKET_HARD``
    case on the CPU, shaped as its scan passes them.  The keys and
    validity come from ``hard_layout`` on the distinct rows (R [n, Cr], S
    [P, Q, Cs], T [m, Ct]); the shared rows get their size-1 dimension
    after."""
    a, b, cr, cs, ct = sizes
    n_r, n_t = (b, a) if layout == "linear" else (a, b)
    k, v = hard_layout(torch, gen, kind, {
        "r": ((n_r, cr), ("rb",)), "s": ((a, b, cs), ("sb", "sc")),
        "t": ((n_t, ct), ("tc",))}, d)
    if layout == "linear":   # R [1, u] shared along g, T [gp, 1] along h
        r_of, t_of = (lambda x: x[None]), (lambda x: x[:, None])
    else:                    # R [uh, 1] shared along g, T [1, ug] along h
        r_of, t_of = (lambda x: x[:, None]), (lambda x: x[None])
    return (r_of(k["rb"]), r_of(v["r"]), k["sb"], k["sc"], v["s"],
            t_of(k["tc"]), t_of(v["t"]))


# (layout, (fp, uh, ug, Cr, Cs, Ct), kind, key range per column): the
# cyclic scan's (f, a, b) grid of one (H, G) cell, R [uh, ug] shared along
# f, S [fp, 1, ug] along a and T [fp, uh, 1] along b ("scan"), or one T
# row [1, 1, 1] shared by every bucket ("shared_t": its cells cut over
# CTAs).  Kinds as ``hard_layout``'s, on the distinct rows: T rows of
# ~9,000 distinct (c, a) pairs and R rows of ~2,250 distinct b past the
# table and multimap budgets; a hot key with 2048 x 2100 x 1100 a bucket
# (int32 wrap); dead rows shared along f, a and b; S rows of 4,000 slots;
# capacities 1, 513 and 4,099; the shared T row of ~600 distinct a (a first
# chunk in the multimap tier) and of ~200 (8-word bit rows) over 60 buckets.
BUCKET_CYCLIC_HARD = [
    ("scan", (2, 3, 2, 2500, 3000, 10_000), "distinct",
     dict(rb=5000, ra=40, sb=5000, sc=12_000, tc=12_000, ta=40)),
    ("scan", (1, 1, 2, 2048, 2100, 1100), "hot",
     dict(rb=1, ra=1, sb=1, sc=1, tc=1, ta=1)),
    ("scan", (3, 2, 3, 50, 40, 60), "dead",
     dict(rb=6, ra=6, sb=6, sc=6, tc=6, ta=6)),
    ("scan", (2, 2, 2, 30, 4000, 200), "long",
     dict(rb=9, ra=9, sb=9, sc=9, tc=9, ta=9)),
    ("scan", (2, 3, 1, 1, 513, 4099), "unaligned",
     dict(rb=4, ra=4, sb=4, sc=4, tc=4, ta=4)),
    ("shared_t", (2, 2, 2, 300, 1000, 5300), "a600",
     dict(rb=50, ra=600, sb=50, sc=500, tc=500, ta=600)),
    ("shared_t", (3, 4, 5, 40, 50, 2000), "a200",
     dict(rb=20, ra=200, sb=20, sc=100, tc=100, ta=200)),
]


def bucket_cyclic_layout(torch, gen, layout, sizes, kind, d):
    """The nine operands (ra, rb, rv, sb, sc, sv, tc, ta, tv) of a
    ``BUCKET_CYCLIC_HARD`` case on the CPU, shaped as the scan passes them:
    keys and validity from ``hard_layout`` on the distinct rows, the shared
    rows' size-1 dimensions added after."""
    fp, uh, ug, cr, cs, ct = sizes
    t_rows = (fp, uh) if layout == "scan" else (1,)
    k, v = hard_layout(torch, gen, kind, {
        "r": ((uh, ug, cr), ("rb", "ra")), "s": ((fp, ug, cs), ("sb", "sc")),
        "t": ((*t_rows, ct), ("tc", "ta"))}, d)

    def t_of(x):   # T [fp, uh, 1] shared along b, or [1, 1, 1]
        return x[:, :, None] if layout == "scan" else x[:, None, None]
    return (k["ra"], k["rb"], v["r"], k["sb"][:, None], k["sc"][:, None],
            v["s"][:, None], t_of(k["tc"]), t_of(k["ta"]), t_of(v["t"]))


# (kind, ka batch, kb batch, Ca, Cb, key range): the pair count's tiers.
# "distinct": rows of distinct keys, 90% live, so the listed (shorter) b
# rows hold ~4,500 distinct keys, past the sweep's shared budget (2,048):
# global tables; "repeats": 1,000 distinct keys in rows of 300,000 slots,
# lists of ~147,000 entries staged in the shared table, and streamed rows
# of 400,000 slots cut into splits; "b6": B6's rows (4,896 slots, ~4 keys,
# 20% live); "hot": one key in every slot of 70,000 a side, a count of
# 4.9e9 that wraps int32, summed over splits; "dead": whole rows and
# buckets dead; capacities 1, 257 and 4,099 with Ca != Cb; rows shared
# along size-1 batch dimensions; keys just above the sentinels.
PAIR_HARD = [
    ("distinct", (3,), (3,), 6000, 5000, 20_000),
    ("repeats", (2,), (2,), 300_000, 400_000, 1000),
    ("b6", (64,), (64,), 4896, 4896, 4),
    ("hot", (1,), (1,), 70_000, 70_000, 1),
    ("dead", (6, 5), (6, 5), 40, 33, 13),
    ("uniform", (7,), (7,), 1, 257, 3),
    ("uniform", (3,), (3,), 4099, 257, 50),
    ("uniform", (2,), (2,), 257, 4099, 50),
    ("uniform", (3, 1), (1, 4), 500, 300, 50),
    ("uniform", (1,), (5,), 700, 900, 60),
    ("sentinel", (4,), (4,), 300, 200, 6),
]


def pair_layout(torch, ops, gen, kind, ba, bb, ca, cb, d):
    """(ka, va, kb, vb) of one ``PAIR_HARD`` case on the CPU."""
    out = []
    for batch, c in ((ba, ca), (bb, cb)):
        shape = (*batch, c)
        if kind == "hot":
            keys = torch.full(shape, 7, dtype=torch.int32)
        elif kind == "distinct":
            keys = _distinct_rows(torch, gen, shape, d)
        else:
            keys = torch.randint(0, d, shape, generator=gen,
                                 dtype=torch.int32)
            if kind == "sentinel":
                keys += ops.SENT_BASE + 6
        p = {"hot": 1.0, "distinct": 0.9, "b6": 0.2}.get(kind, 0.8)
        valid = torch.rand(shape, generator=gen) < p
        if kind == "dead":   # a whole leading row, the last bucket of every
            valid[0] = False  # second one
            valid[1::2, -1] = False
        out += [keys, valid]
    return out


def bucket_cases(torch, ops, gen):
    """The bucket-row kernels of the baselines, on [*batch, C] rows whose
    size-1 batch dimensions share one row (as the scan drivers pass them)
    and on plain [B, C] rows; the linear and per-R kernels also on
    ``BUCKET_HARD``, the cyclic kernel on ``BUCKET_CYCLIC_HARD``."""
    cases = []
    # (ka batch, kb batch, Ca, Cb, key range, hot)
    for ba, bb, ca, cb, d, hot in [((7,), (7,), 37, 130, 11, True),
                                   ((300,), (300,), 259, 61, 400, False),
                                   ((3, 4), (3, 1), 50, 33, 9, True),
                                   ((1,), (1,), 1, 1, 2, False)]:
        ka, va = _grid(torch, gen, (*ba, ca), d, hot)
        kb, vb = _grid(torch, gen, (*bb, cb), d, hot)
        m = _masked(ops, [(ka, va, "a"), (kb, vb, "b")])
        cases.append(("bucket_pair_count",
                      lambda a=(ka, va, kb, vb): ops.bucket_pair_count(*a),
                      lambda m=m: ops._bucket_pair_ref(*m)))
    for case in PAIR_HARD:
        ka, va, kb, vb = (x.cuda() for x in pair_layout(torch, ops, gen,
                                                        *case))
        m = _masked(ops, [(ka, va, "a"), (kb, vb, "b")])
        cases.append(("bucket_pair_count",
                      lambda a=(ka, va, kb, vb): ops.bucket_pair_count(*a),
                      lambda m=m: ops._bucket_pair_ref(*m)))
    # (R batch, S batch, T batch, Cr, Cs, Ct, key range, hot): the linear
    # driver's (g, h) grid, the star driver's (h, g) grid, plain rows, 1 x 1
    for br, bs, bt, cr, cs, ct, d, hot in [
            ((1, 7), (5, 7), (5, 1), 37, 19, 9001, 13, True),
            ((1, 4), (3, 4), (3, 1), 2100, 300, 130, 7, False),
            ((3, 1), (3, 5), (1, 5), 4999, 3001, 8193, 11, True),
            ((50,), (50,), (50,), 301, 77, 5, 5, True),
            ((1,), (1,), (1,), 3, 1, 1, 2, False)]:
        rb, rv = _grid(torch, gen, (*br, cr), d, hot)
        sb, sv = _grid(torch, gen, (*bs, cs), d, hot)
        sc, _ = _grid(torch, gen, (*bs, cs), d, hot)
        tc, tv = _grid(torch, gen, (*bt, ct), d, hot)
        args = (rb, rv, sb, sc, sv, tc, tv)
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("bucket_count3_linear",
                      lambda a=args: ops.bucket_count3_linear(*a),
                      lambda m=m: ops._bucket_linear_ref(*m)))
        cases.append(("bucket_per_r_counts",
                      lambda a=args: ops.bucket_per_r_counts(*a),
                      lambda m=m: ops._bucket_per_r_ref(*m)))
    for layout, sizes, kind, d in BUCKET_HARD:
        args = tuple(x.cuda() for x in bucket_layout(torch, gen, layout,
                                                     sizes, kind, d))
        rb, rv, sb, sc, sv, tc, tv = args
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        cases.append(("bucket_count3_linear",
                      lambda a=args: ops.bucket_count3_linear(*a),
                      lambda m=m: ops._bucket_linear_ref(*m)))
        cases.append(("bucket_per_r_counts",
                      lambda a=args: ops.bucket_per_r_counts(*a),
                      lambda m=m: ops._bucket_per_r_ref(*m)))
    # the cyclic driver's (f, a, b) grid: R [uh, ug], S shared along a,
    # T shared along b; plain rows; 1 x 1
    for br, bs, bt, cr, cs, ct, d, hot in [
            ((3, 2), (2, 1, 2), (2, 3, 1), 150, 1100, 700, 9, True),
            ((20,), (20,), (20,), 33, 41, 57, 6, False),
            ((1,), (1,), (1,), 5, 3, 2, 2, False)]:
        ra, rv = _grid(torch, gen, (*br, cr), d, hot)
        rb, _ = _grid(torch, gen, (*br, cr), d, hot)
        sb, sv = _grid(torch, gen, (*bs, cs), d, hot)
        sc, _ = _grid(torch, gen, (*bs, cs), d, hot)
        tc, tv = _grid(torch, gen, (*bt, ct), d, hot)
        ta, _ = _grid(torch, gen, (*bt, ct), d, hot)
        args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
        m = _masked(ops, [(ra, rv, "r"), (rb, rv, "r"), (sb, sv, "s"),
                          (sc, sv, "s"), (tc, tv, "t"), (ta, tv, "t")])
        cases.append(("bucket_count3_cyclic",
                      lambda a=args: ops.bucket_count3_cyclic(*a),
                      lambda m=m: ops._bucket_cyclic_ref(*m)))
    for layout, sizes, kind, d in BUCKET_CYCLIC_HARD:
        args = tuple(x.cuda() for x in bucket_cyclic_layout(
            torch, gen, layout, sizes, kind, d))
        m = _masked(ops, [(args[i], args[3 * (i // 3) + 2], "rst"[i // 3])
                          for i in (0, 1, 3, 4, 6, 7)])
        cases.append(("bucket_count3_cyclic",
                      lambda a=args: ops.bucket_count3_cyclic(*a),
                      lambda m=m: ops._bucket_cyclic_ref(*m)))
    return cases


# (n, n_buckets, kind, key offset, validity offset): the radix kernel's
# paths by n_buckets, copies in shared memory up to 32,768 buckets, slices
# of a cluster (2, 4 and 8 CTAs) up to 262,144, global atomics above; n
# of 1, 3, 4,097 and 2^20 + 5 (a scalar head and tail); views starting at
# offsets 1-3 into their storage, and one whose validity is at another
# phase than its keys (streamed scalar); "uniform" keys over all of
# int32, "negative" keys, "hot" every key 7 (one bucket), "dead" every row
# dead.
RADIX_HARD = [
    (1, 1, "uniform", 0, 0),
    (3, 12_288, "negative", 1, 1),
    (4097, 12_289, "hot", 2, 2),
    (2**20 + 5, 4096, "uniform", 3, 3),
    (2**20 + 5, 32_768, "hot", 1, 1),
    (2**20 + 5, 32_769, "uniform", 0, 0),
    (2**20 + 5, 65_536, "hot", 2, 2),
    (2**20 + 5, 65_536, "dead", 0, 0),
    (2**20 + 5, 100_003, "negative", 1, 1),
    (2**20 + 5, 262_143, "uniform", 3, 3),
    (2**20 + 5, 300_007, "hot", 0, 0),
    (100_003, 4096, "uniform", 1, 2),
]


def radix_stream(torch, gen, n, kind):
    """keys (n + 3,) int32 and valid (n + 3,) bool of one ``RADIX_HARD``
    case on the CPU; the case reads a view of n at its offsets."""
    lo, hi = {"negative": (-2**31, 0)}.get(kind, (-2**31, 2**31 - 1))
    keys = torch.randint(lo, hi, (n + 3,), generator=gen, dtype=torch.int32)
    if kind == "hot":
        keys.fill_(7)
    valid = torch.rand(n + 3, generator=gen) < (0.0 if kind == "dead"
                                                 else 0.9)
    return keys, valid


def radix_cases(torch, ops, gen):
    """The radix histogram: n not a multiple of the block, keys over the
    whole int32 range and a hot key, bucket counts from 16 to 100,003; then
    ``RADIX_HARD``, the views taken on the card."""
    cases = []

    def case(keys, valid, nb):
        cases.append(("radix_histogram",
                      lambda k=keys, v=valid, nb=nb: ops.radix_histogram(
                          k, v, n_buckets=nb),
                      lambda k=keys, v=valid, nb=nb: ops._radix_histogram_ref(
                          k, v, nb)))
    for n, nb, hot in [(1, 16, False), (1000, 16, True), (4097, 1000, False),
                       (100_003, 4096, True), (100_003, 12_288, False),
                       (100_003, 12_289, True), (1 << 20, 65_536, False),
                       (50_000, 100_003, True)]:
        keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             dtype=torch.int32)
        if hot:
            keys[torch.rand(n, generator=gen) < 0.5] = 7
        valid = torch.rand(n, generator=gen) < 0.9
        case(keys.cuda(), valid.cuda(), nb)
    for n, nb, kind, k_off, v_off in RADIX_HARD:
        keys, valid = (x.cuda() for x in radix_stream(torch, gen, n, kind))
        case(keys[k_off:k_off + n], valid[v_off:v_off + n], nb)
    return cases


# (B, S, T, H, KVH, D, causal, window, dtype): the six CASES of
# tests/test_flash_kernel.py, then S not a multiple of the 64-row tile,
# D = 128 and 256 (qwen2's and gemma3's heads), D = 8, one row, S != T,
# the VLM's cross-attention shapes and the MoE's and VLM's self-attention
FLASH_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, "float32"),
    (2, 128, 128, 4, 2, 32, True, 0, "float32"),
    (1, 256, 256, 8, 1, 16, True, 0, "float32"),
    (1, 128, 128, 4, 4, 32, False, 0, "float32"),
    (1, 256, 256, 2, 2, 32, True, 64, "float32"),
    (1, 128, 128, 4, 2, 32, True, 0, "bfloat16"),
    (2, 100, 100, 4, 2, 16, True, 0, "float32"),
    (2, 333, 333, 6, 2, 128, True, 0, "bfloat16"),
    (1, 300, 300, 12, 2, 128, True, 0, "float32"),
    (2, 200, 200, 4, 1, 256, True, 50, "bfloat16"),
    (1, 130, 130, 4, 1, 256, True, 0, "float32"),
    (1, 257, 257, 4, 1, 256, False, 100, "bfloat16"),
    (1, 70, 70, 2, 1, 8, True, 0, "bfloat16"),
    (1, 1, 1, 2, 2, 64, True, 0, "float32"),
    (2, 100, 150, 4, 2, 32, False, 0, "bfloat16"),
    (1, 150, 90, 4, 1, 64, True, 30, "float32"),
    # the bf16 kernel's tile edges: S = 127 and 129 around its 128-row CTA
    # tile, T not a multiple of its 64-key stage, T1's microbatch, a window
    # that crosses tile edges, MQA at D = 256, rows with no visible key
    (1, 127, 127, 4, 2, 64, True, 0, "bfloat16"),
    (2, 129, 129, 6, 2, 128, True, 0, "bfloat16"),
    (1, 129, 100, 4, 2, 128, False, 0, "bfloat16"),
    (1, 129, 129, 4, 2, 64, True, 0, "float32"),
    (2, 1024, 1024, 12, 2, 128, True, 0, "bfloat16"),
    (1, 300, 300, 4, 2, 128, True, 100, "bfloat16"),
    (1, 200, 200, 8, 1, 256, True, 0, "bfloat16"),
    (1, 200, 70, 4, 2, 64, True, 30, "bfloat16"),
    # the VLM's cross-attention (S4, T4): text over 1,601 image tokens,
    # no mask, GQA 4:1 at D = 128, in bf16 (serving) and f32 (training
    # over batch_at's f32 memory); one decode query over the same memory
    (1, 1024, 1601, 32, 8, 128, False, 0, "bfloat16"),
    (1, 1024, 1601, 32, 8, 128, False, 0, "float32"),
    (4, 1, 1601, 32, 8, 128, False, 0, "bfloat16"),
    # the self-attention of S3/T3 (qwen3-moe: GQA 8:1, T3's microbatch of
    # 2 x 1,024) and of S4/T4 (llama-3.2-vision: GQA 4:1), causal, D = 128
    (2, 1024, 1024, 32, 4, 128, True, 0, "bfloat16"),
    (1, 1024, 1024, 32, 8, 128, True, 0, "bfloat16"),
    # the enc-dec's (S7/T7: seamless, MHA, 16 heads, D = 64): the
    # encoder's bidirectional attention over 4,096 frames, the decoder's
    # cross-attention over them at S = 256 (S7's prefill), S = 1 (its
    # decode steps) and T7's 2 x 512, the decoder's causal self-attention
    # at S7's prompt and T7's microbatch; zamba2's shared block (S6/T6:
    # MHA, 32 heads, D = 64), causal at S6's prompt and T6's microbatch
    (4, 4096, 4096, 16, 16, 64, False, 0, "bfloat16"),
    (4, 256, 4096, 16, 16, 64, False, 0, "bfloat16"),
    (2, 512, 4096, 16, 16, 64, False, 0, "bfloat16"),
    (4, 1, 4096, 16, 16, 64, False, 0, "bfloat16"),
    (4, 256, 256, 16, 16, 64, True, 0, "bfloat16"),
    (2, 512, 512, 16, 16, 64, True, 0, "bfloat16"),
    (8, 2048, 2048, 32, 32, 64, True, 0, "bfloat16"),
    (4, 1024, 1024, 32, 32, 64, True, 0, "bfloat16"),
]
# Tolerance (atol, rtol) of the flash forward against its plain versions
# (inputs ~N(0, 1)), |got - want| <= atol + rtol |want| on o, by case name
# and dtype.  "flash_fwd", the plain version with f32 probabilities as the
# kernel keeps them: in f32 both sum the same f32 products in another
# order; in bf16 each rounds o to bf16 once, so they differ by a few ulps
# (2^-8 to 2^-7 of |o|), which the relative term carries; the absolute one
# only covers o near 0 (rows over many keys have |o| of a few hundredths).
# "flash_fwd, bf16 P", the JAX package's jnp form, which rounds the
# unnormalised probabilities to bf16 before PV: an error of up to 2^-8 of
# each p |v| that does not shrink with |o| where the v's cancel (0.0022 at
# |o| = 0.007 on a 17-key row, seen on the CPU), so 2e-2 absolute.  The
# softmax stats m, l (f32 in both) within 1e-5 relative.
FLASH_TOL = {"flash_fwd": {"torch.float32": (2e-5, 2e-5),
                           "torch.bfloat16": (2e-3, 2e-2)},
             "flash_fwd, bf16 P": {"torch.bfloat16": (2e-2, 2e-2)}}
STATS_RTOL = 1e-5


def _flash_inputs(torch, gen, b, s, t, nq, nkv, d, dtype, strided=False):
    """q [B,S,H,D], k/v [B,T,KVH,D] ~N(0, 1) on the card; ``strided``
    slices them out of one fused [B, S, (H + 2 KVH) D] projection, as
    views (S == T)."""
    dt = getattr(torch, dtype)
    if strided:
        qkv = torch.randn((b, s, (nq + 2 * nkv) * d), generator=gen)
        qkv = qkv.to(dt).cuda()
        q = qkv[..., :nq * d].unflatten(-1, (nq, d))
        k = qkv[..., nq * d:(nq + nkv) * d].unflatten(-1, (nkv, d))
        v = qkv[..., (nq + nkv) * d:].unflatten(-1, (nkv, d))
        return q, k, v
    return tuple(torch.randn(sh, generator=gen).to(dt).cuda()
                 for sh in ((b, s, nq, d), (b, t, nkv, d), (b, t, nkv, d)))


# (B, S, T, H, KVH, D, causal, window, dtype, strided): f32 and bf16,
# causal and bidirectional, windows 0, 64 and 512, g = 1, 2, 4, 6 and MQA,
# D = 8 to 256, S not a multiple of the 64-row tile, S != T, rows with no
# visible key (S > T + window), one row; strided q/k/v views of a fused
# projection with do a transposed [B, H, S, D] view; the VLM's
# cross-attention shapes and the MoE's and VLM's self-attention (g = 8)
FLASH_BWD_CASES = [
    (1, 128, 128, 4, 4, 32, True, 0, "float32", False),
    (2, 128, 128, 4, 2, 32, True, 0, "float32", False),
    (1, 256, 256, 8, 1, 16, True, 0, "float32", False),
    (1, 128, 128, 4, 4, 32, False, 0, "float32", False),
    (1, 256, 256, 2, 2, 32, True, 64, "float32", False),
    (1, 128, 128, 4, 2, 32, True, 0, "bfloat16", False),
    (2, 100, 100, 12, 2, 64, True, 0, "bfloat16", False),
    (1, 333, 333, 12, 2, 128, True, 0, "bfloat16", False),
    (1, 300, 300, 12, 2, 128, True, 64, "float32", False),
    (1, 600, 600, 4, 1, 256, True, 512, "bfloat16", False),
    (1, 200, 200, 4, 1, 256, False, 0, "float32", False),
    (1, 130, 130, 2, 1, 256, True, 64, "float32", False),
    (2, 200, 100, 4, 2, 16, True, 40, "float32", False),
    (1, 150, 150, 4, 2, 64, False, 64, "bfloat16", False),
    (2, 100, 150, 4, 2, 32, False, 0, "bfloat16", False),
    (1, 70, 70, 2, 1, 8, True, 0, "bfloat16", False),
    (1, 1, 1, 2, 2, 64, True, 0, "float32", False),
    (2, 190, 190, 6, 2, 32, True, 40, "bfloat16", True),
    (1, 129, 129, 4, 2, 128, True, 0, "float32", True),
    (1, 520, 520, 12, 2, 128, True, 512, "float32", True),
    # the bf16 kernels' tile edges, as in FLASH_CASES, and one query head
    # a kv head (the dkv kernel writes dk, dv without partials)
    (1, 127, 127, 4, 2, 64, True, 0, "bfloat16", False),
    (1, 150, 150, 4, 4, 128, True, 0, "bfloat16", False),
    (2, 129, 129, 6, 2, 128, True, 0, "bfloat16", False),
    (1, 129, 100, 4, 2, 128, False, 0, "bfloat16", False),
    (2, 1024, 1024, 12, 2, 128, True, 0, "bfloat16", False),
    (1, 300, 300, 4, 2, 128, True, 100, "bfloat16", True),
    (1, 200, 200, 8, 1, 256, True, 0, "bfloat16", False),
    (1, 200, 70, 4, 2, 64, True, 30, "bfloat16", False),
    # the VLM's cross-attention, as in FLASH_CASES: T4 runs the f32 one
    (1, 1024, 1601, 32, 8, 128, False, 0, "bfloat16", False),
    (1, 1024, 1601, 32, 8, 128, False, 0, "float32", False),
    (2, 1, 1601, 32, 8, 128, False, 0, "float32", False),
    # the self-attention of T3 (GQA 8:1: eight dk/dv partials summed a kv
    # head) and of T4 (GQA 4:1), as in FLASH_CASES
    (2, 1024, 1024, 32, 4, 128, True, 0, "bfloat16", False),
    (1, 1024, 1024, 32, 8, 128, True, 0, "bfloat16", False),
    # the enc-dec's, as in FLASH_CASES (T7's microbatch of 2: the
    # encoder over 4,096 frames, the decoder's cross-attention at 512
    # and at S = 256 and 1, its causal self-attention at 512), and
    # zamba2's shared block, causal at S6's prompt and T6's microbatch
    (2, 4096, 4096, 16, 16, 64, False, 0, "bfloat16", False),
    (2, 512, 4096, 16, 16, 64, False, 0, "bfloat16", False),
    (2, 256, 4096, 16, 16, 64, False, 0, "bfloat16", False),
    (2, 1, 4096, 16, 16, 64, False, 0, "bfloat16", False),
    (2, 512, 512, 16, 16, 64, True, 0, "bfloat16", False),
    (1, 2048, 2048, 32, 32, 64, True, 0, "bfloat16", False),
    (4, 1024, 1024, 32, 32, 64, True, 0, "bfloat16", False),
]
# Tolerance (a, rtol) of the flash backward's dq, dk, dv (inputs and do
# ~N(0, 1)): |got - want| <= a max(max|want|, 1) + rtol |want| per tensor,
# by case name and dtype; stated before the first run on the card.  (The
# floor of 1 is the inputs' scale: with one key the softmax is constant
# and autograd's dq, dk are exactly 0, the recompute's a few 1e-8.)  "flash_bwd",
# against the plain backward on the same (o, m, l): the same f32 math
# summed in another order, about 1e-6 of the largest |value| in f32; in
# bf16 both round once to bf16, so they differ by a bf16 ulp or two, which
# the relative term carries (the forward's 2e-3 / 2e-2, the absolute term
# scaled to the tensor).  "flash_bwd, autograd", against
# torch.autograd.grad of the plain forward: in bf16 the kernel takes
# delta = sum o do from the bf16-rounded o, as the Pallas kernel does, so
# each row's ds moves by up to 2^-8 |delta| (up to 6e-3 of the largest
# |value| on the CPU): 1e-2.
FLASH_BWD_TOL = {"flash_bwd": {"torch.float32": (1e-4, 1e-4),
                               "torch.bfloat16": (2e-3, 2e-2)},
                 "flash_bwd, autograd": {"torch.float32": (1e-4, 1e-4),
                                         "torch.bfloat16": (1e-2, 2e-2)}}


def _plain_grads(torch, fa, q, k, v, do, kw):
    """torch.autograd.grad of the plain forward: (dq, dk, dv)."""
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        o = fa._flash_fwd_ref(*xs, **kw)[0]
        return torch.autograd.grad(o, xs, do)


def flash_bwd_cases(torch, gen):
    """The flash backward against its plain version on the kernel
    forward's (o, m, l), and against autograd of the plain forward."""
    from repro_torch.kernels import flash_attention as fa
    cases = []
    for (b, s, t, nq, nkv, d, causal, window, dtype,
         strided) in FLASH_BWD_CASES:
        q, k, v = _flash_inputs(torch, gen, b, s, t, nq, nkv, d, dtype,
                                strided=strided)
        dt = getattr(torch, dtype)
        if strided:
            do = torch.randn((b, nq, s, d), generator=gen).to(dt).cuda()
            do = do.transpose(1, 2)
        else:
            do = torch.randn((b, s, nq, d), generator=gen).to(dt).cuda()
        kw = dict(causal=causal, window=window)
        o, m, l = fa.flash_fwd(q, k, v, **kw)
        a = (q, k, v, o, m, l, do)
        cases.append(("flash_bwd",
                      lambda a=a, kw=kw: fa.flash_bwd(*a, **kw),
                      lambda a=a, kw=kw: fa._flash_bwd_ref(*a, **kw)))
        cases.append(("flash_bwd, autograd",
                      lambda a=a, kw=kw: fa.flash_bwd(*a, **kw),
                      lambda q=q, k=k, v=v, do=do, kw=kw: _plain_grads(
                          torch, fa, q, k, v, do, kw)))
    return cases


def flash_cases(torch, gen):
    """The flash forward against its plain version (f32 probabilities, as
    the kernel keeps them) and, in bf16, also against the plain version
    with the probabilities rounded to bf16 (the JAX package's jnp form)."""
    from repro_torch.kernels import flash_attention as fa
    cases = []
    for i, (b, s, t, nq, nkv, d, causal, window, dtype) in enumerate(
            FLASH_CASES + [(2, 190, 190, 6, 2, 32, True, 40, "bfloat16"),
                           (1, 129, 129, 4, 2, 128, True, 0, "float32")]):
        q, k, v = _flash_inputs(torch, gen, b, s, t, nq, nkv, d, dtype,
                                strided=i >= len(FLASH_CASES))
        kw = dict(causal=causal, window=window)
        cases.append(("flash_fwd",
                      lambda q=q, k=k, v=v, kw=kw: fa.flash_fwd(q, k, v, **kw),
                      lambda q=q, k=k, v=v, kw=kw: fa._flash_fwd_ref(
                          q, k, v, **kw)))
        if dtype == "bfloat16":
            cases.append(("flash_fwd, bf16 P",
                          lambda q=q, k=k, v=v, kw=kw: fa.flash_fwd(
                              q, k, v, **kw),
                          lambda q=q, k=k, v=v, kw=kw: fa._flash_fwd_ref(
                              q, k, v, p_dtype=torch.bfloat16, **kw)))
    return cases


def case_error(torch, name, got, want):
    """(max abs error, within tolerance) of case ``name``'s kernel result
    against its plain version: integer results exactly; the flash
    forward's (o, m, l) within FLASH_TOL[name] (o) and STATS_RTOL (m, l);
    the flash backward's (dq, dk, dv) within FLASH_BWD_TOL[name]."""
    if name.startswith("flash_bwd"):
        err, ok = 0.0, True
        for g, w in zip(got, want):
            if (g.shape, g.dtype) != (w.shape, w.dtype):
                return math.inf, False
            if not g.numel():
                continue
            a, rtol = FLASH_BWD_TOL[name][str(g.dtype)]
            g, w = g.float(), w.float()
            err = max(err, float((g - w).abs().max()))
            ok &= torch.allclose(g, w, rtol=rtol,
                                 atol=a * max(float(w.abs().max()), 1.0))
        return err, ok
    if isinstance(got, tuple):
        (o, m, l), (wo, wm, wl) = got, want
        if (o.shape, o.dtype, m.shape, l.shape) != (wo.shape, wo.dtype,
                                                    wm.shape, wl.shape):
            return math.inf, False
        atol, rtol = FLASH_TOL[name][str(o.dtype)]
        err = float((o.float() - wo.float()).abs().max()) if o.numel() else 0.
        close = torch.allclose(o.float(), wo.float(), rtol=rtol, atol=atol)
        stats = all(torch.allclose(a, w, rtol=STATS_RTOL, atol=STATS_RTOL)
                    for a, w in ((m, wm), (l, wl)))
        return err, close and stats
    if got.shape != want.shape or got.dtype != want.dtype:
        return math.inf, False
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    return err, err == 0


def compare(torch, name, got, want, errs):
    torch.cuda.synchronize()
    err, ok = case_error(torch, name, got, want)
    errs[name] = max(errs.get(name, 0), err)
    if not ok:
        fail(f"{name}: kernel differs from its plain version beyond its "
             f"tolerance (max |diff| = {err})")
    return err


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def make_data(seed):
    rng = np.random.default_rng(seed)
    d1, n1 = 14_000, 4_000_000
    F = {"src": rng.integers(0, d1, n1).astype(np.int32),
         "dst": rng.integers(0, d1, n1).astype(np.int32)}
    hot = 7
    extra = 1500
    F4 = {"src": np.concatenate([F["src"], np.full(extra, hot, np.int32),
                                 rng.integers(0, d1, extra).astype(np.int32)]),
          "dst": np.concatenate([F["dst"],
                                 rng.integers(0, d1, extra).astype(np.int32),
                                 np.full(extra, hot, np.int32)])}
    d2 = 100_000
    star = {"r": {"a": rng.integers(0, d2, 100_000).astype(np.int32),
                  "b": rng.integers(0, d2, 100_000).astype(np.int32)},
            "s": {"b": rng.integers(0, d2, 20_000_000).astype(np.int32),
                  "c": rng.integers(0, d2, 20_000_000).astype(np.int32)},
            "t": {"c": rng.integers(0, d2, 100_000).astype(np.int32),
                  "d": rng.integers(0, d2, 100_000).astype(np.int32)}}
    d5, n5 = 1_000_000, 1_000_000
    chain = {f"r{i + 1}": {k1: rng.integers(0, d5, n5).astype(np.int32),
                           k2: rng.integers(0, d5, n5).astype(np.int32)}
             for i, (k1, k2) in enumerate(["ab", "bc", "cd", "de"])}
    d6, n6 = 3_500, 1_000_000
    F6 = {"src": rng.integers(0, d6, n6).astype(np.int32),
          "dst": rng.integers(0, d6, n6).astype(np.int32)}
    return {"F": F, "F4": F4, "star": star, "chain": chain, "F6": F6,
            "d": {"F": d1, "star": d2, "chain": d5, "F6": d6}}


def linear_oracle(F, d):
    """Σ over f2's rows of indeg(src) · outdeg(dst) for f1.dst = f2.src,
    f2.dst = f3.src over one edge list F (int64, numpy)."""
    indeg = np.bincount(F["dst"], minlength=d).astype(np.int64)
    outdeg = np.bincount(F["src"], minlength=d).astype(np.int64)
    return int(np.sum(indeg[F["src"]] * outdeg[F["dst"]]))


def star_oracle(star, d):
    cnt_r = np.bincount(star["r"]["b"], minlength=d).astype(np.int64)
    cnt_t = np.bincount(star["t"]["c"], minlength=d).astype(np.int64)
    return int(np.sum(cnt_r[star["s"]["b"]] * cnt_t[star["s"]["c"]]))


def trace3_oracle(torch, pairs, d):
    """trace(A1 A2 A3) with Ai the d x d count matrix of the i-th (row,
    column) key pair, in float64 on the card: every value is an integer
    far below 2^53, so it is exact.  A triangle R(a, b), S(b, c), T(c, a)
    is ``pairs = [(R.a, R.b), (S.b, S.c), (T.c, T.a)]``."""
    def matrix(rows, cols):
        m = torch.zeros((d, d), dtype=torch.float64, device="cuda")
        r = torch.as_tensor(rows, device="cuda").long()
        c = torch.as_tensor(cols, device="cuda").long()
        m.index_put_((r, c), torch.ones_like(r, dtype=torch.float64),
                     accumulate=True)
        return m
    prod = matrix(*pairs[0]) @ matrix(*pairs[1])
    total = float((prod * matrix(*pairs[2]).T).sum())
    del prod
    torch.cuda.empty_cache()
    if total >= 2**53:
        fail("trace oracle left the exact float64 range")
    return int(round(total))


def triangle_oracle(torch, F, d):
    """trace(A^3) with A the d x d edge-count matrix of one edge list."""
    return trace3_oracle(torch, [(F["src"], F["dst"])] * 3, d)


def chain_oracle(chain, d):
    """Weight backflow r4 -> r1 over r1.b=r2.b, r2.c=r3.c, r3.d=r4.d."""
    w4 = np.bincount(chain["r4"]["d"], minlength=d).astype(np.int64)
    w3 = w4[chain["r3"]["d"]]
    w3c = np.zeros(d, np.int64)
    np.add.at(w3c, chain["r3"]["c"], w3)
    w2 = w3c[chain["r2"]["c"]]
    w2b = np.zeros(d, np.int64)
    np.add.at(w2b, chain["r2"]["b"], w2)
    return int(np.sum(w2b[chain["r1"]["b"]]))


def per_key_oracle(F, d):
    """Per f1.src key: Σ over its f1 rows of the linear counts."""
    outdeg = np.bincount(F["src"], minlength=d).astype(np.int64)
    w2 = np.zeros(d, np.int64)
    np.add.at(w2, F["src"], outdeg[F["dst"]])
    per_row = w2[F["dst"]]
    out = np.zeros(d, np.int64)
    np.add.at(out, F["src"], per_row)
    return out


def timed_execute(torch, sess, query, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.execute(query, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_query(torch, sess, label, query, want, checks=(), **kw):
    res, cold = timed_execute(torch, sess, query, **kw)
    warm = []
    for _ in range(WARM):
        r2, t = timed_execute(torch, sess, query, **kw)
        warm.append(t)
        if int(r2.count) != int(res.count) or r2.rounds != res.rounds:
            fail(f"{label}: warm execute disagrees with the cold one")
    if bool(res.overflowed):
        fail(f"{label}: overflowed")
    if int(res.count) != want:
        fail(f"{label}: count {int(res.count)} != oracle {want}")
    for check in checks:
        check(res)
    row = {"query": label, "kind": res.kind, "strategy": res.strategy,
           "count": int(res.count), "oracle": want, "rounds": res.rounds,
           "tuples_read": int(res.tuples_read), "cold_s": cold,
           "warm_median_s": statistics.median(warm), "warm_s": warm}
    log(f"[main] {json.dumps(row)}")
    return res, row


def main_path(torch, data):
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.query import Query
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda

    def rels(d):
        return relation_from_numpy(d)

    F = rels(data["F"])
    lin = Query({"f1": F, "f2": F, "f3": F},
                [("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    st = data["star"]
    star = Query({k: rels(v) for k, v in st.items()},
                 [("r.b", "s.b"), ("s.c", "t.c")])
    tri = Query({"f1": F, "f2": F, "f3": F},
                [("f1.dst", "f2.src"), ("f2.dst", "f3.src"),
                 ("f3.dst", "f1.src")])
    F4 = rels(data["F4"])
    skew = Query({"f1": F4, "f2": F4, "f3": F4},
                 [("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    chain = Query({k: rels(v) for k, v in data["chain"].items()},
                  [("r1.b", "r2.b"), ("r2.c", "r3.c"), ("r3.d", "r4.d")])
    F6 = rels(data["F6"])
    per_r = Query({"f1": F6, "f2": F6, "f3": F6},
                  [("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    torch.cuda.synchronize()

    log("[main] oracles ...")
    t0 = time.perf_counter()
    want = {"Q1": linear_oracle(data["F"], data["d"]["F"]),
            "Q2": star_oracle(st, data["d"]["star"]),
            "Q3": triangle_oracle(torch, data["F"], data["d"]["F"]),
            "Q4": linear_oracle(data["F4"], data["d"]["F"]),
            "Q5": chain_oracle(data["chain"], data["d"]["chain"]),
            "Q6": linear_oracle(data["F6"], data["d"]["F6"])}
    key_sums = per_key_oracle(data["F6"], data["d"]["F6"])
    log(f"[main] oracles {json.dumps(want)} in "
        f"{time.perf_counter() - t0:.1f}s")

    def rounds_at_least_2(res):
        if res.rounds < 2:
            fail(f"Q4: expected recovery rounds >= 2, got {res.rounds}")

    def binary_feeds_fused3(res):
        ops_ = [s.op for s in res.plan.steps]
        if not (ops_[-1] == "fused3" and "binary" in ops_[:-1]):
            fail(f"Q5 3way: plan is {ops_}, expected binary -> fused3")

    def per_key_sums(res):
        p = res.per_r
        keys = p.keys[p.valid].long()
        sums = torch.zeros(len(key_sums), dtype=torch.int64, device="cuda")
        sums.index_add_(0, keys, p.counts[p.valid])
        if not np.array_equal(sums.cpu().numpy(), key_sums):
            fail("Q6: per-key sums differ from the numpy oracle")

    sess = JoinSession(m_budget=M_BUDGET)
    cuda.reset_launch_counts()
    rows, results = [], {}
    for label, q, kw, checks in [
            ("Q1", lin, dict(strategy="3way"), ()),
            ("Q2", star, dict(strategy="3way"), ()),
            ("Q3", tri, {}, ()),
            ("Q4", skew, dict(strategy="3way"), (rounds_at_least_2,)),
            ("Q5", chain, dict(strategy="3way"), (binary_feeds_fused3,)),
            ("Q5", chain, dict(strategy=None), ()),
            ("Q6", per_r, dict(per_r=True, key_col="src"),
             (per_key_sums,))]:
        res, row = run_query(torch, sess, label, q, want[label], checks, **kw)
        row["strategy_arg"] = kw.get("strategy", "default")
        rows.append(row)
        results[label, row["strategy_arg"]] = res
        if label == "Q5" and kw["strategy"] is None:
            log(f"[main] Q5 strategy=None: planner chose "
                f"{res.strategy}:\n{res.plan.describe()}")
    launches = dict(cuda.LAUNCHES)
    log(f"[main] kernel launches on the main path: {json.dumps(launches)}")
    for name in cuda.FUSED_KERNELS:
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main path")
    queries = {"Q1": lin, "Q2": star, "Q3": tri, "Q6": per_r}
    return rows, launches, results, queries, want, key_sums


# --------------------------------------------------------------------------
# phase 9: kernels at the main path's first-round layouts
# --------------------------------------------------------------------------

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


def kernel_ms(torch, fn, reps=5, tries=3):
    """Device ms of the kernels one call of ``fn`` launches: their sum and
    each by name, the mean over ``reps`` calls traced by ``torch.profiler``
    (host and device; the device events are the kernels).  The trace's
    first step is the profiler's warm-up (``reps`` calls, their records
    dropped): late in a long process the first two kernel launches after
    a trace starts leave no record (seen on the H100 with torch 2.11 after
    the serving and training phases: 3 of 5 flash_fwd calls recorded; with
    a warm-up step of 2 calls, 5 of 5).  A trace in which a kernel does
    not appear a multiple of ``reps`` times, or that holds no device
    event, measured nothing: it is taken again, up to ``tries`` times in
    all (the radix histogram's trace came back empty once), and where
    every try failed the sum is None and the third value says why."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        by_name, why = _traced_kernels(torch, fn, reps)
        if why is None:
            return sum(by_name.values()), by_name, None
        log(f"[kernel] {why}")
    return None, {}, why


def _traced_kernels(torch, fn, reps):
    """One ``kernel_ms`` trace: device ms by kernel name, or why not."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):   # the warm-up step, then the traced one
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by_name, count = {}, {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        # device events: the kernels (the step's own annotation excluded)
        if (e.device_type.name == "CUDA" and us > 0
                and not e.key.startswith("ProfilerStep")):
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + us / 1e3 / reps
            count[e.key[:60]] = count.get(e.key[:60], 0) + e.count
    partial = {k: n for k, n in count.items() if n % reps}
    if not by_name or partial:
        return {}, (f"not measured: the trace of {reps} calls holds "
                    + (f"kernels seen a number of times that is not a "
                       f"multiple of {reps}: {partial}" if partial
                       else "no device event"))
    return by_name, None


def nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def first_round_layout(results, queries, label, strategy):
    """The round-1 layouts the engine built for a single-fused-step query,
    rebuilt by the recovery loop's own round pass (same plan, same salt,
    same capacity sizing)."""
    from repro_torch.core import recovery
    step = results[label, strategy].plan.root
    rels = {role: queries[label].relations[name] for role, name in step.roles}
    cols = dict(step.cols)
    ops_ = recovery.OPS[step.kind](**cols)
    plan, _, lay = recovery._round_pass(ops_, rels, step.shape_plan,
                                        salt=0, final=False)
    return plan, (lay["r"], lay["s"], lay["t"]), cols


def n_live(torch, ops, x, side, dims):
    return (x != ops._SENT[side]).to(torch.int64).sum(dims)


def search_steps(torch, n):
    """Binary-search steps over sorted rows of n live entries."""
    return torch.ceil(torch.log2(n.to(torch.float64) + 1)).to(torch.int64)


def cyclic_table_ops(torch, ops, ra, sb, tc, ta):
    """The triangle sweep's bit-row formulation over the fused grid (masked
    R [hp, gp, uh, ug, Cr], S [gp, fp, ug, Cs], T [hp, fp, uh, Ct]), one
    operation per table probe or row word: two probes per live T entry
    (its a and c), and for every (cell, f) whose R cell, S bucket and T
    row all hold live entries, two per R entry (its a and b) and, per S
    entry, two probes (its b and c rows) and the W words of the rows' AND
    (W = 4 where the T row has at most 128 distinct a, else 8).  The scan's
    (f, a, b) grid of one (H, G) cell is the fused grid with hp = gp = 1."""
    n_s = n_live(torch, ops, sb, "s", -1)               # [gp, fp, ug]
    n_r = n_live(torch, ops, ra, "r", -1)               # [hp, gp, uh, ug]
    n_t = n_live(torch, ops, tc, "t", -1)               # [hp, fp, uh]
    # [i, j, a, b, f]: the (cell, f) passes the kernel makes
    s5 = n_s.permute(0, 2, 1)[None, :, None, :, :]     # [1, gp, 1, ug, fp]
    t5 = n_t.permute(0, 2, 1)[:, None, :, None, :]     # [hp, 1, uh, 1, fp]
    r5 = n_r[..., None]
    active = ((r5 > 0) & (s5 > 0) & (t5 > 0)).to(torch.int64)
    ta_sorted = torch.sort(ta, dim=-1).values          # [hp, fp, uh, ct]
    dead_t = ops._SENT["t"]
    n_a = (((ta_sorted[..., 1:] != ta_sorted[..., :-1])
            & (ta_sorted[..., 1:] != dead_t)).sum(-1)
           + (ta_sorted[..., 0] != dead_t))
    words = torch.where(n_a <= 128, 4, 8).permute(0, 2, 1)[:, None, :, None, :]
    return int(2 * n_t.sum() + (active * 2 * r5).sum()
               + (active * s5 * (2 + words)).sum())


def sorts_and_masks(by_name):
    """The sort and elementwise kernels among a trace's kernels by name."""
    return [k for k in by_name
            if "sort" in k.lower() or "elementwise" in k.lower()]


def record_kernel(torch, lines, errs, launches, name, shape_note, kern,
                  plain, out_bytes, steps, line=True, rate=INT32_OPS_PER_S,
                  library=None, extra=None, clean=False):
    """Hold one kernel against its plain version at a layout, time both
    (and ``library``, one PyTorch call computing the same function, where
    there is one), and put its entry in the ``kernels`` line.  Its bound
    is the larger of ``out_bytes`` (inputs read once, output written once)
    over the HBM rate and ``steps`` operations over ``rate``.  ``ms`` is
    one call of the op as the main path makes it; ``kernel_ms`` the device
    time of the kernels that call launches (``kernel_ms_by_name`` each,
    the sort and elementwise ones among them in ``sorts_and_masks``,
    which must be empty where ``clean``)."""
    from repro_torch.kernels import cuda
    got = kern()
    want = plain()
    compare(torch, name, got, want, errs)
    del got, want
    ms = time_ms(torch, kern)
    k_ms, k_by_name, k_missing = kernel_ms(torch, kern)
    plain_ms = time_ms(torch, plain, reps=3)
    library_ms = None if library is None else time_ms(torch, library)
    t_bytes = out_bytes / HBM_BYTES_PER_S
    t_ops = steps / rate
    src, replaces = cuda.SOURCES[name]
    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms, "kernel_ms": k_ms,
             "kernel_ms_by_name": k_by_name,
             "sorts_and_masks": sorts_and_masks(k_by_name),
             **({"kernel_ms_missing": k_missing} if k_missing else {}),
             "plain_ms": plain_ms,
             "bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms, "shape": shape_note,
             "ops": steps, "ops_per_s": rate, "bytes": out_bytes,
             **(extra or {})}
    log(f"[kernel] {json.dumps(entry)}")
    if clean and entry["sorts_and_masks"]:
        fail(f"{name} ({shape_note}) launched a sort or an elementwise "
             f"kernel: {entry['sorts_and_masks']}")
    if line:
        lines.append(entry)


def linear_terms(torch, ops, args):
    """The linear fused kernel's plain inputs and bound terms at a layout
    (``args`` as ``ops.fused_count3_linear`` takes them): the masked
    grids, a shape note, the T-row and R-row search steps of the live S
    slots (two each), the per-R gather's steps, and the count and per-R
    outputs' bytes."""
    rb, rv, sb, sc, sv, tc, tv = args
    m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                      (tc, tv, "t")])
    hp, u, cr = rb.shape
    _, gp, _, cs = sb.shape
    ct = tc.shape[1]
    n_s = n_live(torch, ops, m[1], "s", -1)             # [hp, gp, u]
    n_r = n_live(torch, ops, m[0], "r", -1)             # [hp, u]
    lg_r = search_steps(torch, n_r)
    lg_t = search_steps(torch, n_live(torch, ops, m[3], "t", -1))  # [gp]
    t_steps = int((n_s * 2 * lg_t[None, :, None]).sum())
    r_steps = int((n_s * 2 * lg_r[:, None, :]).sum())
    shape = f"hp={hp} gp={gp} u={u} Cr={cr} Cs={cs} Ct={ct}"
    return m, shape, t_steps, r_steps, int((n_r * lg_r).sum()), \
        hp * u * 4, hp * u * cr * 4


def record_cyclic(torch, ops, record, args, note, **kw):
    """Record the pair-index kernel at a layout (``args`` as
    ``ops.fused_count3_cyclic`` takes them).  The sorted formulation:
    every live S slot of bucket (j, f, b) is visited by the hp * uh cells
    (i, a): two searches of the R cell (i, j, a, b) and two of the T row
    (i, f, a) per visit, and two steps per matching pair.  The kernel's
    bit-row formulation: ``cyclic_table_ops``.  The bound takes the
    smaller count."""
    names = ("ra", "rb", "sb", "sc", "tc", "ta")
    raw = dict(zip(names, (args[0], args[1], args[3], args[4], args[6],
                           args[7])))
    valid = {"r": args[2], "s": args[5], "t": args[8]}
    m = _masked(ops, [(raw[k], valid[k[0]], k[0]) for k in names])
    hp, gp, uh, ug, cr = raw["ra"].shape
    _, fp, _, cs = raw["sb"].shape
    ct = raw["tc"].shape[-1]
    rkeys = raw["rb"][valid["r"]].long()
    skeys = raw["sb"][valid["s"]].long()
    top = int(max(rkeys.max(), skeys.max())) + 1
    pairs = int((torch.bincount(rkeys, minlength=top)
                 * torch.bincount(skeys, minlength=top)).sum())
    del rkeys, skeys
    n_s = n_live(torch, ops, m[2], "s", -1)             # [gp, fp, ug]
    n_r = n_live(torch, ops, m[0], "r", -1)             # [hp, gp, uh, ug]
    n_t = n_live(torch, ops, m[4], "t", -1)             # [hp, fp, uh]
    lg_r, lg_t = search_steps(torch, n_r), search_steps(torch, n_t)
    r_visit = int((lg_r * n_s.sum(1)[None, :, None, :]).sum())
    t_visit = int((lg_t * n_s.sum((0, 2))[None, :, None]).sum())
    search_ops = 2 * (r_visit + t_visit) + 2 * pairs
    table_ops = cyclic_table_ops(torch, ops, m[0], m[2], m[4], m[5])
    record("fused_count3_cyclic_pairidx",
           f"{note}: hp={hp} gp={gp} uh={uh} ug={ug} fp={fp} Cr={cr} "
           f"Cs={cs} Ct={ct}; matching (s, r) pairs={pairs}",
           lambda: ops.fused_count3_cyclic(*args),
           lambda: ops._fused_cyclic_pairidx_ref(*m),
           nbytes(*m) + hp * gp * uh * ug * 4, min(search_ops, table_ops),
           extra={"ops_search": search_ops, "ops_tables": table_ops}, **kw)


def kernel_phase(torch, ops, errs, launches, results, queries):
    """Each fused kernel at its main-path layout, against its plain version
    and its bound.  The bound is the larger of two times: the bytes of the
    function's inputs (each read once) and output (written once) over the
    HBM rate, and the search steps the sorted-bucket formulation needs on
    this run's data over the 32-bit issue rate: two binary searches
    (ceil(log2(n + 1)) steps each, n the live entries of the row) per live
    probing slot and probed row, plus, for cyclic, two steps per matching
    (s, r) pair."""
    lines = []

    def live(x, side, dims):
        return n_live(torch, ops, x, side, dims)

    def _steps(n):
        return search_steps(torch, n)

    def record(*a, **kw):
        record_kernel(torch, lines, errs, launches, *a, **kw)

    def linear_layout(label, strategy):
        _, (rg, sg, tg), cols = first_round_layout(results, queries, label,
                                                   strategy)
        args = (rg.columns[cols["rb"]], rg.valid, sg.columns[cols["sb"]],
                sg.columns[cols["sc"]], sg.valid, tg.columns[cols["tc"]],
                tg.valid)
        m, shape, *terms = linear_terms(torch, ops, args)
        return (args, m, f"{label} round 1: {shape}", *terms)

    # Q1: linear; the per-R kernel is also timed on Q1's layout (printed,
    # not in the kernels line: its main-path layout is Q6's)
    args, m, note, t_steps, r_steps, gather_steps, out_b, per_r_out_b = \
        linear_layout("Q1", "3way")
    record("fused_count3_linear", note,
           lambda: ops.fused_count3_linear(*args),
           lambda: ops._fused_linear_ref(*m),
           nbytes(*m) + out_b, t_steps + r_steps)
    record("fused_per_r_counts", note,
           lambda: ops.fused_per_r_counts(*args),
           lambda: ops._fused_per_r_ref(*m),
           nbytes(*m) + per_r_out_b, t_steps + r_steps // 2 + gather_steps,
           line=False)
    del args, m

    # Q6: the per-R kernel at its own main-path layout: two searches of
    # the T row and one of the R row per live S slot, one of the R row per
    # live R slot to gather
    args, m, note, t_steps, r_steps, gather_steps, _, per_r_out_b = \
        linear_layout("Q6", "default")
    record("fused_per_r_counts", note,
           lambda: ops.fused_per_r_counts(*args),
           lambda: ops._fused_per_r_ref(*m),
           nbytes(*m) + per_r_out_b, t_steps + r_steps // 2 + gather_steps)
    del args, m

    # Q2: star
    _, (rg, sg, tg), cols = first_round_layout(results, queries, "Q2", "3way")
    rb, sb, sc, tc = (rg.columns[cols["rb"]], sg.columns[cols["sb"]],
                      sg.columns[cols["sc"]], tg.columns[cols["tc"]])
    args = (rb, rg.valid, sb, sc, sg.valid, tc, tg.valid)
    m = _masked(ops, [(rb, rg.valid, "r"), (sb, sg.valid, "s"),
                      (sc, sg.valid, "s"), (tc, tg.valid, "t")])
    uh, cr = rb.shape
    ch, _, ug, cs = sb.shape
    ct = tc.shape[1]
    n_s = live(m[1], "s", -1).sum(0)                    # [uh, ug]
    lg_r = _steps(live(m[0], "r", -1))                  # [uh]
    lg_t = _steps(live(m[3], "t", -1))                  # [ug]
    steps = int((n_s * 2 * (lg_r[:, None] + lg_t[None, :])).sum())
    record("fused_count3_star",
           f"Q2 round 1: uh={uh} ug={ug} chunks={ch} Cr={cr} Cs={cs} Ct={ct}",
           lambda: ops.fused_count3_star(*args),
           lambda: ops._fused_star_ref(*m),
           nbytes(*m) + uh * ug * 4, steps)
    del args, m, rg, sg, tg

    # Q3: cyclic, its bound as ``record_cyclic`` states
    _, (rg, sg, tg), cols = first_round_layout(results, queries, "Q3",
                                               "default")
    args = (rg.columns[cols["ra"]], rg.columns[cols["rb"]], rg.valid,
            sg.columns[cols["sb"]], sg.columns[cols["sc"]], sg.valid,
            tg.columns[cols["tc"]], tg.columns[cols["ta"]], tg.valid)
    record_cyclic(torch, ops, record, args, "Q3 round 1")
    return lines


# --------------------------------------------------------------------------
# phase 5: the paper's baselines on the same data
# --------------------------------------------------------------------------

BASELINE_WARM = 3
# B4's graph: Q3's N/d of about 286 at a size the all-pairs forms finish
B4_USERS, B4_EDGES = 350, 100_000
LIN = dict(rb="dst", sb="src", sc="dst", tc="src")       # f1.dst = f2.src, ...
CYC = dict(ra="src", rb="dst", sb="src", sc="dst", tc="src", ta="dst")
STAR = dict(rb="b", sb="b", sc="c", tc="c")


def retries(plan0, final):
    """Whole-query retries from ``plan0`` to ``final`` (each doubles every
    capacity)."""
    from repro_torch.core import recovery
    n, p = 0, plan0
    while tuple(p) != tuple(final):
        p, n = recovery.grown(p, 2.0), n + 1
        if n > 8:
            fail(f"plan {final} is not a growth of {plan0}")
    return n


def run_baseline(torch, label, fn, want, fused_warm_s=None):
    """Run ``fn`` cold and BASELINE_WARM times warm.  ``fn`` returns a dict
    with at least ``count``; the count must equal ``want`` and nothing may
    have overflowed.  Prints one ``[baseline]`` line."""
    from repro_torch.kernels import cuda
    before = dict(cuda.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k: cuda.LAUNCHES[k] - before[k] for k in cuda.KERNELS
                if cuda.LAUNCHES[k] != before[k]}
    if row.pop("overflowed"):
        fail(f"{label}: overflowed")
    if row["count"] != want:
        fail(f"{label}: count {row['count']} != oracle {want}")
    warm = []
    for _ in range(BASELINE_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again["count"] != want:
            fail(f"{label}: a warm run disagrees with the cold one")
    row = {"baseline": label, "count": row.pop("count"), "oracle": want,
           **row, "launches": launches, "cold_s": cold,
           "warm_median_s": statistics.median(warm), "warm_s": warm}
    if fused_warm_s is not None:
        row["fused_execute_warm_s"] = fused_warm_s
    log(f"[baseline] {json.dumps(row)}")
    return row


def fused_count_s(torch, query, want):
    """Median warm seconds of the fused COUNT execute of ``query``."""
    from repro_torch.core.session import JoinSession
    sess = JoinSession(m_budget=M_BUDGET)
    times = []
    for _ in range(1 + BASELINE_WARM):
        res, t = timed_execute(torch, sess, query, strategy="3way")
        if int(res.count) != want or bool(res.overflowed):
            fail(f"fused COUNT execute gave {int(res.count)}, oracle {want}")
        times.append(t)
    return statistics.median(times[1:])


def baseline_phase(torch, data, main_rows, queries, want, key_sums, seed):
    """B1-B6: the scan drivers with their whole-query retry, the all-pairs
    cyclic forms and the binary baselines, each against an oracle
    independent of the port.  The launch counters are zeroed before the
    phase; every baseline kernel must have launched in it."""
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import (binary_join, cyclic3, engine, linear3,
                                  partition, reference, star3)
    from repro_torch.kernels import cuda

    fused = {(r["query"], r["strategy_arg"]): r["warm_median_s"]
             for r in main_rows}
    F = queries["Q1"].relations["f1"]
    st = queries["Q2"].relations
    F6 = queries["Q6"].relations["f1"]
    rows, layouts = [], {}
    cuda.reset_launch_counts()

    # B1: linear scan with whole-query retry on Q1's F
    n1 = len(data["F"]["src"])
    plan0 = linear3.default_plan(n1, n1, n1, m_budget=M_BUDGET)

    def b1():
        res, plan = reference.linear3_count_auto(F, F, F, plan0, **LIN)
        layouts["linear"] = plan
        return {"count": int(res.count), "overflowed": bool(res.overflowed),
                "tuples_read": int(res.tuples_read),
                "retries": retries(plan0, plan), "plan": list(plan)}

    rows.append(run_baseline(torch, "B1 linear3_count_auto on Q1", b1,
                             want["Q1"], fused["Q1", "3way"]))

    # B2: star scan on Q2's data
    plan0 = star3.default_plan(*(len(data["star"][k][c])
                                 for k, c in (("r", "b"), ("s", "b"),
                                              ("t", "c"))))

    def b2():
        res, plan = reference.star3_count_auto(st["r"], st["s"], st["t"],
                                               plan0, **STAR)
        layouts["star"] = plan
        return {"count": int(res.count), "overflowed": bool(res.overflowed),
                "tuples_read": int(res.tuples_read),
                "retries": retries(plan0, plan), "plan": list(plan)}

    rows.append(run_baseline(torch, "B2 star3_count_auto on Q2", b2,
                             want["Q2"], fused["Q2", "3way"]))

    # B3: per-R scan on Q6's F6, per-key sums against the numpy oracle
    n6 = len(data["F6"]["src"])
    plan0 = linear3.default_plan(n6, n6, n6, m_budget=M_BUDGET)

    def b3():
        (keys, counts, valid), plan = reference.linear3_per_r_counts_auto(
            F6, F6, F6, plan0, key_col="src", **LIN)
        layouts["per_r"] = plan
        sums = torch.zeros(len(key_sums), dtype=torch.int64, device="cuda")
        sums.index_add_(0, keys[valid].long(), counts[valid])
        if not np.array_equal(sums.cpu().numpy(), key_sums):
            fail("B3: per-key sums differ from the numpy oracle")
        return {"count": int(counts[valid].sum()), "overflowed": False,
                "retries": retries(plan0, plan), "plan": list(plan)}

    rows.append(run_baseline(torch, "B3 linear3_per_r_counts_auto on Q6",
                             b3, want["Q6"], fused["Q6", "default"]))

    # B4: the all-pairs cyclic forms on a graph cut from Q3's (N/d kept)
    rng = np.random.default_rng(seed + 1)
    d4, n4 = B4_USERS, B4_EDGES
    G = {"src": rng.integers(0, d4, n4).astype(np.int32),
         "dst": rng.integers(0, d4, n4).astype(np.int32)}
    E = relation_from_numpy(G)
    tri4 = triangle_oracle(torch, G, d4)
    for label, rel, n, oracle, fused_s in [
            ("B4", E, n4, tri4, None),
            ("B4q3", F, n1, want["Q3"], fused["Q3", "default"])]:
        plan0 = cyclic3.default_plan(n, n, n, m_budget=M_BUDGET)
        final = {}

        def scan(rel=rel, plan0=plan0, final=final, label=label):
            res, plan = reference.cyclic3_count_auto(
                rel, rel, rel, plan0, pair_index=False, **CYC)
            final["plan"] = plan
            layouts[label] = (rel, plan)
            return {"count": int(res.count),
                    "overflowed": bool(res.overflowed),
                    "tuples_read": int(res.tuples_read),
                    "retries": retries(plan0, plan), "plan": list(plan)}

        rows.append(run_baseline(
            torch, f"{label} cyclic3_count_auto(pair_index=False)", scan,
            oracle, fused_s))

        def fused_all_pairs(rel=rel, final=final):
            res = engine.cyclic3_count_fused(rel, rel, rel, final["plan"],
                                             pair_index=False, **CYC)
            return {"count": int(res.count),
                    "overflowed": bool(res.overflowed),
                    "tuples_read": int(res.tuples_read)}

        rows.append(run_baseline(
            torch, f"{label} engine.cyclic3_count_fused(pair_index=False)",
            fused_all_pairs, oracle))
        if label == "B4":
            def pair_index_scan(rel=rel, final=final):
                res = cyclic3.cyclic3_count(rel, rel, rel, final["plan"],
                                            pair_index=True, **CYC)
                return {"count": int(res.count),
                        "overflowed": bool(res.overflowed),
                        "tuples_read": int(res.tuples_read)}

            rows.append(run_baseline(
                torch, "B4 cyclic3_count(pair_index=True)", pair_index_scan,
                oracle))

    # B5: the cascade, intermediate sized exactly.  The main path runs Q6
    # per R; its fused COUNT is timed here for the comparison.
    q6_count_s = fused_count_s(torch, queries["Q6"], want["Q6"])
    for label, (r, s, t), cols, oracle, fused_s in [
            ("B5 cascaded_binary_count on Q6", (F6, F6, F6), LIN,
             want["Q6"], q6_count_s),
            ("B5 cascaded_binary_count on Q2", (st["r"], st["s"], st["t"]),
             STAR, want["Q2"], fused["Q2", "3way"])]:
        cap = binary_join.exact_join_count(r, cols["rb"], s, cols["sb"])

        def cascade(r=r, s=s, t=t, cols=cols, cap=cap, label=label):
            res = binary_join.cascaded_binary_count(r, s, t, cap, **cols)
            if res.intermediate_total != cap:
                fail(f"{label}: intermediate_total {res.intermediate_total}"
                     f" != exact pair count {cap}")
            return {"count": int(res.count),
                    "overflowed": bool(res.intermediate_overflowed),
                    "intermediate_total": res.intermediate_total}

        rows.append(run_baseline(torch, label, cascade, oracle, fused_s))

    # B6: bucketed binary join F.dst ⋈ F.src
    n_buckets = 4096
    cap = partition.suggest_capacity(n1, n_buckets, 2.5)
    while bool(binary_join.bucketed_join_count(F, "dst", F, "src", n_buckets,
                                               cap, cap)[1]):
        cap *= 2
    layouts["pair"] = (n_buckets, cap)
    d1 = data["d"]["F"]
    indeg = np.bincount(data["F"]["dst"], minlength=d1).astype(np.int64)
    outdeg = np.bincount(data["F"]["src"], minlength=d1).astype(np.int64)

    def b6():
        count, ovf = binary_join.bucketed_join_count(F, "dst", F, "src",
                                                     n_buckets, cap, cap)
        return {"count": int(count), "overflowed": bool(ovf),
                "n_buckets": n_buckets, "cap": cap}

    rows.append(run_baseline(torch, "B6 bucketed_join_count on Q1", b6,
                             int(np.sum(indeg * outdeg))))

    launches = dict(cuda.LAUNCHES)
    log(f"[baseline] kernel launches in the phase: {json.dumps(launches)}")
    for name in cuda.BASELINE_KERNELS:
        if launches[name] <= 0:
            fail(f"{name} was never launched in the baseline phase")
    layouts["relations"] = {"F": F, "F6": F6, "star": st}
    return rows, launches, layouts


def baseline_kernel_phase(torch, ops, errs, launches, layouts):
    """Each baseline kernel at the layout of its phase (the first step's
    layout for the scan kernels, at the plan that did not overflow),
    against its plain version and its bound (as in ``kernel_phase``; the
    all-pairs cyclic kernels add, per live R slot, the steps of its merge
    over the S run with b = r.b and the T run with a = r.a)."""
    from repro_torch.core import cyclic3, linear3, partition, star3
    lines = []

    def live(x, side):
        return n_live(torch, ops, x, side, -1)

    def steps(x, side):
        return search_steps(torch, live(x, side))

    def record(*a, **kw):
        record_kernel(torch, lines, errs, launches, *a, **kw)

    rels = layouts["relations"]
    # the scan kernels at the first H partition of B1 and B3
    for name, key, rel, kern, plain in [
            ("bucket_count3_linear", "linear", rels["F"],
             ops.bucket_count3_linear, ops._bucket_linear_ref),
            ("bucket_per_r_counts", "per_r", rels["F6"],
             ops.bucket_per_r_counts, ops._bucket_per_r_ref)]:
        plan = layouts[key]
        rg, sg, tg = linear3.layouts(rel, rel, rel, plan, **LIN)
        args = linear3._partition_rows(rg, sg, tg, 0, **LIN)
        rb, rv, sb, sc, sv, tc, tv = args
        m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                          (tc, tv, "t")])
        n_s = live(m[1], "s")                              # [gp, u]
        lg_r, lg_t = steps(m[0], "r"), steps(m[3], "t")    # [1, u], [gp, 1]
        gp, u = n_s.shape
        if name == "bucket_count3_linear":
            n_steps = int((n_s * 2 * (lg_r + lg_t)).sum())
            out_b = gp * u * 4
        else:   # + one search per R slot of every bucket to gather
            n_steps = int((n_s * (2 * lg_t + lg_r)).sum()
                          + gp * (live(m[0], "r") * lg_r).sum())
            out_b = gp * u * plan.r_cap * 4
        record(name, f"first H partition of the final plan {list(plan)}",
               lambda k=kern, a=args: k(*a), lambda p=plain, m=m: p(*m),
               nbytes(*m) + out_b, n_steps)
        del args, m

    # the linear scan kernel also at B2's first S chunk, the star scan's
    # layout (printed, not in the kernels line)
    plan = layouts["star"]
    st = rels["star"]
    rg, sg, tg = star3.layouts(st["r"], st["s"], st["t"], plan, **STAR)
    args = (rg.columns["b"][:, None], rg.valid[:, None], sg.columns["b"][0],
            sg.columns["c"][0], sg.valid[0], tg.columns["c"][None],
            tg.valid[None])
    rb, rv, sb, sc, sv, tc, tv = args
    m = _masked(ops, [(rb, rv, "r"), (sb, sv, "s"), (sc, sv, "s"),
                      (tc, tv, "t")])
    n_s = live(m[1], "s")                                  # [uh, ug]
    lg_r, lg_t = steps(m[0], "r"), steps(m[3], "t")        # [uh, 1], [1, ug]
    record("bucket_count3_linear",
           f"B2's first S chunk of the final plan {list(plan)}",
           lambda: ops.bucket_count3_linear(*args),
           lambda: ops._bucket_linear_ref(*m),
           nbytes(*m) + n_s.numel() * 4,
           int((n_s * 2 * (lg_r + lg_t)).sum()), line=False)
    del args, m, rg, sg, tg

    # the all-pairs cyclic kernels at B4's and B4q3's final plans: the
    # bucket-row kernel at the first (H, G) cell on its (f, a, b) grid, the
    # fused sweep whole (B4q3's records printed, not in the kernels line).
    # Their bound takes, as the pair-index kernel's does, the smaller of
    # the merge formulation's steps (``ops_search``, the rule of these rows
    # before they ran the pair-index sweep) and the bit-row formulation's
    # operations (``cyclic_table_ops``, ``ops_tables``), both printed.
    def merge_steps(ra, rb, sb, ta, batch):
        """Per R-slot visit: two searches of its S row and two of its T row,
        then one step per entry of its S run (b = r.b) and T run
        (a = r.a)."""
        visits = live(rb, "r").expand(batch).reshape(-1)
        lg = steps(sb, "s").expand(batch) + steps(ta, "t").expand(batch)
        runs = (ops._multiplicity(sb, rb, batch).to(torch.int64).sum()
                + ops._multiplicity(ta, ra, batch).to(torch.int64).sum())
        return int((visits * 2 * lg.reshape(-1)).sum() + runs)

    for label in ("B4", "B4q3"):
        rel, plan = layouts[label]
        rg, sg, tg = cyclic3.layouts(rel, rel, rel, plan, **CYC)
        raw = [rg.columns[CYC["ra"]], rg.columns[CYC["rb"]], rg.valid,
               sg.columns[CYC["sb"]], sg.columns[CYC["sc"]], sg.valid,
               tg.columns[CYC["tc"]], tg.columns[CYC["ta"]], tg.valid]
        ra, rb, sb, sc, tc, ta = _masked(ops, [
            (raw[0], raw[2], "r"), (raw[1], raw[2], "r"),
            (raw[3], raw[5], "s"), (raw[4], raw[5], "s"),
            (raw[6], raw[8], "t"), (raw[7], raw[8], "t")])
        # bucket-row: the first (H, G) cell as the scan passes it, R
        # [uh, ug], S [fp, 1, ug] and T [fp, uh, 1]
        cell_raw = [x[0, 0] for x in raw[:3]] + [
            x[0][:, None] for x in raw[3:6]] + [
            x[0][..., None, :] for x in raw[6:]]
        cell = [ra[0, 0], rb[0, 0], sb[0][:, None], sc[0][:, None],
                tc[0][..., None, :], ta[0][..., None, :]]
        batch = ops.batch_shape(*cell)
        search = merge_steps(cell[0], cell[1], cell[2], cell[5], batch)
        tables = cyclic_table_ops(torch, ops, ra[:1, :1], sb[:1], tc[:1],
                                  ta[:1])
        record("bucket_count3_cyclic",
               f"{label}: first (H, G) cell of the final plan {list(plan)}",
               lambda c=cell_raw: ops.bucket_count3_cyclic(*c),
               lambda c=cell: ops._bucket_cyclic_ref(*c),
               nbytes(*cell) + math.prod(batch) * 4, min(search, tables),
               line=label == "B4",
               extra={"ops_search": search, "ops_tables": tables})
        del cell_raw, cell
        # fused: the whole sweep, S rows (j, f, b), T rows (i, f, a) per f
        hp, gp, uh, ug, _ = ra.shape
        search = sum(
            merge_steps(ra, rb, sb[:, f][None, :, None],
                        ta[:, f][:, None, :, None], (hp, gp, uh, ug))
            for f in range(plan.f_parts))
        tables = cyclic_table_ops(torch, ops, ra, sb, tc, ta)
        record("fused_count3_cyclic", f"{label} at the final plan "
               f"{list(plan)}",
               lambda raw=raw: ops.fused_count3_cyclic(*raw, pair_index=False),
               lambda m=(ra, rb, sb, sc, tc, ta):
                   ops._fused_cyclic_pairidx_ref(*m),
               nbytes(ra, rb, sb, sc, tc, ta) + hp * gp * uh * ug * 4,
               min(search, tables), line=label == "B4",
               extra={"ops_search": search, "ops_tables": tables})
        del raw, ra, rb, sb, sc, tc, ta, rg, sg, tg

    # the pair count at B6's layout.  Its bound's bytes are what the
    # kernel's inputs need: both validity grids at 1 B a slot and the live
    # keys at 4 B each (a dead slot's key is never read), and the counts
    # written once; the masked grids' 4 B a slot, the rule of PRs 12-19,
    # is printed beside (``bytes_masked``).  Its operations are the
    # smaller of the sorted formulation's search steps (``ops_search``:
    # two searches of the kb row per live ka slot) and the table
    # formulation's (``ops_tables``: one insert per live slot of the
    # listed side, one probe per live slot of the other).
    n_buckets, cap = layouts["pair"]
    F = rels["F"]
    b = partition.bucketize(F, "dst", n_buckets, cap, fn="h")
    p = partition.bucketize(F, "src", n_buckets, cap, fn="h")
    ka, kb = _masked(ops, [(b.columns["dst"], b.valid, "a"),
                           (p.columns["src"], p.valid, "b")])
    search = int((live(ka, "a") * 2 * steps(kb, "b")).sum())
    tables = int(live(ka, "a").sum() + live(kb, "b").sum())
    record("bucket_pair_count",
           f"B6: {n_buckets} buckets x {cap} slots a side",
           lambda: ops.bucket_pair_count(b.columns["dst"], b.valid,
                                         p.columns["src"], p.valid),
           lambda: ops._bucket_pair_ref(ka, kb),
           nbytes(b.valid, p.valid) + 4 * tables + n_buckets * 4,
           min(search, tables),
           extra={"ops_search": search, "ops_tables": tables,
                  "bytes_masked": nbytes(ka, kb) + n_buckets * 4},
           clean=True)
    return lines


# --------------------------------------------------------------------------
# phase 6: the radix histogram over Q1's keys
# --------------------------------------------------------------------------

RADIX_BUCKETS = (4096, 65_536)
RADIX_DEAD = 0.1
# integer operations per live key: fmix32 (4 xors, 3 shifts, 2 multiplies,
# the seed xor) and the modulo
RADIX_OPS_PER_KEY = 11


def radix_phase(torch, ops, data, seed):
    """``ops.radix_histogram`` over Q1's source keys with ~10% dead rows,
    at each of RADIX_BUCKETS, exact against the plain version and summing
    to the live count.  The counter is zeroed before the phase."""
    from repro_torch.kernels import cuda
    src = data["F"]["src"]
    keys = torch.as_tensor(src).cuda()
    valid = torch.as_tensor(np.random.default_rng(seed + 2).random(len(src))
                            >= RADIX_DEAD).cuda()
    n_live = int(valid.sum())
    cuda.reset_launch_counts()
    rows = []
    for nb in RADIX_BUCKETS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = ops.radix_histogram(keys, valid, n_buckets=nb)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        if not torch.equal(hist, ops._radix_histogram_ref(keys, valid, nb)):
            fail(f"radix_histogram at {nb} buckets differs from the plain "
                 "version")
        if int(hist.sum()) != n_live:
            fail(f"radix_histogram at {nb} buckets counts {int(hist.sum())}"
                 f" live keys, not {n_live}")
        rows.append({"radix": f"Q1 F.src, {nb} buckets", "keys": len(src),
                     "live": n_live, "max_bucket": int(hist.max()),
                     "cold_call_s": call_s})
        log(f"[radix] {json.dumps(rows[-1])}")
    launches = dict(cuda.LAUNCHES)
    if launches["radix_histogram"] != len(RADIX_BUCKETS):
        fail(f"radix_histogram launched {launches['radix_histogram']} times "
             f"in the radix phase, expected {len(RADIX_BUCKETS)}")
    return rows, launches, (keys, valid)


def radix_kernel_phase(torch, ops, errs, launches, keys, valid):
    """The radix kernel at Q1's keys: bound by the bytes (4 B key + 1 B
    validity per row, the histogram written once) or RADIX_OPS_PER_KEY
    integer operations per live key; library: ``hash_bucket`` and
    ``torch.bincount``, the plain version's two calls on the live keys.
    The 4,096-bucket record goes in the kernels line, the 65,536-bucket
    one (the cluster path) is printed beside it."""
    from repro_torch.core import hashing
    lines = []
    n, n_live = keys.numel(), int(valid.sum())
    for nb in RADIX_BUCKETS:
        record_kernel(
            torch, lines, errs, launches, "radix_histogram",
            f"Q1 F.src: {n} keys, {n_live} live, {nb} buckets",
            lambda nb=nb: ops.radix_histogram(keys, valid, n_buckets=nb),
            lambda nb=nb: ops._radix_histogram_ref(keys, valid, nb),
            5 * n + 4 * nb, RADIX_OPS_PER_KEY * n_live,
            line=nb == RADIX_BUCKETS[0], clean=True,
            library=lambda nb=nb: torch.bincount(
                hashing.hash_bucket(keys[valid], nb, "H"), minlength=nb))
    return lines


# --------------------------------------------------------------------------
# phase 7: standing queries under ingest
# --------------------------------------------------------------------------

# W1: three distinct edge relations of Q1's N over Q1's d; deltas of 1%
# (the reference bench's delta_frac), rotating over the relations
STREAM_N, STREAM_D = 4_000_000, 14_000
STREAM_DELTA = 40_000
STREAM_WARM, STREAM_TIMED = 3, 6
# W3: the reference bench's streaming_ingest shape (n = 24,000 x scale,
# d = 4,096 x scale) at scale 167, ~4e6 rows a relation.  Its deltas take
# the cascade delta path, which joins R with S first whichever relation
# took the delta: at Q1's N/d that join has ~1.1e9 rows and does not fit
# on the card, at the bench's N/d ~2.3e7
W3_N, W3_D = 24_000 * 167, 4_096 * 167
W3_DELTA = W3_N // 100
# W1's small deltas: 400 rows touch ~9% of the 4,096 hash families, so the
# family mask applies (it is skipped past half of them)
SMALL_DELTA, SMALL_DELTAS = 400, 3
# W2: Q5's chain, deltas of 1% of its 1e6 rows
CHAIN_DELTA, CHAIN_WARM, CHAIN_TIMED = 10_000, 4, 8
FULL_REPS = 3
W1_PREDS = [("R.b", "S.b"), ("S.c", "T.c"), ("T.a", "R.a")]
W2_PREDS = [("r1.b", "r2.b"), ("r2.c", "r3.c"), ("r3.d", "r4.d")]
W3_PREDS = [("R.b", "S.b"), ("S.c", "T.c")]
STREAM_SCHEMAS = {"W1": {"R": "ab", "S": "bc", "T": "ca"},
                  "W3": {"R": "ab", "S": "bc", "T": "ce"}}


def stream_data(seed):
    """W1's and W3's relations (numpy), drawn from the seed apart from the
    main path's data."""
    rng = np.random.default_rng((seed, 1))
    size = {"W1": (STREAM_N, STREAM_D), "W3": (W3_N, W3_D)}
    return {w: {name: {c: rng.integers(0, size[w][1], size[w][0])
                       .astype(np.int32) for c in cols}
                for name, cols in schema.items()}
            for w, schema in STREAM_SCHEMAS.items()}


def delta_batches(rng, schema, d, rows, names):
    """One batch of ``rows`` rows over [0, d) per entry of ``names``, each
    for that relation's columns."""
    return [(nm, {c: rng.integers(0, d, rows).astype(np.int32)
                  for c in schema[nm]}) for nm in names]


def rotation(names, count):
    return [names[i % len(names)] for i in range(count)]


def linear3_oracle(R, S, T, d):
    """Σ over S's rows of |R.b = s.b| · |T.c = s.c| (numpy bincounts)."""
    cnt_r = np.bincount(R["b"], minlength=d).astype(np.int64)
    cnt_t = np.bincount(T["c"], minlength=d).astype(np.int64)
    return int(np.sum(cnt_r[S["b"]] * cnt_t[S["c"]]))


def _final(store):
    """The numpy columns of each relation after its appends."""
    return {nm: {c: np.concatenate(parts) for c, parts in cols.items()}
            for nm, cols in store.items()}


def _median_full_ms(torch, query, strategy):
    """A fresh session's warm from-scratch execute: one cold, then the
    median of FULL_REPS (host clock around execute and a synchronise)."""
    from repro_torch.core.session import JoinSession
    sess = JoinSession(m_budget=M_BUDGET)
    res, _ = timed_execute(torch, sess, query, strategy=strategy)
    ms = [1e3 * timed_execute(torch, sess, query, strategy=strategy)[1]
          for _ in range(FULL_REPS)]
    return int(res.count), statistics.median(ms)


def _check_run(label, row, recs, timed, kernel, launches):
    """The stream phase's failure conditions for one run."""
    if any(r.overflowed for r in recs):
        fail(f"{label}: a delta round overflowed")
    if row["count"] != row["oracle"]:
        fail(f"{label}: standing count {row['count']} != oracle "
             f"{row['oracle']}")
    if row["count"] != row["full_count"]:
        fail(f"{label}: standing count {row['count']} != from-scratch "
             f"execute {row['full_count']}")
    if all(r.replanned for r in recs[timed]):
        fail(f"{label}: every timed delta re-planned; the delta path was "
             "not measured")
    if kernel is not None and launches[kernel] <= 0:
        fail(f"{label}: {kernel} never launched in the deltas")


def _stream_row(label, recs, delta_ms, timed, count, oracle, full_count,
                full_ms, launches, t0, **extra):
    timed_ms = delta_ms[timed]
    med = statistics.median(timed_ms)
    return {"run": label, "count": count, "oracle": oracle,
            "full_count": full_count, "rounds": [r.rounds for r in recs],
            "replanned": [r.replanned for r in recs],
            "delta_rows": [r.delta_rows for r in recs],
            "delta_ms": med, "timed_delta_ms": timed_ms,
            "warm_up_delta_ms": delta_ms[:timed.start],
            "full_ms": full_ms, "speedup": full_ms / med,
            "launches": {k: v for k, v in launches.items() if v},
            **extra, "seconds": time.perf_counter() - t0}


def _standing(tables, preds):
    """The port's relations on the card from numpy tables, each
    relation's numpy columns kept for the oracle (appends add to them),
    and the query over the relations."""
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.query import Query
    rels = {nm: relation_from_numpy(v) for nm, v in tables.items()}
    store = {nm: {c: [v] for c, v in cols.items()}
             for nm, cols in tables.items()}
    return rels, store, Query(rels, preds)


def _ingest(torch, rel, cols, store):
    """Append ``cols`` to ``rel``; every standing query watching it runs
    its delta plan inside the append.  Host ms around the append and a
    synchronise; ``store`` keeps the numpy columns for the oracle."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rel.append(**cols)
    torch.cuda.synchronize()
    for c, v in cols.items():
        store[c].append(v)
    return 1e3 * (time.perf_counter() - t0)


def _touched_share(torch, cols):
    """Share of the hash families each column of a delta touches."""
    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import streaming
    delta = relation_from_numpy(cols)
    return {c: int(streaming.touched_families(delta, c).sum())
            / streaming.N_FAMILIES for c in cols}


@contextlib.contextmanager
def spying(module, name):
    """Route ``module.name`` through a wrapper that keeps each call's
    positional arguments and result, in order; restored on exit.  The
    call itself is unchanged (a kernel op still counts its launch)."""
    orig = getattr(module, name)
    calls = []

    def spy(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, out))
        return out
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def stream_watch(torch, ops, errs, run, tables, seed):
    """One standing query under ingest through ``JoinSession.watch``:
    ``warm`` warm-up and ``timed`` timed deltas of ``rows`` rows, then
    ``small`` deltas of SMALL_DELTA rows, rotating over the relations.
    At the deltas listed in ``capture`` the delta root's op is spied and
    its first call's layout kept for ``stream_kernel_records``; at the
    small deltas ``streaming.mask_to_families`` is spied, and each must
    mask a sibling to fewer live rows.  A delta into a resident binary
    step's input must grow that resident (merged, not rebuilt)."""
    from repro_torch.core import streaming
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda
    t0 = time.perf_counter()
    label = run["label"]
    rels, store, query = _standing(tables, run["preds"])
    sq = JoinSession(m_budget=M_BUDGET).watch(query, strategy=run["strategy"])
    if sq._plan.steps[-1].op != "fused3":
        fail(f"{label}: plan {sq._plan.describe()} has no fused root")
    residents = [s for s in sq._plan.steps
                 if s.op == "binary" and not s.aggregate]
    schema = {nm: tuple(cols) for nm, cols in tables.items()}
    n_big = run["warm"] + run["timed"]
    rng = np.random.default_rng((seed, 2, run["tag"]))
    batches = (delta_batches(rng, schema, run["d"], run["rows"],
                             rotation(list(rels), n_big))
               + delta_batches(rng, schema, run["d"], SMALL_DELTA,
                               rotation(list(rels), run["small"])))
    cuda.reset_launch_counts()
    delta_ms, captured, masked, resident_rows = [], [], [], []
    for i, (nm, cols) in enumerate(batches):
        grow = [s.out for s in residents if nm in s.inputs]
        before = [int(sq._intermediates[out].n) for out in grow]
        with contextlib.ExitStack() as spies:
            roots = (spies.enter_context(spying(ops, run["op"]))
                     if i in run["capture"] else None)
            masks = (spies.enter_context(
                spying(streaming, "mask_to_families")) if i >= n_big
                else None)
            delta_ms.append(_ingest(torch, rels[nm], cols, store[nm]))
        if roots is not None:
            if not roots:
                fail(f"{label}: delta {i} into {nm} never called "
                     f"ops.{run['op']}")
            captured.append((f"{label} delta {i}, {len(cols[schema[nm][0]])}"
                             f" rows into {nm}, round 1", roots[0][0]))
        if masks is not None:
            lives = [(int(a[0].n), int(out.n)) for a, out in masks
                     if out is not a[0]]
            masked.append(lives)
            if not any(after < live for live, after in lives):
                fail(f"{label}: the {len(cols[schema[nm][0]])}-row delta "
                     f"{i} into {nm} masked no sibling to fewer live rows "
                     f"(masked: {lives})")
        replanned = sq.delta_rounds[-1].replanned
        for out, b in zip(grow, before):
            after = int(sq._intermediates[out].n)
            if not replanned and after <= b:
                fail(f"{label}: a delta into {nm} left the resident {out} "
                     f"at {after} rows (was {b}): not merged")
        if residents:
            resident_rows.append({s.out: int(sq._intermediates[s.out].n)
                                  for s in residents})
    launches = dict(cuda.LAUNCHES)
    recs = list(sq.delta_rounds)
    count = int(sq.snapshot().count)
    plan = sq._plan.describe()
    sq.close()
    oracle = run["oracle"](_final(store))
    full_count, full_ms = _median_full_ms(torch, query, run["strategy"])
    timed = slice(run["warm"], n_big)
    extra = {"plan": plan}
    if residents:
        extra["resident_rows"] = resident_rows
    if run["small"]:
        extra.update(small_delta_ms=delta_ms[n_big:],
                     small_touched_share=[_touched_share(torch, cols)
                                          for _, cols in batches[n_big:]],
                     small_masked_live=masked)
    row = _stream_row(label, recs, delta_ms, timed, count, oracle,
                      full_count, full_ms, launches, t0, **extra)
    _check_run(label, row, recs, timed, run["kernel"], launches)
    row["root_kernels"] = stream_kernel_records(torch, ops, errs, launches,
                                                captured)
    row["seconds"] = time.perf_counter() - t0
    return row


def stream_kernel_records(torch, ops, errs, launches, captured):
    """The delta root's kernel at each captured layout, against its plain
    version (exact) and its bound, as ``kernel_phase`` records it at the
    main path's layouts (``launches``: the run's deltas).  Each record is
    printed beside the kernels line; a summary of each is returned."""
    lines = []

    def record(*a, **kw):
        record_kernel(torch, lines, errs, launches, *a, **kw)

    for note, args in captured:
        if len(args) == 9:
            record_cyclic(torch, ops, record, args, note)
        else:
            m, shape, t_steps, r_steps, _, out_b, _ = linear_terms(
                torch, ops, args)
            record("fused_count3_linear", f"{note}: {shape}",
                   lambda: ops.fused_count3_linear(*args),
                   lambda: ops._fused_linear_ref(*m),
                   nbytes(*m) + out_b, t_steps + r_steps)
            del m
    keys = ("name", "shape", "max_abs_err", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by")
    return [{k: e[k] for k in keys} for e in lines]


def stream_w3(torch, tables, seed):
    """The reference bench's streaming shape through the join service on
    its background thread: tenant t1 watches the linear 3-way query,
    ingests 1% deltas and takes a snapshot; tenant t2's executes of the
    same query ride in the first and the last waves.  ``full_ms`` is
    tenant t2's executes at the final state through the same service
    (the deltas' path: its queue and its pump thread's poll), median of
    FULL_REPS after the last wave's; ``direct_full_ms`` a fresh
    session's."""
    from repro_torch.kernels import cuda
    from repro_torch.launch.join_service import JoinService
    t0 = time.perf_counter()
    rels, store, query = _standing(tables, W3_PREDS)
    oracle0 = linear3_oracle(tables["R"], tables["S"], tables["T"], W3_D)
    svc = JoinService(max_queue=64, wave_size=8, m_budget=M_BUDGET)

    def through_service(fut):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fut().result(timeout=600)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t1)

    watch_f = svc.watch("t1", query)
    first_f = svc.submit("t2", query)
    svc.start()
    try:
        sq = watch_f.result(timeout=600)
        first = int(first_f.result(timeout=600).count)
        batches = delta_batches(np.random.default_rng((seed, 2, 3)),
                                STREAM_SCHEMAS["W3"], W3_D, W3_DELTA,
                                rotation(list(rels),
                                         STREAM_WARM + STREAM_TIMED))
        cuda.reset_launch_counts()
        delta_ms = []
        for nm, cols in batches:
            applied, ms = through_service(
                lambda: svc.ingest("t1", rels[nm], cols))
            delta_ms.append(ms)
            if applied != W3_DELTA:
                fail(f"W3: ingest applied {applied} rows")
            for c, v in cols.items():
                store[nm][c].append(v)
        launches = dict(cuda.LAUNCHES)
        snap_f = svc.snapshot("t1", sq)
        last_f = svc.submit("t2", query)
        count = int(snap_f.result(timeout=600).count)
        last = [int(last_f.result(timeout=600).count)]
        full_ms = []
        for _ in range(FULL_REPS):
            res, ms = through_service(lambda: svc.submit("t2", query))
            last.append(int(res.count))
            full_ms.append(ms)
    finally:
        svc.stop()
    metrics = svc.metrics()
    recs = list(sq.delta_rounds)
    sq.close()
    final = _final(store)
    oracle = linear3_oracle(final["R"], final["S"], final["T"], W3_D)
    if first != oracle0 or any(n != oracle for n in last):
        fail(f"W3: tenant t2's executes {first}, {last} != oracles "
             f"{oracle0}, {oracle}")
    full_count, direct_ms = _median_full_ms(torch, query, None)
    timed = slice(STREAM_WARM, STREAM_WARM + STREAM_TIMED)
    row = _stream_row("W3", recs, delta_ms, timed, count, oracle, full_count,
                      statistics.median(full_ms), launches, t0,
                      direct_full_ms=direct_ms, t2_counts=[first, *last],
                      plan=sq._plan.describe(), metrics=metrics)
    _check_run("W3", row, recs, timed, None, launches)
    return row


def stream_phase(torch, ops, errs, chain, chain_d, seed):
    """W1–W3, each printed as one ``[stream]`` line; the delta roots'
    kernel records are printed beside them."""
    t0 = time.perf_counter()
    tables = stream_data(seed)
    n_w1 = STREAM_WARM + STREAM_TIMED
    runs = [
        (dict(label="W1", preds=W1_PREDS, strategy=None, tag=1, d=STREAM_D,
              rows=STREAM_DELTA, warm=STREAM_WARM, timed=STREAM_TIMED,
              small=SMALL_DELTAS, op="fused_count3_cyclic",
              kernel="fused_count3_cyclic_pairidx",
              # the first timed delta, the first small one
              capture=(STREAM_WARM, n_w1),
              oracle=lambda f: trace3_oracle(
                  torch, [(f["R"]["a"], f["R"]["b"]),
                          (f["S"]["b"], f["S"]["c"]),
                          (f["T"]["c"], f["T"]["a"])], STREAM_D)),
         tables["W1"]),
        (dict(label="W2", preds=W2_PREDS, strategy="3way", tag=2, d=chain_d,
              rows=CHAIN_DELTA, warm=CHAIN_WARM, timed=CHAIN_TIMED, small=0,
              op="fused_count3_linear", kernel="fused_count3_linear",
              # the first timed deltas into r1 (the root fed by the
              # resident's delta) and into r3 (fed by the resident itself)
              capture=(CHAIN_WARM, CHAIN_WARM + 2),
              oracle=lambda f: chain_oracle(f, chain_d)),
         chain)]
    rows = []
    for run, data in runs:
        rows.append(stream_watch(torch, ops, errs, run, data, seed))
        log(f"[stream] {json.dumps(rows[-1])}")
        torch.cuda.empty_cache()
    rows.append(stream_w3(torch, tables["W3"], seed))
    log(f"[stream] {json.dumps(rows[-1])}")
    log(f"[stream] phase took {time.perf_counter() - t0:.1f}s")
    return rows


# --------------------------------------------------------------------------
# phase 8: the mesh path
# --------------------------------------------------------------------------

# (case, main-path query, the single-card execute's strategy, extra
# execute_sharded options); M4 keeps local buckets at their mean so that
# the hot key overflows round 1 and recovery runs
MESH_CASES = [("M1", "Q1", "3way", {}), ("M2", "Q2", "3way", {}),
              ("M3", "Q3", "default", {}),
              ("M4", "Q4", "3way", dict(local_slack=1.0, max_rounds=2))]
MESH_REPS = 3
MESH_TIMEOUT_S = 600
# the one-shot wrappers' graph: B4's 1e5 edges over 350 users
ONESHOT_N, ONESHOT_D = 100_000, 350


def mesh_grid(world):
    """The largest two-dimensional factorisation of the world: 1 x 1 on
    one card, 2 x 2 on four."""
    rows = max(r for r in range(1, world + 1)
               if world % r == 0 and r * r <= world)
    return rows, world // rows


def mesh_queries(data, rel):
    """Q1-Q4 of the main path over relations made by ``rel`` (whole on
    one card, or this rank's stripes)."""
    from repro_torch.core.query import Query
    F, F4 = rel(data["F"]), rel(data["F4"])
    lin = [("f1.dst", "f2.src"), ("f2.dst", "f3.src")]
    return {"Q1": Query({"f1": F, "f2": F, "f3": F}, lin),
            "Q2": Query({k: rel(v) for k, v in data["star"].items()},
                        [("r.b", "s.b"), ("s.c", "t.c")]),
            "Q3": Query({"f1": F, "f2": F, "f3": F},
                        lin + [("f3.dst", "f1.src")]),
            "Q4": Query({"f1": F4, "f2": F4, "f3": F4}, lin)}


def local_dims(kind, p):
    """The rank-local bucket grid no coarser than the single-card shape
    plan ``p``: its coarse partitions folded into the local buckets."""
    if kind == "linear":
        return {"local_u": p.h_parts * p.u, "local_g": p.g_parts}
    if kind == "cyclic":
        return {"local_uh": p.h_parts * p.uh, "local_ug": p.g_parts * p.ug,
                "local_f": p.f_parts}
    return {"local_uh": p.uh, "local_ug": p.ug, "local_chunks": p.chunks}


def oneshot_data(seed):
    """The one-shot wrappers' relations under the column names they route
    by: one graph of B4's size as R(a, b), S(b, c) and T(c, a) for the
    triangles or T(c, d) for the chain; three such edge lists for the
    star."""
    rng = np.random.default_rng((seed, 2))

    def edges(x, y):
        return {c: rng.integers(0, ONESHOT_D, ONESHOT_N).astype(np.int32)
                for c in (x, y)}

    g = edges("a", "b")

    def renamed(x, y):
        return {x: g["a"], y: g["b"]}

    return {"cyclic": (g, renamed("b", "c"), renamed("c", "a")),
            "linear": (g, renamed("b", "c"), renamed("c", "d")),
            "star": (edges("a", "b"), edges("b", "c"), edges("c", "d"))}


def mesh_rank(rank, world, port, data, oneshot, specs):
    """One rank of the mesh: NCCL over ``world`` cards, each case through
    ``JoinSession.execute_sharded`` on this rank's stripes (one cold and
    MESH_REPS timed runs), then the one-shot wrappers.  Returns the counts,
    rounds and seconds every rank saw, and this rank's kernel launches."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.convert import relation_from_numpy
    from repro_torch.core import distributed
    from repro_torch.core.session import JoinSession
    from repro_torch.kernels import cuda
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        rows, cols = mesh_grid(world)
        mesh = distributed.make_mesh(rows, cols, timeout=MESH_TIMEOUT_S)

        def place(cols_):
            rel = distributed.pad_to_multiple(relation_from_numpy(cols_),
                                              world)
            return distributed.shard_relation(rel, mesh, "row", "col")

        queries = mesh_queries(data, place)
        sess = JoinSession(m_budget=M_BUDGET)
        cuda.reset_launch_counts()
        out = {"cases": {}, "oneshot": {}}
        for label, (q, kw) in specs.items():
            runs = []
            for _ in range(MESH_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = sess.execute_sharded(queries[q], mesh, "row", "col", **kw)
                torch.cuda.synchronize()
                runs.append((r, time.perf_counter() - t0))
            res = runs[0][0]
            if any((r.count, r.rounds) != (res.count, res.rounds)
                   for r, _ in runs):
                fail(f"{label}: a warm execute_sharded disagrees")
            out["cases"][label] = {
                "kind": res.kind, "count": int(res.count),
                "rounds": res.rounds, "overflowed": bool(res.overflowed),
                "cold_s": runs[0][1], "warm_s": [t for _, t in runs[1:]]}
        for kind, tables in oneshot.items():
            fn = getattr(distributed, f"{kind}3_count_sharded")(
                mesh, "row", "col")
            res = fn(*map(place, tables))
            out["oneshot"][kind] = {"count": int(res.count),
                                    "overflowed": bool(res.overflowed)}
        torch.cuda.synchronize()
        out["launches"] = dict(cuda.LAUNCHES)
        out["mesh"] = [rows, cols]
        return out
    finally:
        dist.destroy_process_group()


def _mesh_worker(rank, world, port, seed, specs, out_path):
    out = mesh_rank(rank, world, port, make_data(seed), oneshot_data(seed),
                    specs)
    if rank == 0:
        pathlib.Path(out_path).write_text(json.dumps(out))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phase(torch, data, results, want, seed):
    """M1-M4 through ``JoinSession.execute_sharded`` on a mesh of every
    visible card (NCCL, one card a rank), each against the oracle and the
    single-card ``execute`` of the same query, never overflowed; M4 must
    recover (rounds >= 2).  Then the one-shot wrappers, exact against
    their oracles.  The launch counters, zeroed before the sharded runs,
    must show the three fused kernels."""
    import tempfile

    from repro_torch.convert import relation_from_numpy
    from repro_torch.core.session import JoinSession
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    queries = mesh_queries(data, relation_from_numpy)
    sess = JoinSession(m_budget=M_BUDGET)
    specs, single = {}, {}
    for label, q, strategy, extra in MESH_CASES:
        kw = {} if strategy == "default" else {"strategy": strategy}
        res, _ = timed_execute(torch, sess, queries[q], **kw)
        warm = [timed_execute(torch, sess, queries[q], **kw)[1]
                for _ in range(MESH_REPS)]
        single[label] = {"count": int(res.count), "kind": res.kind,
                         "warm_s": warm}
        dims = local_dims(res.kind, results[q, strategy].plan.root.shape_plan)
        specs[label] = (q, dict(dims, shuffle_slack=1.0 if world == 1
                                else 3.0, **extra))
    del queries
    oneshot = oneshot_data(seed)
    port = free_port()
    if world == 1:
        out = mesh_rank(0, 1, port, data, oneshot, specs)
    else:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "mesh.json"
            mp.start_processes(_mesh_worker, nprocs=world,
                               args=(world, port, seed, specs, str(path)),
                               start_method="spawn")
            out = json.loads(path.read_text())
    rows = []
    for label, q, _strategy, _extra in MESH_CASES:
        got = out["cases"][label]
        row = {"case": label, "query": q, "world": world,
               "mesh": out["mesh"], "kind": got["kind"],
               "count": got["count"], "oracle": want[q],
               "single_count": single[label]["count"],
               "rounds": got["rounds"], "overflowed": got["overflowed"],
               "exec_s": statistics.median(got["warm_s"]),
               "cold_s": got["cold_s"], "warm_s": got["warm_s"],
               "single_exec_s": statistics.median(single[label]["warm_s"]),
               "options": specs[label][1]}
        log(f"[mesh] {json.dumps(row)}")
        rows.append(row)
        if got["overflowed"]:
            fail(f"{label}: the mesh run overflowed")
        if not got["count"] == want[q] == single[label]["count"]:
            fail(f"{label}: mesh count {got['count']}, oracle {want[q]}, "
                 f"single-card execute {single[label]['count']}")
        if got["kind"] != single[label]["kind"]:
            fail(f"{label}: the mesh bound {got['kind']}, the single card "
                 f"{single[label]['kind']}")
    if out["cases"]["M4"]["rounds"] < 2:
        fail(f"M4: expected recovery rounds >= 2, got "
             f"{out['cases']['M4']['rounds']}")
    R, S, T = oneshot["cyclic"]
    oracles = {"cyclic": trace3_oracle(torch, [(R["a"], R["b"]),
                                              (S["b"], S["c"]),
                                              (T["c"], T["a"])], ONESHOT_D),
               "linear": linear3_oracle(*oneshot["linear"], ONESHOT_D),
               "star": linear3_oracle(*oneshot["star"], ONESHOT_D)}
    for kind, got in out["oneshot"].items():
        row = {"case": f"{kind}3_count_sharded", "world": world,
               "mesh": out["mesh"], "count": got["count"],
               "oracle": oracles[kind], "overflowed": got["overflowed"]}
        log(f"[mesh] {json.dumps(row)}")
        rows.append(row)
        if got["overflowed"] or got["count"] != oracles[kind]:
            fail(f"{kind}3_count_sharded: {got} against oracle "
                 f"{oracles[kind]}")
    launches = out["launches"]
    log(f"[mesh] kernel launches in the phase (rank 0): "
        f"{json.dumps(launches)}")
    for name in ("fused_count3_linear", "fused_count3_star",
                 "fused_count3_cyclic_pairidx", "bucket_count3_linear"):
        if launches[name] <= 0:
            fail(f"{name} was never launched in the mesh phase")
    log(f"[mesh] phase took {time.perf_counter() - t0:.1f}s")
    return rows, launches


# --------------------------------------------------------------------------
# phase 10: analytics — the FM DISTINCT sketch at Q6's data, the examples
# --------------------------------------------------------------------------

FM_REGISTERS = (32, 64)
FM_WARM = 3
FM_MAX_RETRIES = 4
FM_PEAK_GIB = 16.0
# the FM pair key's mixing seeds for a and d (the reference's
# ``kernels/ref.py`` ``fm_registers``)
FM_SEED_A, FM_SEED_D = 0x1B873593, 0xE6546B64
# (example, arguments): the defaults, training cut to 200 steps (its crash
# at step 100 resumes from the checkpoint of step 100)
EXAMPLES = [("quickstart", []), ("analytics_3way", []), ("nway_star", []),
            ("streaming_counts", []), ("train_lm", ["--steps", "200"])]


def fm_oracle(torch, F, d, n_registers):
    """FM registers of the distinct (a, d) pairs of R ⋈ S ⋈ T with R, S, T
    all the edge list F (F.dst = F.src twice), independent of the FM path:
    the pairs are the non-zeros of a float64 A·A·A on the card (A the
    d x d edge-count matrix; a sum of non-negative integers is zero only
    where no path is), their keys folded with ``sketches.add`` on the
    CPU.  Returns (registers, distinct pairs)."""
    from repro_torch.core import hashing, sketches
    a = torch.zeros((d, d), dtype=torch.float64, device="cuda")
    src = torch.as_tensor(F["src"], device="cuda").long()
    dst = torch.as_tensor(F["dst"], device="cuda").long()
    a.index_put_((src, dst), torch.ones_like(src, dtype=torch.float64),
                 accumulate=True)
    ai, di = torch.nonzero((a @ a @ a) > 0, as_tuple=True)
    keys = (hashing.mix32(ai, FM_SEED_A) ^ hashing.mix32(di, FM_SEED_D)).cpu()
    del a, ai, di
    torch.cuda.empty_cache()
    regs = sketches.add(sketches.empty(n_registers), keys,
                        torch.ones_like(keys, dtype=torch.bool))
    return regs, int(keys.numel())


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fm_relations(F):
    """A1's R(a, b), S(b, c), T(c, d): the edge list F three times, on
    the card."""
    from repro_torch.core.relation import Relation
    return (Relation.from_arrays(a=F["src"], b=F["dst"]),
            Relation.from_arrays(b=F["src"], c=F["dst"]),
            Relation.from_arrays(c=F["src"], d=F["dst"]))


def fm_plan(torch, rels):
    """``default_plan(n, n, n, m_budget=M_BUDGET)`` grown x2, as the
    whole-query retry drivers grow it, while a bucket overflows.  Returns
    the plan and the tries (plan, overflowed, seconds; the first is the
    process's first FM call)."""
    from repro_torch.core import linear3, recovery
    n = rels[0].capacity          # every row live
    plan0 = plan = linear3.default_plan(n, n, n, m_budget=M_BUDGET)
    tries = []
    for _ in range(FM_MAX_RETRIES + 1):
        (_, ovf), sec = _timed(torch, lambda: linear3.linear3_fm_distinct(
            *rels, plan, n_registers=FM_REGISTERS[0]))
        tries.append({"plan": list(plan), "overflowed": bool(ovf), "s": sec})
        if not bool(ovf):
            return plan, tries
        plan = recovery.grown(plan, 2.0)
    fail(f"A1: overflow persisted from {plan0} to {plan}")


def fm_phase(torch, F, d):
    """A1: ``linear3_fm_distinct`` on the card at Q6's data as R(a, b),
    S(b, c), T(c, d) under ``fm_plan``'s plan, at 32 and 64 registers:
    equal to ``fm_oracle``, never overflowed, its peak above the phase's
    start under ``FM_PEAK_GIB``."""
    from repro_torch.core import linear3, sketches
    rels = fm_relations(F)
    t0 = time.perf_counter()
    want, exact = fm_oracle(torch, F, d, max(FM_REGISTERS))
    oracle_s = time.perf_counter() - t0

    def run(plan, k):
        return _timed(torch, lambda: linear3.linear3_fm_distinct(
            *rels, plan, n_registers=k))

    plan, tries = fm_plan(torch, rels)
    log(f"[analytics] A1 plans tried (the first call is the process's "
        f"first FM call): {json.dumps(tries)}")
    rows = []
    for k in FM_REGISTERS:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(1 + FM_WARM):
            (regs, ovf), sec = run(plan, k)
            times.append(sec)
            if bool(ovf):
                fail(f"A1 K={k}: overflowed at {plan}")
            if not torch.equal(regs.cpu(), want[:k]):
                fail(f"A1 K={k}: registers differ from the oracle's")
        peak = torch.cuda.max_memory_allocated()
        row = {"run": f"A1 K={k}", "registers": k, "first_s": times[0],
               "warm_s": statistics.median(times[1:]), "warm_all_s": times[1:],
               "peak_gib": peak / 2**30,
               "peak_above_start_gib": (peak - base) / 2**30,
               "estimate": sketches.fm_estimate(regs),
               "exact_distinct_pairs": exact, "exact": True,
               "plan": list(plan), "retries": len(tries) - 1,
               "default_plan_overflowed": tries[0]["overflowed"],
               "oracle_s": oracle_s}
        log(f"[analytics] {json.dumps(row)}")
        if row["peak_above_start_gib"] >= FM_PEAK_GIB:
            fail(f"A1 K={k}: peak {row['peak_above_start_gib']:.2f} GiB "
                 f"above the phase's start (limit {FM_PEAK_GIB})")
        rows.append(row)
    return rows


def examples_phase(torch):
    """E: each ported example (``examples/*_torch.py``) on the card at its
    defaults, in this process; each asserts its counts against its own
    oracles, and a failure raises.  One ``[example]`` line each: seconds
    and the lines it printed (the host-clock straggler lines left out)."""
    import contextlib
    import importlib.util
    import io
    import shutil
    rows = []
    ckpt = ROOT / ".smoke_ckpt"
    for name, args in EXAMPLES:
        path = ROOT / "examples" / f"{name}_torch.py"
        spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        extra = ["--ckpt-dir", str(ckpt)] if name == "train_lm" else []
        out = io.StringIO()
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            with contextlib.redirect_stdout(out):
                _, sec = _timed(torch, lambda: mod.main([*args, *extra]))
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.strip() and not ln.startswith("[ft] straggler")]
        row = {"example": f"{name}_torch.py", "args": args, "s": sec,
               "lines": lines}
        log(f"[example] {json.dumps(row)}")
        rows.append({k: v for k, v in row.items() if k != "lines"})
    return rows


def analytics_phase(torch, F, d):
    t0 = time.perf_counter()
    rows = fm_phase(torch, F, d)
    rows += examples_phase(torch)
    log(f"[analytics] phase took {time.perf_counter() - t0:.1f}s")
    return rows


# --------------------------------------------------------------------------
# phase 11: the LM served at full width
# --------------------------------------------------------------------------

# (label, arch, batch, prompt length, generated tokens, requests, layers
# kept (None: the config's)).  S3 keeps 24 of qwen3-moe's 48 layers: its
# f32 masters are 2.49 GB a layer (122 GB at 48); S4 is whole (40 self +
# 8 cross layers, 10.1e9 parameters, 40 GB).  S5-S7 are whole: S5
# mamba2-370m (48 SSD layers) the long-context serve with bounded state,
# S6 zamba2-1.2b (38 SSD layers, 6 shared-block calls), S7
# seamless-m4t-medium (12 encoder + 12 decoder layers, each wave's memory
# [4, 4096, 1024] f32)
SERVE = [("S1", "qwen2-1.5b", 8, 1024, 32, 16, None),
         ("S2", "gemma3-1b", 4, 2048, 16, 4, None),
         ("S3", "qwen3-moe-30b-a3b", 8, 1024, 32, 16, 24),
         ("S4", "llama-3.2-vision-11b", 4, 1024, 16, 8, None),
         ("S5", "mamba2-370m", 4, 8192, 32, 8, None),
         ("S6", "zamba2-1.2b", 8, 2048, 32, 16, None),
         ("S7", "seamless-m4t-medium", 4, 256, 32, 8, None)]
CHECK_ROWS = 2
# S5 prefilled again, outside the counted run, at its own prompt and at
# LONG_PROMPT: the served cache's bytes after each must be equal (the
# SSM's state is bounded), and the two peaks give the prefill's bytes a
# prompt position, hence the longest prompt that fits at S5's batch
LONG_PROMPT = 32768


def serve_flash_passes(cfg):
    """(flash forwards a prefill or forward pass runs, flash forwards a
    decode step runs) under ``cfg``: the dense and MoE self layers and
    the VLM's cross layers a pass, its cross layers a step; the hybrid's
    shared-block calls a pass (decode attends over the cache, no kernel;
    the pure SSM has none); the enc-dec's encoder layers and its decoder
    layers' self and cross attention a pass, its cross layers a step."""
    n = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        return (n // cfg.hybrid_every if cfg.hybrid_every else 0), 0
    if cfg.family in ("encdec", "audio"):
        return cfg.n_enc_layers + 2 * n, n
    n_cross = n // cfg.cross_attn_every if cfg.cross_attn_every else 0
    return n + n_cross, n_cross


def cache_bytes(torch, cache):
    """Bytes of a serving cache's tensors."""
    return sum(v.numel() * v.element_size() for v in cache.values()
               if isinstance(v, torch.Tensor))


def prefill_memory(torch, model, params, cfg, batch, prompts, gen, seed):
    """Prefill ``batch`` rows of random tokens at each of the two prompt
    lengths ``prompts`` into a fresh cache: the served cache's bytes
    after each, the prefill's peak bytes above what was allocated before
    it, the slope between the two peaks (bytes a prompt position), and
    the longest prompt whose prefill fits the card's memory beside what
    is allocated when it is called (the parameters)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    served, peaks = [], []
    for n in prompts:
        cache = model.init_cache(batch, n + gen, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (batch, n), generator=g,
                             device="cuda", dtype=torch.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            _, cache = model.prefill(params, toks, cache)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        served.append(cache_bytes(torch, cache))
        del cache, toks
    (n0, n1), (p0, p1) = prompts, peaks
    per_pos = (p1 - p0) / (n1 - n0)
    room = torch.cuda.mem_get_info()[1] - torch.cuda.memory_allocated()
    return {"prefill_prompts": list(prompts),
            "cache_bytes_after_prefill": served,
            "prefill_peak_bytes": peaks,
            "prefill_bytes_a_position": per_pos,
            "longest_prompt_fits": int((room - (p0 - per_pos * n0))
                                       // per_pos)}


# Teacher-forced check, bf16 compute: the served logits (prefill through
# the flash kernel, decode through the plain einsum path over the cache)
# against one forward over prompt + generated tokens (flash kernel), with
# other GEMM shapes and so other bf16 roundings, which grow over the
# layers.  Logits are ~N(0, 1) at init.  Stated before the first run:
# max |diff| <= 0.5 over every compared logit and mean |diff| <= 0.06.
# S4's forward takes the wave's f32 memory, its serving the cache's bf16
# copy; S3's checks are in ``moe_serve_checks``.  S5-S7 (stated before
# their first run) are held to the same SERVE_TOL: S5/S6's decode is the
# SSD recurrence (f32 state) against the forward's chunked scan, S7's
# forward encodes the wave's f32 memory again (2 rows, other GEMM shapes).
SERVE_TOL = {"max": 0.5, "mean": 0.06}


def teacher_forced_check(torch, model, params, wave, prompt_len, gen, label):
    """``forward`` over prompt + generated tokens of CHECK_ROWS rows (and
    the wave's memory, for the VLM) against the logits the serving loop
    produced at the same positions."""
    rows = CHECK_ROWS
    seq = np.concatenate([wave["prompts"][:rows], wave["tokens"][:rows, :gen]],
                         axis=1)
    memory = (None if wave["memory"] is None
              else torch.from_numpy(wave["memory"][:rows]).cuda())
    with torch.no_grad():
        full, _ = model.forward(params, torch.from_numpy(seq).cuda(),
                                memory=memory)
    ref = full[:, prompt_len - 1:prompt_len + gen]         # [rows, gen+1, V]
    served = wave["logits"][:rows]
    if ref.shape != served.shape:
        fail(f"{label}: forward logits {tuple(ref.shape)} against served "
             f"{tuple(served.shape)}")
    if not (torch.isfinite(ref).all() and torch.isfinite(served).all()):
        fail(f"{label}: non-finite logits")
    diff = (ref - served).abs()
    max_d, mean_d = float(diff.max()), float(diff.mean())
    tokens = torch.from_numpy(wave["tokens"][:rows]).cuda().long()
    if not torch.equal(served.argmax(-1), tokens):
        fail(f"{label}: the served tokens are not the argmax of the served "
             "logits")
    # at every position the served token is, under the forward, within the
    # logit tolerance of the forward's own greedy choice (random weights
    # leave top-2 margins below the bf16 differences, so the two argmaxes
    # need not agree)
    regret = ref.max(-1).values - ref.gather(-1, tokens[..., None])[..., 0]
    max_regret = float(regret.max())
    out = {"check_rows": rows, "check_positions": int(ref.shape[1]),
           "greedy_positions_checked": int(regret.numel()),
           "logit_max_abs_diff": max_d, "logit_mean_abs_diff": mean_d,
           "logit_std": float(ref.std()),
           "forward_max_regret_of_served": max_regret,
           "forward_greedy_agree_share": float(
               (ref.argmax(-1) == tokens).float().mean())}
    if (max_d > SERVE_TOL["max"] or mean_d > SERVE_TOL["mean"]
            or max_regret > SERVE_TOL["max"]):
        fail(f"{label}: teacher-forced check failed: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def moe_recorded(capacity_factor=None):
    """Swap ``models.moe.moe_mlp_auto`` (which the blocks look up at call
    time) for one that records (tokens, dropped) of every call, at
    ``capacity_factor`` when given; restored on exit."""
    from repro_torch.models import moe
    calls, auto = [], moe.moe_mlp_auto

    def recorded(x, p, cfg):
        out, aux = (auto(x, p, cfg) if capacity_factor is None
                    else moe.moe_mlp(x, p, cfg, capacity_factor))
        calls.append((x.shape[0] * x.shape[1], aux["dropped"]))
        return out, aux

    moe.moe_mlp_auto = recorded
    try:
        yield calls
    finally:
        moe.moe_mlp_auto = auto


def _shares(torch, calls, n_layers, top_k):
    """The dropped share of each call, each pass's mean over its n_layers
    calls (a pass: one prefill, forward or decode step), and the calls
    that dropped an assignment (a share of at least half of one of the
    call's tokens x top_k assignments: with nothing dropped the share is
    1 - (n k)·f32(1/(n k)), 0 or a rounding error)."""
    got = torch.stack([d for _, d in calls]).cpu().tolist()
    dropping = [i for i, ((n, _), d) in enumerate(zip(calls, got))
                if d * n * top_k >= 0.5]
    return got, [statistics.fmean(got[i:i + n_layers])
                 for i in range(0, len(got), n_layers)], dropping


def weight_cast_ms(torch, params, n_layers):
    """Device ms of one decode step's f32 -> bf16 expert-weight casts
    (the three stacked tensors of every MoE layer, as ``moe_mlp`` casts
    them on each call), from one layer's casts timed with CUDA events,
    and their bytes (f32 read, bf16 written)."""
    blk = params.blocks[0].moe
    ws = (blk.gate, blk.up, blk.down)

    def casts():
        return [w.to(torch.bfloat16) for w in ws]
    ms = time_ms(torch, casts)
    nb = sum(w.numel() for w in ws) * 6 * n_layers
    return {"cast_ms_per_decode_step": ms * n_layers,
            "cast_bytes_per_decode_step": nb,
            "cast_bound_ms_per_decode_step": nb / HBM_BYTES_PER_S * 1e3}


def moe_serve_checks(torch, model, params, cfg, waves, calls, prompt, gen,
                     label, seed):
    """S3's checks, stated before its first run.  (a) The last wave's
    prefill logits against ``forward`` over the same 8 prompts (the same
    dispatch: 8 x 1024 tokens, capacity 640) within SERVE_TOL.  (b) No
    decode step dropped an assignment (capacity max(8, ...) >= 8 tokens,
    each token's experts distinct) and every served token is the argmax
    of its served logits.  (c) With ``capacity_factor`` = E / k (capacity
    = tokens: nothing can drop) two rows served and ``forward`` over
    prompt + generated tokens agree as in ``teacher_forced_check``.  The
    default capacity's dropped share of every prefill and of (a)'s
    forward is printed, not limited."""
    from repro_torch.launch import serve
    n_layers, batch = cfg.n_layers, waves[-1]["tokens"].shape[0]
    wave = waves[-1]
    toks = torch.from_numpy(wave["tokens"]).cuda().long()
    if not torch.equal(wave["logits"].argmax(-1), toks):
        fail(f"{label}: the served tokens are not the argmax of the served "
             "logits")
    before = len(calls)
    with torch.no_grad():
        full, _ = model.forward(params,
                                torch.from_numpy(wave["prompts"]).cuda())
    ref = full[:, prompt - 1]
    del full
    diff = (ref - wave["logits"][:, 0]).abs()
    check = {"prefill_vs_forward_max_abs_diff": float(diff.max()),
             "prefill_vs_forward_mean_abs_diff": float(diff.mean()),
             "prefill_vs_forward_rows": batch}
    del ref, diff
    shares, per_pass, dropping = _shares(torch, calls, n_layers, cfg.top_k)
    prefill_idx = [w * (1 + gen) for w in range(len(waves))]
    decode = [i for i in range(before // n_layers) if i not in prefill_idx]
    decode_dropping = [i for i in dropping
                       if i < before and i // n_layers in decode]
    check.update({
        "dropped_share_prefills": [per_pass[i] for i in prefill_idx],
        "dropped_share_prefill_layers": [
            shares[i * n_layers:(i + 1) * n_layers] for i in prefill_idx],
        "dropped_share_forward": per_pass[before // n_layers],
        "decode_steps_checked": len(decode),
        "decode_dropped_max": max(shares[i * n_layers + j] for i in decode
                                  for j in range(n_layers)),
        "decode_calls_that_dropped": len(decode_dropping)})
    if (check["prefill_vs_forward_max_abs_diff"] > SERVE_TOL["max"]
            or check["prefill_vs_forward_mean_abs_diff"] > SERVE_TOL["mean"]
            or len(decode) != gen * len(waves) or decode_dropping):
        fail(f"{label}: MoE serving checks (a)/(b) failed: "
             f"{json.dumps(check)}")
    factor = cfg.n_experts / cfg.top_k
    with moe_recorded(factor) as nodrop:
        two = serve.serve(model, params, batch=CHECK_ROWS, prompt_len=prompt,
                          gen=gen, requests=CHECK_ROWS, seed=seed + 1,
                          device="cuda", keep_rows=CHECK_ROWS,
                          log=lambda m: log(f"[serve] {label} (c) {m}"))
        tf = teacher_forced_check(torch, model, params, two[-1], prompt, gen,
                                  label + " (c)")
    got, _, dropping = _shares(torch, nodrop, n_layers, cfg.top_k)
    if dropping:
        fail(f"{label}: capacity_factor {factor} dropped assignments in "
             f"{len(dropping)} calls")
    check.update({"check_c_capacity_factor": factor,
                  "check_c_dropped_max": max(got),
                  **{f"check_c_{k}": v for k, v in tf.items()}})
    return check


def serve_phase(torch, seed):
    """S1-S7 through ``repro_torch.launch.serve.serve`` at the configs'
    full widths (S3 cut to 24 layers).  The flash counter is zeroed just
    before each run and read after its checks: every prefill and every
    checking forward run each attention layer once through the kernel,
    and each decode step each cross-attention layer (S4's, S7's) once
    (``serve_flash_passes``).  Each row prints its cache's bytes; S5's
    (the pure SSM's) is read again after prefills at its prompt and at
    LONG_PROMPT, and must not change (``prefill_memory``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.models import zoo
    rows, flash_launches = [], 0
    for label, arch, batch, prompt, gen, requests, layers in SERVE:
        cfg = configs.get(arch)
        full_layers = cfg.n_layers
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = zoo.build(cfg)
        per_pass, per_step = serve_flash_passes(cfg)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        keep = batch if cfg.is_moe else CHECK_ROWS
        with (moe_recorded() if cfg.is_moe
              else contextlib.nullcontext([])) as calls:
            waves = serve.serve(model, params, batch=batch, prompt_len=prompt,
                                gen=gen, requests=requests, seed=seed,
                                device="cuda", keep_rows=keep,
                                log=lambda m, label=label: log(
                                    f"[serve] {label} {m}"))
            served = cuda.LAUNCHES["flash_fwd"]
            if cfg.is_moe:
                check = moe_serve_checks(torch, model, params, cfg, waves,
                                         calls, prompt, gen, label, seed)
                check.update(weight_cast_ms(torch, params, cfg.n_layers))
                passes, steps = len(waves) + 3, gen * (len(waves) + 1)
            else:
                check = teacher_forced_check(torch, model, params, waves[-1],
                                             prompt, gen, label)
                passes, steps = len(waves) + 1, gen * len(waves)
        launches = cuda.LAUNCHES["flash_fwd"]
        want = per_pass * passes + per_step * steps
        if launches != want:
            fail(f"{label}: flash_fwd launched {launches} times, expected "
                 f"{want}: {per_pass} attention layers x {passes} prefills "
                 f"and forwards + {per_step} cross-attention layers x "
                 f"{steps} decode steps")
        flash_launches += launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        cache = model.init_cache(batch, prompt + gen, device="cuda")
        nb = {"cache_bytes": cache_bytes(torch, cache)}
        del cache
        if cfg.family == "ssm":
            nb.update(prefill_memory(torch, model, params, cfg, batch,
                                     (prompt, LONG_PROMPT), gen, seed))
            if set(nb["cache_bytes_after_prefill"]) != {nb["cache_bytes"]}:
                fail(f"{label}: the SSM cache's bytes depend on the prompt "
                     f"length: {json.dumps(nb)}")
        pre = [w["prefill_s"] for w in waves]
        dec = [w["decode_s"] for w in waves]
        row = {"serve": label, "arch": arch,
               "params": sum(p.numel() for p in params.parameters()),
               "layers": cfg.n_layers, "config_layers": full_layers,
               "flash_layers_a_pass": per_pass,
               "flash_layers_a_decode_step": per_step, "batch": batch,
               "prompt_len": prompt, "gen": gen, "requests": requests,
               "waves": len(waves), "init_s": init_s, "prefill_s": pre,
               "decode_s": dec,
               "prefill_tok_s": [batch * prompt / t for t in pre],
               "decode_tok_s": [batch * gen / t for t in dec],
               "flash_launches": launches,
               "flash_launches_serving": served,
               "peak_gib": peak_gib, **nb, **check}
        log(f"[serve] {json.dumps(row)}")
        rows.append(row)
        del params, waves, model, calls
        torch.cuda.empty_cache()
    return rows, {"flash_fwd": flash_launches}


# --------------------------------------------------------------------------
# phase 12: the LM trained at full width
# --------------------------------------------------------------------------

# (label, arch, batch, sequence length, steps, config overrides): the
# configs' own accum_steps (4, 2, 4, 4, 2, 2, 2) and remat (on).  Depth is
# cut where 80 GB forces it (f32 masters, gradients and two AdamW moments,
# 16 B a parameter): T3 keeps 4 of qwen3-moe's 48 layers (~50 GB) with
# scan_group 2 (its own 8 needs >= 16 layers, ~160 GB); T4 keeps 5 of
# llama-3.2-vision's 40, one cross group (~35 GB).  T5-T7 are whole
# (~6, ~18 and ~16 GB of state): mamba2-370m, zamba2-1.2b, and
# seamless-m4t-medium over batch_at's f32 memory [4, 4096, 1024]
TRAIN = [("T1", "qwen2-1.5b", 8, 1024, 6, {}),
         ("T2", "gemma3-1b", 4, 2048, 2, {}),
         ("T3", "qwen3-moe-30b-a3b", 8, 1024, 3,
          {"n_layers": 4, "scan_group": 2}),
         ("T4", "llama-3.2-vision-11b", 4, 1024, 2, {"n_layers": 5}),
         ("T5", "mamba2-370m", 8, 1024, 3, {}),
         ("T6", "zamba2-1.2b", 8, 1024, 3, {}),
         ("T7", "seamless-m4t-medium", 4, 512, 2, {})]
GRAD_SEQ = 1024
# The gradient check, stated before the first run: T1's model on one
# 1 x 1024 microbatch, bf16 compute, the loss and every parameter's
# gradient through the flash kernels against the same model whose
# attention is the plain forward under autograd.  The two differ by bf16
# roundings (o, dq, dk, dv; the kernel's delta from the rounded o) that
# grow over the layers: a relative L2 error per tensor <= 5e-2 (1.35e-2
# worst on the CPU at 8 layers) and a relative loss difference <= 1e-3.
GRAD_TOL = {"rel_l2": 5e-2, "loss_rel": 1e-3}
RESTART_STEPS, RESTART_FAIL_AT = 8, 5


def train_flash_passes(cfg):
    """The flash forward and backward launches of one microbatch's
    forward and backward under ``cfg``: each attention of the pass (a
    self or cross block's; the hybrid's shared calls, the enc-dec's
    encoder layers and its decoder layers' self and cross attention)
    runs the forward once and the backward once, and remat runs each
    checkpointed block's forward again in its backward (the pure SSM has
    none).  With ``scan_group`` gk (the dense and MoE stacks) a group's
    outer checkpoint recomputes the group in the backward, and torch's
    non-reentrant checkpoint stops that recompute once every tensor the
    group saved is back: under remat the group saved only its blocks'
    inputs, so the recompute ends at the last block's input (gk - 1
    forwards) and each block then runs once more in its own backward;
    without remat the recompute runs all gk (the JAX package runs 3
    forwards a block under remat and groups, the port 3 - 1/gk)."""
    n, remat, gk = cfg.n_layers, cfg.remat, cfg.scan_group
    attn = serve_flash_passes(cfg)[0]
    if cfg.family in ("dense", "moe") and gk and n % gk == 0 and gk < n:
        fwd = n + (n // gk) * (2 * gk - 1 if remat else gk)
    else:
        fwd = attn * (2 if remat else 1)
    return {"flash_fwd": fwd, "flash_bwd": attn}


def grad_check(torch, model, params, cfg, seed):
    """Loss and gradients of ``params`` on one microbatch through the
    kernels and through the plain attention (the model's attention
    function swapped here, not in the package), within GRAD_TOL."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    from repro_torch.train import cross_entropy_loss
    rng = np.random.default_rng(seed + 7)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, GRAD_SEQ + 1)).astype(np.int32)).cuda()
    plist = list(params.parameters())

    def loss_and_grads():
        logits, _ = model.forward(params, toks[:, :-1])
        loss = cross_entropy_loss(logits, toks[:, 1:])
        del logits
        loss.backward()
        grads = [p.grad for p in plist]
        for p in plist:
            p.grad = None
        return float(loss.detach()), grads

    def plain(q, k, v, qpos, kpos, *, causal=True, window=0):
        return fa._flash_fwd_ref(q, k, v, causal=causal, window=window)[0]

    loss_k, grads_k = loss_and_grads()
    before, kernel_attention = dict(cuda.LAUNCHES), attention.flash_attention
    attention.flash_attention = plain
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        attention.flash_attention = kernel_attention
    if cuda.LAUNCHES != before:
        fail("grad check: the plain attention path launched a flash kernel")
    errs = sorted(
        (float(torch.linalg.vector_norm(a - b)
               / torch.linalg.vector_norm(b)), name)
        for (name, _), a, b in zip(params.named_parameters(), grads_k,
                                   grads_p))
    del grads_k, grads_p
    out = {"grad_check_tokens": GRAD_SEQ, "loss_kernel": loss_k,
           "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "tensors": len(errs), "worst_rel_l2": errs[-1][0],
           "worst_tensor": errs[-1][1],
           "median_rel_l2": errs[len(errs) // 2][0]}
    if (out["worst_rel_l2"] > GRAD_TOL["rel_l2"]
            or out["loss_rel_diff"] > GRAD_TOL["loss_rel"]):
        fail(f"grad check: {json.dumps(out)}")
    return out


def train_phase(torch, seed):
    """T1-T7 through ``repro_torch.launch.train.train`` at the configs'
    full widths (T3, T4 cut in depth), random weights from the seed, the
    launcher's ``batch_at`` data (T4's and T7's with their f32 memory).
    The flash counters are zeroed just before each run and read after
    every step: each step must launch ``train_flash_passes`` x
    microbatches.  Losses, gradient norms and the MoE's aux loss must be
    finite.  Then the gradient check on T1's model."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.launch import train
    from repro_torch.models import zoo
    rows, totals, check = [], {"flash_fwd": 0, "flash_bwd": 0}, None
    for label, arch, batch, seq, steps, over in TRAIN:
        full_layers = configs.get(arch).n_layers
        cfg = dataclasses.replace(configs.get(arch), **over)
        model = zoo.build(cfg)
        accum = cfg.accum_steps
        per_step = {k: v * accum
                    for k, v in train_flash_passes(cfg).items()}
        snaps = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = train.train(
            model, steps=steps, batch=batch, seq=seq, seed=seed,
            device="cuda", log_every=1,
            log=lambda m, label=label: log(f"[train] {label} {m}"),
            metrics_cb=lambda *_: snaps.append(
                {k: cuda.LAUNCHES[k] for k in per_step}))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: cuda.LAUNCHES[k] for k in per_step}
        got = [{k: b[k] - a[k] for k in per_step}
               for a, b in zip([dict.fromkeys(per_step, 0)] + snaps, snaps)]
        if got != [per_step] * steps:
            fail(f"{label}: flash launches per step {got}, expected "
                 f"{per_step} ({train_flash_passes(cfg)} a microbatch x "
                 f"{accum} microbatches)")
        recs = out["records"]
        finite = ("loss", "grad_norm") + (("aux_loss", "dropped")
                                          if cfg.is_moe else ())
        if len(recs) != steps or not all(
                k in r and math.isfinite(r[k]) for r in recs for k in finite):
            fail(f"{label}: {len(recs)} steps, non-finite metrics: {recs}")
        step_s = [r["step_s"] for r in recs]
        warm = statistics.median(step_s[1:]) if steps > 1 else step_s[0]
        params = out["state"].params
        row = {"train": label, "arch": arch,
               "params": sum(p.numel() for p in params.parameters()),
               "layers": cfg.n_layers, "config_layers": full_layers,
               "scan_group": cfg.scan_group, "batch": batch, "seq": seq,
               "accum_steps": accum, "remat": cfg.remat, "steps": steps,
               "wall_s": wall, "step_s": step_s, "warm_step_s": warm,
               "tokens_per_s": batch * seq / warm, "peak_gib": peak,
               **{k: [r[k] for r in recs] for k in ("loss", "grad_norm",
                                                   "lr", "aux_loss",
                                                   "dropped")
                  if k in recs[0]},
               "flash_launches_per_step": per_step,
               "flash_launches": launches}
        log(f"[train] {json.dumps(row)}")
        rows.append(row)
        for k in totals:
            totals[k] += launches[k]
        if label == "T1":
            t0 = time.perf_counter()
            check = grad_check(torch, model, params, cfg, seed)
            check["seconds"] = time.perf_counter() - t0
            log(f"[train] T1 gradient check {json.dumps(check)}")
        del out, params, model
        torch.cuda.empty_cache()
    return rows, totals, check


def restart_phase(torch, seed):
    """On the card at the qwen2-1.5b smoke config: a run that fails at step
    RESTART_FAIL_AT and resumes from the newest committed checkpoint ends
    with the parameters of an uninterrupted run.  The checkpoints go to a
    directory of the checkout (``.smoke_ckpt``), removed afterwards."""
    import shutil

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import TokenGenConfig, batch_at
    from repro_torch.models import zoo
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import RestartableLoop
    from repro_torch.train import init_train_state, make_train_step
    cfg = configs.smoke("qwen2-1.5b")
    model = zoo.build(cfg)
    gen = TokenGenConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=64,
                         seed=seed)
    step_fn = make_train_step(model, AdamWConfig(
        lr=1e-3, total_steps=RESTART_STEPS))

    def batch(step):
        return {k: torch.from_numpy(v).cuda()
                for k, v in batch_at(gen, step).items()}

    def fresh():
        return init_train_state(
            model, torch.Generator(device="cuda").manual_seed(seed))

    ref = fresh()
    for step in range(RESTART_STEPS):
        ref, _ = step_fn(ref, batch(step))
    ckpt = ROOT / ".smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        manager = CheckpointManager(ckpt, every=2, keep=2)
        try:
            RestartableLoop(manager, log=lambda m: None).run(
                fresh(), step_fn, batch, RESTART_STEPS,
                fail_at=RESTART_FAIL_AT)
        except RuntimeError as exc:
            if "simulated node failure" not in str(exc):
                raise
        else:
            fail("restart: the run did not fail at its fail_at step")
        loop = RestartableLoop(manager, log=lambda m: None)
        resumed, start = loop.resume_step(fresh(), device="cuda")
        if resumed is None:
            fail("restart: no committed checkpoint to resume from")
        final, end = loop.run(resumed, step_fn, batch, RESTART_STEPS,
                              start_step=start)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    pairs = list(zip(ref.params.parameters(), final.params.parameters()))
    out = {"restart_config": cfg.name, "steps": RESTART_STEPS,
           "failed_at": RESTART_FAIL_AT, "resumed_from": start, "end": end,
           "bit_equal": all(torch.equal(a, b) for a, b in pairs),
           "max_abs_diff": max(float((a - b).abs().max()) for a, b in pairs)}
    log(f"[restart] {json.dumps(out)}")
    if end != RESTART_STEPS or out["max_abs_diff"] > 1e-6:
        fail(f"restart: the resumed run differs: {json.dumps(out)}")
    return out


# --------------------------------------------------------------------------
# phase 13: the LM's mesh — expert-parallel MoE, meshed training, restore
# --------------------------------------------------------------------------

# L1: qwen3-moe-30b-a3b's MoE FFN at full width over x [8, 1024, 2048]
LM_MOE = ("qwen3-moe-30b-a3b", 8, 1024)
# Stated before the first run: on a 1 x 1 ("data", "model") mesh the
# expert-parallel path runs moe_mlp's ops on the same values (its
# all_reduces over one rank copy), TF32 off, so in f32 its output is
# within 1e-6 of the largest |value| of moe_mlp's (bit-equal expected)
# and ``dropped`` is equal.
LM_MOE_TOL = 1e-6
# L2: T1's run (qwen2-1.5b, batch 8 x 1024, 4 microbatches, remat) for 3
# steps through launch.train on make_host_mesh() (one NCCL rank), from T1's
# seed.  Stated before the first run: each step's loss within 1e-5 and
# gradient norm within 1e-4 (relative) of the meshless T1's first 3 steps
# (the same ops on the same values, plus an all_reduce a gradient over one
# rank; bit-equal expected unless a kernel's summation order varies
# between runs).
LM_TRAIN_STEPS = 3
LM_TRAIN_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4}


def lm_moe_check(torch, seed, mesh):
    """L1: ``moe_mlp_sharded`` on the 1 x 1 mesh against ``moe_mlp`` in
    f32 (LM_MOE_TOL, ``dropped`` equal), then the bf16 ms of each."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.parallel import sharding
    arch, b, s = LM_MOE
    cfg = dataclasses.replace(configs.get(arch), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    layer = moe.init_moe(gen, cfg)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
    sharding.set_context(mesh)
    try:
        with torch.no_grad():
            want, wa = moe.moe_mlp(x, layer, cfg)
            got, ga = moe.moe_mlp_sharded(x, layer, cfg)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            row = {"lm_mesh": "L1", "arch": arch, "x": [b, s, cfg.d_model],
                   "experts": cfg.n_experts, "top_k": cfg.top_k,
                   "expert_ff": cfg.moe_d_ff, "mesh": [1, 1],
                   "max_abs_err": err, "max_abs": scale,
                   "tol": LM_MOE_TOL * scale,
                   "dropped": float(ga["dropped"]),
                   "dropped_plain": float(wa["dropped"]),
                   "aux_loss": float(ga["aux_loss"]),
                   "aux_loss_plain": float(wa["aux_loss"])}
            del want, got
            xb = x.to(torch.bfloat16)
            row["bf16_ms"] = time_ms(
                torch, lambda: moe.moe_mlp_sharded(xb, layer, cfg))
            row["bf16_plain_ms"] = time_ms(
                torch, lambda: moe.moe_mlp(xb, layer, cfg))
    finally:
        sharding.set_context(None)
    log(f"[lm mesh] {json.dumps(row)}")
    if (not math.isfinite(err) or err > row["tol"]
            or row["dropped"] != row["dropped_plain"]):
        fail(f"L1: moe_mlp_sharded against moe_mlp: {json.dumps(row)}")
    del layer, x, xb
    torch.cuda.empty_cache()
    return row


def lm_train_check(torch, seed, mesh, t1):
    """L2: T1 for LM_TRAIN_STEPS steps through ``launch.train`` on the
    host mesh, against the meshless T1's first steps (LM_TRAIN_TOL); the
    flash counters zeroed just before and read after every step.  Then
    one ``all_reduce`` of every parameter over the mesh's "data" group
    (the step's reductions, timed apart; a sum over one rank leaves the
    values as they are).  Returns the row, the run's output and the
    flash launches."""
    import dataclasses
    import shutil

    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.launch import train
    from repro_torch.models import zoo
    label, arch, batch, seq, _steps, over = TRAIN[0]
    cfg = dataclasses.replace(configs.get(arch), **over)
    per_step = {k: v * cfg.accum_steps
                for k, v in train_flash_passes(cfg).items()}
    ckpt = ROOT / ".smoke_ckpt" / "lm_mesh"
    shutil.rmtree(ckpt, ignore_errors=True)
    snaps = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    out = train.train(
        zoo.build(cfg), steps=LM_TRAIN_STEPS, batch=batch, seq=seq,
        seed=seed, device="cuda", log_every=1, mesh=mesh,
        ckpt_dir=str(ckpt),
        log=lambda m: log(f"[lm mesh] L2 {m}"),
        metrics_cb=lambda *_: snaps.append(
            {k: cuda.LAUNCHES[k] for k in per_step}))
    launches = {k: cuda.LAUNCHES[k] for k in per_step}
    got = [{k: b[k] - a[k] for k in per_step}
           for a, b in zip([dict.fromkeys(per_step, 0)] + snaps, snaps)]
    if got != [per_step] * LM_TRAIN_STEPS:
        fail(f"L2: flash launches per step {got}, expected {per_step}")
    recs = out["records"]
    diffs = {"loss_rel": max(abs(r["loss"] - w) / abs(w) for r, w in
                             zip(recs, t1["loss"])),
             "grad_norm_rel": max(abs(r["grad_norm"] - w) / abs(w)
                                  for r, w in zip(recs, t1["grad_norm"]))}
    params = list(out["state"].params.parameters())
    group = mesh.get_group("data")
    reduce_ms = time_ms(torch, lambda: [torch.distributed.all_reduce(
        p.detach(), group=group) for p in params], reps=3)
    step_s = [r["step_s"] for r in recs]
    warm = statistics.median(step_s[1:])
    row = {"lm_mesh": "L2", "train": label, "arch": arch,
           "mesh": {"data": 1}, "batch": batch, "seq": seq,
           "accum_steps": cfg.accum_steps, "remat": cfg.remat,
           "steps": LM_TRAIN_STEPS, "loss": [r["loss"] for r in recs],
           "grad_norm": [r["grad_norm"] for r in recs],
           "t1_loss": t1["loss"][:LM_TRAIN_STEPS],
           "t1_grad_norm": t1["grad_norm"][:LM_TRAIN_STEPS],
           "max_rel_diff": diffs, "tol": LM_TRAIN_TOL, "step_s": step_s,
           "warm_step_s": warm, "t1_step_s": t1["step_s"],
           "t1_warm_step_s": t1["warm_step_s"],
           "grad_all_reduce_ms": reduce_ms,
           "grad_all_reduce_share": reduce_ms / 1e3 / warm,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "flash_launches_per_step": per_step, "flash_launches": launches}
    log(f"[lm mesh] {json.dumps(row)}")
    if len(recs) != LM_TRAIN_STEPS or any(diffs[k] > LM_TRAIN_TOL[k]
                                          for k in diffs):
        fail(f"L2: the meshed steps differ from T1's: {json.dumps(diffs)}")
    return row, out, ckpt, launches


def lm_restore_check(torch, mesh, out, ckpt):
    """L3: L2's checkpoint restored with ``specs.state_shardings`` on the
    host mesh: every leaf a DTensor whose ``full_tensor()`` is the saved
    array, bit for bit."""
    import shutil

    from torch.distributed.tensor import DTensor

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import specs
    from repro_torch.parallel import sharding
    try:
        t0 = time.perf_counter()
        ctx = sharding.MeshContext(mesh, sharding.DEFAULT_RULES)
        state = out["state"]
        restored, manifest = CheckpointManager(ckpt).restore(
            state, device="cuda", shardings=specs.state_shardings(state,
                                                                  ctx))
        restore_s = time.perf_counter() - t0
        path = ckpt / f"step_{manifest['step']:08d}" / "arrays.npz"
        paths = convert.leaf_paths(restored.params)
        by_key: dict = {}            # checkpoint key -> [(layer, leaf)]
        for top, xs in (("params", list(restored.params.parameters())),
                        ("opt/m", restored.opt["m"]),
                        ("opt/v", restored.opt["v"])):
            for (p, i), x in zip(paths, xs):
                by_key.setdefault(f"{top}/{p}", []).append((i, x))
        by_key["opt/step"] = [(-1, restored.opt["step"])]
        by_key["step"] = [(-1, restored.step)]
        bad, dtensors, n = [], 0, 0
        with np.load(path) as data:
            for key, xs in by_key.items():
                want = data[key]              # each array read once
                for layer, x in xs:
                    n += 1
                    dtensors += isinstance(x, DTensor)
                    full = (x.full_tensor() if isinstance(x, DTensor)
                            else x).detach().cpu().numpy()
                    if not np.array_equal(full, want if layer < 0
                                          else want[layer]):
                        bad.append(f"{key}[{layer}]")
        row = {"lm_mesh": "L3", "step": manifest["step"],
               "leaves": n, "dtensors": dtensors,
               "placements": str(restored.opt["m"][0].placements),
               "bit_equal": not bad, "restore_s": restore_s,
               "checkpoint_bytes": path.stat().st_size,
               "seconds": time.perf_counter() - t0}
        log(f"[lm mesh] {json.dumps(row)}")
        if bad or dtensors != n:
            fail(f"L3: {len(bad)} leaves differ from the checkpoint "
                 f"({bad[:4]}), {dtensors} of {n} DTensors")
        return row
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def lm_mesh_phase(torch, seed, t1):
    """L1-L3 on one rank, NCCL (the launcher's world of one): the
    expert-parallel MoE at qwen3-moe's width on a 1 x 1 ("data", "model")
    mesh, T1 trained through the host mesh, and its checkpoint restored
    onto the mesh's placements."""
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    mesh_lib.init_world(timeout=MESH_TIMEOUT_S)     # one rank, NCCL
    try:
        rows = [lm_moe_check(torch, seed, distributed.make_mesh(
            1, 1, "data", "model", timeout=MESH_TIMEOUT_S))]
        host = mesh_lib.make_host_mesh()
        row, out, ckpt, launches = lm_train_check(torch, seed, host, t1)
        rows.append(row)
        rows.append(lm_restore_check(torch, host, out, ckpt))
        del out
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(f"[lm mesh] phase took {time.perf_counter() - t0:.1f}s")
    return rows, launches


def sdpa_kernels(torch, fn):
    """The device kernels one call of ``fn`` runs, by device time (which
    SDPA backend took the inputs), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0]
        evs.sort(key=lambda e: -e.device_time_total)
        return [e.key[:80] for e in evs[:3]] or ["no device time recorded"]
    except Exception as exc:   # the yardstick's backend is a note only
        return [f"not measured: {type(exc).__name__}: {exc}"[:120]]


def _sdpa_backward(torch, F, q, k, v, do, kw):
    """The backward alone of ``scaled_dot_product_attention`` on a retained
    graph (the yardstick's time; the port never calls it), or None and
    why when no backend takes the inputs."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **kw)

        def lib():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        lib()
        torch.cuda.synchronize()
        return lib, None
    except Exception as exc:   # the yardstick's backend is a note only
        return None, f"not measured: {type(exc).__name__}: {exc}"[:120]


def flash_kernel_phase(torch, errs, launches, seed):
    """The flash kernels at S1's prefill shape (in the kernels line) and at
    T1's microbatch and S2's local and global layers' (printed), bf16,
    causal, against their plain versions, their bounds and
    ``scaled_dot_product_attention`` on the same tensors (forward;
    backward alone on a retained graph).
    Bounds: the larger of the bytes (forward: q, k, v read once, o, m, l
    written once; backward: q, k, v, o, do, m, l read once, dq, dk, dv
    written once) over the HBM rate, and 4 D (forward) or 10 D (backward)
    flops per visible (q, k) pair over the bf16 tensor-core rate."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator().manual_seed(seed + 3)
    lines = []
    for label, (b, s, h, kvh, d, window) in [
            ("S1 prefill", (8, 1024, 12, 2, 128, 0)),
            ("T1 microbatch", (2, 1024, 12, 2, 128, 0)),
            ("S2 prefill, local layer", (4, 2048, 4, 1, 256, 512)),
            ("S2 prefill, global layer", (4, 2048, 4, 1, 256, 0))]:
        q, k, v = _flash_inputs(torch, gen, b, s, s, h, kvh, d, "bfloat16")
        rows = np.arange(s)
        visible = int(np.minimum(rows + 1, window if window else s).sum())
        flops = 4 * d * visible * b * h
        nb = nbytes(q, k, v) * 2 - nbytes(k, v) + 2 * 4 * b * h * s
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(s, device="cuda")
        kw = (dict(attn_mask=(pos[None] <= pos[:, None])
                   & (pos[None] > pos[:, None] - window)) if window
              else dict(is_causal=True))

        def lib(qt=qt, kt=kt, vt=vt, kw=kw):
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **kw)
        lib_out = lib().transpose(1, 2)
        o_ref = fa._flash_fwd_ref(q, k, v, causal=True, window=window)[0]
        extra = {"sdpa_kernels": sdpa_kernels(torch, lib),
                 "sdpa_max_abs_diff_vs_plain": float(
                     (lib_out.float() - o_ref.float()).abs().max()),
                 "visible_pairs": visible * b * h, "flops": flops}
        del lib_out, o_ref
        shape = (f"{label}: q [{b}, {s}, {h}, {d}], k/v [{b}, {s}, {kvh}, "
                 f"{d}] bf16, causal, window {window}")
        record_kernel(torch, lines, errs, launches, "flash_fwd", shape,
                      lambda q=q, k=k, v=v, w=window: fa.flash_fwd(
                          q, k, v, causal=True, window=w),
                      lambda q=q, k=k, v=v, w=window: fa._flash_fwd_ref(
                          q, k, v, causal=True, window=w),
                      nb, flops, line=label == "S1 prefill",
                      rate=BF16_FLOPS_PER_S, library=lib, extra=extra)

        o, m, l = fa.flash_fwd(q, k, v, causal=True, window=window)
        do = torch.randn((b, s, h, d), generator=gen).to(
            torch.bfloat16).cuda()
        a = (q, k, v, o, m, l, do)
        bwd_flops = 10 * d * visible * b * h
        bwd_bytes = nbytes(*a) + nbytes(q, k, v)
        lib_bwd, why = _sdpa_backward(torch, F, q, k, v, do, kw)
        extra = {"sdpa_backward_kernels": (sdpa_kernels(torch, lib_bwd)
                                           if lib_bwd else [why]),
                 "visible_pairs": visible * b * h, "flops": bwd_flops}
        record_kernel(torch, lines, errs, launches, "flash_bwd",
                      shape.replace("prefill", "training shape") + ", do",
                      lambda a=a, w=window: fa.flash_bwd(
                          *a, causal=True, window=w),
                      lambda a=a, w=window: fa._flash_bwd_ref(
                          *a, causal=True, window=w),
                      bwd_bytes, bwd_flops, line=label == "S1 prefill",
                      rate=BF16_FLOPS_PER_S, library=lib_bwd, extra=extra)
        del q, k, v, qt, kt, vt, o, m, l, do, a, lib_bwd
        torch.cuda.empty_cache()
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: FAILED: torch is not importable ({exc})",
              file=sys.stderr)
        return 2
    name, card = device_phase(torch)
    try:
        from repro_torch.kernels import cuda, ops
    except ImportError as exc:
        print(f"chip_smoke: FAILED: the port is not importable here ({exc});"
              " run from the root of a checkout", file=sys.stderr)
        return 2
    # the plain versions' f32 products in full f32 (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_s = cuda.build()
    log(f"[build] {len(cuda.KERNELS)} kernels built in {build_s:.1f}s "
        f"(phase {time.perf_counter() - t0:.1f}s)")
    for stem, text in cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {stem}: {line.strip()}")

    errs = {}
    t0 = time.perf_counter()
    cases = kernel_cases(torch, ops, args.seed)
    bf16_p = []
    for kname, kern, plain in cases:
        err = compare(torch, kname, kern(), plain(), errs)
        if kname == "flash_fwd, bf16 P":
            bf16_p.append(err)
    # for information: each bf16 forward case's distance from the plain
    # version that rounds P to bf16 (the kernel keeps P to ~2^-17)
    log(f"[kernels] flash_fwd bf16 cases against the bf16-P plain version, "
        f"max |diff| each: {json.dumps(bf16_p)}")
    log(f"[kernels] {len(cases)} random layouts against the plain versions "
        f"(join and radix kernels exact, flash within FLASH_TOL and "
        f"FLASH_BWD_TOL) in "
        f"{time.perf_counter() - t0:.1f}s: {json.dumps(errs)}")
    del cases

    t0 = time.perf_counter()
    data = make_data(args.seed)
    log(f"[data] generated in {time.perf_counter() - t0:.1f}s")
    rows, launches, results, queries, want, key_sums = main_path(torch, data)
    t0 = time.perf_counter()
    b_rows, b_launches, b_layouts = baseline_phase(
        torch, data, rows, queries, want, key_sums, args.seed)
    log(f"[baseline] phase took {time.perf_counter() - t0:.1f}s")
    r_rows, r_launches, (keys, valid) = radix_phase(torch, ops, data,
                                                    args.seed)
    st_rows = stream_phase(torch, ops, errs, data["chain"],
                           data["d"]["chain"], args.seed)
    m_rows, m_launches = mesh_phase(torch, data, results, want, args.seed)
    f6, d6 = data["F6"], data["d"]["F6"]
    del data

    lines = kernel_phase(torch, ops, errs, launches, results, queries)
    lines += baseline_kernel_phase(torch, ops, errs, b_launches, b_layouts)
    lines += radix_kernel_phase(torch, ops, errs, r_launches, keys, valid)
    del results, queries, b_layouts, keys, valid
    torch.cuda.empty_cache()
    a_rows = analytics_phase(torch, f6, d6)
    del f6
    torch.cuda.empty_cache()
    s_rows, s_launches = serve_phase(torch, args.seed)
    t_rows, t_launches, grad = train_phase(torch, args.seed)
    restart = restart_phase(torch, args.seed)
    lm_rows, lm_launches = lm_mesh_phase(torch, args.seed, t_rows[0])
    lines += flash_kernel_phase(
        torch, errs, {"flash_fwd": s_launches["flash_fwd"]
                      + t_launches["flash_fwd"] + lm_launches["flash_fwd"],
                      "flash_bwd": t_launches["flash_bwd"]
                      + lm_launches["flash_bwd"]}, args.seed)
    log(json.dumps({"queries": rows, "baselines": b_rows, "radix": r_rows,
                    "stream": st_rows, "mesh": m_rows,
                    "mesh_launches": m_launches, "analytics": a_rows,
                    "serve": s_rows, "train": t_rows, "grad_check": grad,
                    "restart": restart, "lm_mesh": lm_rows}))
    print(card, flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
