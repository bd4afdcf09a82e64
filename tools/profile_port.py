#!/usr/bin/env python3
"""Where the time of a warm ``JoinSession.execute``, of serving, or of a
training step goes, on the card.

    python3 tools/profile_port.py [--seed N] [--serve | --train | --stream
                                   | --fm]

Default: builds the smoke's Q1 (linear), Q2 (star) and Q3 (triangles)
data (``chip_smoke.make_data``), runs each query once to warm the plan
cache, then traces one more execute with ``torch.profiler``.  With
``--serve``: for each of the smoke's serving runs (``chip_smoke.SERVE``:
S1 qwen2-1.5b, S2 gemma3-1b, S3 qwen3-moe at 24 layers, S4
llama-3.2-vision, S5 mamba2, S6 zamba2, S7 seamless, full widths, random
weights; ``--runs S3`` picks), one warm-up wave, then a traced prefill of
a fresh wave (with its memory for the VLM and the enc-dec) and a traced
run of ``DECODE_STEPS`` decode steps.  With ``--train``: the smoke's
training runs (``chip_smoke.TRAIN``; T1 by default, qwen2-1.5b at full
width, batch 8 x 1024, 4 microbatches, remat; ``--runs T5,T6`` picks),
one warm-up step each, then one traced train step.
With ``--stream``: the smoke's standing queries W1 (a triangle over
three 4e6-row edge relations) and W2 (Q5's chain, ``strategy="3way"``),
each registered with ``JoinSession.watch`` and warmed by the smoke's
warm-up deltas, then one more delta traced (the ``append`` that runs the
delta plan).  With ``--fm``: the smoke's A1 (``linear3_fm_distinct`` at
Q6's data under ``chip_smoke.fm_plan``'s plan), one warm-up call, then
one traced call at 32 and one at 64 registers, with the layouts
(``linear3.layouts``) and the register fold (``ops.fm_fold``) marked.
Prints, per traced span: the host wall
time, the summed device kernel time, the device busy share (kernel time
over wall time; kernels on one stream do not overlap), the kernel
launches, the host syncs (``cudaStreamSynchronize`` and
``cudaDeviceSynchronize`` calls) and device scalars read on the host
(``aten::_local_scalar_dense``, e.g. ``int(tensor)``), the device
kernels that took the most time, and the host ops with the most self
time (the profiler's own overhead included).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


DECODE_STEPS = 4


def traced(torch, fn, top, marks=()):
    """Run ``fn`` under ``torch.profiler``; wall time, device kernel time,
    busy share, kernel launches and the top kernels.  ``marks`` names
    ``record_function`` ranges inside ``fn``: the profiler lists them
    among the device events too, and they are not kernels; each one's
    calls, host time and torch ops are reported (``ops_under``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and e.key not in marks]
    host = [e for e in events if e.device_type.name == "CPU"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    calls = {e.key: e.count for e in host}
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    host_ranked = sorted(host, key=lambda e: -e.self_cpu_time_total)
    return out, {"wall_s": wall, "device_kernel_s": dev_us / 1e6,
                 "device_busy_share": dev_us / 1e6 / wall,
                 "device_launches": sum(e.count for e in kernels),
                 "host_syncs": calls.get("cudaStreamSynchronize", 0)
                 + calls.get("cudaDeviceSynchronize", 0),
                 "scalar_reads": calls.get("aten::_local_scalar_dense", 0),
                 "top_kernels": [
                     {"name": e.key[:90], "calls": e.count,
                      "device_s": e.self_device_time_total / 1e6}
                     for e in ranked[:top]],
                 "top_host_ops": [
                     {"name": e.key[:60], "calls": e.count,
                      "host_self_s": e.self_cpu_time_total / 1e6}
                     for e in host_ranked[:top]],
                 **({"marked": {m: ops_under(prof, m) for m in marks}}
                    if marks else {})}


def profile_serving(torch, chip_smoke, seed, top, runs=()):
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import zoo
    from repro_torch.train import make_decode_step, make_prefill_step
    for label, arch, batch, prompt, gen, _, layers in chip_smoke.SERVE:
        if runs and label not in runs:
            continue
        cfg = configs.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = zoo.build(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        serve.serve(model, params, batch=batch, prompt_len=prompt, gen=gen,
                    requests=batch, seed=seed, device="cuda",
                    log=lambda m: None)
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        rng = np.random.default_rng(seed + 1)
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(batch, prompt)).astype(np.int32)
        memory = (torch.from_numpy(rng.normal(0, 1, size=(
            batch, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)).cuda() if model.needs_memory else None)
        cache = model.init_cache(batch, prompt + gen, device="cuda")
        (logits, cache), row = traced(torch, lambda: prefill(
            params, torch.from_numpy(prompts).cuda(), cache, memory), top)
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


def profile_training(torch, chip_smoke, seed, top, runs=("T1",)):
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.synthetic import TokenGenConfig, batch_at
    from repro_torch.kernels import cuda
    from repro_torch.models import zoo
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    for label, arch, batch, seq, steps, over in chip_smoke.TRAIN:
        if label not in runs:
            continue
        cfg = dataclasses.replace(configs.get(arch), **over)
        model = zoo.build(cfg)
        state = init_train_state(
            model, torch.Generator(device="cuda").manual_seed(seed))
        gen = TokenGenConfig(vocab_size=cfg.vocab_size, batch=batch,
                             seq_len=seq, seed=seed,
                             n_frontend_tokens=cfg.n_frontend_tokens,
                             d_model=cfg.d_model)
        step = make_train_step(model, AdamWConfig(total_steps=steps,
                                                  warmup_steps=5))

        def data(i):
            return {k: torch.from_numpy(v).cuda()
                    for k, v in batch_at(gen, i).items()}
        state, _ = step(state, data(0))
        cuda.reset_launch_counts()
        (state, metrics), row = traced(
            torch, lambda: step(state, data(1)), top)
        print(json.dumps({"train": label, "span": "one train step",
                          "batch": batch, "seq": seq,
                          "accum_steps": cfg.accum_steps, "remat": cfg.remat,
                          "loss": float(metrics["loss"]),
                          "flash_launches": {k: cuda.LAUNCHES[k] for k in
                                             ("flash_fwd", "flash_bwd")},
                          **row}), flush=True)
        del state, model
        torch.cuda.empty_cache()


SKETCH_MARK = "Relation.append: FM sketch update"


@contextlib.contextmanager
def calls_marked(module, name, mark):
    """Mark every call of ``module.name`` as a profiler range."""
    from torch.profiler import record_function
    fn = getattr(module, name)

    def marked(*a, **kw):
        with record_function(mark):
            return fn(*a, **kw)
    setattr(module, name, marked)
    try:
        yield
    finally:
        setattr(module, name, fn)


def sketch_update_marked():
    """Mark every ``sketches.add`` call (``Relation.append`` updates each
    cached sketch with it) as a profiler range."""
    from repro_torch.core import sketches
    return calls_marked(sketches, "add", SKETCH_MARK)


def ops_under(prof, mark):
    """Calls of a marked range, its host seconds, and the torch ops it
    issued (outermost ``aten::`` ops, each one or more launches)."""
    calls, host_us, ops = 0, 0.0, 0
    for e in prof.events():
        if e.name != mark or e.device_type.name != "CPU":
            continue
        calls += 1
        host_us += e.cpu_time_total
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            if c.name.startswith("aten::"):
                ops += 1
            else:
                stack.extend(c.cpu_children)
    return {"calls": calls, "host_s": host_us / 1e6, "torch_ops": ops}


def profile_stream(torch, chip_smoke, seed, top):
    import numpy as np

    from repro_torch.core.session import JoinSession
    data = chip_smoke.make_data(seed)
    runs = [("W1", chip_smoke.stream_data(seed)["W1"], chip_smoke.W1_PREDS,
             {}, chip_smoke.STREAM_D, chip_smoke.STREAM_DELTA,
             chip_smoke.STREAM_WARM, 1),
            ("W2", data["chain"], chip_smoke.W2_PREDS,
             dict(strategy="3way"), data["d"]["chain"],
             chip_smoke.CHAIN_DELTA, chip_smoke.CHAIN_WARM, 2)]
    del data
    for label, tables, preds, kw, d, rows, warm, tag in runs:
        rels, _, query = chip_smoke._standing(tables, preds)
        sq = JoinSession(m_budget=chip_smoke.M_BUDGET).watch(query, **kw)
        schema = {nm: tuple(cols) for nm, cols in tables.items()}
        batches = chip_smoke.delta_batches(
            np.random.default_rng((seed, 2, tag)), schema, d, rows,
            chip_smoke.rotation(list(rels), warm + 1))
        for nm, cols in batches[:warm]:
            rels[nm].append(**cols)
        nm, cols = batches[warm]
        with sketch_update_marked():
            _, row = traced(torch, lambda: rels[nm].append(**cols), top,
                            marks=(SKETCH_MARK,))
        rec = sq.delta_rounds[-1]
        print(json.dumps({"stream": label, "span": f"one warm delta of "
                          f"{rows} rows into {nm}",
                          "rounds": rec.rounds, "replanned": rec.replanned,
                          "plan": sq._plan.describe(), **row}), flush=True)
        sq.close()
        del rels
        torch.cuda.empty_cache()


FM_MARKS = ("linear3.layouts", "ops.fm_fold")


def profile_fm(torch, chip_smoke, seed, top):
    from repro_torch.core import linear3
    from repro_torch.kernels import ops
    rels = chip_smoke.fm_relations(chip_smoke.make_data(seed)["F6"])
    plan, _ = chip_smoke.fm_plan(torch, rels)
    for k in chip_smoke.FM_REGISTERS:
        with calls_marked(linear3, "layouts", FM_MARKS[0]), \
                calls_marked(ops, "fm_fold", FM_MARKS[1]):
            _, row = traced(torch, lambda k=k: linear3.linear3_fm_distinct(
                *rels, plan, n_registers=k), top, marks=FM_MARKS)
        print(json.dumps({"fm": f"A1 K={k}", "plan": list(plan), **row}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--serve", action="store_true",
                    help="profile the serving runs instead of the joins")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step instead of the joins")
    ap.add_argument("--stream", action="store_true",
                    help="profile a standing query's delta instead")
    ap.add_argument("--fm", action="store_true",
                    help="profile the FM DISTINCT sketch (A1) instead")
    ap.add_argument("--runs", default="",
                    help="with --serve or --train: the runs to profile, "
                         "comma-separated labels (default: every serving "
                         "run, or T1)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_port: needs a CUDA device")
    import chip_smoke
    runs = tuple(filter(None, args.runs.split(",")))
    if args.serve:
        profile_serving(torch, chip_smoke, args.seed, args.top, runs)
        return 0
    if args.train:
        profile_training(torch, chip_smoke, args.seed, args.top,
                         runs or ("T1",))
        return 0
    if args.stream:
        profile_stream(torch, chip_smoke, args.seed, args.top)
        return 0
    if args.fm:
        profile_fm(torch, chip_smoke, args.seed, args.top)
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
