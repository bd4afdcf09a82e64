"""bf16 rehearsal of tensor parallelism and FSDP: two ranks against one,
sound and with a planted fault.

    PYTHONPATH=src python tools/tp_rehearsal.py [--arch qwen2-1.5b] \
        [--axis model|data] [--seeds 0 1 2] [--steps 2] [--batch 8] \
        [--seq-len 128] [--plant none row_sum grad_sum gather_slice]
    python3 tools/tp_rehearsal.py --full [--plant none row_sum grad_sum]
    python3 tools/tp_rehearsal.py --full --axis data --layers 4 \
        [--plant none gather_slice]
    PYTHONPATH=src python tools/tp_rehearsal.py --seq \
        [--plant none seq_gather_slice norm_unsummed]
    python3 tools/tp_rehearsal.py --full --seq --layers 4 \
        [--plant none seq_gather_slice norm_unsummed]
    python3 tools/tp_rehearsal.py --full --seq --arch qwen3-moe-30b-a3b \
        --layers 2 [--plant none moe_gather_summed]
    python3 tools/tp_rehearsal.py --full --seq --arch seamless-m4t-medium \
        --layers 2 [--plant none memory_unsummed encoder_twice]

Two gloo ranks on a (1, 2) ("data", "model") mesh (``--axis data``: a
(2, 1) mesh, FSDP over "data", each rank its rows of every microbatch)
train the arch's smoke config in bf16 compute (remat on, 4 microbatches,
as T1) through
``launch.train.train`` beside the meshless run of the same seed, and
prefill + greedily decode it beside the meshless serve steps (fed the
meshless run's tokens).  Printed: each step's relative loss and
gradient-norm difference (and the MoE's aux loss's), the largest over
the seeds, and the serve logits' largest |difference|.  In bf16 a
row-parallel product is rounded to bf16 on each rank before the f32 sum
over "model", where one GEMM rounds once: this is that difference at a
small width, the base for ``chip_smoke.TP_TRAIN_TOL``.  Over "data"
the weights are gathered exactly (f32) and each rank computes its rows:
what differs is the rows' GEMMs at half the batch and the gradient's
sum over the ranks, the base for ``chip_smoke.FSDP_TRAIN_TOL``.
``--seq`` adds the rule ``seq_res -> ("model",)`` on the (1, 2) mesh
(sequence parallelism: each rank's positions of the residual stream
between the regions; the serve runs' prefill splits too): the sums
over "model" are the same f32 sums as reduce-scatters in place of
all-reduces, and the norms run on each rank's positions, the base for
``chip_smoke.SP_TRAIN_TOL``.

``--full`` runs the arch's row of chip_smoke's ``TRAIN`` instead (T1
for qwen2-1.5b: the arch's full config with the row's overrides, batch
and sequence length, the seed of ``--seeds``; ``--layers`` cuts its
depth, an encoder-decoder's encoder too, as chip_smoke's FS1, SP3 and
SP4 do) on the card: both ranks on card 0 over gloo, as chip_smoke's
"tp", "fsdp" and "sp" phases, the meshless run on rank 0 after them;
training only.

``--plant`` names the runs, each a fault installed in the ranks'
processes for the partitioned run only (the sources are untouched):
``none`` is the sound run; ``row_sum`` skips the sum over "model" of
the last layer's GLU down projection (each rank keeps its partial
product: a lost partial sum in one layer); ``grad_sum`` lets the last
layer's GLU input into its rank-local region without the backward sum
over "model" (the residual stream's and that layer's norm gradient keep
only this rank's part); ``gather_slice`` (``--axis data``) makes the
"data" gather's backward this rank's slice of its own gradient instead
of the reduce-scatter (a sum over the ranks); ``seq_gather_slice``
(``--seq``) makes the sequence gather's backward this rank's slice of
its gradient instead of the reduce-scatter over "model" (each rank's
part of the gathered input's gradient lost but its own);
``norm_unsummed`` (``--seq``) leaves a norm scale's gradient unsummed
over "model" (each rank's positions' part only); ``moe_gather_summed``
(``--seq``, an MoE arch) makes the MoE's sequence gather sum its
backward over "model" (the gradient every rank holds whole summed
again); ``memory_unsummed`` (a cross-attending arch) lets the memory
into a cross attention's rank-local region without the backward sum
over "model"; ``encoder_twice`` (an encoder-decoder) sums the encoder
output's gradient over "model" a second time.  A fault's reading above
the limit and the sound reading below it is what the limit must
separate.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PLANTS = ("none", "row_sum", "grad_sum", "gather_slice", "seq_gather_slice",
          "norm_unsummed", "moe_gather_summed", "memory_unsummed",
          "encoder_twice")
SEQ_PLANTS = ("seq_gather_slice", "norm_unsummed", "moe_gather_summed")
TP_PLANTS = ("row_sum", "grad_sum")          # without --seq only


def _train_row(arch):
    """(label, arch, batch, seq, steps, overrides) of ``arch`` in
    chip_smoke's TRAIN table."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return next(r for r in smoke.TRAIN if r[1] == arch)


def _plant(name):
    """Install the fault ``name`` in this process; returns its undo."""
    from repro_torch.launch import specs
    from repro_torch.models import layers
    from repro_torch.parallel import fsdp
    from repro_torch.parallel import sequence_parallel as seqp
    from repro_torch.parallel import tensor_parallel as tpl
    if name == "none":
        return lambda: None
    if name == "moe_gather_summed":
        from repro_torch.models import moe
        auto = moe.moe_mlp_auto

        def summed(x, p, cfg):
            sp = seqp.current()
            if sp is None:
                return moe._dispatch(x, p, cfg)
            x = seqp.gather(x, sp, summed=True)
            with seqp.stream(None):
                out, aux = moe._dispatch(x, p, cfg)
            return seqp.scatter(out, sp), aux
        moe.moe_mlp_auto = summed
        return lambda: setattr(moe, "moe_mlp_auto", auto)
    if name == "memory_unsummed":
        from repro_torch.models import attention
        enter = attention._Heads.enter_memory
        attention._Heads.enter_memory = lambda self, m: m
        return lambda: setattr(attention._Heads, "enter_memory", enter)
    if name == "encoder_twice":
        from repro_torch.models import encdec
        encode = encdec.encode

        def twice(params, cfg, frames):
            mem = encode(params, cfg, frames)
            tp = tpl.active()
            return mem if tp is None else tpl.to_model(mem, tp.group)
        encdec.encode = twice
        return lambda: setattr(encdec, "encode", encode)
    if name == "seq_gather_slice":
        gather = seqp._Gather.__dict__["backward"]

        def seq_sliced(ctx, g):
            return g.narrow(1, ctx.tp.rank * ctx.n, ctx.n), None, None
        seqp._Gather.backward = staticmethod(seq_sliced)
        return lambda: setattr(seqp._Gather, "backward", gather)
    if name == "norm_unsummed":
        replicated = seqp.replicated
        seqp.replicated = lambda w: w
        return lambda: setattr(seqp, "replicated", replicated)
    if name == "gather_slice":
        backward = fsdp._GatherData.backward

        def sliced(ctx, g):
            n = g.shape[ctx.dim] // ctx.ax.size
            return (g.narrow(ctx.dim, ctx.ax.rank * n, n).contiguous(),
                    None, None, None)
        fsdp._GatherData.backward = staticmethod(sliced)

        def undo_slice():
            fsdp._GatherData.backward = staticmethod(backward)
        return undo_slice
    if name not in ("row_sum", "grad_sum"):
        raise ValueError(f"unknown fault {name!r}; one of {PLANTS}")
    last = {}
    place, glu = specs.place, layers.glu_mlp
    # the last layer's GLU: its exit's sum skipped, or its entry's
    # backward sum
    mod, fn = (seqp, "leave") if name == "row_sum" else (tpl, "to_model")

    def place_marked(obj, mesh, *args, **kwargs):
        out = place(obj, mesh, *args, **kwargs)
        last["mlp"] = getattr(obj, "params", obj).blocks[-1].mlp
        return out

    def glu_mlp(x, p, act):
        if p is not last.get("mlp"):
            return glu(x, p, act)
        sound = getattr(mod, fn)
        setattr(mod, fn, lambda t, _: t)
        try:
            return glu(x, p, act)
        finally:
            setattr(mod, fn, sound)

    specs.place, layers.glu_mlp = place_marked, glu_mlp

    def undo():
        specs.place, layers.glu_mlp = place, glu
    return undo


def _rel(got, want, key):
    return [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(got, want)]


def _train_rows(model, mesh, kw, plants, device, rules=None):
    """{plant: the partitioned run's records} and the meshless records
    (on rank 0 only; the other ranks wait)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.train import train
    tp = {}
    for plant in plants:
        undo = _plant(plant)
        try:
            tp[plant] = train(model, mesh=mesh, rules=rules,
                              **kw)["records"]
        finally:
            undo()
        if device == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    one = train(model, **kw)["records"] if dist.get_rank() == 0 else None
    dist.barrier()
    return tp, one


def _serve_diff(model, cfg, mesh, seed, seq, rules=None):
    """The serve logits' max and mean |difference|, m = 2 against m = 1:
    a prefill of 2 x ``seq`` and 8 greedy steps, the partitioned run fed
    the meshless run's tokens (so a near tie that rounds the other way
    does not send the two down different sequences)."""
    import numpy as np
    import torch

    from repro_torch.launch import specs
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor_parallel as tpl
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32))
    # the VLM's or the enc-dec's frontend memory, as the prefill takes it
    mem = (torch.from_numpy(rng.normal(size=(
        2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
        if cfg.n_frontend_tokens else None)
    logits, fed = {}, []
    for tag, m in (("one", None), ("tp", mesh)):
        p = model.init(torch.Generator().manual_seed(seed))
        if m is not None:
            specs.place(p, m)
        sharding.set_context(m, rules)
        try:
            t = tpl.active()
            cache = model.init_cache(2, seq + 8, device="cpu")
            lg, cache = make_prefill_step(model)(p, toks, cache, mem)
            got = [lg]
            for i in range(8):
                if t is None:
                    fed.append(lg[:, -1].argmax(-1)[:, None])
                _, lg, cache = make_decode_step(model)(
                    p, cache, fed[i].to(torch.int32))
                got.append(lg)
            if t is not None:
                got = [tpl.all_gather(x, 2, t) for x in got]
            logits[tag] = torch.cat(got, 1)
        finally:
            sharding.set_context(None)
    d = (logits["tp"] - logits["one"]).abs()
    return {"serve_logits_max_abs_diff": float(d.max()),
            "serve_logits_mean_abs_diff": float(d.mean())}


def _rank(rank, world, init, args, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.models import zoo
    from repro_torch.parallel import sequence_parallel as seqp
    device = "cuda" if args.full else "cpu"
    rules = seqp.RULES if args.seq else None
    if args.full:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    mesh = init_device_mesh(device, (1, world) if args.axis == "model"
                            else (world, 1),
                            mesh_dim_names=("data", "model"))
    if args.full:
        _, _, batch, seq, _, over = _train_row(args.arch)
        cfg = dataclasses.replace(configs.get(args.arch), **over)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers, **(
                {"n_enc_layers": args.layers} if cfg.n_enc_layers else {}))
        shape = dict(batch=batch, seq=seq)
    else:
        cfg = dataclasses.replace(configs.smoke(args.arch), dtype="bfloat16",
                                  remat=True, accum_steps=4)
        shape = dict(batch=args.batch, seq=args.seq_len)
    model = zoo.build(cfg)
    rows = []
    for seed in args.seeds:
        kw = dict(steps=args.steps, seed=seed, device=device,
                  log=lambda _: None, **shape)
        tp, one = _train_rows(model, mesh, kw, args.plant, device, rules)
        serve = {} if args.full else _serve_diff(model, cfg, mesh, seed,
                                                 args.seq_len, rules)
        if rank == 0:
            for plant, recs in tp.items():
                rows.append({"seed": seed, "plant": plant,
                             "loss_rel": _rel(recs, one, "loss"),
                             "grad_norm_rel": _rel(recs, one, "grad_norm"),
                             **({"aux_loss_rel": _rel(recs, one, "aux_loss")}
                                if "aux_loss" in recs[0] else {}),
                             "loss": [r["loss"] for r in recs],
                             "grad_norm": [r["grad_norm"] for r in recs],
                             "meshless_loss": [r["loss"] for r in one],
                             "meshless_grad_norm": [r["grad_norm"]
                                                    for r in one],
                             **(serve if plant == "none" else {})})
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(rows))
    dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="the smoke runs' sequence length")
    ap.add_argument("--seq", action="store_true",
                    help="the rule seq_res -> (\"model\",) on --axis model")
    ap.add_argument("--full", action="store_true",
                    help="the arch's chip_smoke TRAIN row on the card "
                    "(training only)")
    ap.add_argument("--axis", choices=("model", "data"), default="model",
                    help="the axis of the two ranks")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut --full's depth to this many layers")
    ap.add_argument("--plant", nargs="+", default=["none"], choices=PLANTS)
    args = ap.parse_args(argv)
    bad = [p for p in args.plant if p != "none"
           and ((p == "gather_slice") != (args.axis == "data")
                or (p in SEQ_PLANTS and not args.seq)
                or (p in TP_PLANTS and args.seq))]
    if args.seq and args.axis != "model":
        ap.error("--seq splits the sequence over --axis model")
    if bad:
        ap.error(f"--plant {' '.join(bad)} does not apply to --axis "
                 f"{args.axis}")
    if args.seeds is None:
        args.seeds = [0] if args.full else [0, 1, 2]
    if args.full:
        import subprocess
        import time
        t0 = time.perf_counter()
        from repro_torch.kernels import cuda
        cuda.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.json")
        mp.spawn(_rank, args=(2, f"tcp://localhost:{_free_port()}", args,
                              out), nprocs=2)
        rows = json.loads(pathlib.Path(out).read_text())
    for r in rows:
        print(json.dumps(r))
    keys = ["loss_rel", "grad_norm_rel", "aux_loss_rel"] + (
        [] if args.full else ["serve_logits_max_abs_diff",
                              "serve_logits_mean_abs_diff"])
    for plant in args.plant:
        got = [r for r in rows if r["plant"] == plant]
        print(json.dumps({"plant": plant, **{
            k: max(max(r[k]) if isinstance(r[k], list) else r[k]
                   for r in got) for k in keys if k in got[0]}}))


if __name__ == "__main__":
    main()
