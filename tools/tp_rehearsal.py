"""bf16 rehearsal of tensor parallelism and FSDP: two ranks against one,
sound and with a planted fault.

    PYTHONPATH=src python tools/tp_rehearsal.py [--arch qwen2-1.5b] \
        [--axis model|data] [--seeds 0 1 2] [--steps 2] [--batch 8] \
        [--seq 128] [--plant none row_sum grad_sum gather_slice]
    python3 tools/tp_rehearsal.py --full [--plant none row_sum grad_sum]
    python3 tools/tp_rehearsal.py --full --axis data --layers 4 \
        [--plant none gather_slice]

Two gloo ranks on a (1, 2) ("data", "model") mesh (``--axis data``: a
(2, 1) mesh, FSDP over "data", each rank its rows of every microbatch)
train the arch's smoke config in bf16 compute (remat on, 4 microbatches,
as T1) through
``launch.train.train`` beside the meshless run of the same seed, and
prefill + greedily decode it beside the meshless serve steps (fed the
meshless run's tokens).  Printed: each step's relative loss and
gradient-norm difference, the largest over the seeds, and the serve
logits' largest |difference|.  In bf16 a
row-parallel product is rounded to bf16 on each rank before the f32 sum
over "model", where one GEMM rounds once: this is that difference at a
small width, the base for ``chip_smoke.TP_TRAIN_TOL``.  Over "data"
the weights are gathered exactly (f32) and each rank computes its rows:
what differs is the rows' GEMMs at half the batch and the gradient's
sum over the ranks, the base for ``chip_smoke.FSDP_TRAIN_TOL``.

``--full`` runs chip_smoke's T1 instead (the arch's full config, batch
8 x 1,024, the seed of ``--seeds``; ``--layers`` cuts its depth, as
chip_smoke's FS1 does) on the card: both ranks on card 0 over gloo, as
chip_smoke's "tp" and "fsdp" phases, the meshless run on rank 0 after
them; training only.

``--plant`` names the runs, each a fault installed in the ranks'
processes for the partitioned run only (the sources are untouched):
``none`` is the sound run; ``row_sum`` skips the sum over "model" of
the last layer's GLU down projection (each rank keeps its partial
product: a lost partial sum in one layer); ``grad_sum`` lets the last
layer's GLU input into its rank-local region without the backward sum
over "model" (the residual stream's and that layer's norm gradient keep
only this rank's part); ``gather_slice`` (``--axis data``) makes the
"data" gather's backward this rank's slice of its own gradient instead
of the reduce-scatter (a sum over the ranks).  A fault's reading above
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

PLANTS = ("none", "row_sum", "grad_sum", "gather_slice")
T1 = dict(batch=8, seq=1024)                 # chip_smoke.TRAIN[0]'s shape


def _plant(name):
    """Install the fault ``name`` in this process; returns its undo."""
    from repro_torch.launch import specs
    from repro_torch.models import layers
    from repro_torch.parallel import fsdp
    from repro_torch.parallel import tensor_parallel as tpl
    if name == "none":
        return lambda: None
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
    last = {}
    place, row, glu = specs.place, tpl.row_parallel, layers.glu_mlp

    def place_marked(obj, mesh, *args, **kwargs):
        out = place(obj, mesh, *args, **kwargs)
        last["mlp"] = getattr(obj, "params", obj).blocks[-1].mlp
        return out

    def row_parallel(x, w, b, size, tp):
        if "mlp" not in last or w is not last["mlp"].down.w:
            return row(x, w, b, size, tp)
        start, n = tp.chunk(size)
        y = x @ tpl.part(w, 0, size, start, n, tp).to(x.dtype)
        return y if b is None else y + b.to(x.dtype)

    def glu_mlp(x, p, act):
        if p is not last.get("mlp"):
            return glu(x, p, act)
        to = tpl.to_model
        tpl.to_model = lambda t, group: t
        try:
            return glu(x, p, act)
        finally:
            tpl.to_model = to

    specs.place = place_marked
    if name == "row_sum":
        tpl.row_parallel = row_parallel
    elif name == "grad_sum":
        layers.glu_mlp = glu_mlp
    else:
        raise ValueError(f"unknown fault {name!r}; one of {PLANTS}")

    def undo():
        specs.place, tpl.row_parallel, layers.glu_mlp = place, row, glu
    return undo


def _rel(got, want, key):
    return [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(got, want)]


def _train_rows(model, mesh, kw, plants, device):
    """{plant: the partitioned run's records} and the meshless records
    (on rank 0 only; the other ranks wait)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.train import train
    tp = {}
    for plant in plants:
        undo = _plant(plant)
        try:
            tp[plant] = train(model, mesh=mesh, **kw)["records"]
        finally:
            undo()
        if device == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    one = train(model, **kw)["records"] if dist.get_rank() == 0 else None
    dist.barrier()
    return tp, one


def _serve_diff(model, cfg, mesh, seed, seq):
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
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32))
    logits, fed = {}, []
    for tag, m in (("one", None), ("tp", mesh)):
        p = model.init(torch.Generator().manual_seed(seed))
        if m is not None:
            specs.place(p, m)
        sharding.set_context(m)
        try:
            t = tpl.active()
            cache = model.init_cache(2, seq + 8, device="cpu")
            lg, cache = make_prefill_step(model)(p, toks, cache)
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
    device = "cuda" if args.full else "cpu"
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
        cfg = configs.get(args.arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        shape = T1
    else:
        cfg = dataclasses.replace(configs.smoke(args.arch), dtype="bfloat16",
                                  remat=True, accum_steps=4)
        shape = dict(batch=args.batch, seq=args.seq)
    model = zoo.build(cfg)
    rows = []
    for seed in args.seeds:
        kw = dict(steps=args.steps, seed=seed, device=device,
                  log=lambda _: None, **shape)
        tp, one = _train_rows(model, mesh, kw, args.plant, device)
        serve = {} if args.full else _serve_diff(model, cfg, mesh, seed,
                                                 args.seq)
        if rank == 0:
            for plant, recs in tp.items():
                rows.append({"seed": seed, "plant": plant,
                             "loss_rel": _rel(recs, one, "loss"),
                             "grad_norm_rel": _rel(recs, one, "grad_norm"),
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
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="T1 on the card (training only)")
    ap.add_argument("--axis", choices=("model", "data"), default="model",
                    help="the axis of the two ranks")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut --full's depth to this many layers")
    ap.add_argument("--plant", nargs="+", default=["none"], choices=PLANTS)
    args = ap.parse_args(argv)
    bad = [p for p in args.plant if p != "none"
           and (p == "gather_slice") != (args.axis == "data")]
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
    keys = ["loss_rel", "grad_norm_rel"] + (
        [] if args.full else ["serve_logits_max_abs_diff",
                              "serve_logits_mean_abs_diff"])
    for plant in args.plant:
        got = [r for r in rows if r["plant"] == plant]
        print(json.dumps({"plant": plant, **{
            k: max(max(r[k]) if isinstance(r[k], list) else r[k]
                   for r in got) for k in keys if k in got[0]}}))


if __name__ == "__main__":
    main()
