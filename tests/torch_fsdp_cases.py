"""Two gloo ranks on a (2, 1) ("data", "model") mesh: FSDP's block
gather against the meshless model, run by ``tests/test_torch_fsdp.py``.

    python torch_fsdp_cases.py --out FILE

Each rank takes its rows of one seeded batch.  For each config the
meshless model gives each rank's rows' whole gradients g_0, g_1; the
placed model (``launch.specs.place``) runs the rank's rows under the
mesh's sharding context.  Written to ``--out`` (rank 0's JSON and rank
1's beside it, ``FILE.1``): whether the losses are the meshless ones,
whether each data-split gradient is this rank's slice of g_0 + g_1
(and its largest difference from it relative to the slice's largest
|value|: a block called more than once, zamba2's shared block, sums
each call's reduce-scatter, another order of the same f32 sums) and
each unsplit one the rank's own g_r (all bit for bit), the same under
``replicated_batch`` (every rank the whole batch: the slice of its whole
gradient, no sum), the gathers and reduce-scatters counted, and the
global norm of tensors split over "data", "model", both and neither
against the whole tensors' norm.

On a (1, 2) mesh of the same two ranks, sequence parallelism over
"model" (``SEQ_CONFIGS``, the rule ``seq_res -> ("model",)``): each
rank runs the whole batch on its split residual stream, and each of its
gradients is held against its slice of the meshless gradient (its
largest difference relative to the slice's largest |value|), sound and
with a planted fault (``SEQ_PLANTS``): the sequence gather's backward
as this rank's slice instead of the reduce-scatter, a replicated
region's exit keeping only its own positions' gradient instead of the
all-gather, and a norm's scale used on the rank's positions with its
gradient not summed over "model".
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import json
import os
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
# gemma3: remat and scan_group (a recompute gathers again, groups of two
# blocks); zamba2: the shared block gathered at each of its calls
CONFIGS = {"gemma3-1b": dict(remat=True, scan_group=2),
           "zamba2-1.2b": dict(remat=True)}
BATCH, SEQ = 4, 16
# the dense smoke config splits every region over "model" (under remat:
# the recompute re-enters the split stream); torch_dist_cases.ODD none
SEQ_CONFIGS = {"qwen2-1.5b": dict(remat=True), "odd": {}}
SEQ_PLANTS = ("none", "seq_gather_slice", "seq_scatter_local",
              "norm_unsummed")


def _loss(model, params, toks):
    from repro_torch.train.steps import cross_entropy_loss
    logits, _ = model.forward(params, toks[:, :-1])
    return cross_entropy_loss(logits, toks[:, 1:])


def _grads(model, params, toks):
    loss = _loss(model, params, toks)
    loss.backward()
    out = [p.grad.detach().clone() for p in params.parameters()]
    for p in params.parameters():
        p.grad = None
    return float(loss), out


def _arch_case(arch, over, mesh, rank):
    import torch

    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import zoo
    from repro_torch.parallel import fsdp, sharding
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32", **over)
    model = zoo.build(cfg)
    whole = model.init(torch.Generator().manual_seed(11))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32))
    each = BATCH // WORLD
    rows = [toks[r * each:(r + 1) * each] for r in range(WORLD)]
    losses, per_rank = zip(*[_grads(model, whole, x) for x in rows])
    summed = [a + b for a, b in zip(*per_rank)]
    _, all_rows = _grads(model, whole, toks)
    ctx = sharding.MeshContext(mesh, sharding.DEFAULT_RULES)
    spec = specs.param_specs(whole, ctx)
    placed = specs.place(copy.deepcopy(whole), mesh)
    ddims = specs.placement(placed)["data"][1]
    out = {"split": sum(d is not None for d in ddims),
           "tensors": len(ddims)}
    sharding.set_context(mesh)
    try:
        fsdp.reset_counts()
        loss, got = _grads(model, placed, rows[rank])
        out["counts"] = {k: list(v) for k, v in fsdp.COUNTS.items()}
        with sharding.replicated_batch():
            _, got_rep = _grads(model, placed, toks)
    finally:
        sharding.set_context(None)

    def mine(t, sp):
        return specs.local_slice(t, sp, mesh)

    out["loss_equal"] = loss == losses[rank]
    out["split_grads_equal"] = all(
        torch.equal(g, mine(s, sp)) for g, s, sp, d in
        zip(got, summed, spec, ddims) if d is not None)
    out["split_grads_max_rel"] = max(
        float((g - mine(s, sp)).abs().max() / mine(s, sp).abs().max())
        for g, s, sp, d in zip(got, summed, spec, ddims) if d is not None)
    out["unsplit_grads_equal"] = all(
        torch.equal(g, own) for g, own, d in
        zip(got, per_rank[rank], ddims) if d is None)
    out["replicated_grads_equal"] = all(
        torch.equal(g, mine(w, sp)) for g, w, sp in
        zip(got_rep, all_rows, spec))
    return out


def _norm_case(mesh, rank):
    """Tensors split over "data", "model" (size 1 here), both and
    neither: ``clip_by_global_norm`` of the local slices against the
    whole tensors' norm."""
    import torch

    from repro_torch.optim import clip_by_global_norm
    gen = torch.Generator().manual_seed(2)
    whole = [torch.randn((4, 6), generator=gen) for _ in range(8)]
    d, m = mesh.get_group("data"), mesh.get_group("model")
    kinds = [(d,), (m,), (d, m), ()] * 2
    local = [t.chunk(WORLD)[rank].clone() if d in k else t.clone()
             for t, k in zip(whole, kinds)]
    _, gn = clip_by_global_norm(local, 1e9, split=kinds)
    _, want = clip_by_global_norm([t.clone() for t in whole], 1e9)
    return {"norm": float(gn), "whole_norm": float(want)}


def _seq_plant(name):
    """Install the fault ``name`` in this process; returns its undo."""
    import torch

    from repro_torch.parallel import sequence_parallel as seqp
    if name == "none":
        return lambda: None
    if name == "norm_unsummed":
        replicated = seqp.replicated
        seqp.replicated = lambda w: w
        return lambda: setattr(seqp, "replicated", replicated)
    cls = seqp._Gather if name == "seq_gather_slice" else seqp._Scatter
    orig = cls.__dict__["backward"]

    def sliced(ctx, g):
        return g.narrow(1, ctx.tp.rank * ctx.n, ctx.n), None, None

    def local(ctx, g):
        shape = list(g.shape)
        shape[1] *= ctx.tp.size
        full = torch.zeros(shape, dtype=g.dtype)
        full.narrow(1, ctx.tp.rank * g.shape[1], g.shape[1]).copy_(g)
        return full, None

    cls.backward = staticmethod(sliced if name == "seq_gather_slice"
                                else local)
    return lambda: setattr(cls, "backward", orig)


def _seq_case(arch, over, mesh):
    import torch

    import torch_dist_cases
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import zoo
    from repro_torch.parallel import sequence_parallel as seqp
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor_parallel as tpl
    from repro_torch.train.steps import cross_entropy_loss
    base, shape = torch_dist_cases.ODD if arch == "odd" else (arch, {})
    cfg = dataclasses.replace(configs.smoke(base), dtype="float32",
                              **shape, **over)
    model = zoo.build(cfg)
    whole = model.init(torch.Generator().manual_seed(13))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32))
    _, want = _grads(model, whole, toks)
    spec = specs.param_specs(whole, sharding.MeshContext(
        mesh, sharding.DEFAULT_RULES))
    want = [specs.local_slice(w, sp, mesh) for w, sp in zip(want, spec)]
    placed = specs.place(copy.deepcopy(whole), mesh)
    out = {}
    for plant in SEQ_PLANTS:
        undo = _seq_plant(plant)
        sharding.set_context(mesh, seqp.RULES)
        try:
            tp = tpl.active()
            logits, _ = model.forward(placed, toks[:, :-1])
            if tp.splits("vocab", cfg.vocab_size):
                loss = tpl.cross_entropy(logits, toks[:, 1:],
                                         cfg.vocab_size, tp)
            else:
                loss = cross_entropy_loss(logits, toks[:, 1:])
            loss.backward()
        finally:
            sharding.set_context(None)
            undo()
        out[plant] = max(float((p.grad - w).abs().max() / w.abs().max())
                         for p, w in zip(placed.parameters(), want))
        for p in placed.parameters():
            p.grad = None
    return out


def run(rank, store, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (WORLD, 1),
                                mesh_dim_names=("data", "model"))
        res = {a: _arch_case(a, o, mesh, rank) for a, o in CONFIGS.items()}
        res["norm"] = _norm_case(mesh, rank)
        model_mesh = init_device_mesh("cpu", (1, WORLD),
                                      mesh_dim_names=("data", "model"))
        res["seq"] = {a: _seq_case(a, o, model_mesh)
                      for a, o in SEQ_CONFIGS.items()}
    finally:
        dist.destroy_process_group()
    path = out if rank == 0 else f"{out}.{rank}"
    pathlib.Path(path).write_text(json.dumps(res))


def main(argv=None):
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(os.path.join(tmp, "store"), args.out),
                 nprocs=WORLD)


if __name__ == "__main__":
    main()
