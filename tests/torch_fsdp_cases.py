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
