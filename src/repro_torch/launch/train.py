"""Training launcher: build the model, init the TrainState, then a
restartable loop of AdamW train steps with microbatch accumulation.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 6 --batch 8 --seq 1024

The flow is the JAX launcher's: the data pipeline is a pure function of the
step (``data.synthetic.batch_at``), checkpoints are atomic and only
committed ones are resumed (``--ckpt-dir``), a straggler monitor watches
the step times, and ``--fail-at`` simulates a node failure.  Parameters
are drawn from ``torch.Generator(seed)`` on the training device.

The mesh is the JAX launcher's: ``--production`` builds the (16, 16)
("data", "model") mesh, with ``--multi-pod`` the (2, 16, 16) one (256 or
512 ranks, started with ``torchrun``); otherwise ``make_host_mesh()``, a
("data",) mesh over the world's ranks, which is one rank when the
launcher is not started under ``torchrun``.  The step is data-parallel
over the batch axes and tensor-parallel over "model" (``train.steps``:
heads, GLU columns and vocabulary where they divide it; the MoE's
experts are parallel over "model").

``--overlap`` is the counterpart of the JAX launcher's XLA
latency-hiding flags (collectives overlapped with compute): each
gradient's ``all_reduce`` is issued asynchronously from a post-accumulate
hook during the last microbatch's backward, and awaited before the
optimizer; the parameters are the same with and without it.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-1.5b --steps 6 --batch 8 --seq 1024
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.relation import resolve_device
from repro_torch.data.synthetic import TokenGenConfig, batch_at
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import zoo
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import RestartableLoop, StragglerMonitor
from repro_torch.train import init_train_state, make_train_step


def _quiet(msg: str) -> None:
    pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model: zoo.Model, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, device=None, ckpt_dir: str = "",
          ckpt_every: int = 50, fail_at: int | None = None,
          log_every: int = 10, log=print, metrics_cb=None, mesh=None,
          overlap: bool = False) -> dict:
    """Train ``model`` from ``init_train_state(seed)`` (or the newest
    committed checkpoint in ``ckpt_dir``) for ``steps`` steps of
    ``batch`` x ``seq`` tokens.

    Returns ``{"state", "start", "end", "records"}``: one record per step
    run with its ``loss``, ``lr``, ``grad_norm`` (and the MoE's
    ``aux_loss`` and ``dropped``; host floats) and
    ``step_s`` (host clock around the batch, the step and a device
    synchronise).  ``metrics_cb(step, metrics, stats)`` is called after
    each step, as the loop calls it.

    ``mesh`` (a ``DeviceMesh``; every rank calls ``train`` alike): each
    rank of the batch axes takes its rows of every microbatch and the
    gradients are averaged over them (``train.make_train_step``); where
    its "model" axis has size > 1 the state is placed onto each rank's
    "model" slices and the model computes its share of the heads, GLU
    columns and vocabulary (tensor parallelism).  The records hold the
    global loss and gradient norm.  Only rank 0 logs and writes
    checkpoints; the other ranks of its "model" group take part in
    gathering a placed state for them.  ``overlap`` reduces the
    gradients during the backward."""
    cfg = model.config
    device = resolve_device(device)
    gen = TokenGenConfig(vocab_size=cfg.vocab_size, batch=batch,
                         seq_len=seq, seed=seed,
                         n_frontend_tokens=cfg.n_frontend_tokens,
                         d_model=cfg.d_model)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    train_step = make_train_step(model, opt_cfg, mesh=mesh, overlap=overlap)
    lead = mesh is None or torch.distributed.get_rank() == 0
    # the ranks that save: rank 0, and the rest of its "model" group (a
    # placed state is gathered over it; its first rank, rank 0, writes)
    coords = None if mesh is None else mesh.get_coordinate()
    saves = lead or (coords is not None and "model" in mesh.mesh_dim_names
                     and all(c == 0 for a, c in zip(mesh.mesh_dim_names,
                                                    coords) if a != "model"))

    def step_fn(state, b):
        state, metrics = train_step(state, b)
        _sync(device)
        return state, metrics

    manager = (CheckpointManager(ckpt_dir, every=ckpt_every, mesh=mesh)
               if ckpt_dir and saves else None)
    loop = RestartableLoop(manager, monitor=StragglerMonitor(),
                           log=log if lead else _quiet)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(seed))
    start = 0
    if ckpt_dir:
        restored, start = RestartableLoop(
            CheckpointManager(ckpt_dir), log=log if lead else _quiet
        ).resume_step(state, device=device)
        if restored is not None:
            state = restored

    def batch_for_step(step):
        # inputs, targets and, for the VLM and the enc-dec, the f32 memory
        return {k: torch.from_numpy(v).to(device)
                for k, v in batch_at(gen, step).items()}

    records = []

    def on_step(step, metrics, stats):
        rec = {k: float(metrics[k]) for k in ("loss", "lr", "grad_norm",
                                               "aux_loss", "dropped")
               if k in metrics}
        records.append({"step": step, **rec, "step_s": stats.last})
        if lead and step % log_every == 0:
            log(f"step {step:5d}  loss {rec['loss']:.4f}  "
                f"lr {rec['lr']:.2e}  gnorm {rec['grad_norm']:.3f}  "
                f"dt {stats.last:.3f}s")
        if metrics_cb:
            metrics_cb(step, metrics, stats)

    t0 = time.perf_counter()
    state, end = loop.run(state, step_fn, batch_for_step, steps,
                          start_step=start, fail_at=fail_at,
                          metrics_cb=on_step)
    dt = time.perf_counter() - t0
    if manager is not None and end > start:
        manager.save(state, end)
    if records and lead:
        log(f"done: steps [{start},{end}) in {dt:.1f}s  first loss "
            f"{records[0]['loss']:.4f}  last loss {records[-1]['loss']:.4f}")
    return {"state": state, "start": start, "end": end, "records": records}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--production", action="store_true",
                    help="the (16,16) or (2,16,16) production mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a node failure at this step (tests)")
    ap.add_argument("--overlap", action="store_true",
                    help="reduce the gradients during the backward")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(None if args.device == "cuda" else args.device)
    owned = mesh_lib.init_world(device)
    try:
        if args.production:
            mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                                 device=device)
        else:
            mesh = mesh_lib.make_host_mesh(device=device)
        mesh_lib.activate(mesh)
        cfg = (configs.smoke(args.arch) if args.smoke
               else configs.get(args.arch))
        out = train(zoo.build(cfg), steps=args.steps, batch=args.batch,
                    seq=args.seq, lr=args.lr, seed=args.seed, device=device,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    fail_at=args.fail_at, log_every=args.log_every,
                    mesh=mesh, overlap=args.overlap)
    finally:
        from repro_torch.parallel import sharding
        sharding.set_context(None)
        if owned:
            torch.distributed.destroy_process_group()
    return out["state"], [r["loss"] for r in out["records"]]


if __name__ == "__main__":
    main()
