"""Multi-pod dry-run on fake tensors: run one step of every (architecture ×
input shape) cell as one rank of the production mesh, and read its
flops, traffic, collectives, memory and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch] \\
        [--set n_layers=4 remat=0 ...] [--tag TAG]

The counterpart of the JAX package's ``launch/dryrun.py``, which forces
512 host devices, lowers and compiles each cell and reads XLA's memory
and cost analyses and the optimized HLO.  The port has no compiler in
between: it brings up a world of 256 or 512 ranks in this one process on
the ``fake`` process-group backend (every collective returns at once,
moving nothing) as rank 0, builds the production mesh on it
(``launch/mesh.py``), and runs the port's own step once on fake CPU
tensors (``FakeTensorMode``: shapes and dtypes, no memory, no compute)
under ``launch/step_stats.py``.

It is a CPU tool by design, as the JAX package's is: it touches no CUDA
and takes no device.  CUDA fake tensors cannot carry a step (slicing one
needs a CUDA build), and the flash kernels' custom ops give the same
outputs, flops and operand bytes on either device (their fake
implementations hold no score matrix), so the cell reads as the card's.

What runs, per kind, always partitioned over "model"
(``parallel.tensor_parallel``: the rank's heads, GLU columns and
vocabulary rows where ``spec_for`` splits them, the MoE's experts
expert-parallel):

  * train   — ``make_train_step(..., mesh=)``: data-parallel over the
              batch axes, each rank taking its rows of every microbatch;
              every parameter and both AdamW moments held as the rank's
              "model" slice (``specs.place_model``; the "data" entries,
              FSDP, are not applied: ROADMAP Queue A item 5), one
              ``all_reduce`` a gradient and batch axis.  A cell whose
              state does not fit one card says so in ``fits_80gb``.
  * prefill / decode — the serve steps under the mesh's sharding
              context: the rank runs its rows of the batch as
              ``batch_specs`` / ``cache_specs`` split the batch axes (all
              of it where the batch does not split), on its "model"
              slices of the parameters and a cache of its KV heads where
              they split; the SSM state and conv window stay whole.
              ``ran`` states the shapes that ran and, under
              ``tensor_parallel``, which tensors split.

Writes one JSON artifact per cell, the JAX package's keys:
  memory            argument / output / temp / alias bytes of the rank
  per_device_peak_bytes_est, fits_80gb (the card's 80 GB; the JAX
                    package's ``fits_16gb``)
  xla_cost          no XLA: ``FlopCounterMode``'s flops and the eager
                    traffic (an upper bound: every unfused op's bytes)
  hlo_stats         ``step_stats.analyze()``: flops, eager traffic, wire
                    bytes by kind and group size
  attn_substitution the flash ops' eager traffic beside the JAX package's
                    kernel contract (n_attn_layers × ``hbm_bytes`` /
                    n_chips); nothing is substituted, the ops are the
                    kernels
  roofline          three terms (s) at the H100's rates, bottleneck, MODEL
                    FLOPS ratio; its memory term is the HBM floor, so
                    ``step_time_lb_s`` is a lower bound
``lower_s`` times the world, mesh, cell and inputs, ``compile_s`` the
step's one run; ``hbm_floor`` splits the floor (``step_stats``);
``collective_groups`` says which groups span nodes.

The JAX package's ``seq_shard`` / ``seq_shard_rule`` overrides raise: the
port's steps shard no sequence (sequence parallelism, ROADMAP Queue A
item 6).  So does ``serve_bf16``: the port serves f32 weights, cast to
bf16 a call (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch import hlo_analysis, specs, step_stats

CAPACITY_BYTES = 80e9        # one NVIDIA H100 80GB HBM3


def _parse_overrides(items):
    out = {}
    for it in items or ():
        k, v = it.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
        if k in ("seq_shard", "remat") and isinstance(out[k], int):
            out[k] = bool(out[k])
    return out


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group: ``world`` ranks on the ``fake`` backend,
    this process rank 0.  Taken down on exit, so that a later process
    group can start."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run brings up its own world: a "
                           "process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rows_per_rank(cell, ctx) -> int:
    """The rows of the batch one rank serves: the batch split over the
    batch axes ``batch_specs`` gives it (all of it where it does not
    split)."""
    tokens = torch.empty((cell.global_batch, 1), dtype=torch.int32)
    entry = specs.batch_specs({"inputs": tokens}, ctx)["inputs"][0]
    axes = () if entry is None else (entry if isinstance(entry, tuple)
                                     else (entry,))
    return cell.global_batch // math.prod(ctx.shape[a] for a in axes)


def _rank_args(cell, args, rows: int) -> tuple:
    """The serve step's inputs for the rank's ``rows``: the parameters as
    they are, its rows of the tokens and the memory, a cache of its rows
    (of its KV heads under the sharding context's "model" axis)."""
    local = dataclasses.replace(cell, global_batch=rows)
    cache = specs.abstract_cache(local, rows, cell.seq_len)
    if cell.kind == "prefill":
        rest = tuple(x[:rows].clone() for x in args[3:])
        return (args[0], args[1][:rows].clone(), cache) + rest
    cache["length"] = args[1]["length"]
    return args[0], cache, args[2][:rows].clone()


def _shapes(args) -> dict:
    """The shapes of the step's inputs that are not parameters."""
    out = {}
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            out[str(i)] = list(a.shape)
        elif isinstance(a, dict):
            for k, v in a.items():
                out[f"{i}/{k}"] = (list(v.shape) if isinstance(v, torch.Tensor)
                                   else v)
    return out


@contextlib.contextmanager
def _rank_context(mesh, replicated: bool):
    """The mesh's sharding context for the length of one step (a batch
    that did not split marked replicated)."""
    from repro_torch.parallel import sharding
    if mesh is None:
        yield
        return
    sharding.set_context(mesh)
    try:
        with (sharding.replicated_batch() if replicated
              else contextlib.nullcontext()):
            yield
    finally:
        sharding.set_context(None)


def prepare(cell, mesh=None, *, seed: int = 0):
    """The step one rank of ``mesh`` runs for the cell, and its inputs
    (None: a world of one rank, the meshless step a single card runs);
    under a ``FakeTensorMode`` the inputs are fake.  The parameters (and
    a train state's moments) are the rank's "model" slices.  Returns
    (step, args, context, ran): run ``step(*args)`` inside ``context``,
    the mesh's sharding context; ``ran`` states the shapes and the
    tensors split over "model"."""
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor_parallel as tpl
    args = specs.cell_inputs(cell, seed)
    step = specs.cell_step(cell, mesh)
    rows, replicated = cell.global_batch, False
    ran = {}
    if mesh is not None:
        ctx = sharding.MeshContext(mesh, sharding.DEFAULT_RULES)
        specs.place_model(args[0], mesh)
        ran["tensor_parallel"] = tpl.plan(cell.cfg, ctx)
        if cell.kind != "train":
            rows = _rows_per_rank(cell, ctx)
            replicated = rows == cell.global_batch and mesh.size() > 1
            with _rank_context(mesh, replicated):
                args = _rank_args(cell, args, rows)
    ran.update({"rows_per_rank": rows, "batch_replicated": replicated,
                "inputs": _shapes(args)})
    return step, args, _rank_context(mesh, replicated), ran


def estimate(cell, mesh=None, *, trace: bool = False, seed: int = 0):
    """Runs the cell's step once on fake CPU tensors as one rank of
    ``mesh`` (``prepare``) and returns its estimates, the artifact's keys
    from ``memory`` to ``roofline`` plus ``ran``, ``collective_groups``
    and ``run_s``, and the ``StepStats`` (with ``trace``, one row an
    op)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    n_chips = mesh.size() if mesh is not None else 1
    with FakeTensorMode():
        step, args, context, ran = prepare(cell, mesh, seed=seed)
        stats = step_stats.StepStats(args, trace=trace)
        t0 = time.monotonic()
        with context, stats:
            out = step(*args)
        stats.outputs(out)
        run_s = time.monotonic() - t0
        del out, args

    mem = stats.memory()
    peak = 0.0
    for k in ("temp_bytes", "argument_bytes", "output_bytes"):
        peak += mem.get(k) or 0.0
    peak -= mem.get("alias_bytes") or 0.0
    hs = stats.analyze()
    substitution = None
    if cell.kind in ("train", "prefill") and cell.cfg.family != "ssm":
        n_attn_layers = cell.cfg.n_layers
        if cell.cfg.is_hybrid:
            n_attn_layers = cell.cfg.n_layers // cell.cfg.hybrid_every
        substitution = {
            "flash_op_traffic_bytes": (
                stats.traffic_by_op["repro_torch.flash_fwd"]
                + stats.traffic_by_op["repro_torch.flash_bwd"]),
            "kernel_contract_bytes": n_attn_layers * fa.hbm_bytes(
                cell.cfg, cell.global_batch, cell.seq_len,
                train=(cell.kind == "train")) / n_chips,
        }
    floor = stats.memory_floor()
    mflops = hlo_analysis.model_flops_per_device(
        cell.cfg, cell.kind, cell.global_batch, cell.seq_len, n_chips)
    roof = hlo_analysis.Roofline(
        flops=hs["flops"], hbm_bytes=floor["bytes"],
        wire_bytes=hs["collective_wire_bytes"], model_flops=mflops,
        cross_node_wire_bytes=stats.cross_node_wire_bytes)
    est = {
        "memory": mem,
        "per_device_peak_bytes_est": peak,
        "fits_80gb": bool(peak < CAPACITY_BYTES),
        "xla_cost": {"flops": hs["flops"],
                     "bytes_accessed": hs["traffic_bytes"],
                     "note": "no XLA: FlopCounterMode's flops and "
                             "step_stats' eager traffic, every op counted"},
        "hlo_stats": hs,
        "attn_substitution": substitution,
        "roofline": roof.to_json(),
        "hbm_floor": floor,
        "ran": ran,
        "collective_groups": stats.group_table(),
        "run_s": run_s,
    }
    return est, stats


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: dict | None = None):
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.monotonic()
    overrides = dict(overrides or {})
    # the flash ops are the kernels: there is nothing to substitute
    overrides.pop("attn_substitute", None)
    if overrides.pop("seq_shard_rule", None) or overrides.get("seq_shard"):
        raise ValueError("seq_shard: the port's steps shard no sequence "
                         "(sequence parallelism, ROADMAP Queue A item 6)")
    if overrides.pop("serve_bf16", False):
        raise ValueError("serve_bf16: the port serves f32 weights, cast to "
                         "bf16 a call (ROADMAP Queue A item 7)")
    n_chips = math.prod(mesh_lib.PRODUCTION[multi_pod][0])
    with fake_world(n_chips):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
        cell = specs.build_cell(arch, shape, overrides=overrides or None)
        est, _ = estimate(cell, mesh)
    run_s = est.pop("run_s")
    art = {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "mesh": ("pod2x16x16" if multi_pod else "16x16"),
        "n_chips": n_chips,
        "overrides": {k: v for k, v in (overrides or {}).items()},
        "ok": True,
        "lower_s": round(time.monotonic() - t0 - run_s, 2),
        "compile_s": round(run_s, 2),
        **est,
        "param_count": cell.cfg.param_count(),
        "active_param_count": cell.cfg.active_param_count(),
        "rates": {"card": "NVIDIA H100 80GB HBM3, 700 W",
                  "peak_flops": hlo_analysis.PEAK_FLOPS,
                  "hbm_bw": hlo_analysis.HBM_BW,
                  "nvlink_bw": hlo_analysis.NVLINK_BW,
                  "network_bw": hlo_analysis.NETWORK_BW,
                  "node_size": hlo_analysis.NODE_SIZE,
                  "capacity_bytes": CAPACITY_BYTES},
    }
    return art


def summary(art: dict) -> dict:
    out = {k: art[k] for k in ("arch", "shape", "mesh", "kind", "ok",
                               "compile_s", "fits_80gb")}
    out["peak_bytes"] = art["per_device_peak_bytes_est"]
    out["bottleneck"] = art["roofline"]["bottleneck"]
    out["roofline_fraction"] = round(art["roofline"]["roofline_fraction"], 4)
    return out


def main(argv=None):
    from repro_torch import configs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k",
                    choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--set", nargs="*", dest="overrides", default=None,
                    metavar="K=V", help="ModelConfig overrides "
                    "(e.g. n_layers=4 remat=0)")
    ap.add_argument("--tag", default="", help="artifact filename suffix "
                    "(perf-iteration id)")
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.overrides)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    name = f"{args.arch}__{args.shape}__" \
           f"{'pod2' if args.multi_pod else 'pod1'}"
    if args.tag:
        name += f"__{args.tag}"

    try:
        art = run_cell(args.arch, args.shape, args.multi_pod,
                       overrides=overrides)
    except Exception as e:  # record failures as artifacts too
        art = {"arch": args.arch, "shape": args.shape,
               "mesh": "pod2x16x16" if args.multi_pod else "16x16",
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        (outdir / f"{name}.json").write_text(json.dumps(art, indent=2))
        print(json.dumps({k: art[k] for k in ("arch", "shape", "ok",
                                              "error")}, indent=2))
        raise SystemExit(1)

    (outdir / f"{name}.json").write_text(json.dumps(art, indent=2))
    print(json.dumps(summary(art), indent=2))


if __name__ == "__main__":
    main()
