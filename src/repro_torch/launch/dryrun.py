"""Multi-pod dry-run on fake tensors: run one step of every (architecture ×
input shape) cell as one rank of the production mesh, and read its
flops, traffic, collectives, memory and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch] \\
        [--set n_layers=4 remat=0 ...] [--tag TAG] [--save-hlo PATH]

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
expert-parallel) and FSDP over "data" (``parallel.fsdp``: every weight
held as the rank's ``spec_for`` slice, its d_model dim split over
"data" where it divides, gathered a block at a time as the block runs):

  * train   — ``make_train_step(..., mesh=)``: data-parallel over the
              batch axes, each rank taking its rows of every microbatch;
              every parameter and both AdamW moments held as the rank's
              "data" and "model" slice (``specs.place``); a gradient
              split over "data" is reduce-scattered over it in the
              backward (and all-reduced over "pod"), the rest
              all-reduced over each batch axis.  A cell whose state does
              not fit one card says so in ``fits_80gb``.
  * prefill / decode — the serve steps under the mesh's sharding
              context: the rank runs its rows of the batch as
              ``batch_specs`` / ``cache_specs`` split the batch axes (all
              of it where the batch does not split) on its slices of the
              parameters and of the cache (below).  ``ran`` states the
              shapes that ran and, under ``tensor_parallel`` and
              ``fsdp``, which tensors split.
              ``--set serve_bf16=true`` is the JAX package's serving
              deployment: rules ``p_embed -> ()`` (weights replicated
              over "data", no per-step gather) and every f32 parameter
              held as bf16 (``specs.serve_bf16_params``); a train cell
              ignores it.

``--set seq_shard=1`` (or ``seq_shard_rule=model``) adds the JAX
package's rule ``seq_res -> ("model",)``: the residual stream of a
train or prefill step whose S divides "model" is each rank's positions
of the sequence between the regions (``parallel.sequence_parallel``).
Whatever the rule, a serve cell's rank holds its rows of the batch, its
"data" and "model" slices of the parameters (gathered over "data" a
block at a time, every step) and its ``cache_specs`` slice of the KV
cache: its rows, its KV heads where they split over "model" and its
positions of T where T splits over the axes those leave unused (the
SSM state and conv window whole over "model").

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

``--save-hlo PATH`` (``run_cell(..., save_hlo=)``) writes what the port
has in the optimized HLO's place: the step's recorded op trace
(``estimate(trace=True)``, ``step_stats.trace_lines``), one line an op
with its output shapes, flops and traffic and, for a ``c10d`` op, its
group and bytes.
"""

from __future__ import annotations

import argparse
import contextlib
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
    they are, its rows of the tokens and the memory, and its slice of
    the cache, built under the sharding context (``cache_specs``)."""
    cache = specs.abstract_cache(cell, cell.global_batch, cell.seq_len)
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
def _rank_context(mesh, replicated: bool, rules=None):
    """The mesh's sharding context (``rules``: the default ones unless
    given) for the length of one step (a batch that did not split marked
    replicated)."""
    from repro_torch.parallel import sharding
    if mesh is None:
        yield
        return
    sharding.set_context(mesh, rules)
    try:
        with (sharding.replicated_batch() if replicated
              else contextlib.nullcontext()):
            yield
    finally:
        sharding.set_context(None)


def prepare(cell, mesh=None, *, seed: int = 0, serve_bf16: bool = False,
            seq_shard: bool = False):
    """The step one rank of ``mesh`` runs for the cell, and its inputs
    (None: a world of one rank, the meshless step a single card runs);
    under a ``FakeTensorMode`` the inputs are fake.  The parameters (and
    a train state's moments) are the rank's "data" and "model" slices;
    with ``serve_bf16`` (prefill and decode only) bf16 and whole over
    "data"; with ``seq_shard`` the rules add ``seq_res -> ("model",)``.
    Returns (step, args, context, ran): run ``step(*args)`` inside
    ``context``, the mesh's sharding context; ``ran`` states the shapes
    and the tensors split over "model" and "data"."""
    from repro_torch.parallel import sequence_parallel as seqp
    from repro_torch.parallel import sharding
    from repro_torch.parallel import tensor_parallel as tpl
    serve_bf16 = serve_bf16 and cell.kind in ("prefill", "decode")
    rules = None
    if seq_shard:
        rules = dict(seqp.RULES)
    if serve_bf16:
        # the serving deployment's rules: weights replicated over "data"
        rules = {**(rules or sharding.DEFAULT_RULES), "p_embed": ()}
    args = specs.cell_inputs(cell, seed)
    if serve_bf16:
        specs.serve_bf16_params(args[0])
    step = specs.cell_step(cell, mesh)
    rows, replicated = cell.global_batch, False
    ran = {"serve_bf16": serve_bf16, "seq_shard": seq_shard}
    if mesh is not None:
        ctx = sharding.MeshContext(mesh, rules or sharding.DEFAULT_RULES)
        specs.place(args[0], mesh, rules=rules)
        ran["tensor_parallel"] = tpl.plan(cell.cfg, ctx)
        # the residual stream [B, S, d] of the step (decode's S is 1)
        stream = (cell.global_batch, 1 if cell.kind == "decode"
                  else cell.seq_len, cell.cfg.d_model)
        with _rank_context(mesh, False, rules):
            ran["sequence_parallel"] = seqp.split(stream) is not None
        _, dims = (specs.placement(args[0]) or {}).get("data", (1, ()))
        ran["fsdp"] = {"data": ctx.shape.get("data", 1),
                       "split_tensors": sum(d is not None for d in dims)}
        if cell.kind != "train":
            rows = _rows_per_rank(cell, ctx)
            replicated = rows == cell.global_batch and mesh.size() > 1
            with _rank_context(mesh, replicated, rules):
                args = _rank_args(cell, args, rows)
    ran.update({"rows_per_rank": rows, "batch_replicated": replicated,
                "inputs": _shapes(args)})
    return step, args, _rank_context(mesh, replicated, rules), ran


def estimate(cell, mesh=None, *, trace: bool = False, seed: int = 0,
             serve_bf16: bool = False, seq_shard: bool = False):
    """Runs the cell's step once on fake CPU tensors as one rank of
    ``mesh`` (``prepare``) and returns its estimates, the artifact's keys
    from ``memory`` to ``roofline`` plus ``ran``, ``collective_groups``
    and ``run_s``, and the ``StepStats`` (with ``trace``, one row an
    op)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    n_chips = mesh.size() if mesh is not None else 1
    with FakeTensorMode():
        step, args, context, ran = prepare(cell, mesh, seed=seed,
                                           serve_bf16=serve_bf16,
                                           seq_shard=seq_shard)
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
             overrides: dict | None = None, save_hlo: str | None = None):
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.monotonic()
    overrides = dict(overrides or {})
    # the flash ops are the kernels: there is nothing to substitute
    overrides.pop("attn_substitute", None)
    # the JAX package's rule: seq_res -> ("model",)
    seq_shard = bool(overrides.pop("seq_shard_rule", None)
                     or overrides.get("seq_shard"))
    serve_bf16 = bool(overrides.pop("serve_bf16", False))
    n_chips = math.prod(mesh_lib.PRODUCTION[multi_pod][0])
    with fake_world(n_chips):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="cpu")
        cell = specs.build_cell(arch, shape, overrides=overrides or None)
        est, stats = estimate(cell, mesh, trace=bool(save_hlo),
                              serve_bf16=serve_bf16, seq_shard=seq_shard)
    if save_hlo:
        pathlib.Path(save_hlo).write_text(
            "\n".join(step_stats.trace_lines(stats)) + "\n")
    run_s = est.pop("run_s")
    art = {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "mesh": ("pod2x16x16" if multi_pod else "16x16"),
        "n_chips": n_chips,
        "overrides": {**overrides,
                      **({"serve_bf16": True} if serve_bf16 else {})},
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
    ap.add_argument("--save-hlo", default=None,
                    help="also write the step's op trace (the port's "
                    "stand-in for the optimized HLO text) to this path")
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
                       overrides=overrides, save_hlo=args.save_hlo)
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
