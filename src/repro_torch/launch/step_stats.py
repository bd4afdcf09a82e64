"""Per-rank statistics of one call of a step: the port's counterpart of
the JAX package's ``src/repro/launch/hlo_stats.py``.

The JAX package walks the optimized HLO module.  The port has no compiled
module, so it watches the step run: ``StepStats`` is one dispatch mode
(``torch.utils.flop_counter.FlopCounterMode`` beneath it) over a single
call of the step, on fake CPU tensors in the dry-run
(``FakeTensorMode``, ``launch/dryrun.py``), and records for this rank:

  * flops          — ``FlopCounterMode``'s count: aten's formulas (mm,
                     bmm, addmm, convolution, ...) and the flash ops'
                     own (4·D a visible (query, key) pair forward, 10·D
                     backward, ``kernels/flash_attention.py``);
  * traffic bytes  — the JAX package's HBM model (``hlo_stats.py:8-14``)
                     applied to eager ops: every non-view op reads its
                     inputs and writes its outputs once, gathers and
                     in-place copies and scatters charged for the data
                     they touch.  Eager ops are not fused, so this is an
                     upper bound for an eager run (a cache hit reads
                     less), where the JAX package's is a fused module's;
  * collective wire bytes by kind and by group size — each ``c10d`` op's
                     tensors and process group read off its arguments,
                     under the JAX package's ring convention
                     (``_collective_wire``); the part in groups whose
                     ranks span more than one node of
                     ``hlo_analysis.NODE_SIZE`` kept apart;
  * the HBM floor   — the bytes the step moves however it were fused
                     (``memory_floor()``, the roofline's memory term):
                     every argument byte it reads, once (the union of the
                     byte ranges its ops read of each argument storage;
                     a gather counts the rows it takes), every byte it
                     writes into an argument (the union of the ranges
                     written), and its new outputs, once.  Intermediates,
                     the flash ops' operands among them, are left out: a
                     fused step, or the L2, may keep them off HBM;
  * memory         — the rank's live bytes: the step's arguments, the
                     storages it allocates while they live (their peak),
                     its outputs and the outputs that are arguments
                     updated in place (``memory()``, split as the JAX
                     dry-run splits XLA's memory analysis).

No loop is counted once: the step runs every layer and microbatch, so
nothing is multiplied by a trip count.  ``analyze()`` returns the keys
of ``hlo_stats.analyze``; ``trace_contributors`` lists the largest ops
by aten name and the port module that issued them.
"""

from __future__ import annotations

import math
import sys
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import hlo_analysis

aten = torch.ops.aten

# ops that move no bytes of their own (besides views, ``func.is_view``)
_NO_TRAFFIC = {
    aten._unsafe_view.default, aten.lift_fresh.default, aten.empty_like.default,
    aten.empty.memory_format, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten._local_scalar_dense.default, aten.set_.source_Storage_storage_offset,
}
# a result gathered from a table: charged for the rows it reads
_GATHERS = {aten.embedding.default, aten.index.Tensor,
            aten.index_select.default, aten.gather.default}
# in-place ops that write their destination without reading it
_OVERWRITES = {aten.copy_.default, aten.fill_.Scalar, aten.zero_.default,
               aten._foreach_copy_.default}
# c10d op name (without its overload) -> the JAX package's kind
_C10D_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"),
               ("alltoall", "all-to-all"), ("send", "collective-permute"))
_PACKAGE = "/repro_torch/"
_MAX_RUNS = 4096          # byte ranges one view may add to the floor


def _collective_wire(kind: str, result_bytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return float((n - 1) * result_bytes)      # operand = result × n
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)                    # collective-permute


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _byte_runs(t: torch.Tensor) -> list:
    """The byte ranges [start, end) of its storage a view covers: its dims
    ordered by stride (a permutation covers the same elements), repeats
    (stride 0) dropped, the innermost dims that tile without a gap merged
    into one run.  Past ``_MAX_RUNS`` runs the first alone, a subset, so
    that the floor stays one."""
    if t.numel() == 0:
        return []
    dims = sorted(((n, s) for n, s in zip(t.shape, t.stride())
                   if n > 1 and s > 0), key=lambda d: -d[1])
    run = 1
    while dims and dims[-1][1] == run:
        run *= dims.pop()[0]
    starts = [t.storage_offset()]
    if math.prod(n for n, _ in dims) <= _MAX_RUNS:
        for n, s in dims:
            starts = [a + i * s for a in starts for i in range(n)]
    es = t.element_size()
    return [(a * es, (a + run) * es) for a in starts]


def _union_bytes(runs) -> int:
    """Bytes in the union of byte ranges."""
    total, end = 0, -1
    for a, b in sorted(runs):
        if a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _tensors(tree):
    """Every tensor of a step's arguments or outputs: nested tuples,
    lists, dicts and NamedTuples, and a module's parameters and
    buffers."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storages(tree) -> dict:
    """Storage key -> bytes of every distinct storage under ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _process_group(args):
    for a in args:
        if (isinstance(a, torch.ScriptObject)
                and a._type().qualified_name().endswith("c10d.ProcessGroup")):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("a c10d op without a process group")


def _c10d_kind(func) -> str | None:
    name = func._overloadpacket.__name__
    for key, kind in _C10D_KINDS:
        if key in name:
            return kind
    if "recv" in name:
        return None               # the pair's send carries the bytes
    raise NotImplementedError(f"no wire convention for c10d.{name}")


def _issuer() -> str:
    """``path:function`` of the innermost port frame that issued the op
    being dispatched (outside this module)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if _PACKAGE in path and not path.endswith("step_stats.py"):
            rel = path.split(_PACKAGE, 1)[1]
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Recorder(TorchDispatchMode):
    def __init__(self, stats: "StepStats"):
        super().__init__()
        self.s = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        s = self.s
        before = s._flops_now()
        out = func(*args, **kwargs)
        flops = s._flops_now() - before
        traffic = s._op(func, args, kwargs, out)
        name = f"{func.namespace}.{func._overloadpacket.__name__}"
        s.flops_by_op[name] += flops
        s.traffic_by_op[name] += traffic
        if s.trace:
            shapes = [tuple(t.shape) for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
            s.rows.append((flops, traffic, name, _issuer(), shapes))
        return out


class StepStats:
    """Records one call of a step: ``with StepStats(args) as st: out =
    step(*args)``, then ``st.outputs(out)``.  ``args`` are the step's
    arguments (their storages count as argument bytes); ``trace`` keeps
    one row per op for ``trace_contributors`` and ``output_shapes``."""

    def __init__(self, args, *, trace: bool = False):
        self.trace = trace
        self.args = _storages(args)
        # the arguments' storages held for the call: one the step drops
        # (a cache entry it replaces) must not free its address, which a
        # new storage would then share as its key
        self._arg_storages = [t.untyped_storage() for t in _tensors(args)]
        self.flops_by_op: dict = defaultdict(float)
        self.traffic_by_op: dict = defaultdict(float)
        self.collectives = hlo_analysis.CollectiveStats(
            defaultdict(float), defaultdict(float), defaultdict(float), 0)
        self.groups: dict = {}        # ranks -> size, wire bytes, ops, ...
        self.arg_read: dict = defaultdict(set)     # storage -> ranges read
        self.arg_written: dict = defaultdict(set)  # ... written in place
        self.arg_gathered: dict = {}  # storage -> most rows one gather took
        self.rows: list = []
        self._live: dict = {}         # storage key -> bytes, new storages
        self._cur = self.peak = 0
        self._out: dict = {}
        self._flops = FlopCounterMode(display=False)

    # -- the modes -----------------------------------------------------
    def __enter__(self):
        self._flops.__enter__()
        self._mode = _Recorder(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def _flops_now(self) -> int:
        return sum(self._flops.flop_counts["Global"].values())

    # -- one op ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self.args:
            return
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        self.peak = max(self.peak, self._cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._cur -= self._live.pop(key, 0)

    def _op(self, func, args, kwargs, out) -> float:
        """Records the op's new storages and collectives; returns its
        traffic bytes."""
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.namespace == "c10d":
            # a collective reads its inputs (and writes its outputs) too:
            # a weight slice only gathered is still read once
            self._arguments(func, args, kwargs, outs)
            return self._collective(func, args)
        if func.is_view or func in _NO_TRAFFIC:
            return 0.0
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        written = list(outs)
        if not outs:        # in-place ops returning nothing (_foreach_*_)
            for a, arg in zip(func._schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write:
                    written += [t for t in tree_leaves(arg)
                                if isinstance(t, torch.Tensor)]
        if not written:     # metadata queries: prim.device, sizes
            return 0.0
        self._arguments(func, args, kwargs, outs)
        if func in _GATHERS:
            return 2.0 * sum(_nbytes(t) for t in outs) + _nbytes(ins[-1])
        if func is aten.copy_.default:
            return 2.0 * _nbytes(ins[0])           # read src, write dst
        if func in (aten.fill_.Scalar, aten.zero_.default):
            return float(_nbytes(ins[0]))
        return float(sum(_nbytes(t) for t in ins)
                     + sum(_nbytes(t) for t in written))

    def _arguments(self, func, args, kwargs, outs) -> None:
        """The floor's share of one op: the byte ranges of each argument
        storage it reads, and writes in place."""
        schema = func._schema.arguments
        named = list(zip(schema, args)) + [(a, kwargs[a.name])
                                           for a in schema if a.name in kwargs]
        for i, (a, val) in enumerate(named):
            write = a.alias_info is not None and a.alias_info.is_write
            for t in tree_leaves(val):
                if not isinstance(t, torch.Tensor):
                    continue
                key = t.untyped_storage()._cdata
                if key not in self.args:
                    continue
                if write:
                    self.arg_written[key].update(_byte_runs(t))
                    if func in _OVERWRITES:
                        continue
                elif func in _GATHERS and i == 0:     # the rows taken
                    n = min(sum(_nbytes(o) for o in outs), self.args[key])
                    self.arg_gathered[key] = max(
                        self.arg_gathered.get(key, 0), n)
                    continue
                self.arg_read[key].update(_byte_runs(t))

    def _collective(self, func, args) -> float:
        kind = _c10d_kind(func)
        ts = [t for t in tree_leaves(list(args))
              if isinstance(t, torch.Tensor)]
        if kind is None:
            return float(sum(_nbytes(t) for t in ts))
        pg = _process_group(args)
        n = pg.size()
        # the first tensor argument is the result (all-reduce: in place;
        # all-gather / reduce-scatter / all-to-all: the output) or, for a
        # send, the operand
        res = sum(_nbytes(t) for t in tree_leaves(args[0])
                  if isinstance(t, torch.Tensor))
        w = _collective_wire(kind, res, n)
        c = self.collectives
        c.by_kind_bytes[kind] += res * n if kind == "reduce-scatter" else res
        c.by_kind_wire[kind] += w
        c.by_group_wire[n] += w
        c.n_ops += 1
        ranks = tuple(dist.get_process_group_ranks(pg))
        g = self.groups.setdefault(ranks, {
            "size": n, "first_ranks": list(ranks[:4]),
            "crosses_nodes": hlo_analysis.crosses_nodes(ranks),
            "wire_bytes": 0.0, "ops": 0, "wire_by_kind": defaultdict(float)})
        g["wire_bytes"] += w
        g["wire_by_kind"][kind] += w
        g["ops"] += 1
        return float(sum(_nbytes(t) for t in ts) + res)

    # -- after the call --------------------------------------------------
    def outputs(self, out) -> None:
        """Names the step's outputs (call once after the step)."""
        self._out = _storages(out)

    @property
    def cross_node_wire_bytes(self) -> float:
        return sum(g["wire_bytes"] for g in self.groups.values()
                   if g["crosses_nodes"])

    def group_table(self) -> list:
        """One entry a process group the step communicated over: size,
        its first ranks, whether it spans nodes, wire bytes (in all and
        by kind), ops."""
        return sorted(({**g, "wire_by_kind": dict(g["wire_by_kind"])}
                       for g in self.groups.values()),
                      key=lambda g: -g["wire_bytes"])

    def memory(self) -> dict:
        """Argument, output, temporary and aliased bytes of the call, as
        the JAX dry-run reads XLA's memory analysis: ``temp_bytes`` is the
        peak of what the step allocated less its new outputs, so that
        temp + argument + output - alias is the rank's peak."""
        arg = sum(self.args.values())
        alias = sum(n for k, n in self._out.items() if k in self.args)
        out = sum(self._out.values())
        new_out = out - alias
        return {"argument_bytes": arg, "output_bytes": out,
                "temp_bytes": max(self.peak - new_out, 0),
                "generated_code_bytes": None, "alias_bytes": alias}

    def memory_floor(self) -> dict:
        """The HBM bytes the call cannot move less of (see the module's
        docstring), by part; ``bytes`` is their sum."""
        read = float(sum(
            max(_union_bytes(self.arg_read.get(k, ())),
                self.arg_gathered.get(k, 0))
            for k in set(self.arg_read) | set(self.arg_gathered)))
        written = float(sum(_union_bytes(r) for r in self.arg_written.values()))
        new = float(sum(n for k, n in self._out.items() if k not in self.args))
        return {"argument_read_bytes": read, "argument_written_bytes": written,
                "new_output_bytes": new, "bytes": read + written + new}

    def analyze(self) -> dict:
        coll = self.collectives.to_json()
        return {
            "flops": float(self._flops.get_total_flops()),
            "traffic_bytes": float(sum(self.traffic_by_op.values())),
            "collective_wire_bytes": float(coll["total_wire_bytes"]),
            "wire_by_kind": coll["wire_by_kind"],
            "wire_by_group_size": coll["wire_by_group_size"],
            "n_collectives": coll["n_ops"],
        }

    def output_shapes(self) -> set:
        """Every shape an op of the call returned (``trace`` only)."""
        return {sh for row in self.rows for sh in row[4]}


def trace_contributors(stats: StepStats, top: int | None = 25) -> list:
    """The largest contributors of a traced call, summed by (aten op,
    issuing port function): rows of (traffic bytes, flops, calls, aten
    op, issuer), the largest traffic first."""
    acc: dict = {}
    for flops, traffic, name, issuer, _ in stats.rows:
        row = acc.setdefault((name, issuer), [0.0, 0.0, 0])
        row[0] += traffic
        row[1] += flops
        row[2] += 1
    out = sorted(((t, f, c, name, issuer)
                  for (name, issuer), (t, f, c) in acc.items()),
                 reverse=True)
    return out if top is None else out[:top]
