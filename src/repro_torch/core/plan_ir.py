"""Multi-step query-plan IR: cascades of fused 3-way and binary joins.

The paper's central result is a *choice* — one fused 3-way join versus a
cascade of binary hash joins — and this module is the representation that
makes the choice first-class for any connected acyclic equality-join graph
over N >= 2 named relations (cyclic graphs stay supported at N = 3, the
triangle query):

  * :class:`PlanStep` — one physical step.  ``op == "binary"`` is a
    sorted-path hash join (materialized into a fixed-capacity intermediate
    ``Relation``, or host-aggregated when it is the root); ``op ==
    "fused3"`` is the fused 3-way engine, recovery-wrapped: skew rounds +
    the exact-histogram final round make ``overflowed == False`` a
    per-step postcondition.
  * :class:`QueryPlan` — a DAG of steps in topological order.  Steps name
    their inputs (base relations by query name, intermediates as
    ``%i<k>``); intermediate schemas (``project``) and plan-time
    cardinality estimates (``est_rows``/``est_out``) flow between steps;
    the root step writes :data:`COUNT`.
  * :func:`execute_plan` — the ONE executor, device-resident end to end.
    Each binary materialize step runs as a two-stage pipeline
    (``binary_join.stage_join`` → ``gather_staged``) whose only host↔
    device traffic is the exact scalar total that sizes the output
    buffer (log-bucketed capacities).  Steps overlap: before the executor
    blocks on a step's total it enqueues stage 1 of every later binary
    step whose inputs are already live (the CUDA stream runs them while
    the host waits), and a refcounting buffer arena drops each ``%i<k>``
    intermediate the moment its last consumer has captured it.
    ``base_salt``/``max_rounds``/``growth`` thread through every fused
    step; count / tuples_read / recovery rounds / per-step timings
    aggregate into a single result.

``planner.plan_query`` is the decomposer that produces these plans;
``session.JoinSession.execute`` walks them.  The legacy
``planner.EnginePlan.run`` cascade branch now routes through this
executor too — there is no second cascade implementation.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.analysis import arena_sanitizer
from repro_torch.analysis.errors import (PlanPerRError, PlanStructureError,
                                   PlanWidthError)
from repro_torch.core import binary_join, engine, recovery
from repro_torch.core.query import Predicate
from repro_torch.core.relation import Relation

# The root step's output name: the aggregated COUNT of the whole query.
COUNT = "%count"


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One physical step of a :class:`QueryPlan`.

    ``inputs`` are environment names: base relations keep their query
    names, intermediates are ``%i<k>``.  ``preds`` reference columns in
    the *post-projection* key space of each input (base relations keep
    their original column names; intermediate columns are
    ``"<relation>.<column>"``, stamped by the materialize step that
    produced them).
    """

    op: str                              # "binary" | "fused3"
    out: str                             # "%i<k>" or COUNT
    inputs: tuple[str, ...]              # 2 (binary) or 3 (fused3) names
    preds: tuple[Predicate, ...]         # equality predicates among inputs
    aggregate: bool                      # root COUNT step vs materialize
    # binary materialize: per-input projection ((src col, dst col), ...) —
    # only the columns later steps read survive into the intermediate
    project: tuple = ()
    # fused3 bookkeeping: the classified kind, engine role -> input name,
    # engine col kwarg -> column key, and (optionally) a pre-sized shape
    # plan.  ``shape_plan is None`` means "size at execute time from the
    # live cardinalities" — the rule for steps that read intermediates.
    kind: str | None = None
    roles: tuple[tuple[str, str], ...] = ()
    cols: tuple[tuple[str, str], ...] = ()
    shape_plan: object | None = None
    recovery: bool = True                # fused3 steps run skew recovery
    choice: object | None = None         # planner.TimedChoice, if one ran
    est_rows: tuple[int, ...] = ()       # plan-time input-card estimates
    est_out: int | None = None           # plan-time output-rows estimate
    # fused3 root only: per-R group counts requested, keyed by this column
    # of the role-r input — the executor answers through the recovery
    # engine's per-R rounds and surfaces PlanExecResult.per_r
    per_r_key: str | None = None

    def describe(self) -> str:
        if self.op == "fused3":
            ins = ", ".join(self.inputs)
            per_r = (f", per_r[{self.per_r_key}]" if self.per_r_key
                     else "")
            return (f"{self.out} <- fused3[{self.kind}"
                    f"{', recovery' if self.recovery else ''}{per_r}]"
                    f"({ins})")
        (p,) = self.preds
        verb = "count" if self.aggregate else "join"
        est = "" if self.est_out is None else f"  [~{self.est_out} rows]"
        return (f"{self.out} <- binary-{verb}({self.inputs[0]} ⋈ "
                f"{self.inputs[1]} on {p.left[1]} = {p.right[1]}){est}")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A DAG of :class:`PlanStep` in topological order, plus the engine
    configuration every step shares.  This object is what the session's
    plan cache stores: it references relations by NAME only, so a cached
    plan re-executes against refreshed data of similar size."""

    steps: tuple[PlanStep, ...]
    n_relations: int
    kind: str                # classified kind of the (root) frontier
    strategy: str            # "3way" | "cascade" | "hybrid"
    m_budget: int | None = None
    max_rounds: int = 3
    growth: float = 2.0
    base_salt: int = 0

    @property
    def fused3_steps(self) -> tuple[PlanStep, ...]:
        return tuple(s for s in self.steps if s.op == "fused3")

    @property
    def root(self) -> PlanStep:
        return self.steps[-1]

    def describe(self) -> str:
        head = (f"QueryPlan[{self.n_relations} relations, kind={self.kind}, "
                f"strategy={self.strategy}]")
        return "\n".join([head] + ["  " + s.describe() for s in self.steps])


class StepStats(NamedTuple):
    """Per-step execution record (aggregated onto the QueryResult).

    ``exec_s`` is the host time the executor's loop spent on the step —
    under async dispatch that is mostly the blocking two-scalar total
    sync, NOT the device work.  ``dispatch_s`` is the slice of it spent
    enqueueing the step's device work (stage + gather).  ``wall_s`` is
    the step's start-to-buffers-ready wall time and is only populated
    when ``execute_plan(..., profile=True)`` blocks per step — it is 0.0
    on the overlapped default path, where per-step wall time is not a
    well-defined quantity."""

    op: str
    out: str
    rows: int                # materialized rows, or the aggregated count
    rounds: int              # recovery rounds (0 for binary steps)
    tuples_read: int
    exec_s: float
    dispatch_s: float = 0.0  # host time enqueueing device work
    wall_s: float = 0.0      # blocked wall time (profile=True only)


class PlanExecResult(NamedTuple):
    count: int
    overflowed: bool         # False by construction (see execute_plan)
    tuples_read: int         # summed over steps (intermediates counted as
    rounds: int              # written once + read once, like §6.3)
    step_stats: tuple
    per_r: recovery.PerRResult | None = None  # root per-R group counts
    # keep_intermediates=True only: the materialized %i<k> Relations, kept
    # resident instead of arena-dropped (standing queries refresh these
    # incrementally on ingest)
    intermediates: dict | None = None


def _step_keys(step: PlanStep) -> tuple[str, str]:
    """The (left-input, right-input) join column keys of a binary step."""
    (pred,) = step.preds
    if pred.left[0] == step.inputs[0]:
        return pred.left[1], pred.right[1]
    return pred.right[1], pred.left[1]


def _project(rel: Relation, mapping) -> Relation:
    if not mapping:
        return rel
    return Relation({dst: rel.columns[src] for src, dst in mapping},
                    rel.valid)


class _Staged(NamedTuple):
    """A binary step whose stage-1 pipeline (sort + ranges + exact total)
    has been dispatched.  The inputs are captured here — once every
    consumer of an intermediate holds its capture, the arena drops the
    intermediate from the environment."""

    staged: binary_join.StagedJoin
    probe: Relation            # projected probe side (stage 2 reads it)
    na: object                 # device scalars: live input cardinalities
    nb: object                 # (synced with the total, not eagerly)
    dispatch_s: float


def _stage_binary(step: PlanStep, env) -> _Staged:
    """Enqueue stage 1 of a binary step (no host sync)."""
    a, b = env[step.inputs[0]], env[step.inputs[1]]
    proj_a, proj_b = step.project if step.project else ((), ())
    a2, b2 = _project(a, proj_a), _project(b, proj_b)
    ka, kb = _step_keys(step)
    t0 = time.perf_counter()
    st = binary_join.stage_join(a2, b2, build_key=ka, probe_key=kb)
    return _Staged(st, b2, a.n, b.n, time.perf_counter() - t0)


def _run_fused3(step: PlanStep, plan: QueryPlan, env):
    """Execute a fused 3-way step through the recovery-wrapped engine.
    ``shape_plan is None`` sizes the partition shape here, from the LIVE
    input cardinalities (the inputs may be just-materialized
    intermediates whose sizes no plan-time estimate pinned down).  A
    ``per_r_key`` stamp routes the step through the per-R recovery
    rounds instead of the scalar count — returns a PerRResult then."""
    rels = {role: env[name] for role, name in step.roles}
    r, s, t = rels["r"], rels["s"], rels["t"]
    eng = engine.MultiwayJoinEngine(
        step.kind, max_rounds=plan.max_rounds,
        growth=plan.growth, base_salt=plan.base_salt)
    shape = step.shape_plan
    if shape is None:
        shape = eng.default_plan(int(r.n), int(s.n), int(t.n),
                                 m_budget=plan.m_budget)
    if step.per_r_key is not None:
        if step.kind != "linear":
            raise PlanPerRError(
                "per-R fused steps must be linear; planner emitted kind "
                f"{step.kind!r}", step=step)
        return recovery.run_per_r_rounds(
            recovery.LinearOps(**dict(step.cols)), r, s, t, shape,
            max_rounds=plan.max_rounds, growth=plan.growth,
            base_salt=plan.base_salt,
            key_col=step.per_r_key)
    return eng.count(r, s, t, shape, **dict(step.cols))


def execute_plan(plan: QueryPlan, relations: Mapping[str, Relation], *,
                 profile: bool = False,
                 keep_intermediates: bool = False) -> PlanExecResult:
    """Walk the DAG: materialize intermediates, aggregate at the root.

    Device-resident and overlapped: every binary step is two stages
    (stage: sort + match ranges + exact int64 total; gather: prefix-sum
    offsets + materialize into a log-bucketed capacity), and before
    blocking on a step's scalar total the executor enqueues stage 1 of
    every later binary step whose inputs are already live — the CUDA
    stream runs them while the host waits, and the fused root's recovery
    rounds queue behind still-in-flight gathers.  A refcounting arena
    drops each ``%i<k>`` intermediate from the environment as soon as its
    last consumer has captured it, so its memory can be reused.

    ``overflowed == False`` is a postcondition of the whole walk: binary
    materialize steps are exact-sized on device (the gather capacity
    covers the exact total), binary aggregates are exact int64 sums, and
    fused steps inherit the recovery engine's exact-histogram
    final round.

    ``profile=True`` blocks on each step's output buffers and fills
    ``StepStats.wall_s`` — attribution mode for benches; it serializes
    the overlap, so leave it off on the hot path.

    ``keep_intermediates=True`` disables the arena drop and returns every
    materialized ``%i<k>`` on ``PlanExecResult.intermediates`` — the
    standing-query path, which keeps them resident and refreshes them
    incrementally on ingest instead of recomputing.
    """
    if os.environ.get("REPRO_VERIFY_PLANS", "") not in ("", "0"):
        # execute-time re-verification: static checks against the live
        # environment plus width analysis over the live cardinalities
        from repro_torch.analysis import verify_plan as _verify
        from repro_torch.analysis import widths as _widths
        _verify.verify_plan(plan, external=set(relations))
        _widths.check_widths(
            plan, {name: int(rel.n) for name, rel in relations.items()})

    steps = plan.steps
    env: dict[str, Relation] = dict(relations)
    # arena refcounts: consumers left per environment name (base relations
    # are caller-owned and never dropped; every %i<k> is dropped at zero)
    readers: dict[str, int] = {}
    for s in steps:
        for n in s.inputs:
            readers[n] = readers.get(n, 0) + 1
    shadow = arena_sanitizer.begin(plan, relations, keep_intermediates)

    def release(name: str) -> None:
        if shadow is not None:
            shadow.on_release(name)
        readers[name] -= 1
        if (readers[name] == 0 and name.startswith("%")
                and not keep_intermediates):
            if shadow is not None:
                shadow.on_drop(name)
            env.pop(name, None)

    staged: dict[int, _Staged] = {}

    def stage_ready(start: int) -> None:
        # dispatch stage 1 of every not-yet-staged later binary step whose
        # inputs are live — this is the overlap: it runs BEFORE the
        # executor blocks on the current step's total
        for j in range(start, len(steps)):
            s = steps[j]
            if (j not in staged and s.op == "binary"
                    and all(n in env for n in s.inputs)):
                staged[j] = _stage_binary(s, env)
                for n in s.inputs:
                    release(n)

    total_tuples = 0
    rounds = 0
    count = 0
    per_r = None
    stats: list[StepStats] = []
    for i, step in enumerate(steps):
        t0 = time.perf_counter()
        if step.op == "binary":
            stage_ready(i)
            sg = staged.pop(i)
            dispatch_s = sg.dispatch_s
            total = binary_join.staged_total(sg.staged)  # sync: 1 scalar
            tuples = int(sg.na) + int(sg.nb)
            if step.aggregate:
                count = total
                out = None
            else:
                if total >= 2**31:
                    raise PlanWidthError(
                        f"intermediate {step.out} has {total} rows — too "
                        "large to materialize; re-plan with "
                        "strategy='3way' (the fused 3-way engine never "
                        "materializes the join output)", step=step)
                cap = binary_join.bucket_capacity(total)
                t_d = time.perf_counter()
                out = binary_join.gather_staged(sg.staged, sg.probe, cap)
                dispatch_s += time.perf_counter() - t_d
                if shadow is not None:
                    shadow.on_produce(step.out)
                env[step.out] = out
                tuples += total               # intermediate written once
                # producing %i<k> may unblock dependent steps: overlap
                # their stage 1 with this gather already in flight
                stage_ready(i + 1)
            if profile and out is not None and out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            rows = count if step.aggregate else total
            total_tuples += tuples
            stats.append(StepStats(
                "binary", step.out, rows, 0, tuples,
                time.perf_counter() - t0, dispatch_s,
                (time.perf_counter() - t0) if profile else 0.0))
        elif step.op == "fused3":
            if not step.aggregate:
                raise PlanStructureError(
                    "fused3 steps aggregate (the engine never materializes "
                    f"its output); step {step.out!r} tries to materialize",
                    step=step)
            res = _run_fused3(step, plan, env)
            for n in step.inputs:
                release(n)
            if step.per_r_key is not None:
                per_r = res
            count = int(res.count)
            total_tuples += int(res.tuples_read)
            rounds += int(res.rounds)
            stats.append(StepStats(
                "fused3", step.out, count, int(res.rounds),
                int(res.tuples_read), time.perf_counter() - t0, 0.0,
                (time.perf_counter() - t0) if profile else 0.0))
        else:
            raise PlanStructureError(f"unknown plan-step op {step.op!r}",
                                     step=step)
    overflowed = bool(per_r.overflowed) if per_r is not None else False
    if shadow is not None:
        shadow.finish(env)
    inter = None
    if keep_intermediates:
        inter = {s.out: env[s.out] for s in steps
                 if s.op == "binary" and not s.aggregate and s.out in env}
    return PlanExecResult(int(count), overflowed, int(total_tuples),
                          max(rounds, 1), tuple(stats), per_r, inter)


def result_as_engine(res: PlanExecResult) -> engine.EngineResult:
    """Repackage a plan walk as the EngineResult contract."""
    return engine.EngineResult(np.int64(res.count), False,
                               np.int64(res.tuples_read), res.rounds)
