"""Static verifier for ``core.plan_ir.QueryPlan`` DAGs.

``execute_plan`` trusts its input: a plan with steps out of topological
order, a projection that drops a column a later predicate reads, or a
per-R pin on a cyclic root would fail deep inside a kernel (or worse,
answer wrong).  :func:`verify_plan` checks the whole contract as pure
bookkeeping — no device work, microseconds per plan — and raises a typed
:class:`~repro_torch.analysis.errors.PlanValidationError` naming the failing
step via its ``describe()``.

Checked invariants (one exception class per family):

  structure  — ops are known; the root (and only the root) aggregates to
               ``%count``; fused3 steps are aggregate roots; binary steps
               have 2 inputs + 1 predicate, fused3 have 3 inputs with a
               role permutation and kind-complete column bindings; every
               ``%i<k>`` is defined exactly once, before first use; every
               relation the caller names is read by some step
  schema     — projections and predicates only reference columns their
               (post-projection) inputs carry; destination columns never
               collide
  refcount   — every materialized intermediate has at least one consumer
               (mirrors the executor's refcounting arena: a consumer
               count of zero means the buffer would leak)
  per_r      — a ``per_r_key`` pin sits on the linear fused root and the
               key is a column of the role-r input

Two call modes:

* **Plan time** (``session.JoinSession._plan``, always on): ``schemas``
  maps each base relation to its column set, so schema propagation is
  checked end to end, and every ``%``-named input must be defined by an
  earlier step.
* **Execute time** (``REPRO_VERIFY_PLANS=1`` in ``execute_plan``):
  ``external`` is the execution environment's name set.  Streaming delta
  plans legitimately read resident ``%i<k>`` intermediates and ``%d·``
  delta relations straight from the environment, so any external name is
  an allowed input there.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

from repro_torch.analysis.errors import (PlanPerRError, PlanRefcountError,
                                   PlanSchemaError, PlanStructureError)
from repro_torch.core import plan_ir

_INTERMEDIATE = re.compile(r"^%i\d+$")

# engine column kwarg -> fused role its column must live on, per kind
_KIND_COLS = {
    "linear": {"rb": "r", "sb": "s", "sc": "s", "tc": "t"},
    "star": {"rb": "r", "sb": "s", "sc": "s", "tc": "t"},
    "cyclic": {"ra": "r", "rb": "r", "sb": "s", "sc": "s",
               "tc": "t", "ta": "t"},
}


def _schema_of(step: plan_ir.PlanStep, in_schemas) -> frozenset | None:
    """Output schema of a binary materialize step: the destination columns
    of both projections, or the union of input schemas when a side is
    unprojected.  ``None`` when an unprojected side's schema is unknown."""
    proj_a, proj_b = step.project if step.project else ((), ())
    out: set[str] = set()
    for proj, schema, name in ((proj_a, in_schemas[0], step.inputs[0]),
                               (proj_b, in_schemas[1], step.inputs[1])):
        if proj:
            cols = [dst for _src, dst in proj]
        elif schema is not None:
            cols = sorted(schema)
        else:
            return None
        for c in cols:
            if c in out:
                raise PlanSchemaError(
                    f"projection destination column {c!r} (from input "
                    f"{name!r}) collides with the other side's output",
                    step=step)
            out.add(c)
    return frozenset(out)


def _check_pred_cols(step, index, schemas_by_input) -> None:
    """Predicates reference the post-projection key space of each input."""
    proj = dict(zip(step.inputs, step.project)) if step.project else {}
    for pred in step.preds:
        for name, col in (pred.left, pred.right):
            if name not in step.inputs:
                raise PlanStructureError(
                    f"predicate endpoint {name!r} is not one of the "
                    f"step's inputs {step.inputs}", step=step, index=index)
            mapping = proj.get(name, ())
            if mapping:
                space = {dst for _src, dst in mapping}
            else:
                space = schemas_by_input.get(name)
                if space is None:
                    continue
            if col not in space:
                raise PlanSchemaError(
                    f"predicate column {col!r} is not in the "
                    f"post-projection key space of input {name!r} "
                    f"({sorted(space)})", step=step, index=index)


def _check_binary(step, index, schemas_by_input) -> None:
    if len(step.inputs) != 2:
        raise PlanStructureError(
            f"binary steps take 2 inputs, got {len(step.inputs)}",
            step=step, index=index)
    if len(step.preds) != 1:
        raise PlanStructureError(
            f"binary steps join on exactly 1 predicate, got "
            f"{len(step.preds)}", step=step, index=index)
    if step.per_r_key is not None:
        raise PlanPerRError(
            "per-R pins live on the fused linear root, not on binary "
            "steps", step=step, index=index)
    if step.project:
        if len(step.project) != 2:
            raise PlanStructureError(
                "binary projections are one (src, dst) tuple per input",
                step=step, index=index)
        for proj, name in zip(step.project, step.inputs):
            schema = schemas_by_input.get(name)
            if schema is None:
                continue
            for src, _dst in proj:
                if src not in schema:
                    raise PlanSchemaError(
                        f"projection source column {src!r} is not a "
                        f"column of input {name!r} ({sorted(schema)})",
                        step=step, index=index)
    _check_pred_cols(step, index, schemas_by_input)


def _check_fused3(step, index, is_root, schemas_by_input) -> None:
    if not step.aggregate:
        raise PlanStructureError(
            "fused3 steps aggregate (the engine never materializes its "
            f"output); step {step.out!r} tries to materialize",
            step=step, index=index)
    if not is_root:
        raise PlanStructureError(
            "fused3 steps are aggregate-only, so they can only be the "
            "plan root — no later step could read this one's output",
            step=step, index=index)
    if len(step.inputs) != 3:
        raise PlanStructureError(
            f"fused3 steps take 3 inputs, got {len(step.inputs)}",
            step=step, index=index)
    if step.kind not in _KIND_COLS:
        raise PlanStructureError(
            f"unknown fused kind {step.kind!r}; choose from "
            f"{sorted(_KIND_COLS)}", step=step, index=index)
    if not step.recovery:
        raise PlanStructureError(
            "fused3 steps must be recovery-wrapped (recovery=False breaks "
            "the overflowed == False postcondition)", step=step,
            index=index)
    roles = dict(step.roles)
    if sorted(roles) != ["r", "s", "t"]:
        raise PlanStructureError(
            f"fused3 roles must bind exactly r/s/t, got "
            f"{sorted(roles)}", step=step, index=index)
    if sorted(roles.values()) != sorted(step.inputs):
        raise PlanStructureError(
            f"fused3 roles {roles} are not a permutation of the step's "
            f"inputs {step.inputs}", step=step, index=index)
    cols = dict(step.cols)
    expected = _KIND_COLS[step.kind]
    if set(cols) != set(expected):
        raise PlanStructureError(
            f"{step.kind} fused steps bind columns {sorted(expected)}, "
            f"got {sorted(cols)}", step=step, index=index)
    for kwarg, col in cols.items():
        schema = schemas_by_input.get(roles[expected[kwarg]])
        if schema is not None and col not in schema:
            raise PlanSchemaError(
                f"column binding {kwarg}={col!r} is not a column of the "
                f"role-{expected[kwarg]} input "
                f"{roles[expected[kwarg]]!r} ({sorted(schema)})",
                step=step, index=index)
    _check_pred_cols(step, index, schemas_by_input)
    if step.per_r_key is not None:
        if step.kind != "linear":
            raise PlanPerRError(
                "per-R fused steps must be linear; planner emitted kind "
                f"{step.kind!r}", step=step, index=index)
        schema = schemas_by_input.get(roles["r"])
        if schema is not None and step.per_r_key not in schema:
            raise PlanPerRError(
                f"per-R key column {step.per_r_key!r} is not a column of "
                f"the role-r input {roles['r']!r} ({sorted(schema)})",
                step=step, index=index)


def verify_plan(plan: plan_ir.QueryPlan, schemas: Mapping[str, Iterable[str]]
                | None = None, *, external: Iterable[str] | None = None,
                require_all_inputs: bool | None = None) -> None:
    """Statically verify ``plan``; raise ``PlanValidationError`` on the
    first violation.

    ``schemas`` maps base-relation (or environment) names to their column
    names; when provided, schema/projection propagation is checked step by
    step.  ``external`` is the set of environment names available at
    execution (defaults to ``schemas``' keys) — inputs must be external or
    defined by an earlier step.  With no ``external`` and no ``schemas``,
    any non-``%`` name passes as an implicit base relation, but
    ``%``-names must still be step-defined (the planner never emits free
    ``%`` inputs; the streaming delta path passes ``external`` instead).
    ``require_all_inputs=True`` (the default whenever ``schemas`` is
    given) additionally rejects orphan relations no step reads.
    """
    steps = plan.steps
    if not steps:
        raise PlanStructureError("plan has no steps")
    known: set[str] | None = None
    if external is not None:
        known = set(external)
    elif schemas is not None:
        known = set(schemas)
    if require_all_inputs is None:
        require_all_inputs = schemas is not None and external is None

    # name -> column set (None = unknown); intermediates fill in as steps
    # define them
    schema_env: dict[str, frozenset | None] = {}
    if schemas is not None:
        for name, cols in schemas.items():
            schema_env[name] = frozenset(cols)

    defined: dict[str, int] = {}
    consumers: dict[str, int] = {}
    last = len(steps) - 1
    for index, step in enumerate(steps):
        if step.op not in ("binary", "fused3"):
            raise PlanStructureError(
                f"unknown plan-step op {step.op!r}", step=step, index=index)
        # -- def-use / topological order ------------------------------
        for name in step.inputs:
            if name in defined:
                consumers[name] = consumers.get(name, 0) + 1
                continue
            if known is not None:
                if name not in known:
                    raise PlanStructureError(
                        f"input {name!r} is neither defined by an earlier "
                        "step nor provided by the environment "
                        f"(topological-order or unknown-relation error)",
                        step=step, index=index)
            elif _INTERMEDIATE.match(name) or name.startswith("%"):
                raise PlanStructureError(
                    f"intermediate input {name!r} is read before any step "
                    "defines it (topological-order violation)",
                    step=step, index=index)
        # -- output naming / single definition ------------------------
        if step.out in defined:
            raise PlanStructureError(
                f"output {step.out!r} is defined more than once (first at "
                f"step[{defined[step.out]}])", step=step, index=index)
        if known is not None and step.out in known:
            raise PlanStructureError(
                f"output {step.out!r} shadows an environment relation",
                step=step, index=index)
        if index == last:
            if not step.aggregate or step.out != plan_ir.COUNT:
                raise PlanStructureError(
                    f"the root step must aggregate to {plan_ir.COUNT!r}; "
                    f"got out={step.out!r} aggregate={step.aggregate}",
                    step=step, index=index)
        else:
            if step.aggregate or step.out == plan_ir.COUNT:
                raise PlanStructureError(
                    "only the root step aggregates; an earlier aggregate "
                    "would be overwritten and its inputs wasted",
                    step=step, index=index)
            if not _INTERMEDIATE.match(step.out) and not (
                    step.out.startswith("%d·")):
                raise PlanStructureError(
                    f"materialized outputs are named %i<k> (or %d·… on "
                    f"delta plans); got {step.out!r}", step=step,
                    index=index)

        in_schemas = [schema_env.get(n) for n in step.inputs]
        schemas_by_input = dict(zip(step.inputs, in_schemas))
        if step.op == "binary":
            _check_binary(step, index, schemas_by_input)
            if not step.aggregate:
                schema_env[step.out] = _schema_of(step, in_schemas)
        else:
            _check_fused3(step, index, index == last, schemas_by_input)
        defined[step.out] = index

    # -- refcounts: every materialized intermediate is consumed --------
    for name, index in defined.items():
        if name == plan_ir.COUNT:
            continue
        if consumers.get(name, 0) == 0:
            raise PlanRefcountError(
                f"intermediate {name!r} is materialized but never "
                "consumed — the refcounting arena would hold it for the "
                "whole walk (leak) and the work is dead",
                step=steps[index], index=index)

    # -- orphan relations ---------------------------------------------
    if require_all_inputs and schemas is not None:
        read = {n for s in steps for n in s.inputs}
        orphans = sorted(set(schemas) - read)
        if orphans:
            raise PlanStructureError(
                f"relation(s) {orphans} are provided but no step reads "
                "them (orphan relations)")
