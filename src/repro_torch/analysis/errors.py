"""Typed plan-validation errors shared by the static verifier and the
executor.

``plan_ir.execute_plan`` used to raise bare ``ValueError``s for malformed
plans (unknown op, materializing fused3 step, per-R pin on a non-linear
root, an intermediate too large for int32 indexing).  Those conditions are
exactly what ``analysis.verify_plan`` / ``analysis.widths`` check *before*
dispatch, so both layers now raise the same typed hierarchy: a test (or a
caller) that guards against "this plan is structurally broken" catches one
exception family regardless of whether the verifier or the executor found
it first.

Every class subclasses ``ValueError`` so pre-existing ``except ValueError``
call sites keep working.  This module imports nothing from ``repro`` — it
sits below ``core.plan_ir`` in the import graph on purpose.
"""

from __future__ import annotations


class PlanValidationError(ValueError):
    """A :class:`~repro_torch.core.plan_ir.QueryPlan` violates a plan invariant.

    ``rule`` names the invariant family (mirrored by the subclasses),
    ``step`` / ``index`` locate the offending :class:`PlanStep` when one is
    identifiable — the message embeds the step's ``describe()`` output so
    the failing step is readable without re-walking the plan.
    """

    rule = "plan"

    def __init__(self, message: str, *, step=None, index: int | None = None):
        self.step = step
        self.index = index
        if step is not None:
            try:
                where = step.describe()
            except Exception:
                where = repr(step)
            at = f"step[{index}]" if index is not None else "step"
            message = f"{message}\n  at {at}: {where}"
        super().__init__(message)


class PlanStructureError(PlanValidationError):
    """Topology / def-use violations: steps out of topological order,
    duplicate or malformed ``%i<k>`` definitions, unknown ops, wrong input
    arity, predicates naming relations the step does not read, a fused3
    step that tries to materialize, or an orphan relation no step reads."""

    rule = "structure"


class PlanSchemaError(PlanValidationError):
    """Schema / projection propagation broke: a projection or predicate
    references a column its input does not carry, or two projections
    collide on a destination column name."""

    rule = "schema"


class PlanRefcountError(PlanValidationError):
    """Arena refcount invariants: a materialized ``%i<k>`` intermediate
    with no consumer (the executor would leak it), or consumption that
    cannot match the refcounting arena's bookkeeping."""

    rule = "refcount"


class PlanPerRError(PlanValidationError):
    """Per-R pin violations: ``per_r_key`` on a non-root or non-linear
    step, a pinned key column the role-r input does not carry, or a pin
    the classification cannot host (path centre / cyclic kind)."""

    rule = "per_r"


class PlanWidthError(PlanValidationError):
    """Integer-width violations found by ``analysis.widths``: a composite
    bucket-id space or flat slot range past int32, an intermediate too
    large to materialize, or a Traffic64 multiplier out of range.  Carries
    the diagnostics that crossed the line on ``diagnostics``."""

    rule = "width"

    def __init__(self, message: str, *, step=None, index: int | None = None,
                 diagnostics: tuple = ()):
        super().__init__(message, step=step, index=index)
        self.diagnostics = tuple(diagnostics)
