"""Integer-width dataflow analysis over :class:`~repro_torch.core.plan_ir.QueryPlan`.

Everything index-shaped in the engine is int32: composite bucket ids
(``kernels/ops.composite_ids``), flat slot indexes (``partition.bucketize``,
``bucket * capacity + slot``), per-cell fused accumulators, materialized
intermediate row indexes, and the static multipliers feeding
``engine.traffic64``.  Today a mis-sized plan dies in a scattered runtime
``ValueError`` deep inside ``partition._check_flat_range`` — after the
planner has committed, and only on the code paths that still check.  In
the CUDA kernels, which index and accumulate in int32, the same mistake
is a silently wrapped int32, i.e. a wrong join count.

This pass walks the DAG once with whatever cardinalities it has — planner
estimates at plan time (``est_rows``/``est_out``), live ``Relation.n``
values at execute under ``REPRO_VERIFY_PLANS=1`` — sizes each fused step's
partition shape exactly the way ``_run_fused3`` will (``shape_plan`` if
pinned, else ``MultiwayJoinEngine.default_plan`` from the cards), and
bounds every width-sensitive quantity.  Each diagnostic names the step,
the quantity, the computed bound, and the width the value would need.

Severities:

``error``
    A bound the engine *guarantees* to exceed: a composite-id space or
    flat slot range past int32 (``composite_ids`` / ``bucketize`` would
    raise, or a compiled kernel would wrap), an intermediate estimated at
    >= 2^31 rows (``execute_plan`` refuses to materialize it), a Traffic64
    static multiplier outside ``0 < k < 2^31``.  :func:`check_widths`
    raises :class:`PlanWidthError` carrying these.

``hazard``
    A data-dependent worst case worth surfacing but not failing on: the
    skew-recovery growth rounds pushing flat slot ranges toward int32, a
    per-cell accumulator whose capacity-product ceiling crosses the 2^24
    exact-f32 range (``kernels.ops.EXACT_F32_MAX`` — relevant the moment a
    compiled kernel accumulates in f32) or int32.  These products are
    *ceilings* (every bucket full, every pair matching), so treating them
    as errors would flag every healthy plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.analysis.errors import PlanWidthError
from repro_torch.core import engine, plan_ir, recovery
from repro_torch.kernels.ops import EXACT_F32_MAX

_INT32_MAX = 2**31 - 1
_INT32_ROWS = 2**31          # materialize / cardinality ceiling
_TRAFFIC_MAX = 2**61         # Traffic64 two-limb total ceiling


@dataclasses.dataclass(frozen=True)
class WidthDiagnostic:
    """One width finding: ``quantity`` at ``step_out`` needs
    ``width_needed`` but the engine gives it ``limit``."""

    step_index: int
    step_out: str
    quantity: str            # e.g. "composite-id space (role r)"
    bound: int               # the computed bound
    limit: int               # the width ceiling it is judged against
    width_needed: str        # e.g. "int35" — bits the bound requires
    severity: str            # "error" | "hazard"
    detail: str

    def __str__(self) -> str:
        return (f"[{self.severity}] step[{self.step_index}] "
                f"{self.step_out}: {self.quantity} = {self.bound} "
                f"exceeds {self.limit} (needs {self.width_needed}) — "
                f"{self.detail}")


def _width(bound: int) -> str:
    """Signed integer width a positive bound requires."""
    return f"int{max(8, int(bound).bit_length() + 1)}"


def _diag(out, index, quantity, bound, limit, severity, detail):
    return WidthDiagnostic(index, out, quantity, int(bound), int(limit),
                           _width(bound), severity, detail)


def _grown_caps(shape, growth: float, rounds: int):
    """Worst-round capacities: ``recovery.grown`` applied ``rounds`` times."""
    for _ in range(max(0, rounds)):
        shape = recovery.grown(shape, growth)
    return shape


def _fused_spaces(kind: str, cols: dict, shape):
    """(role, composite-id space, bucket capacity) per hashed relation,
    exactly as ``recovery`` lays them out."""
    ops = recovery.OPS[kind](**cols)
    caps = {"r": shape.r_cap, "s": shape.s_cap, "t": shape.t_cap}
    out = []
    for role, (_specs, out_shape) in ops.specs(shape).items():
        out.append((role, math.prod(out_shape), caps[role]))
    if kind == "star":
        # S is bucketed by s_pass: chunks x uh x ug (see StarOps.s_pass)
        out.append(("s", shape.chunks * shape.uh * shape.ug, caps["s"]))
    return out


def _accum_cell_bound(kind: str, shape) -> int:
    """Capacity-product ceiling of one fused accumulator cell.

    Each cell counts matches driven by one bucket of the driving relation:
    every driving row can match at most ``cap`` rows per joined bucket,
    summed over the streamed dimension (g_parts / f_parts / chunks)."""
    if kind == "linear":     # cell [hp, u]: r_cap rows x Σ_g s_cap·t_cap
        return shape.r_cap * shape.g_parts * shape.s_cap * shape.t_cap
    if kind == "cyclic":     # cell [hp, gp, uh, ug]: r_cap x Σ_f s·t
        return shape.r_cap * shape.f_parts * shape.s_cap * shape.t_cap
    # star, cell [uh, ug]: Σ_chunks s_cap fact rows x r_cap x t_cap
    return shape.chunks * shape.s_cap * shape.r_cap * shape.t_cap


def _traffic_terms(kind: str, shape, in_rows: dict):
    """(static multiplier, estimated rows) per ``engine.traffic64`` term —
    mirrors each kind's ``tuples_read``."""
    r, s, t = (in_rows.get(k) for k in ("r", "s", "t"))
    if kind == "linear":
        return [(1, r), (1, s), (shape.h_parts, t)]
    if kind == "cyclic":
        return [(1, r), (shape.h_parts, s), (shape.g_parts, t)]
    return [(1, r), (1, s), (1, t)]


def _check_fused(step, index, shape, in_rows, plan, diags) -> None:
    cols = dict(step.cols)
    kind = step.kind
    for role, space, cap in _fused_spaces(kind, cols, shape):
        if space > _INT32_MAX:
            diags.append(_diag(
                step.out, index, f"composite-id space (role {role})",
                space, _INT32_MAX, "error",
                "partition.composite_ids flat bucket ids are int32; this "
                "shape cannot be hashed — shrink the partition grid or "
                "raise m_budget"))
            continue                      # slots are hopeless too
        slots = space * cap + 1           # bucketize: bucket*cap + slot
        if slots > _INT32_MAX:
            diags.append(_diag(
                step.out, index, f"flat slot range (role {role})",
                slots, _INT32_MAX, "error",
                "partition.bucketize scatters into bucket*capacity+slot "
                "int32 ids; shrink capacities or the partition grid"))
        else:
            worst = _grown_caps(shape, plan.growth, plan.max_rounds)
            wcap = {"r": worst.r_cap, "s": worst.s_cap,
                    "t": worst.t_cap}[role]
            wslots = space * wcap + 1
            if wslots > _INT32_MAX:
                diags.append(_diag(
                    step.out, index,
                    f"grown flat slot range (role {role}, "
                    f"round {plan.max_rounds})", wslots, _INT32_MAX,
                    "hazard",
                    "skew-recovery capacity growth could push the flat "
                    "slot range past int32 on the worst round; recovery "
                    "would fail late instead of at plan time"))
    cell = _accum_cell_bound(kind, shape)
    if cell > _INT32_MAX:
        diags.append(_diag(
            step.out, index, "accumulator cell ceiling", cell,
            _INT32_MAX, "hazard",
            "fused per-cell partials are int32; the capacity-product "
            "ceiling of one cell crosses 2^31 — only reachable under "
            "total skew, but a compiled kernel would wrap silently"))
    elif cell > EXACT_F32_MAX:
        diags.append(_diag(
            step.out, index, "accumulator cell ceiling", cell,
            EXACT_F32_MAX, "hazard",
            "one fused accumulator cell could exceed the 2^24 exact-f32 "
            "range; any compiled kernel lowering these partials to f32 "
            "would lose counts — keep int32 accumulation"))
    # Traffic64: static multipliers must satisfy 0 < k < 2^31, and the
    # two-limb total holds up to 2^61.
    roles = dict(step.roles)
    rows = {role: in_rows.get(roles[role]) for role in ("r", "s", "t")}
    total = 0
    for k, n in _traffic_terms(kind, shape, rows):
        if not 0 < k < 2**31:
            diags.append(_diag(
                step.out, index, "Traffic64 static multiplier", k,
                _INT32_MAX, "error",
                "engine.traffic64 requires 0 < k < 2^31 for its 15-bit "
                "limb split; this partition count cannot be metered"))
        elif n is not None:
            total += k * n
    if total > _TRAFFIC_MAX:
        diags.append(_diag(
            step.out, index, "Traffic64 total", total, _TRAFFIC_MAX,
            "hazard",
            "estimated tuples_read exceeds the two-limb 2^61 ceiling; "
            "the traffic meter would wrap"))


def analyze_widths(plan: plan_ir.QueryPlan,
                   cards: Mapping[str, int] | None = None,
                   ) -> tuple[WidthDiagnostic, ...]:
    """Bound every width-sensitive quantity in ``plan``.

    ``cards`` maps input names to row counts — live ``Relation.n`` values
    at execute time, or planner estimates; step-level ``est_rows`` /
    ``est_out`` fill the gaps.  Quantities whose cardinalities are unknown
    are skipped (never guessed), so an estimate-free plan only gets the
    purely static checks (pinned shape plans, traffic multipliers).
    """
    diags: list[WidthDiagnostic] = []
    rows: dict[str, int] = {k: int(v) for k, v in (cards or {}).items()}
    for index, step in enumerate(plan.steps):
        in_rows: dict[str, int] = {}
        for pos, name in enumerate(step.inputs):
            n = rows.get(name)
            if n is None and pos < len(step.est_rows):
                n = int(step.est_rows[pos])
            if n is not None:
                in_rows[name] = n
        for name, n in in_rows.items():
            if n >= _INT32_ROWS:
                diags.append(_diag(
                    step.out, index, f"input cardinality ({name})", n,
                    _INT32_ROWS - 1, "error",
                    "row indexes, sort permutations and bucket ids are "
                    "int32; a relation this large cannot be processed"))
        if step.op == "binary":
            out_rows = step.est_out
            if out_rows is not None and not step.aggregate:
                if out_rows >= _INT32_ROWS:
                    diags.append(_diag(
                        step.out, index, "materialized rows", out_rows,
                        _INT32_ROWS - 1, "error",
                        "execute_plan refuses to materialize >= 2^31 "
                        "rows; re-plan with strategy='3way' (the fused "
                        "engine never materializes the join output)"))
                rows.setdefault(step.out, int(out_rows))
        elif step.op == "fused3" and step.kind in recovery.OPS:
            shape = step.shape_plan
            if shape is None and len(in_rows) == 3 and plan.m_budget:
                roles = dict(step.roles)
                eng = engine.MultiwayJoinEngine(step.kind)
                shape = eng.default_plan(
                    in_rows[roles["r"]], in_rows[roles["s"]],
                    in_rows[roles["t"]], m_budget=plan.m_budget)
            if shape is not None:
                _check_fused(step, index, shape, in_rows, plan, diags)
    return tuple(diags)


def check_widths(plan: plan_ir.QueryPlan,
                 cards: Mapping[str, int] | None = None,
                 ) -> tuple[WidthDiagnostic, ...]:
    """Run :func:`analyze_widths`; raise :class:`PlanWidthError` if any
    diagnostic is an error.  Returns the full diagnostic tuple (hazards
    included) so callers can log them."""
    diags = analyze_widths(plan, cards)
    errors = [d for d in diags if d.severity == "error"]
    if errors:
        lines = "\n".join(f"  {d}" for d in errors)
        raise PlanWidthError(
            f"plan fails integer-width analysis "
            f"({len(errors)} error(s)):\n{lines}", diagnostics=diags)
    return diags
