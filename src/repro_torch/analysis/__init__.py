"""Static analysis over the plan IR (the port's copy of ``repro.analysis``).

Three entry points:

  verify_plan      — pure static checker over ``QueryPlan`` DAGs (topo
                     order, def-use, schema propagation, refcounts, per-R
                     pins); always-on at session plan time, re-checked per
                     execute under ``REPRO_VERIFY_PLANS=1``
  widths           — integer-width dataflow analysis: bound every
                     composite-id space, flat slot index, fused
                     accumulator cell and Traffic64 limb from plan-time
                     estimates (or live cardinalities) and flag int32 /
                     f32-exactness hazards before any kernel runs
  arena_sanitizer  — opt-in dynamic shadow of ``execute_plan``'s
                     refcounting arena and the streaming residents
                     (``REPRO_SANITIZE_ARENA=1``)

Submodules import lazily: ``analysis.errors`` sits below ``core.plan_ir``
in the import graph (the executor raises the shared typed errors), so this
package must be importable without touching ``repro_torch.core``.
"""

from __future__ import annotations

import importlib

from repro_torch.analysis.errors import (  # noqa: F401
    PlanPerRError, PlanRefcountError, PlanSchemaError, PlanStructureError,
    PlanValidationError, PlanWidthError)

_SUBMODULES = ("arena_sanitizer", "errors", "verify_plan", "widths")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
