"""Core multiway hash-join engine of the port.

Public API:
  Query / JoinSession      — the declarative front door: any connected
                             acyclic graph of N >= 2 relations (cyclic at
                             N = 3), decomposed + planned + executed +
                             skew-recovered, QueryResult out (plan-cached)
  QueryPlan / PlanStep     — the multi-step plan IR
  Relation                 — fixed-capacity columnar relation on a device
  MultiwayJoinEngine       — fused partition-sweep engine + skew recovery
"""

from repro_torch.core.engine import MultiwayJoinEngine  # noqa: F401
from repro_torch.core.plan_ir import PlanStep, QueryPlan, StepStats  # noqa: F401
from repro_torch.core.query import Predicate, Query  # noqa: F401
from repro_torch.core.relation import Relation  # noqa: F401
from repro_torch.core.results import JoinResult, PerRResult  # noqa: F401
from repro_torch.core.session import JoinSession, QueryResult  # noqa: F401
