"""Core multiway hash-join engine of the port.

Public API:
  Query / JoinSession      — the declarative front door: any connected
                             acyclic graph of N >= 2 relations (cyclic at
                             N = 3), decomposed + planned + executed +
                             skew-recovered, QueryResult out (plan-cached)
  Binding / Classification — how a 3-relation query binds to the r/s/t
                             roles of a fused kind
  QueryError / QueryGraphError / QuerySchemaError
                           — what a malformed query raises
  StandingQuery / DeltaRecord
                           — JoinSession.watch(query): exact incremental
                             counts under Relation.append ingest (delta
                             plan execution over resident intermediates),
                             one DeltaRecord per append
  QueryPlan / PlanStep     — the multi-step plan IR
  Relation                 — fixed-capacity columnar relation on a device
  MultiwayJoinEngine       — fused partition-sweep engine + skew recovery
  linear3_count_fused / cyclic3_count_fused / star3_count_fused
                           — single-launch fused sweeps
  linear3_count / linear3_per_r_counts, cyclic3_count, star3_count
                           — the bucket-row scan baselines (``reference``
                             adds their whole-query retry drivers)
  linear3_fm_distinct      — FM-sketch DISTINCT (a, d) over the linear
                             3-way join (Example 1), never materialized
  cascaded_binary_count / bucketed_join_count / join_count
                           — the binary baselines and the sorted-path
                             pair count
  cost_model               — the paper's tuple-traffic analysis
"""

from repro_torch.core import cost_model, hashing, partition, reference, sketches  # noqa: F401
from repro_torch.core.binary_join import (  # noqa: F401
    bucketed_join_count, cascaded_binary_count, cascaded_binary_per_r_counts,
    join_count, join_materialize, probe_weight_sum)
from repro_torch.core.cyclic3 import Cyclic3Plan, cyclic3_count  # noqa: F401
from repro_torch.core.cyclic3 import default_plan as cyclic3_default_plan  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    EngineResult, MultiwayJoinEngine, PerRResult, cyclic3_count_fused,
    linear3_count_fused, star3_count_fused)
from repro_torch.core.linear3 import (  # noqa: F401
    Linear3Plan, linear3_count, linear3_fm_distinct, linear3_per_r_counts)
from repro_torch.core.linear3 import default_plan as linear3_default_plan  # noqa: F401
from repro_torch.core.plan_ir import PlanStep, QueryPlan, StepStats  # noqa: F401
from repro_torch.core.query import (  # noqa: F401
    Binding, Classification, Predicate, Query, QueryError, QueryGraphError,
    QuerySchemaError)
from repro_torch.core.relation import Relation  # noqa: F401
from repro_torch.core.results import JoinResult  # noqa: F401
from repro_torch.core.session import JoinSession, QueryResult  # noqa: F401
from repro_torch.core.streaming import DeltaRecord, StandingQuery  # noqa: F401
from repro_torch.core.star3 import Star3Plan, star3_count  # noqa: F401
from repro_torch.core.star3 import default_plan as star3_default_plan  # noqa: F401
