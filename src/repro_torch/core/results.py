"""The unified result hierarchy: every executor answers with a JoinResult.

One query can be answered by several machines — the recovery-wrapped
fused engine, the multi-step plan executor, a session execute — and they
share one result core:

  * :class:`JoinResult` — ``count`` (int64-exact), ``overflowed`` (False by
    construction everywhere recovery runs), ``tuples_read`` (int64 traffic,
    summed over steps and rounds), ``rounds`` (recovery rounds) and
    ``steps`` (per-step ``plan_ir.StepStats``, empty where no plan walked).
  * :class:`~repro_torch.core.session.QueryResult` — the session's answer:
    JoinResult plus plan/cache/timing metadata, which
    ``JoinSession.execute`` returns.
  * :class:`PerRResult` — per-R-tuple group counts (paper Example 1):
    JoinResult (``count`` is the valid per-key sum) plus the aligned
    (keys, counts, valid) arrays.

``recovery.EngineResult`` is an internal alias of :class:`JoinResult` kept
for the engine layer's own call sites; new code should name JoinResult.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Common result core shared by every join entry point."""

    count: object                 # np.int64 — exact cardinality (> 2^31 safe)
    overflowed: object            # bool / () bool — False after recovery
    tuples_read: object           # np.int64 | None — traffic over steps/rounds
    rounds: int                   # recovery rounds executed (1 = no skew)
    steps: tuple = ()             # per-step plan_ir.StepStats, if a plan ran

    @property
    def step_stats(self) -> tuple:
        """Back-compat alias for ``steps`` (the pre-unification name)."""
        return self.steps


@dataclasses.dataclass(frozen=True, kw_only=True)
class PerRResult(JoinResult):
    """Per-R-tuple aggregate: ``count`` is the valid per-key sum and the
    aligned (keys, counts, valid) arrays carry the group breakdown."""

    keys: object                  # [N] int32 carried key column (flattened)
    counts: object                # [N] int64 per-R-tuple counts
    valid: object                 # [N] bool
