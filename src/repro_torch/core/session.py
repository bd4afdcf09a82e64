"""JoinSession: one front door for plan → decompose → execute → recover.

The session owns everything between a declarative :class:`~repro_torch.core.query.
Query` — over ANY connected acyclic graph of N ≥ 2 relations (cyclic stays
supported at N = 3, the triangle query) — and an exact answer:

  * **decompose** — ``planner.plan_query`` turns the predicate graph into
    a ``core.plan_ir.QueryPlan``: 3-relation queries keep their single
    fused, recovery-wrapped step; larger trees become binary materialize
    steps feeding a fused 3-way (or binary) root, ordered by the cost
    model's per-step cardinality estimates,
  * **cache** — whole multi-step plans are cached by (query structure,
    log-bucketed cardinalities, m_budget, hardware, forced strategy).
    Bucketing the cardinalities (``sketches.card_bucket``) makes the
    cache survive small data drift — a ±5% refresh still hits; a 4x
    resize re-plans,
  * **execute / recover** — ``plan_ir.execute_plan`` walks the DAG:
    intermediates materialize exactly (device-side sizing), every
    fused step runs the shared skew-recovery rounds with the session's
    ``base_salt``, and ``overflowed == False`` is a postcondition.  The
    returned :class:`QueryResult` aggregates count / tuples_read /
    recovery rounds / timings across steps (``step_stats`` has the
    per-step breakdown).

``execute_many`` batches queries over the shared plan cache (structurally
repeated queries plan once); ``watch`` registers a standing query whose
count stays exact under ``Relation.append`` ingest
(``core.streaming.StandingQuery``).  ``execute_sharded`` runs a
3-relation query on a device mesh (``core.distributed``): every rank
holds its stripes, the collectives are NCCL on the card and gloo on the
CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

import numpy as np

from repro_torch.core import plan_ir, planner, recovery, sketches
from repro_torch.core.query import STAR_FACT_RATIO, Classification, Query
from repro_torch.core.results import JoinResult
from repro_torch.perfmodel import HW, PLASTICINE, Calibration


@dataclasses.dataclass(frozen=True, kw_only=True)
class QueryResult(JoinResult):
    """Uniform result for every kind, strategy and relation count: the
    :class:`~repro_torch.core.results.JoinResult` core (count / overflowed /
    tuples_read / rounds / steps) plus the session's plan, cache and
    timing metadata.  ``JoinSession.execute`` and
    ``StandingQuery.snapshot`` answer with this type."""

    kind: str                             # root frontier kind (or "binary")
    strategy: str                         # "3way" | "cascade" | "hybrid"
    cache_hit: bool                       # plan came from the session cache
    plan_s: float                         # decompose + sizing seconds
    exec_s: float                         # execution seconds, all steps
    plan: plan_ir.QueryPlan | None = None
    per_r: recovery.PerRResult | None = None   # per-R aggregates (linear)


class JoinSession:
    """Declarative query executor with a plan cache.

    >>> sess = JoinSession(m_budget=4096)
    >>> res = sess.execute(Query(relations={...}, predicates=[...]))
    >>> res.count, res.kind, res.strategy, res.cache_hit

    Parameters mirror the engine: ``max_rounds``/``growth`` shape skew
    recovery, ``base_salt`` seeds every round's hash salt (plumbed all the
    way into the recovery rounds of every fused step), ``hw`` is the
    profile the 3-way vs cascade time decisions run on, and
    ``star_fact_ratio`` tunes the star/linear hub disambiguation.
    ``calibration`` (``perfmodel.Calibration``, typically
    ``calibration_from_bench(perfmodel.BENCH_FILE)``, the port's own bench
    report) re-anchors the time
    model's constants to measured per-root seconds; the default ``None``
    keeps the paper's hand-set constants.
    """

    def __init__(self, *, m_budget: int | None = None, hw: HW = PLASTICINE,
                 max_rounds: int = 3,
                 growth: float = 2.0, base_salt: int = 0,
                 star_fact_ratio: float | None = None,
                 calibration: Calibration | None = None):
        self.m_budget = m_budget
        self.hw = hw
        self.max_rounds = max_rounds
        self.growth = growth
        self.base_salt = base_salt
        self.star_fact_ratio = (STAR_FACT_RATIO if star_fact_ratio is None
                                else star_fact_ratio)
        self.calibration = calibration
        self._plan_cache: dict[Any, plan_ir.QueryPlan] = {}
        self._hits = 0
        self._misses = 0

    # -- cache -------------------------------------------------------------

    @property
    def cache_info(self) -> dict[str, int]:
        return {"size": len(self._plan_cache), "hits": self._hits,
                "misses": self._misses}

    def clear_plan_cache(self) -> None:
        self._plan_cache.clear()

    def refresh_calibration(self, bench=None, *, out_path=None,
                            shape: str = "cascade_4way") -> Calibration:
        """Re-derive the time-model calibration from a bench report (the
        port's ``perfmodel.BENCH_FILE`` unless ``bench`` names another),
        persist it to the port's calibration file
        (``perfmodel.CALIBRATION_FILE`` unless ``out_path`` names another),
        and adopt it for this session.
        The plan cache is cleared: cached plans embed 3-way/cascade
        decisions made under the old scales, and the calibration is part
        of the cache key anyway."""
        from repro_torch.perfmodel import calibrate
        cal = calibrate.refresh_calibration_file(
            calibrate.BENCH_FILE if bench is None else bench,
            calibrate.CALIBRATION_FILE if out_path is None else out_path,
            shape=shape)
        self.calibration = cal
        self.clear_plan_cache()
        return cal

    def _cache_key(self, query: Query, cards: dict[str, int],
                   m_budget: int | None, strategy: str | None,
                   forced: Classification | None,
                   per_r_name: str | None, per_r_key: str):
        # cardinalities enter the key LOG-BUCKETED (sketches.card_bucket):
        # plans are estimate-sized and recovery-correct, so a few percent
        # of data drift must not evict them — only scale changes re-plan
        buckets = tuple(sorted((name, sketches.card_bucket(n))
                               for name, n in cards.items()))
        cal = self.calibration
        return (query.schema(), buckets, m_budget, self.hw, strategy,
                None if forced is None else (forced.kind, forced.roles,
                                             forced.cols),
                None if per_r_name is None else (per_r_name, per_r_key),
                None if cal is None else (cal.fused3_scale,
                                          cal.cascade_scale))

    # -- planning ----------------------------------------------------------

    def _plan(self, query: Query, cards: dict[str, int],
              m_budget: int | None, strategy: str | None,
              forced: Classification | None,
              per_r_name: str | None = None, per_r_key: str = "a"
              ) -> tuple[plan_ir.QueryPlan, bool]:
        """Decompose + size, through the plan cache.  A hit skips the
        graph analysis, the decomposition and the shape/strategy sizing."""
        key = self._cache_key(query, cards, m_budget, strategy, forced,
                              per_r_name, per_r_key)
        hit = self._plan_cache.get(key)
        if hit is not None:
            self._hits += 1
            return hit, True
        self._misses += 1
        qp = planner.plan_query(
            query, cards, m_budget=m_budget, hw=self.hw,
            max_rounds=self.max_rounds,
            growth=self.growth, base_salt=self.base_salt,
            star_fact_ratio=self.star_fact_ratio, strategy=strategy,
            classification=forced, calibration=self.calibration,
            per_r_name=per_r_name, per_r_key=per_r_key)
        # every plan the session caches is statically verified: DAG shape,
        # schema propagation, refcounts, per-R pins, and the width bounds
        # of every composite-id space / accumulator at the estimated cards
        # (imports deferred: analysis sits above core in the import graph)
        from repro_torch.analysis.verify_plan import verify_plan
        from repro_torch.analysis.widths import check_widths
        verify_plan(qp, schemas={name: frozenset(rel.columns)
                                 for name, rel in query.relations.items()})
        check_widths(qp, cards)
        self._plan_cache[key] = qp
        return qp, False

    # -- execution ---------------------------------------------------------

    def _resolve_per_r(self, query: Query, cards: dict[str, int],
                       per_r: bool | str) -> str | None:
        """Turn the ``per_r`` argument into a pinned relation name:
        ``False`` → ``None``; a string names the relation; ``True`` picks
        the classified role-r endpoint (3 relations) or the first-declared
        leaf of the predicate tree (N ≥ 4)."""
        if not per_r:
            return None
        if isinstance(per_r, str):
            return per_r
        names = list(query.relations)
        if len(names) == 3:
            cls_ = query.classify(cards,
                                  star_fact_ratio=self.star_fact_ratio)
            return dict(cls_.roles)["r"]
        degree = {nm: 0 for nm in names}
        for key in query.edges():
            for nm in key:
                degree[nm] += 1
        for nm in names:           # a tree always has >= 2 leaves
            if degree[nm] == 1:
                return nm
        raise ValueError("per_r=True found no leaf relation; pin one by "
                         "name (per_r='<relation>')")

    def execute(self, query: Query, *, m_budget: int | None = None,
                per_r: bool | str = False, key_col: str = "a",
                plan=None, strategy: str | None = None,
                classification: Classification | None = None) -> QueryResult:
        """Decompose (or reuse a cached plan), walk the DAG, recover.

        ``plan`` overrides sizing with an explicit 3-relation shape plan
        (skipping the planner and the cache); ``strategy=None`` lets the
        time model pick per root, ``"3way"`` forces the fused engine at
        the root, ``"cascade"`` forces the all-binary cascade;
        ``classification`` bypasses 3-relation inference (the deprecation
        shims use it — new code should let the graph speak).

        ``per_r`` requests per-key group counts: ``True`` groups by the
        classified role-r endpoint (3 relations) or the first-declared
        leaf (N ≥ 4); a string pins a specific relation.  The planner
        routes the pinned relation to the fused linear root (its join
        edge is never contracted away) and the executor answers through
        the recovery engine's per-R rounds — ``QueryResult.per_r`` holds
        the (keys, counts, valid) aggregate, ``count`` its valid sum.
        """
        if strategy not in (None, "3way", "cascade"):
            raise ValueError(f"unknown strategy {strategy!r}: pass None "
                             "(planner decides), '3way' (force the fused "
                             "multiway engine) or 'cascade' (force the "
                             "binary cascade)")
        t0 = time.perf_counter()
        m_budget = self.m_budget if m_budget is None else m_budget
        cards = {name: int(rel.n) for name, rel in query.relations.items()}
        per_r_name = self._resolve_per_r(query, cards, per_r)
        if plan is not None:
            cls_ = classification or query.classify(
                cards, star_fact_ratio=self.star_fact_ratio)
            if per_r_name is not None:
                cls_ = planner.pin_per_r_classification(cls_, per_r_name)
            ep = planner.forced_3way_plan(
                cls_.kind, plan, m_budget=m_budget,
                max_rounds=self.max_rounds,
                growth=self.growth, base_salt=self.base_salt)
            qp = planner._single_fused_plan(
                query, cls_, ep,
                per_r_key=(key_col if per_r_name else None))
            from repro_torch.analysis.verify_plan import verify_plan
            from repro_torch.analysis.widths import check_widths
            verify_plan(qp, schemas={
                name: frozenset(rel.columns)
                for name, rel in query.relations.items()})
            check_widths(qp, cards)
            cache_hit = False
        else:
            qp, cache_hit = self._plan(query, cards, m_budget, strategy,
                                       classification, per_r_name,
                                       key_col)
        plan_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        res = plan_ir.execute_plan(qp, dict(query.relations))
        exec_s = time.perf_counter() - t1
        return QueryResult(
            count=np.int64(res.count), overflowed=bool(res.overflowed),
            tuples_read=np.int64(res.tuples_read), rounds=int(res.rounds),
            kind=qp.kind, strategy=qp.strategy, cache_hit=cache_hit,
            plan_s=plan_s, exec_s=exec_s, plan=qp, per_r=res.per_r,
            steps=res.step_stats)

    # -- standing queries --------------------------------------------------

    def watch(self, query: Query, *, m_budget: int | None = None,
              strategy: str | None = None):
        """Register ``query`` as a standing query: execute it once keeping
        every binary step's materialized intermediate resident, then keep
        the count exact under ``Relation.append`` ingest by executing only
        the delta plan per append (``core.streaming.StandingQuery``).
        ``snapshot()`` on the returned handle answers with the same
        :class:`QueryResult` type as :meth:`execute`."""
        from repro_torch.core.streaming import StandingQuery
        return StandingQuery(self, query, m_budget=m_budget,
                             strategy=strategy)

    # -- batched execution -------------------------------------------------

    def execute_many(self, queries: Iterable[Query], *,
                     m_budget: int | None = None,
                     strategy: str | None = None) -> list[QueryResult]:
        """Execute a batch of queries over the SHARED plan cache.

        Structurally repeated queries (the common serving pattern: one
        parametrized query over refreshed relations of similar size) pay
        decomposition + sizing once — every later execution is a
        plan-cache hit, including across ±small cardinality drift thanks
        to the log-bucketed cache key.  Returns one QueryResult per query,
        in input order.
        """
        return [self.execute(q, m_budget=m_budget, strategy=strategy)
                for q in queries]

    # -- distributed -------------------------------------------------------

    def execute_sharded(self, query: Query, mesh, row: str, col: str, *,
                        max_rounds: int = 2,
                        classification: Classification | None = None,
                        **kw) -> QueryResult:
        """The same declarative query on a device mesh: classify + bind,
        re-key the relations to the canonical routing columns, and run the
        cross-device recovery rounds of ``distributed.engine_count_sharded``
        (``overflowed == False`` on the mesh too).  Every rank of the mesh
        calls this with its stripes of the relations
        (``distributed.shard_relation``); the classification reads the
        cardinalities summed over the mesh, so every rank binds the same
        kind.  3 relations only for now (N-way mesh plans are a ROADMAP
        follow-up).
        """
        from repro_torch.core import distributed
        t0 = time.perf_counter()
        cls_ = classification
        if cls_ is None:
            cards = distributed.global_cardinalities(mesh, row, col,
                                                     query.relations)
            cls_ = query.classify(cards, star_fact_ratio=self.star_fact_ratio)
        binding = query.bind(cls_)
        r, s, t = binding.canonical()
        plan_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        fn = distributed.engine_count_sharded(
            mesh, row, col, binding.kind, max_rounds=max_rounds,
            growth=self.growth, **kw)
        res = fn(r, s, t)
        exec_s = time.perf_counter() - t1
        return QueryResult(
            count=np.int64(int(res.count)),
            overflowed=bool(res.overflowed), tuples_read=None,
            rounds=int(res.rounds), kind=binding.kind, strategy="3way",
            cache_hit=False, plan_s=plan_s, exec_s=exec_s)
