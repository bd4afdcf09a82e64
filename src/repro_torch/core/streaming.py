"""Standing queries: exact incremental counts under continuous ingest.

A production join service does not re-count from scratch on every append —
that throws away exactly the per-step intermediate materialization the plan
IR tracks.  :class:`StandingQuery` (registered through
``JoinSession.watch(query)``) keeps the standing plan's binary-step
intermediates (``%i<k>``) resident in the executor's arena and, on
``Relation.append(delta)``, executes only the *delta plan*:

  * **Delta rule.**  With one relation X changed by ΔX, the count delta of
    the whole multiway join is the same join with X replaced by ΔX and
    every other input at its current value.  Along the standing plan this
    touches exactly the path from X's leaf to the root: each step on the
    path joins its Δ-input against the *resident* value of its sibling
    (a kept-hot ``%i<k>`` or a base relation) — siblings off the path are
    never recomputed.
  * **Same machinery.**  The delta plan is the standing plan's path steps
    with the Δ-carrying input renamed (``%d·<name>``) and re-executed
    through the very same ``plan_ir.execute_plan``; binary materialize
    steps append-merge their Δ-output into the resident intermediate
    (``Relation.append`` — log-bucketed capacities keep the shapes
    stable), and the fused root re-runs recovery-wrapped over only
    the hash-families the delta's histogram actually touches (sibling
    rows hashing to untouched families cannot match any delta row, so
    they are masked out before the engine sizes its partitions).
  * **Drift → re-plan.**  Each ingest re-derives the plan through the
    session's log-bucketed plan cache: ±5% drift maps to the same bucket
    and keeps the standing plan (and its residents); a ≥4x resize misses
    the cache, and the fresh plan triggers a full refresh.  FM sketches on
    each Relation update incrementally inside ``append`` itself, so a
    re-plan always sees current distinct estimates without a host scan.

``overflowed == False`` holds per delta round (every delta run inherits
the recovery engine's exact-histogram final round), and all totals
accumulate in host Python ints (int64-exact under unbounded ingest).

On the card the fused delta root launches the same kernels as a
from-scratch execute (``fused_count3_cyclic_pairidx`` for a triangle,
``fused_count3_linear`` for a linear root fed by a resident intermediate);
the host syncs per append are the reference's: the live counts the plan
cache keys on, the delta's row count, and one touched-family count per
sibling the family mask considers.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.analysis import arena_sanitizer
from repro_torch.core import hashing, plan_ir
from repro_torch.core.plan_ir import COUNT, PlanStep, QueryPlan
from repro_torch.core.query import Predicate, Query
from repro_torch.core.relation import Relation

# Family-masking geometry: the delta's join keys are histogrammed into
# N_FAMILIES hash families; sibling rows outside the touched set are masked
# before the fused root sizes its partitions.  Masking is skipped when the
# delta touches more than MASK_SKIP_FRACTION of the families (nothing to
# save) — correctness never depends on it.
N_FAMILIES = 4096
MASK_SKIP_FRACTION = 0.5
_MASK_SALT = 0x5EED


def _dname(name: str) -> str:
    """Environment name of a delta value (delta plans rename the
    Δ-carrying input so the resident/base value stays addressable)."""
    return f"%d·{name}"


def _pow2(n: int) -> int:
    """Round a live cardinality up to its power-of-two bucket — the shape
    quantization that keeps delta-plan layouts stable across steady
    ingest (recovery absorbs any under-sizing exactly)."""
    return 1 << max(0, int(n) - 1).bit_length()


def touched_families(delta: Relation, col: str,
                     n_families: int = N_FAMILIES) -> torch.Tensor:
    """Boolean histogram of the hash families the delta's keys touch.
    Invalid rows go to one extra slot, sliced off (an out-of-range
    scatter index is a device-side assert on the card)."""
    ids = hashing.hash_bucket(delta.col(col), n_families, "H", _MASK_SALT)
    ids = torch.where(delta.valid, ids.long(),
                      torch.full_like(ids, n_families, dtype=torch.long))
    hit = torch.zeros((n_families + 1,), dtype=torch.bool,
                      device=delta.device)
    hit[ids] = True
    return hit[:n_families]


def mask_to_families(rel: Relation, col: str, touched: torch.Tensor
                     ) -> Relation:
    """Mask ``rel`` to the rows whose ``col`` hashes into a touched
    family.  Exact for equality joins: an untouched-family row cannot
    match any delta key (same hash function, same salt)."""
    n_families = touched.shape[0]
    if int(touched.sum()) > n_families * MASK_SKIP_FRACTION:
        return rel
    ids = hashing.hash_bucket(rel.col(col), n_families, "H", _MASK_SALT)
    return rel.mask_where(touched[torch.clamp(ids.long(), 0,
                                              n_families - 1)])


@dataclasses.dataclass(frozen=True)
class DeltaRecord:
    """One ingest round of a standing query (``StandingQuery.delta_rounds``)."""

    relation: str            # which base relation took the append
    delta_rows: int          # rows in the delta batch
    count_delta: int         # exact contribution to the standing count
    overflowed: bool         # False by construction (recovery contract)
    rounds: int              # recovery rounds of the delta run
    tuples_read: int         # delta-run traffic
    replanned: bool          # drift forced a full re-plan + refresh
    exec_s: float            # host seconds for the delta run


class StandingQuery:
    """A registered standing query: exact count kept fresh under ingest.

    Create through :meth:`JoinSession.watch`.  ``snapshot()`` answers with
    the same :class:`~repro_torch.core.session.QueryResult` type as
    ``JoinSession.execute``; ``delta_rounds`` records every ingest.
    ``close()`` deregisters the append observers.
    """

    def __init__(self, session, query: Query, *,
                 m_budget: int | None = None, strategy: str | None = None):
        self._sess = session
        self.query = query
        self._m_budget = session.m_budget if m_budget is None else m_budget
        self._strategy = strategy
        self._plan: QueryPlan | None = None
        self._intermediates: dict[str, Relation] = {}
        self._versions: dict[str, int] = {}
        self._delta_shapes: dict = {}
        self._count = 0
        self._tuples = 0
        self._rounds = 0
        self._last_steps: tuple = ()
        self._last_plan_s = 0.0
        self._last_exec_s = 0.0
        self._last_cache_hit = False
        self._closed = False
        self.delta_rounds: list[DeltaRecord] = []
        seen: list[int] = []
        for rel in query.relations.values():
            if id(rel) not in seen:
                seen.append(id(rel))
                rel.on_append(self._on_append)
        self.refresh()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Deregister the append observers; the handle goes inert."""
        if self._closed:
            return
        self._closed = True
        seen: list[int] = []
        for rel in self.query.relations.values():
            if id(rel) not in seen:
                seen.append(id(rel))
                rel.remove_on_append(self._on_append)

    # -- planning ----------------------------------------------------------

    def _plan_now(self) -> tuple[QueryPlan, bool]:
        cards = {nm: int(rel.n)
                 for nm, rel in self.query.relations.items()}
        return self._sess._plan(self.query, cards, self._m_budget,
                                self._strategy, None)

    # -- full (re)execution ------------------------------------------------

    def refresh(self) -> None:
        """Execute the standing plan from scratch, keeping every binary
        step's materialized intermediate resident.  Runs at registration
        and whenever drift re-plans (or the delta rule cannot apply —
        e.g. an appended relation bound under several names)."""
        t0 = time.perf_counter()
        qp, hit = self._plan_now()
        plan_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        res = plan_ir.execute_plan(qp, dict(self.query.relations),
                                   keep_intermediates=True)
        self._last_exec_s = time.perf_counter() - t1
        self._plan = qp
        self._intermediates = dict(res.intermediates or {})
        # sanitizer (opt-in): the residents must be exactly the plan's
        # materialized outs — a divergence here means later delta rounds
        # would join against stale or missing intermediates
        arena_sanitizer.check_residents(qp, self._intermediates)
        self._delta_shapes.clear()
        self._count = int(res.count)
        self._tuples += int(res.tuples_read)
        self._rounds += int(res.rounds)
        self._last_steps = res.step_stats
        self._last_plan_s = plan_s
        self._last_cache_hit = hit
        self._versions = {nm: rel.version
                          for nm, rel in self.query.relations.items()}

    # -- ingest ------------------------------------------------------------

    def _on_append(self, rel: Relation, delta: Relation) -> None:
        if self._closed:
            return
        names = [nm for nm, rr in self.query.relations.items()
                 if rr is rel]
        if not names:      # observer outlived a rebinding; nothing to do
            return
        t0 = time.perf_counter()
        if len(names) > 1:
            # the delta rule needs single occurrence (a self-join delta has
            # cross terms); fall back to a full refresh — still exact
            self.refresh()
            self.delta_rounds.append(DeltaRecord(
                relation=names[0], delta_rows=int(delta.n),
                count_delta=0, overflowed=False, rounds=0,
                tuples_read=0, replanned=True,
                exec_s=time.perf_counter() - t0))
            return
        self._delta_update(names[0], delta, t0)

    def _delta_update(self, name: str, delta: Relation,
                      t0: float) -> None:
        qp, _hit = self._plan_now()
        if qp is not self._plan:
            # log-bucketed cache key moved (≥4x-scale drift): the session
            # re-planned, residents match the OLD plan — full refresh
            self.refresh()
            self.delta_rounds.append(DeltaRecord(
                relation=name, delta_rows=int(delta.n), count_delta=0,
                overflowed=False, rounds=0, tuples_read=0,
                replanned=True, exec_s=time.perf_counter() - t0))
            return
        has_resident = any(s.op == "binary" and not s.aggregate
                           for s in self._plan.steps)
        if not has_resident and self._plan.kind != "cyclic":
            # single-root standing plan, nothing resident to refresh: the
            # cheapest exact delta is the all-binary cascade planned at
            # the DELTA's cardinality (same plan_query machinery, cached
            # in the session under the delta's log bucket) — a tiny build
            # side and one staged probe pass per sibling, no partition
            # sweep at all
            res = self._delta_exec_cascade(name, delta)
        else:
            dsteps, env, outs = self._delta_steps(name, delta)
            dplan = QueryPlan(
                steps=tuple(dsteps), n_relations=self._plan.n_relations,
                kind=self._plan.kind, strategy=self._plan.strategy,
                m_budget=self._plan.m_budget,
                max_rounds=self._plan.max_rounds, growth=self._plan.growth,
                base_salt=self._plan.base_salt)
            res = plan_ir.execute_plan(dplan, env, keep_intermediates=True)
            rows = {st.out: st.rows for st in res.step_stats}
            for delta_out, orig_out in outs.items():
                self._merge_intermediate(
                    orig_out, (res.intermediates or {})[delta_out],
                    rows.get(delta_out, 0))
            arena_sanitizer.check_residents(self._plan,
                                            self._intermediates)
        self._count += int(res.count)
        self._tuples += int(res.tuples_read)
        self._rounds += int(res.rounds)
        self._last_steps = res.step_stats
        self._last_exec_s = time.perf_counter() - t0
        self._versions = {nm: rel.version
                          for nm, rel in self.query.relations.items()}
        self.delta_rounds.append(DeltaRecord(
            relation=name, delta_rows=int(delta.n),
            count_delta=int(res.count), overflowed=bool(res.overflowed),
            rounds=int(res.rounds), tuples_read=int(res.tuples_read),
            replanned=False, exec_s=time.perf_counter() - t0))

    def _delta_exec_cascade(self, name: str, delta: Relation):
        """Delta execution for single-root standing plans: plan the same
        query as an all-binary cascade with the delta's cardinality in
        ``name``'s slot (the session caches it under the delta's log
        bucket, so steady ingest re-plans nothing) and execute with the
        delta substituted for the base relation."""
        cards = {nm: int(rel.n) for nm, rel in self.query.relations.items()}
        cards[name] = max(1, int(delta.n))
        dqp, _ = self._sess._plan(self.query, cards, self._m_budget,
                                  "cascade", None)
        env = dict(self.query.relations)
        env[name] = delta
        return plan_ir.execute_plan(dqp, env)

    def _delta_steps(self, name: str, delta: Relation):
        """Build the delta plan: the standing plan's steps on the path
        from ``name``'s leaf to the root, Δ-carrying inputs renamed, plus
        the execution environment (base relations + resident
        intermediates + the delta + family-masked siblings)."""
        env: dict[str, Relation] = dict(self.query.relations)
        env.update(self._intermediates)
        env[_dname(name)] = delta
        # family masking, two hops out from the delta: first every base
        # sibling sharing an equality predicate with the delta relation
        # shrinks to the delta's touched hash families, then each MASKED
        # sibling's own touched families shrink ITS other neighbors (a
        # masked sibling keeps a superset of the rows reaching the delta,
        # so its family histogram over the shared column bounds what the
        # next hop can match — still exact, see mask_to_families)
        sources: dict[str, Relation] = {name: delta}
        for _hop in range(2):
            nxt: dict[str, Relation] = {}
            for a, src in sources.items():
                for pred in self.query.predicates:
                    for (x, xcol), (y, ycol) in ((pred.left, pred.right),
                                                 (pred.right, pred.left)):
                        if (x == a and y != name and y in env
                                and y not in sources and y not in nxt):
                            m = mask_to_families(
                                env[y], ycol, touched_families(src, xcol))
                            if m is not env[y]:
                                env[y] = m
                                nxt[y] = m
            if not nxt:
                break
            sources = nxt
        deltas = {name}
        rename = {name: _dname(name)}
        # Δ-size estimates for inputs that only exist at execution time:
        # a delta intermediate is roughly its resident's rows scaled by the
        # delta fraction (recovery absorbs under-sizing exactly, so these
        # only steer partition sizing, never correctness)
        base_n = max(1, int(self.query.relations[name].n))
        frac = min(1.0, int(delta.n) / base_n)
        est: dict[str, int] = {_dname(name): int(delta.n)}
        out_steps: list[PlanStep] = []
        outs: dict[str, str] = {}      # delta out -> resident out
        for step in self._plan.steps:
            carrying = [i for i in step.inputs if i in deltas]
            if not carrying:
                continue               # off-path: resident value stands
            inputs = tuple(rename.get(i, i) for i in step.inputs)
            preds = tuple(
                Predicate((rename.get(p.left[0], p.left[0]), p.left[1]),
                          (rename.get(p.right[0], p.right[0]), p.right[1]))
                for p in step.preds)
            if step.op == "binary":
                if step.aggregate:
                    out = COUNT
                else:
                    out = _dname(step.out)
                    deltas.add(step.out)
                    rename[step.out] = out
                    outs[out] = step.out
                    resident = self._intermediates.get(step.out)
                    full = int(resident.n) if resident is not None else base_n
                    est[out] = max(64, int(full * frac * 2))
                out_steps.append(dataclasses.replace(
                    step, out=out, inputs=inputs, preds=preds))
            else:
                roles = tuple((role, rename.get(nm, nm))
                              for role, nm in step.roles)
                shape = self._delta_shape(step, roles, env, est)
                out_steps.append(dataclasses.replace(
                    step, inputs=inputs, preds=preds, roles=roles,
                    shape_plan=shape))
        return out_steps, env, outs

    def _delta_shape(self, step: PlanStep, roles, env, est):
        """Pre-size the delta fused root from power-of-two-bucketed live
        cardinalities (Δ-inputs not yet materialized use the ``est``
        scaled estimates), cached per bucket tuple: steady same-size
        deltas reuse one shape plan instead of re-sizing every round
        (recovery absorbs the quantized sizing exactly)."""
        from repro_torch.core import engine
        role_map = dict(roles)
        cards = tuple(
            _pow2(max(1, est[nm] if nm in est else int(env[nm].n)))
            for nm in (role_map[k] for k in ("r", "s", "t")))
        key = (step.kind, cards, self._plan.m_budget)
        shape = self._delta_shapes.get(key)
        if shape is None:
            eng = engine.MultiwayJoinEngine(step.kind)
            shape = eng.default_plan(*cards, m_budget=self._plan.m_budget)
            self._delta_shapes[key] = shape
        return shape

    def _merge_intermediate(self, orig_out: str, delta_rel: Relation,
                            rows: int) -> None:
        """Append-merge a binary step's Δ-output into the resident
        intermediate.  Gather outputs are valid-prefix Relations, so the
        merge is a static slice + ``Relation.append``."""
        if rows <= 0:
            return
        resident = self._intermediates.get(orig_out)
        if resident is None:       # plan had no materialize step resident
            if arena_sanitizer.active() and orig_out.startswith("%"):
                raise arena_sanitizer.ArenaSanitizerError(
                    f"arena shadow: delta merge targets {orig_out!r} but "
                    "no resident intermediate exists — the standing "
                    "plan's residents leaked or were never kept")
            return
        resident.append({c: v[:rows]
                         for c, v in delta_rel.columns.items()})

    # -- answers -----------------------------------------------------------

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self):
        """The standing answer, as the same ``QueryResult`` type
        ``JoinSession.execute`` returns.  ``tuples_read``/``rounds``
        accumulate over the standing query's whole life (int64-exact)."""
        from repro_torch.core.session import QueryResult
        stale = any(rel.version != self._versions.get(nm)
                    for nm, rel in self.query.relations.items())
        if stale:                  # out-of-band change: re-anchor exactly
            self.refresh()
        return QueryResult(
            count=np.int64(self._count), overflowed=False,
            tuples_read=np.int64(self._tuples),
            rounds=max(self._rounds, 1), steps=self._last_steps,
            kind=self._plan.kind, strategy=self._plan.strategy,
            cache_hit=self._last_cache_hit, plan_s=self._last_plan_s,
            exec_s=self._last_exec_s, plan=self._plan)
