"""Join planner: N-way query decomposition + the 3-way vs cascade call.

Three decision layers:
  * traffic  — the paper's closed-form tuple-traffic comparison
    (re-exported from cost_model: Examples 3/4 thresholds),
  * time     — the Appendix-A cycle model on a concrete hardware profile
    (captures the compute/DRAM/SSD terms traffic alone misses); the
    default profile is the paper's Plasticine, as in the JAX package, so
    both packages make the same 3-way-or-cascade decisions,
  * execution — :func:`plan_query` is the **decomposer**: it takes a
    declarative ``core.query.Query`` over any connected acyclic graph of
    N ≥ 2 relations (cyclic allowed at N = 3, the triangle query) and
    returns an executable ``core.plan_ir.QueryPlan``.  The predicate tree
    is greedily contracted along its smallest estimated joins
    (Swami–Schiefer ``|A ⋈ B| ≈ |A||B| / max(d_A, d_B)``) into binary
    materialize steps until three relations remain; the 3-relation
    frontier is classified (linear / star by hub-cardinality ratio) and
    the Appendix-A time model picks the root: one fused, recovery-wrapped
    3-way step or two more binary steps.  3-relation queries therefore
    keep their single-step fused plans, and every cascade — including the
    legacy ``EnginePlan.run`` cascade — executes through the one plan-IR
    walker.

:func:`plan_step` is the former ``plan_query``: the 3-relation step
planner that sizes one shape plan and times one 3-way/cascade choice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.errors import PlanPerRError
from repro_torch.core import (binary_join, cyclic3, engine, linear3, plan_ir,
                              star3)
from repro_torch.core.cost_model import (  # noqa: F401  (traffic layer)
    PlanChoice, cascaded_binary_tuples, choose_cyclic_strategy,
    choose_linear_strategy, cyclic3_tuples, linear3_tuples)
from repro_torch.core.query import (STAR_FACT_RATIO, Classification, Predicate,
                              Query, QueryGraphError)
from repro_torch.core.relation import Relation
from repro_torch.perfmodel import (HW, PLASTICINE, Calibration,
                             binary_cascade_time, linear3_time,
                             star3_binary_time, star3_time)


@dataclasses.dataclass(frozen=True)
class TimedChoice:
    strategy: str            # "3way" | "cascade"
    t_3way_s: float          # calibrated when a Calibration was applied
    t_cascade_s: float
    speedup: float           # cascade / 3way (>1 favors the 3-way)
    bottleneck_3way: str
    bottleneck_cascade: str
    calibration: str = "identity"   # Calibration.source that scaled this


def _timed(t3, tc, cal: Calibration | None) -> TimedChoice:
    """Compare two Breakdowns, optionally re-anchored by measured bench
    constants (``perfmodel.calibrate``) — the decision uses the CALIBRATED
    totals, and the choice records which calibration spoke."""
    t3s, tcs = t3.total, tc.total
    src = "identity"
    if cal is not None:
        t3s, tcs = cal.scaled(t3s, tcs)
        src = cal.source
    return TimedChoice("3way" if t3s < tcs else "cascade",
                       t3s, tcs, tcs / t3s,
                       t3.bottleneck, tc.bottleneck, calibration=src)


def choose_linear_timed(n_r: float, n_s: float, n_t: float, d: float,
                        hw: HW = PLASTICINE, *,
                        calibration: Calibration | None = None
                        ) -> TimedChoice:
    """Self/linear 3-way vs cascade on a hardware profile (Fig 4 e/f)."""
    return _timed(linear3_time(n_r, n_s, n_t, d, hw),
                  binary_cascade_time(n_r, n_s, n_t, d, hw), calibration)


def choose_star_timed(n_r: float, n_s: float, n_t: float, d: float,
                      hw: HW = PLASTICINE, *,
                      calibration: Calibration | None = None) -> TimedChoice:
    """Star 3-way vs cascade (Fig 4 g/h/i)."""
    return _timed(star3_time(n_r, n_s, n_t, d, hw),
                  star3_binary_time(n_r, n_s, n_t, d, hw), calibration)


# --------------------------------------------------------------------------
# executable engine plans (one 3-relation step)
# --------------------------------------------------------------------------

# the "no time model ran" marker: strategy forced to 3-way, time fields
# explicitly n/a rather than a wrong estimate
FORCED_3WAY_CHOICE = TimedChoice("3way", float("nan"), float("nan"),
                                 float("inf"), "n/a", "n/a")

# legacy default column names per engine kwarg (the pre-declarative API)
_DEFAULT_COLS = {"ra": "a", "rb": "b", "sb": "b", "sc": "c", "tc": "c",
                 "ta": "a"}


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """A sized, executable 3-relation step: the timed 3-way/cascade
    decision plus the shape plan the fused engine runs with.  ``run``
    executes the chosen strategy and returns an exact count — the 3-way
    path through the recovery engine, the cascade path through the SAME
    plan-IR executor that runs multi-step query plans (the old ad-hoc
    cascade branch is retired)."""

    kind: str                                   # "linear"|"cyclic"|"star"
    strategy: str                               # "3way" | "cascade"
    shape_plan: object                          # Linear3Plan | Cyclic3Plan | Star3Plan
    choice: TimedChoice
    m_budget: int | None
    max_rounds: int = 3
    growth: float = 2.0
    base_salt: int = 0

    def build(self) -> engine.MultiwayJoinEngine:
        # base_salt MUST flow through: a plan-level salt that build()
        # drops would silently de-randomize every recovery round
        return engine.MultiwayJoinEngine(
            self.kind, max_rounds=self.max_rounds, growth=self.growth,
            base_salt=self.base_salt)

    def run(self, r, s, t, *, binding=None, **cols) -> engine.EngineResult:
        """Execute the chosen strategy.  Column names come from ``binding``
        (a ``query.Binding``, the declarative path) or the legacy
        ``rb=/sb=/...`` kwargs."""
        if binding is not None:
            cols = binding.col_kwargs()
        if self.strategy == "3way" or self.kind == "cyclic":
            return self.build().count(r, s, t, self.shape_plan,
                                      binding=binding, **cols)
        # cascade: build the 2-step plan (materialize R ⋈ S, aggregate
        # with T) and walk it through the plan-IR executor
        colmap = {k: cols.get(k, _DEFAULT_COLS[k])
                  for k in ("rb", "sb", "sc", "tc")}
        qp = plan_ir.QueryPlan(
            steps=_cascade3_steps({"r": "r", "s": "s", "t": "t"}, colmap),
            n_relations=3, kind=self.kind, strategy="cascade",
            m_budget=self.m_budget,
            max_rounds=self.max_rounds, growth=self.growth,
            base_salt=self.base_salt)
        res = plan_ir.execute_plan(qp, {"r": r, "s": s, "t": t})
        return plan_ir.result_as_engine(res)


def forced_3way_plan(kind: str, shape_plan, *, m_budget: int | None = None,
                     max_rounds: int = 3, growth: float = 2.0,
                     base_salt: int = 0) -> EnginePlan:
    """An EnginePlan that always runs the fused 3-way engine with the
    given shape plan — no time model (the cyclic query has no 2-join
    cascade; callers with an explicit shape plan skip the planner)."""
    return EnginePlan(kind=kind, strategy="3way", shape_plan=shape_plan,
                      choice=FORCED_3WAY_CHOICE, m_budget=m_budget,
                      max_rounds=max_rounds, growth=growth,
                      base_salt=base_salt)


def plan_step(kind: str, n_r: int, n_s: int, n_t: int, d: float, *,
              m_budget: int | None = None, hw: HW = PLASTICINE,
              max_rounds: int = 3, growth: float = 2.0, base_salt: int = 0,
              calibration: Calibration | None = None,
              **plan_kw) -> EnginePlan:
    """Size one 3-relation shape plan from the paper's partitioning rules
    AND pick its 3-way vs cascade strategy from the Appendix-A time model
    — returning an executable step rather than a recommendation.  (This
    was ``plan_query`` before the N-way decomposer took that name.)"""
    if kind in ("linear", "cyclic") and m_budget is None:
        raise ValueError(f"{kind} plans need m_budget (on-chip partition "
                         "size in tuples)")
    if kind == "linear":
        choice = choose_linear_timed(n_r, n_s, n_t, d, hw,
                                     calibration=calibration)
        shape = linear3.default_plan(n_r, n_s, n_t, m_budget=m_budget,
                                     **plan_kw)
    elif kind == "cyclic":
        # the cyclic (triangle) query has no 2-join cascade, so the
        # strategy is forced; no cyclic cycle model exists yet either
        choice = FORCED_3WAY_CHOICE
        shape = cyclic3.default_plan(n_r, n_s, n_t, m_budget=m_budget,
                                     **plan_kw)
    elif kind == "star":
        choice = choose_star_timed(n_r, n_s, n_t, d, hw,
                                   calibration=calibration)
        shape = star3.default_plan(n_r, n_s, n_t, **plan_kw)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return EnginePlan(kind=kind, strategy=choice.strategy, shape_plan=shape,
                      choice=choice, m_budget=m_budget,
                      max_rounds=max_rounds, growth=growth,
                      base_salt=base_salt)


# --------------------------------------------------------------------------
# the N-way decomposer: Query -> plan_ir.QueryPlan
# --------------------------------------------------------------------------

def _distinct_est(rel: Relation, col: str) -> int:
    """FM-sketch distinct estimate of a join column (the plan-time seed
    for Swami–Schiefer estimates).  Device-side: the sketch is built once
    per (relation, column) and cached on the Relation, so planning never
    runs a host ``np.unique`` pass over the data."""
    return rel.distinct_estimate(col)


def estimate_d(binding) -> int:
    """Distinct-value estimate for the time model: the hub relation's
    R-side join column (one sketch build, amortized by the plan cache
    and the Relation's own sketch cache)."""
    return _distinct_est(binding.rels["s"], binding.col_kwargs()["sb"])


def _cascade3_steps(role_names, colmap) -> tuple:
    """The 2-step binary cascade over a 3-relation frontier: materialize
    I = R ⋈ S exactly, aggregate I ⋈ T host-side.  ``role_names`` maps
    engine role -> input name; ``colmap`` the rb/sb/sc/tc column keys."""
    rn, sn, tn = role_names["r"], role_names["s"], role_names["t"]
    rb, sb, sc, tc = colmap["rb"], colmap["sb"], colmap["sc"], colmap["tc"]
    i0 = "%i0"
    proj_r = ((rb, f"{rn}.{rb}"),)
    proj_s = tuple({sb: f"{sn}.{sb}", sc: f"{sn}.{sc}"}.items())
    step1 = plan_ir.PlanStep(
        op="binary", out=i0, inputs=(rn, sn),
        preds=(Predicate((rn, f"{rn}.{rb}"), (sn, f"{sn}.{sb}")),),
        aggregate=False, project=(proj_r, proj_s))
    step2 = plan_ir.PlanStep(
        op="binary", out=plan_ir.COUNT, inputs=(i0, tn),
        preds=(Predicate((i0, f"{sn}.{sc}"), (tn, tc)),), aggregate=True)
    return (step1, step2)


def _swap_linear_rt(cls_: Classification) -> Classification:
    """Swap the r/t endpoint roles of a linear classification (the path
    is symmetric, so this is free) — used to land a pinned per-R
    relation on role r, where the recovery engine's per-R rounds live."""
    cm, rm = cls_.col_map, cls_.role_map
    return Classification(
        kind=cls_.kind, shape=cls_.shape,
        roles=(("r", rm["t"]), ("s", rm["s"]), ("t", rm["r"])),
        cols=(("rb", cm["tc"]), ("sb", cm["sc"]),
              ("sc", cm["sb"]), ("tc", cm["rb"])))


def pin_per_r_classification(cls_: Classification,
                             per_r_name: str) -> Classification:
    """Validate + adjust a 3-relation classification so a pinned per-R
    relation lands on engine role r, where the recovery engine's per-R
    rounds live.  Star relaxes to the linear layout (per-R rounds are
    linear-engine ops, and every star is also a valid path); cyclic and
    centre pins are errors."""
    if cls_.kind == "cyclic":
        raise PlanPerRError(
            "per-R counts are defined for linear (path) queries; this "
            "query classified as 'cyclic'")
    if cls_.kind == "star":
        cls_ = Classification(kind="linear", shape=cls_.shape,
                              roles=cls_.roles, cols=cls_.cols)
    role_map = cls_.role_map
    if per_r_name == role_map["s"]:
        raise PlanPerRError(
            f"per-R relation {per_r_name!r} is the path centre; per-R "
            "counts group by a path endpoint")
    if per_r_name == role_map["t"]:
        cls_ = _swap_linear_rt(cls_)
    return cls_


def _single_fused_plan(query: Query, cls_: Classification, ep: EnginePlan,
                       per_r_key: str | None = None) -> plan_ir.QueryPlan:
    """Wrap a sized 3-relation EnginePlan as a one-step QueryPlan (the
    path every 3-relation fused query takes — plan-cache compatible)."""
    role_map = dict(cls_.roles)
    step = plan_ir.PlanStep(
        op="fused3", out=plan_ir.COUNT,
        inputs=tuple(role_map[r] for r in ("r", "s", "t")),
        preds=(), aggregate=True, kind=cls_.kind, roles=cls_.roles,
        cols=cls_.cols, shape_plan=ep.shape_plan, choice=ep.choice,
        per_r_key=per_r_key)
    return plan_ir.QueryPlan(
        steps=(step,), n_relations=len(query.relations), kind=cls_.kind,
        strategy="3way", m_budget=ep.m_budget,
        max_rounds=ep.max_rounds, growth=ep.growth, base_salt=ep.base_salt)


class _Node:
    """One vertex of the contraction graph: a base relation or a planned
    intermediate.  ``colmap`` maps origin ``(relation, column)`` pairs to
    the vertex's CURRENT column keys (base columns keep their names,
    intermediate columns are ``"rel.col"``); ``d`` carries per-origin
    distinct estimates, capped by the vertex's estimated cardinality."""

    __slots__ = ("name", "order", "card", "colmap", "d")

    def __init__(self, name, order, card, colmap, d):
        self.name, self.order, self.card = name, order, max(1, int(card))
        self.colmap, self.d = colmap, d


def _edge_est(nodes, e) -> float:
    """Swami–Schiefer estimated join size of a live edge."""
    na, nb = nodes[e["ends"][0]], nodes[e["ends"][1]]
    d = 1
    for o in (e["pred"].left, e["pred"].right):
        for node in (na, nb):
            if o in node.colmap:
                d = max(d, node.d.get(o, 1))
    return max(1.0, (float(na.card) * float(nb.card)) / d)


def _contract(nodes, live, e, steps, k) -> str:
    """Contract live edge ``e`` into a binary materialize step; returns
    the new intermediate's name.  Projections keep exactly the origins
    the remaining edges still reference (plus this step's join keys)."""
    na_name, nb_name = e["ends"]
    na, nb = nodes[na_name], nodes[nb_name]
    out = f"%i{k}"
    down = set()
    for e2 in live:
        if e2 is e:
            continue
        for o in (e2["pred"].left, e2["pred"].right):
            if o in na.colmap or o in nb.colmap:
                down.add(o)
    jl, jr = e["pred"].left, e["pred"].right

    def side(node):
        origins = sorted({o for o in down if o in node.colmap}
                         | {o for o in (jl, jr) if o in node.colmap})
        proj = tuple((node.colmap[o], f"{o[0]}.{o[1]}") for o in origins)
        return origins, proj

    _, proj_a = side(na)
    _, proj_b = side(nb)
    key_l = jl if jl in na.colmap else jr
    key_r = jr if key_l is jl else jl
    pred = Predicate((na_name, f"{key_l[0]}.{key_l[1]}"),
                     (nb_name, f"{key_r[0]}.{key_r[1]}"))
    est_out = int(_edge_est(nodes, e))
    steps.append(plan_ir.PlanStep(
        op="binary", out=out, inputs=(na_name, nb_name), preds=(pred,),
        aggregate=False, project=(proj_a, proj_b),
        est_rows=(na.card, nb.card), est_out=est_out))
    colmap, d = {}, {}
    for o in down:
        owner = na if o in na.colmap else nb
        colmap[o] = f"{o[0]}.{o[1]}"
        d[o] = min(owner.d.get(o, owner.card), max(1, est_out))
    nodes[out] = _Node(out, min(na.order, nb.order), est_out, colmap, d)
    del nodes[na_name], nodes[nb_name]
    live.remove(e)
    for e2 in live:
        e2["ends"] = [out if x in (na_name, nb_name) else x
                      for x in e2["ends"]]
    return out


def _node_key(nodes, node_name, pred) -> str:
    node = nodes[node_name]
    for o in (pred.left, pred.right):
        if o in node.colmap:
            return node.colmap[o]
    raise AssertionError(f"predicate {pred} has no endpoint in {node_name}")


def plan_query(query: Query, cards=None, *, m_budget: int | None = None,
               hw: HW = PLASTICINE, max_rounds: int = 3, growth: float = 2.0, base_salt: int = 0,
               star_fact_ratio: float | None = None,
               strategy: str | None = None,
               classification: Classification | None = None,
               calibration: Calibration | None = None,
               per_r_name: str | None = None, per_r_key: str = "a",
               **plan_kw) -> plan_ir.QueryPlan:
    """Decompose a declarative Query into an executable multi-step plan.

    * 3 relations — classify (triangle / star / linear) and either emit
      the single fused, recovery-wrapped 3-way step or (when the time
      model or ``strategy="cascade"`` says so) the 2-step binary cascade.
    * 2 relations — one binary aggregate step.
    * N ≥ 4, acyclic — greedily contract the predicate tree along its
      smallest estimated joins into binary materialize steps until three
      vertices remain, then plan the frontier like a 3-relation query
      (fused root sized at execute time from the live intermediates).

    ``strategy``: ``None`` lets the Appendix-A time model decide per
    root; ``"3way"`` forces the fused engine at the root; ``"cascade"``
    forces all-binary.  ``cards`` overrides the live cardinalities.
    ``calibration`` re-anchors the time model's constants from measured
    bench data (``perfmodel.calibrate``); ``None`` keeps the hand-set
    Appendix-A constants.

    ``per_r_name`` pins one relation for per-key group counts: the plan
    gets a fused linear root with that relation in role r and the
    declarative ``per_r_key`` stamped on the root step, which the
    executor answers via the recovery engine's per-R rounds.  The pinned
    relation must be a path endpoint (3 relations) or a leaf of the
    predicate tree (N ≥ 4) — its join edge is excluded from contraction
    so it survives to the root.
    """
    if isinstance(query, str):
        raise TypeError(
            "plan_query now takes a core.query.Query (it is the N-way "
            "decomposer); the 3-relation step planner is plan_step(kind, "
            "n_r, n_s, n_t, d, ...)")
    if strategy not in (None, "3way", "cascade"):
        raise ValueError(f"unknown strategy {strategy!r}: pass None "
                         "(planner decides), '3way' (force the fused "
                         "multiway engine) or 'cascade' (force the "
                         "binary cascade)")
    ratio = STAR_FACT_RATIO if star_fact_ratio is None else star_fact_ratio
    rels = query.relations
    names = list(rels)
    n = len(names)
    if per_r_name is not None:
        if per_r_name not in rels:
            raise PlanPerRError(f"per-R relation {per_r_name!r} is not one "
                                f"of the query's relations {sorted(rels)}")
        if per_r_key not in rels[per_r_name].columns:
            raise PlanPerRError(f"per-R key column {per_r_key!r} is not a "
                                f"column of relation {per_r_name!r}")
        if strategy == "cascade":
            raise PlanPerRError("per-R counts need the fused multiway root "
                                "(recovery per-R rounds); they have no "
                                "binary-cascade form")
        if n == 2:
            raise PlanPerRError("per-R counts need a fused 3-way root; a "
                                "2-relation query has none")
        # the fused root IS the per-R implementation — pin it
        strategy = "3way"
    if cards is None:
        cards = {nm: int(rel.n) for nm, rel in rels.items()}
    edges = query.edges()

    # connectivity over ALL N relations (classify only checks 3)
    adj: dict[str, list[str]] = {nm: [] for nm in names}
    for key in edges:
        a, b = tuple(key)
        adj[a].append(b)
        adj[b].append(a)
    seen, frontier = {names[0]}, [names[0]]
    while frontier:
        for nxt in adj[frontier.pop()]:
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    if seen != set(names):
        missing = sorted(set(names) - seen)
        raise QueryGraphError(
            f"predicate graph is disconnected: relation(s) {missing} "
            "join nothing reachable from the rest of the query")

    cfg = dict(m_budget=m_budget, max_rounds=max_rounds, growth=growth,
               base_salt=base_salt)

    if n == 2:
        if strategy == "3way":
            raise ValueError("a 2-relation query is a single binary hash "
                             "join; it has no 3-way plan")
        (pred,) = edges.values()
        step = plan_ir.PlanStep(op="binary", out=plan_ir.COUNT,
                                inputs=(pred.left[0], pred.right[0]),
                                preds=(pred,), aggregate=True)
        return plan_ir.QueryPlan(steps=(step,), n_relations=2,
                                 kind="binary", strategy="cascade", **cfg)

    if n == 3:
        cls_ = classification or query.classify(cards,
                                                star_fact_ratio=ratio)
        if per_r_name is not None:
            cls_ = pin_per_r_classification(cls_, per_r_name)
        role_map = dict(cls_.roles)
        n_r, n_s, n_t = (cards[role_map[k]] for k in ("r", "s", "t"))
        if strategy == "cascade":
            if cls_.kind == "cyclic":
                raise ValueError("the cyclic (triangle) query has no "
                                 "2-join binary cascade")
            return plan_ir.QueryPlan(
                steps=_cascade3_steps(role_map, dict(cls_.cols)),
                n_relations=3, kind=cls_.kind, strategy="cascade", **cfg)
        if strategy == "3way":
            if cls_.kind != "star" and m_budget is None:
                raise ValueError(f"{cls_.kind} plans need m_budget")
            shape = engine.MultiwayJoinEngine(cls_.kind).default_plan(
                n_r, n_s, n_t, m_budget=m_budget, **plan_kw)
            ep = forced_3way_plan(cls_.kind, shape, **cfg)
        else:
            ep = plan_step(cls_.kind, n_r, n_s, n_t,
                           estimate_d(query.bind(cls_)), hw=hw,
                           calibration=calibration, **cfg, **plan_kw)
        if ep.strategy == "3way":
            return _single_fused_plan(query, cls_, ep,
                                      per_r_key=(per_r_key if per_r_name
                                                 else None))
        return plan_ir.QueryPlan(
            steps=_cascade3_steps(role_map, dict(cls_.cols)),
            n_relations=3, kind=cls_.kind, strategy="cascade", **cfg)

    # ---- N >= 4: acyclic (tree) decomposition ---------------------------
    if classification is not None:
        raise ValueError("forced classifications only apply to "
                         "3-relation queries")
    if len(edges) != n - 1:
        raise QueryGraphError(
            f"cyclic predicate graphs are only supported at 3 relations "
            f"(the triangle query); this {n}-relation query has "
            f"{len(edges)} predicates — N-way queries must form a tree "
            "(connected and acyclic)")
    if per_r_name is not None and len(adj[per_r_name]) != 1:
        raise PlanPerRError(
            f"per-R relation {per_r_name!r} joins "
            f"{len(adj[per_r_name])} relations; N-way per-R counts need "
            "the pinned relation to be a leaf of the predicate tree (so "
            "it can survive contraction to the fused root)")

    nodes: dict[str, _Node] = {}
    for i, nm in enumerate(names):
        refs = sorted({col for p in query.predicates
                       for rn2, col in (p.left, p.right) if rn2 == nm})
        nodes[nm] = _Node(
            nm, i, cards[nm], {(nm, c): c for c in refs},
            {(nm, c): min(_distinct_est(rels[nm], c), max(1, cards[nm]))
             for c in refs})
    live = [{"ends": [p.left[0], p.right[0]], "pred": p}
            for p in edges.values()]

    steps: list = []
    k = 0
    while len(nodes) > 3:
        # a pinned per-R leaf's edge is never contracted, so the pinned
        # relation survives to the 3-vertex frontier as an endpoint
        cands = [ie for ie in enumerate(live)
                 if per_r_name not in ie[1]["ends"]]
        e = min(cands, key=lambda ie: (_edge_est(nodes, ie[1]), ie[0]))[1]
        _contract(nodes, live, e, steps, k)
        k += 1

    # frontier: 3 vertices, 2 edges — a path; classify like a 3-rel query
    e1, e2 = live
    (centre,) = set(e1["ends"]) & set(e2["ends"])
    order = sorted(nodes.values(), key=lambda nd: nd.order)
    ends = [nd.name for nd in order if nd.name != centre]
    rn_, tn = ends[0], ends[1]
    if per_r_name is not None and tn == per_r_name:
        rn_, tn = tn, rn_     # per-R rounds live on role r
    e_rc = e1 if rn_ in e1["ends"] else e2
    e_ct = e2 if e_rc is e1 else e1
    n_r, n_s, n_t = nodes[rn_].card, nodes[centre].card, nodes[tn].card
    kind = "star" if n_s >= ratio * max(n_r, n_t, 1) else "linear"
    if per_r_name is not None:
        # per-R rounds are linear-engine ops; the linear root is correct
        # for any path frontier (star is only a layout optimization)
        kind = "linear"
    cols = (("rb", _node_key(nodes, rn_, e_rc["pred"])),
            ("sb", _node_key(nodes, centre, e_rc["pred"])),
            ("sc", _node_key(nodes, centre, e_ct["pred"])),
            ("tc", _node_key(nodes, tn, e_ct["pred"])))
    sb_origin = next(o for o in (e_rc["pred"].left, e_rc["pred"].right)
                     if o in nodes[centre].colmap)
    d_est = nodes[centre].d.get(sb_origin, n_s)
    if strategy is None:
        timed = (choose_star_timed if kind == "star"
                 else choose_linear_timed)
        choice = timed(n_r, n_s, n_t, d_est, hw, calibration=calibration)
    else:
        choice = FORCED_3WAY_CHOICE if strategy == "3way" else None
    root_3way = (strategy == "3way"
                 or (strategy is None and choice.strategy == "3way"))
    if root_3way:
        if kind != "star" and m_budget is None:
            raise ValueError(f"{kind} plans need m_budget (on-chip "
                             "partition size in tuples)")

        def frontier_pred(e):
            p, (a, b) = e["pred"], e["ends"]
            return Predicate((a, _node_key(nodes, a, p)),
                             (b, _node_key(nodes, b, p)))
        steps.append(plan_ir.PlanStep(
            op="fused3", out=plan_ir.COUNT, inputs=(rn_, centre, tn),
            preds=(frontier_pred(e_rc), frontier_pred(e_ct)),
            aggregate=True, kind=kind,
            roles=(("r", rn_), ("s", centre), ("t", tn)), cols=cols,
            shape_plan=None, choice=choice,
            est_rows=(n_r, n_s, n_t),
            per_r_key=(per_r_key if per_r_name else None)))
        label = "hybrid" if len(steps) > 1 else "3way"
    else:
        # all-binary tail: contract (R, centre), aggregate with T
        i_name = _contract(nodes, live, e_rc, steps, k)
        (e_last,) = live
        a, b = e_last["ends"]
        steps.append(plan_ir.PlanStep(
            op="binary", out=plan_ir.COUNT, inputs=(a, b),
            preds=(Predicate((a, _node_key(nodes, a, e_last["pred"])),
                             (b, _node_key(nodes, b, e_last["pred"]))),),
            aggregate=True, choice=choice,
            est_rows=(nodes[a].card, nodes[b].card)))
        assert i_name in (a, b)
        label = "cascade"
    return plan_ir.QueryPlan(steps=tuple(steps), n_relations=n, kind=kind,
                             strategy=label, **cfg)


# re-export for callers that sized intermediates via the old helper name
exact_join_count = binary_join.exact_join_count
