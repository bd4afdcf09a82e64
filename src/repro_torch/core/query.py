"""Declarative query-graph API: the join *query*, not the physical plan.

The paper's pitch is that one hardware abstraction serves linear (§4),
cyclic (§5) and star (§6.5) multiway joins — but picking which is which was
the caller's job (`kind="linear"` strings plus a per-kind `rb=/sb=/sc=/tc=`
kwarg soup).  This module moves that decision into the engine, the way
graph-pattern systems plan from the join graph itself:

  * :class:`Query` — named relations (with schemas) plus equality join
    predicates, i.e. the join hypergraph.  Nothing physical.
  * :meth:`Query.classify` — analyzes the predicate graph: a 3-cycle is the
    cyclic (triangle) query; a path is either the linear chain or the star
    (hub) schema, disambiguated by cardinalities (a hub whose centre dwarfs
    both endpoints is a fact table with dimension tables — the paper's star
    case); anything disconnected or multi-predicate raises.
  * :meth:`Query.bind` — a schema-checked :class:`Binding` that replaces the
    per-kind column-kwarg soup with ONE object shared by the fused layouts,
    the recovery KindOps and the sharded (mesh) path.

`core.session.JoinSession` is the front door that takes a Query all the way
to an exact, skew-recovered answer (with plan caching).

A Query is NOT limited to three relations: any connected acyclic
equality-predicate hypergraph over N >= 2 named relations executes through
the session (``planner.plan_query`` decomposes it into a
``core.plan_ir.QueryPlan`` — a DAG of fused 3-way and binary join steps).
``classify``/``bind`` remain the 3-relation *engine-kind* analysis that
single fused steps are built from.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from repro_torch.core.relation import Relation

# A path-shaped (hub) query is classified as the paper's star schema when
# the centre relation is at least this many times larger than EACH endpoint
# (fact table vs dimension tables); otherwise it is the linear chain.  Ties
# and ambiguity resolve to linear — the conservative plan (star pins both
# endpoint relations on-chip).
STAR_FACT_RATIO = 4.0

# Canonical column names used by the distributed (mesh) path, which routes
# by literal column name: role -> ((canonical name, col kwarg), ...).
_CANONICAL_COLS = {
    "linear": {"r": (("b", "rb"),), "s": (("b", "sb"), ("c", "sc")),
               "t": (("c", "tc"),)},
    "star": {"r": (("b", "rb"),), "s": (("b", "sb"), ("c", "sc")),
             "t": (("c", "tc"),)},
    "cyclic": {"r": (("a", "ra"), ("b", "rb")),
               "s": (("b", "sb"), ("c", "sc")),
               "t": (("c", "tc"), ("a", "ta"))},
}


class QueryError(ValueError):
    """Base class for declarative-query rejections."""


class QuerySchemaError(QueryError):
    """A predicate references a relation or column the query doesn't have."""


class QueryGraphError(QueryError):
    """The predicate graph doesn't match a supported join shape."""


def _parse_endpoint(ep) -> tuple[str, str]:
    """Accept ``"rel.col"`` strings or ``(rel, col)`` pairs."""
    if isinstance(ep, str):
        rel, dot, col = ep.partition(".")
        if not dot or not rel or not col:
            raise QuerySchemaError(
                f"predicate endpoint {ep!r} is not of the form 'rel.col'")
        return rel, col
    rel, col = ep
    return str(rel), str(col)


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One equality join predicate between two relation columns."""

    left: tuple[str, str]     # (relation name, column)
    right: tuple[str, str]


@dataclasses.dataclass(frozen=True)
class Classification:
    """What the predicate graph analysis decided (no data bound yet)."""

    kind: str                            # "linear" | "cyclic" | "star"
    shape: str                           # "path" | "cycle"
    roles: tuple[tuple[str, str], ...]   # (engine role r/s/t, relation name)
    cols: tuple[tuple[str, str], ...]    # (engine col kwarg, column name)

    @property
    def role_map(self) -> dict[str, str]:
        return dict(self.roles)

    @property
    def col_map(self) -> dict[str, str]:
        return dict(self.cols)


@dataclasses.dataclass(frozen=True)
class Binding:
    """A classification bound to concrete relations: the ONE checked object
    every layer shares (fused layouts take ``**binding.col_kwargs()``,
    recovery takes ``binding.kind_ops()``, the mesh path takes
    ``binding.canonical()``)."""

    kind: str
    roles: tuple[tuple[str, str], ...]           # (role, relation name)
    cols: tuple[tuple[str, str], ...]            # (col kwarg, column name)
    rels: Mapping[str, Relation]                 # role -> Relation

    def col_kwargs(self) -> dict[str, str]:
        """The engine/recovery column kwargs (``rb=/sb=/...``), derived —
        not hand-threaded."""
        return dict(self.cols)

    def relations(self) -> tuple[Relation, Relation, Relation]:
        return self.rels["r"], self.rels["s"], self.rels["t"]

    def cardinalities(self) -> tuple[int, int, int]:
        return tuple(int(self.rels[k].n) for k in ("r", "s", "t"))

    def kind_ops(self, **kw):
        """The recovery KindOps for this query, built FROM the binding."""
        from repro_torch.core import recovery
        return recovery.ops_from_binding(self, **kw)

    def canonical(self) -> tuple[Relation, Relation, Relation]:
        """Relations re-keyed to the canonical column names the distributed
        path routes by (linear/star: r.b, s.b/s.c, t.c; cyclic adds a).
        Pure dict re-keying — arrays (and their device placement) are
        untouched, so sharded inputs stay sharded."""
        colmap = self.col_kwargs()
        out = []
        for role in ("r", "s", "t"):
            rel = self.rels[role]
            cols = {canon: rel.columns[colmap[kwarg]]
                    for canon, kwarg in _CANONICAL_COLS[self.kind][role]}
            out.append(Relation(cols, rel.valid))
        return tuple(out)


class Query:
    """A declarative multiway join: named relations + equality predicates.

    >>> q = Query(
    ...     relations={"f1": friends, "f2": friends, "f3": friends},
    ...     predicates=[("f1.dst", "f2.src"), ("f2.dst", "f3.src")])
    >>> q.classify().kind
    'linear'

    The physical strategy (which relation drives, which columns are H/g
    hashed, 3-way vs cascade) is derived — there is no ``kind`` string.
    Self-joins are expressed by registering the same Relation under several
    names (as above).  Aggregates only, like the engine: COUNT everywhere,
    per-R counts where the classified kind supports them.
    """

    def __init__(self, relations: Mapping[str, Relation],
                 predicates: Iterable):
        self.relations: dict[str, Relation] = dict(relations)
        if not self.relations:
            raise QuerySchemaError("a query needs at least one relation")
        preds = []
        for p in predicates:
            if isinstance(p, Predicate):
                left, right = p.left, p.right
            else:
                left, right = p
            preds.append(Predicate(_parse_endpoint(left),
                                   _parse_endpoint(right)))
        self.predicates: tuple[Predicate, ...] = tuple(preds)
        if not self.predicates:
            raise QueryGraphError("a multiway query needs join predicates")
        for pred in self.predicates:
            for rel, col in (pred.left, pred.right):
                if rel not in self.relations:
                    raise QuerySchemaError(
                        f"predicate references unknown relation {rel!r} "
                        f"(have {sorted(self.relations)})")
                if col not in self.relations[rel].columns:
                    raise QuerySchemaError(
                        f"relation {rel!r} has no column {col!r} "
                        f"(schema: {sorted(self.relations[rel].columns)})")

    # -- structure ---------------------------------------------------------

    def schema(self) -> tuple:
        """Hashable structural signature: relation names + schemas +
        predicates.  Two queries with equal signatures classify and bind
        identically — this is the plan-cache key's structure component."""
        rels = tuple((name, tuple(sorted(rel.columns)))
                     for name, rel in self.relations.items())
        preds = tuple((p.left, p.right) for p in self.predicates)
        return rels, preds

    def edges(self) -> dict[frozenset, Predicate]:
        """The predicate graph's edge set: ``frozenset({rel_a, rel_b}) ->
        Predicate``.  Validates the per-edge rules (no self-referential
        predicates, no parallel predicates between one pair) for ANY
        relation count — the N-way decomposer in ``core.planner`` builds
        its join tree from this."""
        return self._edges()

    def _edges(self) -> dict[frozenset, Predicate]:
        edges: dict[frozenset, Predicate] = {}
        for pred in self.predicates:
            (lr, _), (rr, _) = pred.left, pred.right
            if lr == rr:
                raise QueryGraphError(
                    f"predicate joins {lr!r} with itself; register the "
                    "relation under two names for a self-join")
            key = frozenset((lr, rr))
            if key in edges:
                raise QueryGraphError(
                    f"multiple predicates between {sorted(key)} "
                    "(conjunctive multi-column joins are not supported)")
            edges[key] = pred
        return edges

    # -- classification ----------------------------------------------------

    def classify(self, cardinalities: Mapping[str, int] | None = None, *,
                 star_fact_ratio: float = STAR_FACT_RATIO) -> Classification:
        """Infer the join kind from the predicate graph.

        * three relations in a 3-cycle        → ``cyclic`` (triangles),
        * three relations in a path whose hub is ≥ ``star_fact_ratio`` ×
          each endpoint                        → ``star`` (fact + dims),
        * any other connected path             → ``linear``,
        * anything else (disconnected graph, unsupported arity, repeated
          predicates, self-referential predicates) → ``QueryGraphError``.

        ``cardinalities`` (name → live row count) feeds the star/linear
        disambiguation; when omitted it is read from the relations.
        """
        names = list(self.relations)
        if len(names) != 3:
            raise QueryGraphError(
                f"Query.classify infers the 3-relation engine kinds; got "
                f"{len(names)} relations ({names}).  N-way acyclic queries "
                "are supported: execute them through JoinSession.execute "
                "(or planner.plan_query), which decomposes the predicate "
                "graph into a multi-step plan of fused 3-way and binary "
                "join steps")
        edges = self._edges()
        degree = {n: 0 for n in names}
        for key in edges:
            for n in key:
                degree[n] += 1
        if min(degree.values()) == 0 or len(edges) < 2:
            isolated = sorted(n for n, d in degree.items() if d == 0)
            raise QueryGraphError(
                f"predicate graph is disconnected: relation(s) {isolated} "
                "join nothing")

        def pred_col(pred: Predicate, rel: str) -> str:
            return pred.left[1] if pred.left[0] == rel else pred.right[1]

        if len(edges) == 3:
            # 3-cycle: the triangle query.  R is the first-declared
            # relation (it drives recovery); S its first-declared
            # neighbour; T closes the cycle.
            r = names[0]
            nbrs = [n for n in names[1:]]
            s, t = nbrs[0], nbrs[1]
            e_rs = edges[frozenset((r, s))]
            e_st = edges[frozenset((s, t))]
            e_tr = edges[frozenset((t, r))]
            roles = (("r", r), ("s", s), ("t", t))
            cols = (("ra", pred_col(e_tr, r)), ("rb", pred_col(e_rs, r)),
                    ("sb", pred_col(e_rs, s)), ("sc", pred_col(e_st, s)),
                    ("tc", pred_col(e_st, t)), ("ta", pred_col(e_tr, t)))
            return Classification("cyclic", "cycle", roles, cols)

        # path: centre has degree 2, endpoints degree 1
        centre = next(n for n, d in degree.items() if d == 2)
        ends = [n for n in names if n != centre]
        r, t = ends[0], ends[1]
        e_rs = edges[frozenset((r, centre))]
        e_st = edges[frozenset((centre, t))]
        if cardinalities is None:
            cardinalities = {n: int(rel.n)
                             for n, rel in self.relations.items()}
        n_c = cardinalities[centre]
        hub = n_c >= star_fact_ratio * max(cardinalities[r],
                                           cardinalities[t], 1)
        kind = "star" if hub else "linear"
        roles = (("r", r), ("s", centre), ("t", t))
        cols = (("rb", pred_col(e_rs, r)), ("sb", pred_col(e_rs, centre)),
                ("sc", pred_col(e_st, centre)), ("tc", pred_col(e_st, t)))
        return Classification(kind, "path", roles, cols)

    # -- binding -----------------------------------------------------------

    def bind(self, classification: Classification | None = None, *,
             cardinalities: Mapping[str, int] | None = None,
             star_fact_ratio: float = STAR_FACT_RATIO) -> Binding:
        """Classify (unless given) and attach the relations: the checked
        Binding every execution layer consumes."""
        cls_ = classification or self.classify(
            cardinalities, star_fact_ratio=star_fact_ratio)
        rels = {role: self.relations[name] for role, name in cls_.roles}
        return Binding(kind=cls_.kind, roles=cls_.roles, cols=cls_.cols,
                       rels=rels)
