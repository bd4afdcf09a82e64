"""Port vs JAX package: ingest (``Relation.append``), family masking,
standing queries (``JoinSession.watch``) and ``binary_join.join_count``.

The same seeded numpy relations and the same append schedule go through
both packages in one process.  After every append the port's relation
must equal the reference's: columns, ``valid``, capacity, version and the
cached FM sketches.  Every ``DeltaRecord`` field but ``exec_s`` must equal
the reference's round by round, resident intermediates must match slot
for slot, and every snapshot must equal the reference's and a from-scratch
execute (tolerance: none — every output is an integer, a flag or a
string).
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import oracle_pair_count, skewed_keys
from repro.core import binary_join as jbinary
from repro.core import streaming as jstreaming
from repro.core.query import Query as JQuery
from repro.core.relation import Relation as JRelation
from repro.core.session import JoinSession as JSession
from repro_torch.core import binary_join, streaming
from repro_torch.core.query import Query
from repro_torch.core.relation import Relation
from repro_torch.core.session import JoinSession, QueryResult

M_BUDGET = 128


def _pair(data, capacity=None):
    """The same columns as a reference and a port relation (CPU)."""
    return (JRelation.from_arrays(capacity=capacity, **data),
            Relation.from_arrays(capacity=capacity, device="cpu", **data))


def _cols(rng, n, d, cols):
    return {c: rng.integers(0, d, n).astype(np.int32) for c in cols}


def _assert_rel_equal(jrel, trel, what=""):
    assert sorted(jrel.columns) == sorted(trel.columns), what
    for c in jrel.columns:
        np.testing.assert_array_equal(np.asarray(jrel.col(c)),
                                      trel.col(c).numpy(), err_msg=f"{what}{c}")
    np.testing.assert_array_equal(np.asarray(jrel.valid), trel.valid.numpy(),
                                  err_msg=f"{what}valid")
    assert jrel.capacity == trel.capacity, what
    assert jrel.version == trel.version, what
    jcache = jrel.__dict__.get("_sketch_cache") or {}
    tcache = trel.__dict__.get("_sketch_cache") or {}
    assert sorted(jcache) == sorted(tcache), what
    for c in jcache:
        np.testing.assert_array_equal(np.asarray(jcache[c]),
                                      tcache[c].numpy(),
                                      err_msg=f"{what}sketch {c}")


# --------------------------------------------------------------------------
# ingest: append parity
# --------------------------------------------------------------------------

def _append_schedule(kind, rng):
    """(initial columns, capacity, dead-slot mask or None, sketch columns
    cached before the first append, appended batch sizes)."""
    if kind == "grow":           # 60 -> 65 -> 68 -> 138 rows: 64, 128, 256
        return _cols(rng, 60, 10, "ab"), None, None, (), (5, 3, 70)
    if kind == "padded":         # spare capacity, then past it
        return _cols(rng, 40, 10, "ab"), 100, None, (), (30, 30, 1)
    if kind == "dead":           # dead slots inside the live rows
        keep = rng.random(90) < 0.6
        return _cols(rng, 90, 12, "ab"), 96, keep, (), (4, 40)
    if kind == "empty":          # k = 0 leaves everything, version too
        return _cols(rng, 30, 10, "ab"), None, None, (), (0, 7, 0)
    if kind == "sketch":         # cached sketches update incrementally
        return _cols(rng, 200, 64, "ab"), None, None, ("a", "b"), (40, 300)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["grow", "padded", "dead", "empty",
                                  "sketch"])
def test_append_matches_reference(kind):
    rng = np.random.default_rng(["grow", "padded", "dead", "empty",
                                 "sketch"].index(kind))
    data, cap, keep, sketch_cols, sizes = _append_schedule(kind, rng)
    jrel, trel = _pair(data, cap)
    if keep is not None:
        pad = np.zeros(jrel.capacity, bool)
        pad[:len(keep)] = keep
        jrel = jrel.mask_where(pad)
        trel = trel.mask_where(torch.from_numpy(pad))
    for c in sketch_cols:
        jrel.distinct_sketch(c)
        trel.distinct_sketch(c)
    _assert_rel_equal(jrel, trel, "before: ")
    for i, k in enumerate(sizes):
        batch = _cols(rng, k, 300, "ab")
        jd = jrel.append(batch)
        td = trel.append(**batch)
        _assert_rel_equal(jrel, trel, f"append {i}: ")
        _assert_rel_equal(jd, td, f"delta {i}: ")
        assert td.device == trel.device
    if sketch_cols:               # the incremental sketch is the rebuild
        for c in sketch_cols:
            rebuilt = Relation(dict(trel.columns), trel.valid)
            assert torch.equal(trel.distinct_sketch(c),
                               rebuilt.distinct_sketch(c))
            assert trel.distinct_estimate(c) == jrel.distinct_estimate(c)


def test_append_errors_match_reference():
    rng = np.random.default_rng(1)
    jrel, trel = _pair(_cols(rng, 20, 10, "ab"))
    for rel in (jrel, trel):
        with pytest.raises(ValueError, match="schema"):
            rel.append(a=np.arange(3, dtype=np.int32))
        with pytest.raises(ValueError, match="ragged"):
            rel.append(a=np.arange(3, dtype=np.int32),
                       b=np.arange(4, dtype=np.int32))
        with pytest.raises(TypeError):
            rel.columns["a"] = rel.col("b")
        with pytest.raises(dataclasses.FrozenInstanceError):
            rel.valid = rel.valid
        assert rel.version == 0


def test_append_observers_fire_and_unregister():
    rng = np.random.default_rng(2)
    _, rel = _pair(_cols(rng, 30, 10, "ab"))
    seen = []

    def cb(r, d):
        # fired after the update: the relation already holds the delta
        seen.append((int(d.n), int(r.n), r.version))
    rel.on_append(cb)
    rel.append(a=np.arange(4, dtype=np.int32), b=np.arange(4, dtype=np.int32))
    assert seen == [(4, 34, 1)]
    rel.remove_on_append(cb)
    rel.remove_on_append(cb)           # removing twice is a no-op
    rel.append(a=np.arange(2, dtype=np.int32), b=np.arange(2, dtype=np.int32))
    assert seen == [(4, 34, 1)]


def test_append_leaves_derived_relations_unchanged():
    """Relations derived before an append share its column tensors; the
    append rebinds new tensors and writes into none of the old ones."""
    rng = np.random.default_rng(3)
    data = _cols(rng, 50, 10, "ab")
    _, rel = _pair(data, 64)
    old_cols = dict(rel.columns)
    old_valid = rel.valid
    derived = {
        "masked": rel.mask_where(rel.col("a") < 5),
        "widened": rel.with_columns(c=rel.col("a") + 1),
        "selected": rel.select(torch.arange(10), torch.ones(10, dtype=bool)),
    }
    before = {k: ({c: v.clone() for c, v in r.columns.items()},
                  r.valid.clone()) for k, r in derived.items()}
    for _ in range(3):                 # in-bucket, then past 64
        rel.append(a=rng.integers(0, 10, 9).astype(np.int32),
                   b=rng.integers(0, 10, 9).astype(np.int32))
    for k, r in derived.items():
        cols, valid = before[k]
        assert r.version == 0, k
        assert torch.equal(r.valid, valid), k
        for c, v in cols.items():
            assert torch.equal(r.col(c), v), (k, c)
    for c, v in old_cols.items():
        np.testing.assert_array_equal(v[:50].numpy(), data[c])
    assert int(old_valid.sum()) == 50 and old_valid is not rel.valid


# --------------------------------------------------------------------------
# family masking
# --------------------------------------------------------------------------

@pytest.mark.parametrize("delta_rows,d", [(16, 30), (12_000, 200_000)],
                         ids=["masked", "skipped"])
def test_families_match_reference(delta_rows, d):
    """``touched_families`` (invalid delta rows included) and
    ``mask_to_families`` on both sides of ``MASK_SKIP_FRACTION``."""
    rng = np.random.default_rng(delta_rows)
    jrel, trel = _pair(_cols(rng, 500, d, "bc"), 512)
    jdelta, tdelta = _pair(_cols(rng, delta_rows, d, "bc"),
                           delta_rows + 7)
    dead = np.zeros(delta_rows + 7, bool)
    dead[: delta_rows // 2] = True     # half the delta rows dead
    jdelta = jdelta.mask_where(~dead)
    tdelta = tdelta.mask_where(torch.from_numpy(~dead))
    jt = jstreaming.touched_families(jdelta, "b")
    tt = streaming.touched_families(tdelta, "b")
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    skip = int(tt.sum()) > streaming.N_FAMILIES * streaming.MASK_SKIP_FRACTION
    assert skip == (delta_rows > 1000)   # 6,000 live rows touch ~3,100
    jm = jstreaming.mask_to_families(jrel, "b", jt)
    tm = streaming.mask_to_families(trel, "b", tt)
    assert (tm is trel) == skip == (jm is jrel)
    _assert_rel_equal(jm, tm)
    assert (streaming.N_FAMILIES, streaming.MASK_SKIP_FRACTION,
            streaming._MASK_SALT) == (jstreaming.N_FAMILIES,
                                      jstreaming.MASK_SKIP_FRACTION,
                                      jstreaming._MASK_SALT)


# --------------------------------------------------------------------------
# standing queries, round by round
# --------------------------------------------------------------------------

_RECORD_FIELDS = [f.name for f in dataclasses.fields(streaming.DeltaRecord)
                  if f.name != "exec_s"]


def _records(sq):
    return [{f: getattr(r, f) for f in _RECORD_FIELDS}
            for r in sq.delta_rounds]


def _snap(res):
    return (int(res.count), bool(res.overflowed), int(res.tuples_read),
            int(res.rounds), res.kind, res.strategy, res.plan.describe())


class _Twin:
    """One standing query in both packages over the same data."""

    def __init__(self, rels, preds, *, strategy=None, aliases=None):
        self.data = rels
        self.j, self.t = {}, {}
        for name, cols in rels.items():
            self.j[name], self.t[name] = _pair(cols)
        for alias, name in (aliases or {}).items():
            self.j[alias], self.t[alias] = self.j[name], self.t[name]
        self.preds = preds
        self.jq = JQuery(self.j, preds)
        self.tq = Query(self.t, preds)
        self.jsq = JSession(m_budget=M_BUDGET).watch(self.jq,
                                                     strategy=strategy)
        self.tsq = JoinSession(m_budget=M_BUDGET).watch(self.tq,
                                                        strategy=strategy)
        assert isinstance(self.tsq, streaming.StandingQuery)
        self.check()

    def append(self, name, batch):
        self.j[name].append(batch)
        self.t[name].append(**batch)
        assert _records(self.tsq) == _records(self.jsq)
        self.check()

    def check(self):
        assert self.tsq.count == self.jsq.count
        assert sorted(self.tsq._intermediates) == sorted(
            self.jsq._intermediates)
        for k in self.jsq._intermediates:
            _assert_rel_equal(self.jsq._intermediates[k],
                              self.tsq._intermediates[k], f"{k}: ")

    def finish(self):
        tsnap, jsnap = self.tsq.snapshot(), self.jsq.snapshot()
        assert isinstance(tsnap, QueryResult)
        assert _snap(tsnap) == _snap(jsnap)
        assert not tsnap.overflowed
        fresh = JoinSession(m_budget=M_BUDGET).execute(self.tq)
        assert int(fresh.count) == int(tsnap.count)
        self.tsq.close()
        self.jsq.close()
        return tsnap


def _linear(rng, n, d):
    return ({"R": _cols(rng, n, d, "ab"), "S": _cols(rng, n, d, "bc"),
             "T": _cols(rng, n, d, "ce")},
            [("R.b", "S.b"), ("S.c", "T.c")])


def _query(kind, rng):
    n, d = 400, 80
    if kind == "linear":
        return _linear(rng, n, d)
    if kind == "cyclic":
        return ({"R": _cols(rng, n, d, "ab"), "S": _cols(rng, n, d, "bc"),
                 "T": _cols(rng, n, d, "ca")},
                [("R.b", "S.b"), ("S.c", "T.c"), ("T.a", "R.a")])
    if kind == "star":
        return ({"F": _cols(rng, 4 * n, d, "ab"),
                 "D1": _cols(rng, d, d, ("a", "x")),
                 "D2": _cols(rng, d, d, ("b", "y"))},
                [("F.a", "D1.a"), ("F.b", "D2.b")])
    if kind == "chain4":
        return ({"A": _cols(rng, n, d, "ab"), "B": _cols(rng, n, d, "bc"),
                 "C": _cols(rng, n, d, "ce"), "D": _cols(rng, n, d, "ef")},
                [("A.b", "B.b"), ("B.c", "C.c"), ("C.e", "D.e")])
    raise ValueError(kind)


_STANDING = [("linear", None), ("cyclic", None), ("star", None),
             ("chain4", None), ("chain4", "3way"), ("linear", "cascade")]


@pytest.mark.parametrize("kind,strategy", _STANDING)
def test_standing_query_matches_reference(kind, strategy):
    rng = np.random.default_rng(11 + _STANDING.index((kind, strategy)))
    rels, preds = _query(kind, rng)
    tw = _Twin(rels, preds, strategy=strategy)
    names = list(rels)
    for i in range(4):
        name = names[i % len(names)] if i < len(names) else names[0]
        k = [24, 7, 40, 16][i]
        tw.append(name, _cols(rng, k, 80, tuple(rels[name])))
    # small dimension tables may cross a log bucket and re-plan; the
    # delta path must still have run
    assert not all(r.replanned for r in tw.tsq.delta_rounds)
    assert all(not r.overflowed for r in tw.tsq.delta_rounds)
    tw.finish()


def test_cascade_residents_merge_like_reference():
    """Forced-cascade plans keep ``%i0`` resident; deltas into its inputs
    append-merge into it (rows grow, same slots as the reference's)."""
    rng = np.random.default_rng(5)
    rels, preds = _linear(rng, 500, 90)
    tw = _Twin(rels, preds, strategy="cascade")
    (name,) = tw.tsq._intermediates
    rows = [int(tw.tsq._intermediates[name].n)]
    for rel in ("R", "S", "R"):
        tw.append(rel, _cols(rng, 40, 90, tuple(rels[rel])))
        rows.append(int(tw.tsq._intermediates[name].n))
    assert rows == sorted(rows) and rows[-1] > rows[0]
    tw.finish()


def test_adversarial_skewed_delta_matches_reference():
    rng = np.random.default_rng(6)
    rels, preds = _linear(rng, 600, 100)
    tw = _Twin(rels, preds)
    tw.append("S", {"b": skewed_keys(rng, 80, 100, 0.9),
                    "c": skewed_keys(rng, 80, 100, 0.9, 2)})
    assert not tw.tsq.delta_rounds[-1].overflowed
    tw.finish()


def test_aliased_relation_refreshes_like_reference():
    """One object bound under two names: the delta rule does not apply and
    both packages fall back to a full refresh."""
    rng = np.random.default_rng(7)
    tw = _Twin({"P": _cols(rng, 300, 60, "ab"), "Q": _cols(rng, 300, 60,
                                                           "ba")},
               [("P.b", "Q.b"), ("Q.a", "P2.a")], aliases={"P2": "P"})
    tw.append("P", _cols(rng, 25, 60, "ab"))
    assert tw.tsq.delta_rounds[-1].replanned
    tw.finish()


def test_drift_replans_like_reference():
    """A ~3% delta keeps the plan; a 4x append re-plans and refreshes."""
    rng = np.random.default_rng(8)
    rels, preds = _linear(rng, 1000, 150)
    tw = _Twin(rels, preds)
    plan0 = tw.tsq._plan
    tw.append("R", _cols(rng, 30, 150, "ab"))
    assert not tw.tsq.delta_rounds[-1].replanned and tw.tsq._plan is plan0
    tw.append("T", _cols(rng, 4000, 150, "ce"))
    assert tw.tsq.delta_rounds[-1].replanned and tw.tsq._plan is not plan0
    tw.finish()


def test_closed_handle_ignores_ingest_and_totals_are_host_ints():
    rng = np.random.default_rng(9)
    rels, preds = _linear(rng, 100, 20)
    t = {k: _pair(v)[1] for k, v in rels.items()}
    sq = JoinSession(m_budget=64).watch(Query(t, preds))
    sq._tuples += 2**40
    snap = sq.snapshot()
    assert np.asarray(snap.tuples_read).dtype == np.int64
    assert int(snap.tuples_read) > 2**40
    assert all(type(v) is int for v in (sq._count, sq._tuples, sq._rounds))
    sq.close()
    before = len(sq.delta_rounds)
    t["R"].append(a=np.arange(5, dtype=np.int32),
                  b=np.arange(5, dtype=np.int32))
    assert len(sq.delta_rounds) == before


def test_out_of_band_change_reanchors_snapshot():
    """An append made while the handle's observer is off (closed and
    re-registered by hand) leaves the versions stale: ``snapshot``
    refreshes exactly, as the reference's does."""
    rng = np.random.default_rng(10)
    rels, preds = _linear(rng, 200, 40)
    tw = _Twin(rels, preds)
    for sq, rel in ((tw.jsq, tw.j["S"]), (tw.tsq, tw.t["S"])):
        rel.remove_on_append(sq._on_append)
    batch = _cols(rng, 20, 40, "bc")
    tw.j["S"].append(batch)
    tw.t["S"].append(**batch)
    tw.finish()


# --------------------------------------------------------------------------
# join_count and the exports
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_a,n_b,d,seed", [
    (1, 1, 1, 0), (200, 200, 100, 1), (37, 150, 3, 2), (120, 9, 40, 3),
    (200, 1, 1, 4), (64, 64, 64, 5)])
def test_join_count_matches_reference(n_a, n_b, d, seed):
    rng = np.random.default_rng(seed)
    a, b = {"b": rng.integers(0, d, n_a).astype(np.int32)}, \
        {"b": rng.integers(0, d, n_b).astype(np.int32)}
    ja, ta = _pair(a, n_a + seed % 5)
    jb, tb = _pair(b)
    want = jbinary.join_count(ja, "b", jb, "b")
    got = binary_join.join_count(ta, "b", tb, "b")
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want) == oracle_pair_count(a["b"], b["b"])


def test_join_count_wraps_int32_like_reference():
    n = 50_000                                  # n^2 = 2.5e9 > 2^31
    keys = {"b": np.full(n, 7, np.int32)}
    ja, ta = _pair(keys)
    want = int(jbinary.join_count(ja, "b", ja, "b"))
    got = int(binary_join.join_count(ta, "b", ta, "b"))
    assert got == want == int(np.int64(n * n).astype(np.int32)) < 0


def test_core_exports_the_reference_surface():
    import repro.core as jcore
    import repro_torch.core as core
    names = ["join_count", "Binding", "Classification", "QueryError",
             "QueryGraphError", "QuerySchemaError", "StandingQuery",
             "DeltaRecord"]
    for name in names:
        assert hasattr(core, name) and hasattr(jcore, name), name
    assert core.StandingQuery is streaming.StandingQuery
    assert issubclass(core.QuerySchemaError, core.QueryError)
    assert issubclass(core.QueryGraphError, core.QueryError)
