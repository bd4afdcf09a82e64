"""Port vs JAX package: the paper's baselines.

The scan drivers (``linear3_count``, ``linear3_per_r_counts``,
``star3_count``, ``cyclic3_count`` in both forms), their whole-query retry
drivers in ``core.reference``, the cascaded and bucketed binary joins, and
the fused all-pairs cyclic sweep.  Both packages get the same seeded numpy
relations; counts, ``overflowed``, ``tuples_read``, the per-R arrays, the
retries' final plans and the cascade's intermediate totals are integers or
flags, so every comparison is exact equality (tolerance: none).  Sizes
follow ``tests/test_core_joins.py`` (120–500 rows), where the reference's
int32 totals do not wrap; one test holds a total past 2^31 against a numpy
int64 oracle.
"""

import numpy as np
import pytest
import torch

from repro.core import binary_join as jbinary
from repro.core import cyclic3 as jcyclic3
from repro.core import engine as jengine
from repro.core import linear3 as jlinear3
from repro.core import reference as jreference
from repro.core import star3 as jstar3
from repro.core.relation import Relation as JRelation
from repro_torch.convert import relation_from_numpy
from repro_torch.core import (binary_join, cyclic3, engine, linear3,
                              reference, star3)


def _rels(rng, spec, d, zipf=None, cap_extra=3):
    """Both packages' relations from the same numpy columns:
    spec = [(n_rows, column names), ...]."""
    out_j, out_t, raw = [], [], []
    for n, cols in spec:
        if zipf is None:
            data = {c: rng.integers(0, d, n).astype(np.int32) for c in cols}
        else:
            data = {c: (np.minimum(rng.zipf(zipf, n), d) - 1).astype(np.int32)
                    for c in cols}
        out_j.append(JRelation.from_arrays(capacity=n + cap_extra, **data))
        out_t.append(relation_from_numpy(data, capacity=n + cap_extra,
                                         device="cpu"))
        raw.append(data)
    return out_j, out_t, raw


def _same_result(tres, jres):
    assert int(tres.count) == int(jres.count)
    assert bool(tres.overflowed) == bool(jres.overflowed)
    assert int(tres.tuples_read) == int(jres.tuples_read)


LINEAR = [(150, "ab"), (180, "bc"), (160, "cd")]


@pytest.mark.parametrize("seed,d,u", [(0, 20, 4), (1, 60, 8), (2, 7, 2)])
def test_linear3_count_auto_matches_reference(seed, d, u):
    jr, tr, _ = _rels(np.random.default_rng(seed), LINEAR, d)
    plan = linear3.default_plan(150, 180, 160, m_budget=64, u=u)
    jplan = jlinear3.default_plan(150, 180, 160, m_budget=64, u=u)
    assert tuple(plan) == tuple(jplan)
    tres, tfinal = reference.linear3_count_auto(*tr, plan)
    jres, jfinal = jreference.linear3_count_auto(*jr, jplan)
    _same_result(tres, jres)
    assert tuple(tfinal) == tuple(jfinal)


def test_linear3_zipf_skew_auto_recovers_like_reference():
    """Zipf-skewed keys overflow the uniform plan: both drivers retry the
    whole query the same number of times and end on the same plan."""
    rng = np.random.default_rng(1234)
    jr, tr, raw = _rels(rng, [(200, "ab"), (220, "bc"), (210, "cd")], 50,
                        zipf=1.4, cap_extra=0)
    plan = linear3.default_plan(200, 220, 210, m_budget=64, u=4, slack=1.5)
    jplan = jlinear3.Linear3Plan(*plan)
    assert bool(linear3.linear3_count(*tr, plan).overflowed)
    assert bool(jlinear3.linear3_count(*jr, jplan).overflowed)
    tres, tfinal = reference.linear3_count_auto(*tr, plan)
    jres, jfinal = jreference.linear3_count_auto(*jr, jplan)
    _same_result(tres, jres)
    assert tuple(tfinal) == tuple(jfinal) != tuple(plan)
    r, s, t = raw
    wt = np.bincount(t["c"], minlength=50)[s["c"]]
    ws = np.bincount(s["b"], weights=wt, minlength=50).astype(np.int64)
    assert int(tres.count) == int(ws[r["b"]].sum())


def test_linear3_single_pass_flags_overflow_like_reference():
    jr, tr, _ = _rels(np.random.default_rng(5), LINEAR, 9)
    plan = linear3.default_plan(150, 180, 160, m_budget=64, u=4, slack=1.0)
    tres = linear3.linear3_count(*tr, plan)
    jres = jlinear3.linear3_count(*jr, jlinear3.Linear3Plan(*plan))
    _same_result(tres, jres)
    assert bool(tres.overflowed)


@pytest.mark.parametrize("seed", [3, 4])
def test_linear3_per_r_counts_auto_matches_reference(seed):
    jr, tr, _ = _rels(np.random.default_rng(seed),
                      [(100, "ab"), (120, "bc"), (110, "cd")], 40)
    plan = linear3.default_plan(100, 120, 110, m_budget=48, u=4)
    (tk, tc, tv), tfinal = reference.linear3_per_r_counts_auto(*tr, plan)
    (jk, jc, jv), jfinal = jreference.linear3_per_r_counts_auto(
        *jr, jlinear3.Linear3Plan(*plan))
    assert tuple(tfinal) == tuple(jfinal)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tc.dtype == torch.int64


@pytest.mark.parametrize("seed,d,chunks", [(0, 25, 1), (1, 60, 2),
                                           (2, 8, 3)])
def test_star3_count_auto_matches_reference(seed, d, chunks):
    jr, tr, _ = _rels(np.random.default_rng(seed),
                      [(60, "ab"), (400, "bc"), (70, "cd")], d)
    plan = star3.default_plan(60, 400, 70, uh=4, ug=4, chunks=chunks)
    tres, tfinal = reference.star3_count_auto(*tr, plan)
    jres, jfinal = jreference.star3_count_auto(*jr, jstar3.Star3Plan(*plan))
    _same_result(tres, jres)
    assert tuple(tfinal) == tuple(jfinal)


CYCLIC = [(140, "ab"), (150, "bc"), (130, "ca")]


@pytest.mark.parametrize("pair_index", [True, False])
@pytest.mark.parametrize("seed,d,grid", [(0, 12, (2, 2)), (1, 30, (4, 2)),
                                         (2, 6, (1, 1))])
def test_cyclic3_count_auto_matches_reference(seed, d, grid, pair_index):
    jr, tr, _ = _rels(np.random.default_rng(seed), CYCLIC, d)
    plan = cyclic3.default_plan(140, 150, 130, m_budget=64, uh=grid[0],
                                ug=grid[1])
    tres, tfinal = reference.cyclic3_count_auto(*tr, plan,
                                                pair_index=pair_index)
    jres, jfinal = jreference.cyclic3_count_auto(
        *jr, jcyclic3.Cyclic3Plan(*plan), pair_index=pair_index)
    _same_result(tres, jres)
    assert tuple(tfinal) == tuple(jfinal)


def test_cyclic3_single_pass_both_forms_agree_when_overflowing():
    jr, tr, _ = _rels(np.random.default_rng(8), CYCLIC, 5)
    plan = cyclic3.default_plan(140, 150, 130, m_budget=64, uh=2, ug=2,
                                slack=1.0)
    jplan = jcyclic3.Cyclic3Plan(*plan)
    for pair_index in (True, False):
        tres = cyclic3.cyclic3_count(*tr, plan, pair_index=pair_index)
        jres = jcyclic3.cyclic3_count(*jr, jplan, pair_index=pair_index)
        _same_result(tres, jres)
        assert bool(tres.overflowed)


def test_fused_all_pairs_cyclic_matches_reference():
    """``engine.cyclic3_count_fused(pair_index=False)`` and the recovery
    loop's ``CyclicOps(pair_index=False)`` reach the all-pairs op."""
    jr, tr, _ = _rels(np.random.default_rng(11), CYCLIC, 10)
    plan = cyclic3.default_plan(140, 150, 130, m_budget=64, uh=2, ug=2)
    jplan = jcyclic3.Cyclic3Plan(*plan)
    tres = engine.cyclic3_count_fused(*tr, plan, pair_index=False)
    jres = jengine.cyclic3_count_fused(*jr, jplan, pair_index=False)
    _same_result(tres, jres)
    teng = engine.MultiwayJoinEngine("cyclic").count(*tr, plan,
                                                     pair_index=False)
    jeng = jengine.MultiwayJoinEngine("cyclic").count(*jr, jplan,
                                                      pair_index=False)
    assert int(teng.count) == int(jeng.count) == int(tres.count)
    assert teng.rounds == jeng.rounds


@pytest.mark.parametrize("seed,d,cap", [(0, 30, 4000), (1, 8, 4000),
                                        (2, 8, 100)])
def test_cascaded_binary_count_matches_reference(seed, d, cap):
    jr, tr, _ = _rels(np.random.default_rng(seed),
                      [(120, "ab"), (150, "bc"), (130, "cd")], d)
    tres = binary_join.cascaded_binary_count(*tr, cap)
    jres = jbinary.cascaded_binary_count(*jr, cap)
    assert int(tres.intermediate_total) == int(jres.intermediate_total)
    assert bool(tres.intermediate_overflowed) == \
        bool(jres.intermediate_overflowed)
    assert int(tres.count) == int(jres.count)
    assert bool(tres.intermediate_overflowed) == (cap == 100)


def test_cascaded_binary_per_r_counts_matches_reference():
    jr, tr, _ = _rels(np.random.default_rng(6),
                      [(80, "ab"), (90, "bc"), (70, "cd")], 30)
    got = binary_join.cascaded_binary_per_r_counts(*tr)
    want = jbinary.cascaded_binary_per_r_counts(*jr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_buckets,caps", [(8, (160, 100)), (16, (70, 50)),
                                            (4, (8, 8))])
def test_bucketed_join_count_matches_reference(n_buckets, caps):
    jr, tr, _ = _rels(np.random.default_rng(n_buckets),
                      [(500, "b"), (300, "b")], 97)
    tcount, tovf = binary_join.bucketed_join_count(tr[0], "b", tr[1], "b",
                                                   n_buckets, *caps)
    jcount, jovf = jbinary.bucketed_join_count(jr[0], "b", jr[1], "b",
                                               n_buckets, *caps)
    assert int(tcount) == int(jcount)
    assert bool(tovf) == bool(jovf)
    assert bool(tovf) == (caps == (8, 8))


def test_host_join_count_matches_reference_and_device_count():
    jr, tr, _ = _rels(np.random.default_rng(9), [(300, "b"), (250, "b")], 40)
    got = reference.host_join_count(tr[0], "b", tr[1], "b")
    assert got == jreference.host_join_count(jr[0], "b", jr[1], "b")
    assert got == binary_join.exact_join_count(tr[0], "b", tr[1], "b")


def test_retry_drivers_raise_when_overflow_persists():
    _, tr, _ = _rels(np.random.default_rng(2), LINEAR, 3)
    plan = linear3.default_plan(150, 180, 160, m_budget=64, u=4, slack=1.0)
    with pytest.raises(reference.OverflowError_, match="final plan"):
        reference.linear3_count_auto(*tr, plan, max_retries=0)


@pytest.mark.parametrize("driver", ["linear3_count", "star3_count"])
def test_scan_total_past_int32_matches_numpy(driver):
    """Per-bucket counts stay int32 as the kernels return them; the sum over
    buckets and partitions is int64, so a total past 2^31 is exact (the
    reference's int32 scan carry would wrap here)."""
    rng = np.random.default_rng(21)
    n_r, n_t = 5000, 500_000
    r = {"a": np.arange(n_r, dtype=np.int32),
         "b": rng.permutation(n_r).astype(np.int32)}
    s = {"b": np.arange(n_r, dtype=np.int32), "c": np.zeros(n_r, np.int32)}
    t = {"c": np.zeros(n_t, np.int32), "d": np.arange(n_t, dtype=np.int32)}
    want = int(np.int64(n_r) * n_t)
    assert want > 2**31
    rels = [relation_from_numpy(x, device="cpu") for x in (r, s, t)]
    if driver == "linear3_count":
        plan = linear3.default_plan(n_r, n_r, n_t, m_budget=1 << 20)
        res, _ = reference.linear3_count_auto(*rels, plan)
    else:
        plan = star3.default_plan(n_r, n_r, n_t, uh=4, ug=1)
        res, _ = reference.star3_count_auto(*rels, plan)
    assert res.count.dtype == torch.int64
    assert int(res.count) == want
    assert not bool(res.overflowed)
