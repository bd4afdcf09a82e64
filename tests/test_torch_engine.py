"""Port vs JAX package: the recovery-wrapped fused engine.

Both packages get the same seeded numpy relations.  Count, recovery rounds,
tuples_read and ``overflowed`` are integers or flags, so every comparison
is exact equality (tolerance: none).
"""

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import linear3 as jlinear3
from repro.core.relation import Relation as JRelation
from repro_torch.convert import relation_from_numpy
from repro_torch.core import engine, linear3

N = {"r": 700, "s": 700, "t": 700}
COLS = {"linear": (("a", "b"), ("b", "c"), ("c", "d")),
        "cyclic": (("a", "b"), ("b", "c"), ("c", "a")),
        "star": (("a", "b"), ("b", "c"), ("c", "d"))}


def _data(kind, hot, seed):
    rng = np.random.default_rng(seed)
    sizes = dict(N, s=3200) if kind == "star" else N
    d = 90
    out = []
    for role, cols in zip("rst", COLS[kind]):
        n = sizes[role]
        data = {c: rng.integers(0, d, n).astype(np.int32) for c in cols}
        if hot:
            # one heavy key owns a fifth of every join column: no salt can
            # spread it, so recovery needs the exact-sized final round
            for c in cols:
                data[c][rng.random(n) < 0.2] = 5
        out.append(data)
    return out


# small PMU grids keep uniform buckets from overflowing at these sizes, so
# uniform data takes one round and the heavy key forces recovery rounds
PLAN_KW = {"linear": dict(u=8), "cyclic": dict(uh=2, ug=2), "star": {}}
SEEDS = {("linear", False): 1, ("linear", True): 2, ("cyclic", False): 3,
         ("cyclic", True): 4, ("star", False): 5, ("star", True): 6}


def _both(kind, hot, seed, m_budget=256):
    data = _data(kind, hot, seed)
    jr = [JRelation.from_arrays(capacity=len(next(iter(x.values()))) + 9,
                                **x) for x in data]
    tr = [relation_from_numpy(x, capacity=len(next(iter(x.values()))) + 9,
                              device="cpu") for x in data]
    eng = engine.MultiwayJoinEngine(kind)
    plan = eng.default_plan(*(int(x.n) for x in tr), m_budget=m_budget,
                            **PLAN_KW[kind])
    jeng = jengine.MultiwayJoinEngine(kind)
    jplan = jeng.default_plan(*(int(x.n) for x in jr), m_budget=m_budget,
                              **PLAN_KW[kind])
    assert tuple(plan) == tuple(jplan)
    return jeng.count(*jr, jplan), eng.count(*tr, plan)


@pytest.mark.parametrize("kind", ["linear", "cyclic", "star"])
@pytest.mark.parametrize("hot", [False, True])
def test_engine_count_matches_reference(kind, hot):
    jres, tres = _both(kind, hot, SEEDS[kind, hot])
    assert int(tres.count) == int(jres.count)
    assert tres.rounds == jres.rounds
    assert int(tres.tuples_read) == int(jres.tuples_read)
    assert bool(tres.overflowed) is False and bool(jres.overflowed) is False
    assert tres.rounds >= 2 if hot else tres.rounds == 1


def test_per_r_counts_match_reference():
    data = _data("linear", True, seed=3)
    jr = [JRelation.from_arrays(**x) for x in data]
    tr = [relation_from_numpy(x, device="cpu") for x in data]
    jplan = jlinear3.default_plan(700, 700, 700, m_budget=256, u=8)
    tplan = linear3.default_plan(700, 700, 700, m_budget=256, u=8)
    assert tuple(tplan) == tuple(jplan)
    jres = jengine.MultiwayJoinEngine("linear").per_r_counts(*jr, jplan)
    tres = engine.MultiwayJoinEngine("linear").per_r_counts(*tr, tplan)
    assert tres.rounds == jres.rounds >= 2
    assert int(tres.count) == int(jres.count)
    assert int(tres.tuples_read) == int(jres.tuples_read)
    np.testing.assert_array_equal(tres.keys.numpy(), np.asarray(jres.keys))
    np.testing.assert_array_equal(tres.counts.numpy(),
                                  np.asarray(jres.counts))
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))


def test_single_pass_fused_counts_match_reference():
    """The unrecovered ``*_count_fused`` sweeps: count, overflow flag and
    the int64 traffic meter."""
    data = _data("linear", False, seed=9)
    jr = [JRelation.from_arrays(**x) for x in data]
    tr = [relation_from_numpy(x, device="cpu") for x in data]
    plan = linear3.default_plan(700, 700, 700, m_budget=256, u=8)
    jres = jengine.linear3_count_fused(*jr, jlinear3.Linear3Plan(*plan))
    tres = engine.linear3_count_fused(*tr, plan)
    assert int(tres.count) == int(jres.count)
    assert bool(tres.overflowed) == bool(jres.overflowed)
    assert int(tres.tuples_read) == int(jres.tuples_read)


def test_traffic64_is_plain_int64():
    big = torch.tensor(2**31 - 1)
    assert int(engine.traffic64([(1024, big), (1, big)])) == 1025 * (2**31 - 1)
    assert int(engine.traffic64([(1024, big)])) == int(
        jengine.traffic64([(1024, np.int32(2**31 - 1))]))
    with pytest.raises(ValueError, match="out of range"):
        engine.traffic64([(2**31, big)])
