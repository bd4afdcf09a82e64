"""Port vs JAX package: ``JoinSession.execute`` end to end.

The same seeded numpy relations go through both packages' sessions:
3-relation linear, star and cyclic queries under ``strategy`` None /
"3way" / "cascade" and with ``per_r`` (the 4-way chain and 5-way star
cases are in ``test_torch_session_nway.py``, so the two halves run on
separate test workers).
Count, rounds, tuples_read, kind, strategy, the ``plan.describe()`` lines
and the plan-cache behaviour must all be equal (tolerance: none — every
output is an integer, a flag or a string).
"""

import numpy as np
import pytest
import torch

from repro.core import binary_join as jbinary
from repro.core.query import Query as JQuery
from repro.core.relation import Relation as JRelation
from repro.core.session import JoinSession as JSession
from repro_torch.convert import relation_from_numpy
from repro_torch.core import binary_join
from repro_torch.core.query import Query
from repro_torch.core.session import JoinSession

M_BUDGET = 256


def _rel_data(rng, n, cols, d, hot=False):
    data = {c: rng.integers(0, d, n).astype(np.int32) for c in cols}
    if hot:
        for c in cols:
            data[c][rng.random(n) < 0.15] = 4
    return data


def _queries():
    # two relation sizes only (512 and 128 rows), so the reference compiles
    # each of its eager ops for few shapes
    rng = np.random.default_rng(2024)
    lin = {"f1": _rel_data(rng, 512, ("src", "dst"), 70),
           "f2": _rel_data(rng, 512, ("src", "dst"), 70),
           "f3": _rel_data(rng, 512, ("src", "dst"), 70)}
    lin_preds = [("f1.dst", "f2.src"), ("f2.dst", "f3.src")]
    star = {"r": _rel_data(rng, 128, ("a", "b"), 40),
            "s": _rel_data(rng, 512, ("b", "c"), 40, hot=True),
            "t": _rel_data(rng, 128, ("c", "d"), 40)}
    star_preds = [("r.b", "s.b"), ("s.c", "t.c")]
    cyc = {"x": _rel_data(rng, 512, ("a", "b"), 30),
           "y": _rel_data(rng, 512, ("b", "c"), 30),
           "z": _rel_data(rng, 512, ("c", "a"), 30)}
    cyc_preds = [("x.b", "y.b"), ("y.c", "z.c"), ("z.a", "x.a")]
    chain = {f"r{i + 1}": _rel_data(rng, 512, (k1, k2), 60)
             for i, (k1, k2) in enumerate(["ab", "bc", "cd", "de"])}
    chain_preds = [("r1.b", "r2.b"), ("r2.c", "r3.c"), ("r3.d", "r4.d")]
    star5 = {"fact": _rel_data(rng, 512, ("k1", "k2", "k3", "k4"), 30),
             **{f"d{i}": _rel_data(rng, 128, (f"k{i}", "v"), 30)
                for i in range(1, 5)}}
    star5_preds = [(f"fact.k{i}", f"d{i}.k{i}") for i in range(1, 5)]
    return {"linear": (lin, lin_preds), "star": (star, star_preds),
            "cyclic": (cyc, cyc_preds), "chain4": (chain, chain_preds),
            "star5": (star5, star5_preds)}


QUERIES = _queries()


def _build(name):
    data, preds = QUERIES[name]
    jq = JQuery({k: JRelation.from_arrays(**v) for k, v in data.items()},
                preds)
    tq = Query({k: relation_from_numpy(v, device="cpu")
                for k, v in data.items()}, preds)
    return jq, tq


def _assert_same(jres, tres):
    assert int(tres.count) == int(jres.count)
    assert tres.rounds == jres.rounds
    assert int(tres.tuples_read) == int(jres.tuples_read)
    assert tres.kind == jres.kind
    assert tres.strategy == jres.strategy
    assert bool(tres.overflowed) is False and bool(jres.overflowed) is False
    assert tres.plan.describe().splitlines() == \
        jres.plan.describe().splitlines()


def check_execute(name, strategy):
    jq, tq = _build(name)
    jsess, tsess = JSession(m_budget=M_BUDGET), JoinSession(m_budget=M_BUDGET)
    if name == "cyclic" and strategy == "cascade":
        with pytest.raises(ValueError) as je:
            jsess.execute(jq, strategy=strategy)
        with pytest.raises(ValueError) as te:
            tsess.execute(tq, strategy=strategy)
        assert str(te.value) == str(je.value)
        return
    _assert_same(jsess.execute(jq, strategy=strategy),
                 tsess.execute(tq, strategy=strategy))
    # a second execute is a plan-cache hit in both, with the same answer
    jres, tres = (jsess.execute(jq, strategy=strategy),
                  tsess.execute(tq, strategy=strategy))
    assert tres.cache_hit and jres.cache_hit
    _assert_same(jres, tres)
    assert tsess.cache_info == jsess.cache_info


def check_per_r(name):
    jq, tq = _build(name)
    kw = dict(per_r=True, key_col="src" if name == "linear" else "a")
    jres = JSession(m_budget=M_BUDGET).execute(jq, **kw)
    tres = JoinSession(m_budget=M_BUDGET).execute(tq, **kw)
    _assert_same(jres, tres)
    jp, tp = jres.per_r, tres.per_r
    assert int(tp.count) == int(jp.count)
    np.testing.assert_array_equal(tp.keys.numpy(), np.asarray(jp.keys))
    np.testing.assert_array_equal(tp.counts.numpy(), np.asarray(jp.counts))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))


@pytest.mark.parametrize("name", ["linear", "star", "cyclic"])
@pytest.mark.parametrize("strategy", [None, "3way", "cascade"])
def test_execute_matches_reference(name, strategy):
    check_execute(name, strategy)


def test_per_r_matches_reference():
    check_per_r("linear")


def test_execute_many_shares_the_cache():
    jq, tq = _build("linear")
    jsess, tsess = JSession(m_budget=M_BUDGET), JoinSession(m_budget=M_BUDGET)
    jres = jsess.execute_many([jq, jq, jq])
    tres = tsess.execute_many([tq, tq, tq])
    assert [r.cache_hit for r in tres] == [r.cache_hit for r in jres]
    assert [int(r.count) for r in tres] == [int(r.count) for r in jres]
    assert tsess.cache_info == jsess.cache_info


def test_exact_join_count_past_int32():
    """A product above 2^31 is exact in both (int64 sum vs two limbs)."""
    n = 50_000
    keys = np.full(n, 7, np.int32)
    other = np.arange(n, dtype=np.int32)
    jb = JRelation.from_arrays(k=keys, v=other)
    tb = relation_from_numpy({"k": keys, "v": other}, device="cpu")
    want = jbinary.exact_join_count(jb, "k", jb, "k")
    got = binary_join.exact_join_count(tb, "k", tb, "k")
    assert got == want == n * n > 2**31


def test_results_live_on_the_relations_device():
    _, tq = _build("linear")
    res = JoinSession(m_budget=M_BUDGET).execute(tq, per_r=True,
                                                 key_col="src")
    assert res.per_r.counts.device == torch.device("cpu")


def test_calibration_files_are_the_ports_own(tmp_path, monkeypatch):
    """``refresh_calibration`` writes the port's ``CALIBRATION_torch.json``
    (never the JAX package's ``CALIBRATION_engine.json``), reads the JAX
    package's bench report only when its path is passed, and derives the
    same scales as the reference; ``calibration_from_file`` reads the
    port's file by default, and a missing report gives the identity."""
    import pathlib
    import shutil

    from repro.perfmodel import calibrate as jcal
    from repro_torch import perfmodel
    from repro_torch.perfmodel import calibrate

    bench = pathlib.Path(__file__).resolve().parents[1] / "BENCH_engine.json"
    monkeypatch.chdir(tmp_path)
    assert calibrate.BENCH_FILE == "BENCH_torch.json"
    assert calibrate.CALIBRATION_FILE == "CALIBRATION_torch.json"
    # no report of the port's own here: identity, and no reference file
    sess = JoinSession(m_budget=M_BUDGET)
    assert sess.refresh_calibration() == perfmodel.IDENTITY
    assert not (tmp_path / "CALIBRATION_engine.json").exists()

    shutil.copy(bench, tmp_path / "engine_report.json")
    cal = sess.refresh_calibration(tmp_path / "engine_report.json")
    assert (tmp_path / "CALIBRATION_torch.json").exists()
    assert not (tmp_path / "CALIBRATION_engine.json").exists()
    assert sess.calibration == cal and cal != perfmodel.IDENTITY
    want = jcal.calibration_from_bench(str(tmp_path / "engine_report.json"))
    assert (cal.fused3_scale, cal.cascade_scale, cal.source) == \
        (want.fused3_scale, want.cascade_scale, want.source)
    assert perfmodel.calibration_from_file() == cal
    # the reference's file name is read only when passed
    (tmp_path / "CALIBRATION_engine.json").write_text(
        '{"fused3_scale": 3.0, "cascade_scale": 5.0}')
    assert perfmodel.calibration_from_file() == cal
    assert perfmodel.calibration_from_file(
        "CALIBRATION_engine.json").fused3_scale == 3.0
