"""Port vs JAX package: the join service (``launch/join_service.py``).

Admission and backpressure, wave batching over the tenant's shared plan
cache, per-tenant metrics, the watch / ingest / snapshot round trip,
errors set on the futures, the background pump thread, and the CLI
smoke.  The same seeded requests go to both packages' services: the
``rounds`` and ``tuples_read`` histograms, the wave and rejection
counters, the plan-cache counters and every count must be equal (latency
is the one field left out: it is a host clock reading).
"""

import contextlib
import io

import numpy as np
import pytest

from repro.core.query import Query as JQuery
from repro.core.relation import Relation as JRelation
from repro.launch import join_service as jservice
from repro_torch.core.query import Query
from repro_torch.core.relation import Relation
from repro_torch.core.session import JoinSession
from repro_torch.launch import join_service
from repro_torch.launch.join_service import (JoinService, ServiceOverloaded,
                                             _Hist)


def _linear(seed, n=400, d=80):
    """The same linear 3-way query in both packages (CPU)."""
    rng = np.random.default_rng(seed)
    cols = {name: {c: rng.integers(0, d, n).astype(np.int32) for c in cs}
            for name, cs in (("R", "ab"), ("S", "bc"), ("T", "ce"))}
    preds = [("R.b", "S.b"), ("S.c", "T.c")]
    jrels = {k: JRelation.from_arrays(**v) for k, v in cols.items()}
    trels = {k: Relation.from_arrays(device="cpu", **v)
             for k, v in cols.items()}
    return JQuery(jrels, preds), Query(trels, preds)


def _metrics_wo_latency(svc):
    m = svc.metrics()
    for t in m["tenants"].values():
        t.pop("latency_us")
    return m


def test_hist_pow2_buckets_match_reference():
    values = (0, 1, 2, 3, 4, 1000, 2**40 + 1, -5)
    h, jh = _Hist(), jservice._Hist()
    for v in values:
        h.record(v)
        jh.record(v)
    out = h.export()
    assert out == jh.export()
    assert out["count"] == 8 and out["sum"] == 1010 + 2**40 + 1
    assert out["buckets"] == {"0": 2, "2^0": 1, "2^1": 1, "2^2": 2,
                              "2^10": 1, "2^41": 1}


def test_bounded_queue_backpressure():
    _, q = _linear(0, n=120, d=30)
    svc = JoinService(max_queue=2, wave_size=4, m_budget=64)
    svc.submit("a", q)
    svc.submit("a", q)
    with pytest.raises(ServiceOverloaded, match="queue full"):
        svc.submit("a", q)
    assert svc.rejected == 1 and svc.metrics()["queue_depth"] == 2
    assert svc.run_until_idle() == 2
    fut = svc.submit("a", q)
    svc.run_until_idle()
    assert int(fut.result().count) >= 0
    assert svc.metrics()["queue_depth"] == 0


def test_waves_and_metrics_match_reference():
    """Six executes of one query in waves of four, and two tenants: the
    waves, the plan cache and the rounds / tuples_read histograms equal
    the reference service's."""
    jqa, qa = _linear(1, n=200, d=40)
    jqb, qb = _linear(2, n=150, d=30)
    out = []
    for svc_cls, a, b in ((jservice.JoinService, jqa, jqb),
                          (JoinService, qa, qb)):
        svc = svc_cls(max_queue=16, wave_size=4, m_budget=64)
        futs = [svc.submit("alice", a) for _ in range(6)]
        futs.append(svc.submit("bob", b))
        assert svc.run_until_idle() == 7
        out.append(([int(f.result().count) for f in futs],
                    _metrics_wo_latency(svc)))
        lat = svc.metrics()["tenants"]["alice"]["latency_us"]
        assert lat["count"] == 6
    (jcounts, jm), (counts, m) = out
    assert counts == jcounts and len(set(counts[:6])) == 1
    assert m == jm
    assert m["waves"] == 2                       # 4 + 3
    assert m["tenants"]["alice"]["plan_cache"]["hits"] >= 4
    assert set(m["tenants"]) == {"alice", "bob"}


def test_watch_ingest_snapshot_roundtrip_matches_reference():
    jq, q = _linear(3, n=300, d=60)
    rng = np.random.default_rng(4)
    batches = [{"b": rng.integers(0, 60, 20).astype(np.int32),
                "c": rng.integers(0, 60, 20).astype(np.int32)}
               for _ in range(3)]
    out = []
    for svc_cls, query in ((jservice.JoinService, jq),
                           (JoinService, q)):
        svc = svc_cls(max_queue=16, wave_size=4, m_budget=128)
        hf = svc.watch("a", query)
        svc.run_until_idle()
        sq = hf.result()
        for batch in batches:
            fut = svc.ingest("a", query.relations["S"], batch)
            svc.run_until_idle()
            assert fut.result() == 20
            assert not sq.delta_rounds[-1].overflowed
        sf = svc.snapshot("a", sq)
        svc.run_until_idle()
        snap = sf.result()
        out.append((int(snap.count), int(snap.tuples_read), snap.rounds,
                    [(r.count_delta, r.rounds, r.tuples_read)
                     for r in sq.delta_rounds], _metrics_wo_latency(svc)))
        sq.close()
    assert out[1] == out[0]
    assert out[1][0] == int(JoinSession(m_budget=128).execute(q).count)


def test_errors_reach_the_future():
    svc = JoinService(max_queue=4, wave_size=4, m_budget=64)
    rng = np.random.default_rng(5)
    bad = Relation.from_arrays(device="cpu",
                               a=rng.integers(0, 10, 50).astype(np.int32),
                               b=rng.integers(0, 10, 50).astype(np.int32))
    fut = svc.ingest("a", bad, {"wrong": np.arange(3, dtype=np.int32)})
    _, q = _linear(6, n=60, d=10)
    ok = svc.submit("a", q)
    svc.run_until_idle()
    with pytest.raises(ValueError, match="schema"):
        fut.result()
    assert int(ok.result().count) >= 0        # the wave's other request
    assert bad.version == 0


def test_background_thread_start_stop():
    _, q = _linear(7, n=120, d=30)
    svc = JoinService(max_queue=8, wave_size=4, m_budget=64)
    svc.start()
    svc.start()                                # a second start is a no-op
    try:
        thread = svc._thread
        fut = svc.submit("a", q)
        res = fut.result(timeout=300)
        assert not bool(res.overflowed)
    finally:
        svc.stop()
    thread.join(timeout=10)
    assert not thread.is_alive() and svc._thread is None


def test_cli_smoke_prints_the_reference_counts():
    argv = ["--smoke", "--rows", "600", "--distinct", "100", "--deltas",
            "3", "--delta-rows", "32", "--m-budget", "128"]
    outs = []
    for mod, extra in ((jservice, []), (join_service, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(argv + extra)
        text = buf.getvalue()
        assert "smoke OK" in text
        outs.append([ln for ln in text.splitlines()
                     if ln.startswith(("standing", "delta", "final"))])
    assert outs[1] == outs[0] and len(outs[0]) == 5
