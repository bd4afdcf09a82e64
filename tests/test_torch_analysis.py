"""Port vs JAX package: ``analysis/`` (the plan verifier, the integer-width
analysis, the arena sanitizer) and the calibration-file helpers.

``tests/test_analysis.py``'s cases, each run on the port and, where the
JAX package has the same call, on the reference with the same seeded
numpy relations: the planner-emitted plans the verifier accepts (a
property over random 2-6-relation join trees, uniform and skewed, every
strategy, on the port; on fixed seeds the plans' ``describe()`` lines
and width diagnostics are the reference's), the
typed rejections of mutated plans (the same exception class and message
on both), the width hazards and errors (the same diagnostics), the
executor's typed errors and execute-time gate, the sanitizer's shadow
checks (the same messages) and a sanitized execution and ingest, and the
calibration file's round trip.  The invariant lint's rules are the
port's own (``tests/test_torch_lint.py``).  Tolerance: none (plans,
diagnostics and counts are integers and strings; the calibration scales
are the same float64 arithmetic).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import oracle_linear3_count, skewed_keys
from repro.analysis import arena_sanitizer as jsan
from repro.analysis import verify_plan as jverify
from repro.analysis import widths as jwidths
from repro.core import planner as jplanner
from repro.core.cyclic3 import Cyclic3Plan as JCyclic3Plan
from repro.core.linear3 import Linear3Plan as JLinear3Plan
from repro.core.plan_ir import execute_plan as jexecute_plan
from repro.core.query import Query as JQuery
from repro.core.relation import Relation as JRelation
from repro.core.session import JoinSession as JSession
from repro.perfmodel import calibrate as jcalibrate
from repro_torch.analysis import arena_sanitizer
from repro_torch.analysis.arena_sanitizer import (ArenaSanitizerError,
                                                  ArenaShadow)
from repro_torch.analysis.errors import (PlanPerRError, PlanRefcountError,
                                         PlanSchemaError, PlanStructureError,
                                         PlanValidationError, PlanWidthError)
from repro_torch.analysis.verify_plan import verify_plan
from repro_torch.analysis.widths import analyze_widths, check_widths
from repro_torch.convert import relation_from_numpy
from repro_torch.core import planner
from repro_torch.core.cyclic3 import Cyclic3Plan
from repro_torch.core.linear3 import Linear3Plan
from repro_torch.core.plan_ir import execute_plan
from repro_torch.core.query import Query
from repro_torch.core.session import JoinSession
from repro_torch.kernels.ops import EXACT_F32_MAX
from repro_torch.perfmodel import calibrate

# --------------------------------------------------------------------------
# helpers: one numpy layout, both packages' queries and plans
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Both:
    data: dict                 # name -> {column: int32 array}
    preds: list
    tq: Query
    jq: JQuery


def _both(data, preds) -> Both:
    tq = Query({k: relation_from_numpy(v, device="cpu")
                for k, v in data.items()}, preds)
    jq = JQuery({k: JRelation.from_arrays(**v) for k, v in data.items()},
                preds)
    return Both(data, preds, tq, jq)


def _cards(b: Both) -> dict[str, int]:
    return {k: len(next(iter(v.values()))) for k, v in b.data.items()}


def _schemas(b: Both) -> dict[str, frozenset]:
    return {k: frozenset(v) for k, v in b.data.items()}


def _plans(b: Both, **kw):
    """(port plan, reference plan) under the same arguments; their
    ``describe()`` lines are equal."""
    tp = planner.plan_query(b.tq, _cards(b), m_budget=64, **kw)
    jp = jplanner.plan_query(b.jq, _cards(b), m_budget=64, **kw)
    assert tp.describe() == jp.describe()
    return tp, jp


def _rel(rng, n, cols, d):
    return {c: rng.integers(0, d, n).astype(np.int32) for c in cols}


def _linear_chain(seed=1234, n=120, d=25) -> Both:
    rng = np.random.default_rng(seed)
    return _both({"r": _rel(rng, n, "ab", d), "s": _rel(rng, n + 30, "bc", d),
                  "t": _rel(rng, n + 10, "cd", d)},
                 [("r.b", "s.b"), ("s.c", "t.c")])


def _triangle(seed=1234, n=120, d=25) -> Both:
    rng = np.random.default_rng(seed)
    return _both({"r": _rel(rng, n, "ab", d), "s": _rel(rng, n + 20, "bc", d),
                  "t": _rel(rng, n + 10, "ca", d)},
                 [("r.b", "s.b"), ("s.c", "t.c"), ("t.a", "r.a")])


def _random_tree(seed: int, n_rel: int, skew: bool) -> Both:
    """``test_analysis._random_tree_query``'s join trees: relation i joins
    an earlier one on a shared column ``k<i>``; each carries a payload."""
    rng = np.random.default_rng(seed)
    parents = {i: int(rng.integers(1, i)) for i in range(2, n_rel + 1)}
    cols: dict[int, set[str]] = {i: {f"p{i}"} for i in range(1, n_rel + 1)}
    for i, p in parents.items():
        cols[i].add(f"k{i}")
        cols[p].add(f"k{i}")
    data = {}
    for i in range(1, n_rel + 1):
        n = int(rng.integers(40, 200))
        d = int(rng.integers(8, 40))
        data[f"r{i}"] = {
            c: (skewed_keys(rng, n, d, 0.4) if skew and c == f"k{i}"
                else rng.integers(0, d, size=n).astype(np.int32))
            for c in sorted(cols[i])}
    return _both(data, [(f"r{i}.k{i}", f"r{p}.k{i}")
                        for i, p in sorted(parents.items())])


def _same_raise(exc_type, port_call, ref_call, match=None):
    """Both calls raise the typed error of the same name and message."""
    with pytest.raises(exc_type, match=match) as got:
        port_call()
    with pytest.raises(Exception) as want:
        ref_call()
    assert type(want.value).__name__ == exc_type.__name__
    assert str(got.value) == str(want.value)
    return got.value


def _replace_root(plan, **kw):
    return dataclasses.replace(
        plan, steps=plan.steps[:-1] + (dataclasses.replace(plan.steps[-1],
                                                           **kw),))


def _diags(diags):
    return [dataclasses.astuple(d) for d in diags]


# --------------------------------------------------------------------------
# verifier: every planner-emitted plan passes (property)
# --------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       n_rel=st.integers(min_value=2, max_value=6),
       skew=st.booleans(),
       strategy=st.sampled_from(["default", "3way", "cascade"]))
def test_verifier_accepts_planner_plans(seed, n_rel, skew, strategy):
    b = _random_tree(seed, n_rel, skew)
    if n_rel == 2 and strategy == "3way":
        strategy = "default"
    tp = planner.plan_query(b.tq, _cards(b), m_budget=64,
                            strategy=None if strategy == "default"
                            else strategy)
    verify_plan(tp, schemas=_schemas(b))       # plan-time mode
    verify_plan(tp, external=set(_cards(b)))   # execute-time mode
    for diag in check_widths(tp, _cards(b)):
        assert diag.severity == "hazard"


@pytest.mark.parametrize("seed,n_rel,skew,strategy", [
    (3, 4, True, None), (11, 3, False, "cascade"), (5, 4, False, "3way")])
def test_planner_plans_and_widths_match_reference(seed, n_rel, skew,
                                                  strategy):
    """The property's join trees on fixed seeds (the reference's planner
    compiles per shape, ~5 s a query): the same plan, accepted by both
    verifiers, with the same width diagnostics."""
    b = _random_tree(seed, n_rel, skew)
    tp, jp = _plans(b, strategy=strategy)
    verify_plan(tp, schemas=_schemas(b))
    jverify.verify_plan(jp, schemas=_schemas(b))
    assert _diags(check_widths(tp, _cards(b))) == _diags(
        jwidths.check_widths(jp, _cards(b)))


def test_verifier_accepts_per_r_plan():
    b = _linear_chain()
    r_name = dict(b.tq.classify(_cards(b)).roles)["r"]
    tp, jp = _plans(b, strategy="3way", per_r_name=r_name)
    assert any(s.per_r_key is not None for s in tp.steps)
    verify_plan(tp, schemas=_schemas(b))
    jverify.verify_plan(jp, schemas=_schemas(b))


def test_verifier_accepts_triangle_plan():
    b = _triangle()
    tp, _ = _plans(b, strategy="3way")
    assert tp.steps[-1].kind == "cyclic"
    verify_plan(tp, schemas=_schemas(b))


# --------------------------------------------------------------------------
# verifier: mutations raise the matching typed diagnostic, as in repro
# --------------------------------------------------------------------------

@pytest.fixture
def lin_cascade():
    b = _linear_chain()
    tp, jp = _plans(b, strategy="cascade")
    assert len(tp.steps) == 2 and tp.steps[0].op == "binary"
    return b, tp, jp


@pytest.fixture
def lin_fused():
    b = _linear_chain()
    tp, jp = _plans(b, strategy="3way")
    assert len(tp.steps) == 1 and tp.steps[0].op == "fused3"
    return b, tp, jp


def _reject(exc_type, b, mutate, tp, jp, match=None):
    return _same_raise(
        exc_type,
        lambda: verify_plan(mutate(tp), schemas=_schemas(b)),
        lambda: jverify.verify_plan(mutate(jp), schemas=_schemas(b)),
        match)


def _reversed(plan):
    return dataclasses.replace(plan, steps=tuple(reversed(plan.steps)))


def test_verifier_rejects_reversed_steps(lin_cascade):
    _reject(PlanStructureError, *lin_cascade[:1], _reversed,
            *lin_cascade[1:])


def test_verifier_rejects_duplicate_out():
    rng = np.random.default_rng(7)
    b = _both({f"r{i + 1}": _rel(rng, 80, cols, 20)
               for i, cols in enumerate(("ab", "bc", "cd", "de"))},
              [("r1.b", "r2.b"), ("r2.c", "r3.c"), ("r3.d", "r4.d")])
    tp, jp = _plans(b, strategy="cascade")
    assert len(tp.steps) == 3

    def dup(plan):
        steps = list(plan.steps)
        steps[1] = dataclasses.replace(steps[1], out=steps[0].out)
        return dataclasses.replace(plan, steps=tuple(steps))

    _reject(PlanStructureError, b, dup, tp, jp)


def test_verifier_rejects_bad_column_binding(lin_fused):
    def bad(plan):
        root = plan.steps[0]
        cols = tuple((k, "zz" if k == "rb" else v) for k, v in root.cols)
        return _replace_root(plan, cols=cols)

    b, tp, jp = lin_fused
    _reject(PlanSchemaError, b, bad, tp, jp)


def test_verifier_rejects_bad_projection_source(lin_cascade):
    def bad(plan):
        step0 = plan.steps[0]
        assert step0.project
        proj_a = tuple(("zz", dst) for _src, dst in step0.project[0])
        bad0 = dataclasses.replace(step0,
                                   project=(proj_a,) + step0.project[1:])
        return dataclasses.replace(plan, steps=(bad0,) + plan.steps[1:])

    b, tp, jp = lin_cascade
    _reject(PlanSchemaError, b, bad, tp, jp)


def test_verifier_rejects_unconsumed_intermediate(lin_cascade, lin_fused):
    b, tc, jc = lin_cascade
    _, tf, jf = lin_fused
    _same_raise(
        PlanRefcountError,
        lambda: verify_plan(dataclasses.replace(
            tc, steps=(tc.steps[0], tf.steps[0])), schemas=_schemas(b)),
        lambda: jverify.verify_plan(dataclasses.replace(
            jc, steps=(jc.steps[0], jf.steps[0])), schemas=_schemas(b)))


def test_verifier_rejects_per_r_on_cyclic():
    b = _triangle()
    tp, jp = _plans(b, strategy="3way")
    _reject(PlanPerRError, b, lambda p: _replace_root(p, per_r_key="a"),
            tp, jp)


def test_verifier_rejects_unrecovered_fused(lin_fused):
    b, tp, jp = lin_fused
    _reject(PlanStructureError, b,
            lambda p: _replace_root(p, recovery=False), tp, jp)


def test_verifier_rejects_orphan_relation(lin_fused):
    b, tp, jp = lin_fused
    schemas = dict(_schemas(b), zzz=frozenset({"a"}))
    _same_raise(PlanStructureError,
                lambda: verify_plan(tp, schemas=schemas),
                lambda: jverify.verify_plan(jp, schemas=schemas),
                match="orphan")


def test_verifier_error_names_failing_step(lin_cascade):
    b, tp, jp = lin_cascade
    exc = _reject(PlanStructureError, b, _reversed, tp, jp)
    assert "at step[" in str(exc) and "<-" in str(exc)


# --------------------------------------------------------------------------
# width analysis: the two seeded regressions + clean plans
# --------------------------------------------------------------------------

def test_widths_composite_id_overflow_is_plan_time_error():
    """A cyclic shape whose role-r composite-id space (2^34) cannot be
    hashed in int32 is refused at plan time, with the reference's
    diagnostics."""
    b = _triangle()
    tp, jp = _plans(b, strategy="3way")
    dims = dict(h_parts=2**13, g_parts=2**13, uh=16, ug=16, f_parts=2,
                r_cap=8, s_cap=8, t_cap=8)
    exc = _same_raise(
        PlanWidthError,
        lambda: check_widths(_replace_root(
            tp, shape_plan=Cyclic3Plan(**dims)), _cards(b)),
        lambda: jwidths.check_widths(_replace_root(
            jp, shape_plan=JCyclic3Plan(**dims)), _cards(b)))
    errors = [d for d in exc.diagnostics if d.severity == "error"]
    assert any("composite-id" in d.quantity for d in errors)
    assert all(d.width_needed.startswith("int3") for d in errors)


def test_widths_f32_accumulator_ceiling_is_hazard():
    """A linear shape whose per-cell accumulator ceiling crosses 2^24 is a
    hazard, not an error, on both."""
    b = _linear_chain()
    tp, jp = _plans(b, strategy="3way")
    dims = dict(h_parts=4, u=8, g_parts=64, r_cap=64, s_cap=64, t_cap=72)
    assert 64 * 64 * 64 * 72 > EXACT_F32_MAX
    diags = check_widths(_replace_root(tp, shape_plan=Linear3Plan(**dims)),
                         _cards(b))
    want = jwidths.check_widths(
        _replace_root(jp, shape_plan=JLinear3Plan(**dims)), _cards(b))
    assert _diags(diags) == _diags(want)
    hz = [d for d in diags if d.quantity == "accumulator cell ceiling"]
    assert len(hz) == 1 and hz[0].severity == "hazard"
    assert hz[0].limit == EXACT_F32_MAX
    assert hz[0].bound == 64 * 64 * 64 * 72


def test_widths_materialize_overflow_is_error(lin_cascade):
    b, tp, jp = lin_cascade

    def big(plan):
        return dataclasses.replace(plan, steps=(dataclasses.replace(
            plan.steps[0], est_out=2**31),) + plan.steps[1:])

    _same_raise(PlanWidthError,
                lambda: check_widths(big(tp), _cards(b)),
                lambda: jwidths.check_widths(big(jp), _cards(b)),
                match="materialized rows")


def test_widths_input_cardinality_overflow_is_error(lin_fused):
    b, tp, jp = lin_fused
    cards = dict(_cards(b), r=2**31)
    _same_raise(PlanWidthError, lambda: check_widths(tp, cards),
                lambda: jwidths.check_widths(jp, cards),
                match="input cardinality")


def test_widths_clean_plan_has_no_errors(lin_cascade, lin_fused):
    for b, tp, jp in (lin_cascade, lin_fused):
        diags = analyze_widths(tp, _cards(b))
        assert all(d.severity == "hazard" for d in diags)
        assert _diags(diags) == _diags(jwidths.analyze_widths(jp, _cards(b)))


# --------------------------------------------------------------------------
# executor: typed errors, execute-time verification gate
# --------------------------------------------------------------------------

def test_plan_errors_subclass_value_error():
    for exc_type in (PlanStructureError, PlanSchemaError,
                     PlanRefcountError, PlanPerRError, PlanWidthError):
        assert issubclass(exc_type, PlanValidationError)
        assert issubclass(exc_type, ValueError)


def test_executor_unknown_op_is_typed(lin_cascade):
    b, tp, jp = lin_cascade

    def scan(plan):
        return dataclasses.replace(plan, steps=(dataclasses.replace(
            plan.steps[0], op="scan"),) + plan.steps[1:])

    _same_raise(PlanStructureError,
                lambda: execute_plan(scan(tp), dict(b.tq.relations)),
                lambda: jexecute_plan(scan(jp), dict(b.jq.relations)))


def test_executor_per_r_on_cyclic_is_typed():
    b = _triangle()
    tp, jp = _plans(b, strategy="3way")
    _same_raise(PlanPerRError,
                lambda: execute_plan(_replace_root(tp, per_r_key="a"),
                                     dict(b.tq.relations)),
                lambda: jexecute_plan(_replace_root(jp, per_r_key="a"),
                                      dict(b.jq.relations)))


def test_execute_time_verification_gate(monkeypatch, lin_cascade):
    b, tp, jp = lin_cascade
    monkeypatch.setenv("REPRO_VERIFY_PLANS", "1")
    _same_raise(PlanStructureError,
                lambda: execute_plan(_reversed(tp), dict(b.tq.relations)),
                lambda: jexecute_plan(_reversed(jp), dict(b.jq.relations)))


# --------------------------------------------------------------------------
# arena sanitizer
# --------------------------------------------------------------------------

def _shadows(lin, keep):
    b, tp, jp = lin
    return (ArenaShadow(tp, b.tq.relations, keep_intermediates=keep),
            jsan.ArenaShadow(jp, b.jq.relations, keep_intermediates=keep),
            tp.steps[0].out)


def _same_shadow_raise(port, ref, event, *args, match=None):
    _same_raise(ArenaSanitizerError, lambda: getattr(port, event)(*args),
                lambda: getattr(ref, event)(*args), match)


def test_sanitizer_shadow_clean_walk(lin_cascade):
    for shadow in _shadows(lin_cascade, False)[:2]:
        inter = lin_cascade[1].steps[0].out
        shadow.on_produce(inter)
        for name in ("r", "s", inter, "t"):
            shadow.on_release(name)
        shadow.on_drop(inter)
        shadow.finish({})


def test_sanitizer_shadow_double_release(lin_cascade):
    port, ref, _ = _shadows(lin_cascade, False)
    port.on_release("r")
    ref.on_release("r")
    _same_shadow_raise(port, ref, "on_release", "r", match="double release")
    _same_shadow_raise(port, ref, "on_release", "%i9", match="no step")


def test_sanitizer_shadow_drop_before_last_consumer(lin_cascade):
    port, ref, inter = _shadows(lin_cascade, False)
    port.on_produce(inter)
    ref.on_produce(inter)
    _same_shadow_raise(port, ref, "on_drop", inter, match="consumer")


def test_sanitizer_shadow_leak_and_lost_consumer(lin_cascade):
    port, ref, inter = _shadows(lin_cascade, False)
    for s in (port, ref):
        s.on_produce(inter)
    _same_shadow_raise(port, ref, "finish", {}, match="unconsumed")
    for s in (port, ref):
        for name in ("r", "s", inter, "t"):
            s.on_release(name)
    _same_shadow_raise(port, ref, "finish", {inter: object()},
                       match="leaked")


def test_sanitizer_shadow_produce_twice_and_keep_drop(lin_cascade):
    port, ref, inter = _shadows(lin_cascade, True)
    for s in (port, ref):
        s.on_produce(inter)
    _same_shadow_raise(port, ref, "on_produce", inter, match="produced twice")
    for s in (port, ref):
        for name in ("r", "s", inter, "t"):
            s.on_release(name)
    _same_shadow_raise(port, ref, "on_drop", inter,
                       match="keep_intermediates")


def test_sanitizer_activation_toggle(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE_ARENA", "0")
    assert not arena_sanitizer.active()
    with arena_sanitizer.enabled():
        assert arena_sanitizer.active()
    assert not arena_sanitizer.active()
    monkeypatch.setenv("REPRO_SANITIZE_ARENA", "1")
    assert arena_sanitizer.active()


def test_sanitizer_check_residents(monkeypatch, lin_cascade):
    _, tp, jp = lin_cascade
    inter = tp.steps[0].out
    with arena_sanitizer.enabled(), jsan.enabled():
        arena_sanitizer.check_residents(tp, {inter: object()})
        _same_raise(ArenaSanitizerError,
                    lambda: arena_sanitizer.check_residents(tp, {}),
                    lambda: jsan.check_residents(jp, {}), match="missing")
        extra = {inter: object(), "%i9": object()}
        _same_raise(ArenaSanitizerError,
                    lambda: arena_sanitizer.check_residents(tp, extra),
                    lambda: jsan.check_residents(jp, extra),
                    match="unexpected")
    # inactive -> no-op even on divergent residents
    monkeypatch.setenv("REPRO_SANITIZE_ARENA", "0")
    arena_sanitizer.check_residents(tp, {})


def test_sanitizer_clean_execution():
    b = _linear_chain()
    d = b.data
    want = oracle_linear3_count(d["r"]["b"], d["s"]["b"], d["s"]["c"],
                                d["t"]["c"])
    with arena_sanitizer.enabled():
        sess = JoinSession(m_budget=128)
        assert int(sess.execute(b.tq, strategy="cascade").count) == want
        assert int(sess.execute(b.tq, strategy="3way").count) == want
    assert int(JSession(m_budget=128).execute(b.jq).count) == want


def test_sanitizer_streaming_ingest():
    b = _linear_chain()
    rng = np.random.default_rng(9)
    with arena_sanitizer.enabled():
        sess = JoinSession(m_budget=128)
        sq = sess.watch(b.tq)
        rel = b.tq.relations["s"]
        for _ in range(2):
            rel.append(**{c: rng.integers(0, 25, 40).astype(np.int32)
                          for c in rel.columns})
        want = int(JoinSession(m_budget=128).execute(b.tq).count)
        assert sq.count == want
        sq.close()


# --------------------------------------------------------------------------
# calibration persistence
# --------------------------------------------------------------------------

def _bench_record():
    return {"shapes": {"cascade_4way": {
        "fused_root_s": 2.0, "binary_tail_s": 1.0,
        "model_t3_s": 0.5, "model_tc_s": 0.25}}}


def test_calibration_file_roundtrip(tmp_path):
    out = tmp_path / "cal.json"
    cal = calibrate.refresh_calibration_file(_bench_record(), out)
    want = jcalibrate.refresh_calibration_file(_bench_record(),
                                               tmp_path / "ref.json")
    assert cal.fused3_scale == pytest.approx(4.0) == want.fused3_scale
    assert cal.cascade_scale == pytest.approx(4.0) == want.cascade_scale
    loaded = calibrate.calibration_from_file(out)
    assert loaded.fused3_scale == cal.fused3_scale
    assert loaded.cascade_scale == cal.cascade_scale
    assert loaded.source == "bench:cascade_4way" == want.source
    # each package reads the other's file
    assert json.loads(out.read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())


def test_calibration_file_never_guesses(tmp_path):
    assert calibrate.calibration_from_file(tmp_path / "nope.json") \
        == calibrate.IDENTITY
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert calibrate.calibration_from_file(bad) == calibrate.IDENTITY
    out = tmp_path / "cal.json"
    calibrate.refresh_calibration_file({"shapes": {}}, out)
    assert out.exists()
    assert calibrate.calibration_from_file(out) == calibrate.IDENTITY


def test_session_refresh_calibration_adopts_and_clears_cache(tmp_path):
    b = _linear_chain()
    sess = JoinSession(m_budget=128)
    sess.execute(b.tq)
    assert sess.cache_info["size"] == 1
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(_bench_record()))
    out = tmp_path / "cal.json"
    cal = sess.refresh_calibration(bench, out_path=out)
    assert sess.calibration is cal
    assert cal.source == "bench:cascade_4way"
    assert out.exists()
    assert sess.cache_info["size"] == 0
