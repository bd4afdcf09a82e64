"""Port vs JAX package: the mesh path (``core/distributed.py``,
``JoinSession.execute_sharded``).

Each side runs in processes of its own (``torch_dist_cases.py``): the JAX
package on 8 forced XLA host devices in a (4, 2) mesh, the port as 8 gloo
ranks in a 4 × 2 ``DeviceMesh``, each holding its stripes of the same
seeded numpy relations.  One launch per mesh shape serves every test of
that shape, and all launches run at once under a wall-clock limit, so a
rank that hangs fails the tests instead of stalling the run.

* 4 × 2: every join case of ``dist_runner.py`` (one-shot wrappers,
  ``engine_count_sharded`` per kind, the three ``execute_sharded``
  queries, the skewed cases that reach round 3) gives the reference's
  exact ``[count, overflowed, rounds, kind]`` and the conftest oracle's
  count; the shuffle primitives' received rows equal the reference's
  shards row for row (tolerance: none — all integers and flags).
* 2 × 2 and 1 × 1: odd capacities padded to the mesh against the oracles,
  a heavy-key case whose count passes 2^31 on one rank (exact in int64),
  and at 1 × 1 the single-card ``JoinSession.execute`` beside the mesh.
* A rank that never joins a collective makes the others fail within the
  groups' timeout; ``make_mesh`` without CUDA names ``device="cpu"``.

The same launches also run the LM's mesh cases, which
``tests/test_torch_lm_mesh.py`` reads (``cases.shared_launch``: one
launch a test session, whichever file asks first).
"""

import json
import time

import numpy as np
import pytest
import torch
import torch_dist_cases as cases
from conftest import oracle_cyclic3_count, oracle_linear3_count

from repro_torch.core import distributed

SHAPES = cases.SHAPES
PARITY = [c["name"] for c in cases.parity_suite()[1]]
ORACLE = {shape: [c["name"] for c in cases.oracle_suite(*rc)[1]]
          for shape, rc in SHAPES.items() if shape != "4x2"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port's three mesh shapes, launched at once
    (once a session: ``tests/test_torch_lm_mesh.py`` reads the same
    launches); every rank's results (and the primitives' arrays) read
    back."""
    root, status = cases.shared_launch(tmp_path_factory.getbasetemp())
    if status["bad"]:
        pytest.fail(f"mesh launches failed {status['bad']} (None: killed "
                    f"at the {cases.WALL_S} s limit):\n" + "\n".join(
                        f"--- {n}\n{t}" for n, t in status["tails"].items()))
    got = {"ref": json.loads((root / "ref" / "reference.json").read_text()),
           "ref_prims": dict(np.load(root / "ref" / "prims_ref.npz"))}
    for shape, (rows, cols) in SHAPES.items():
        got[shape] = [json.loads((root / shape / f"port_{k}.json")
                                 .read_text()) for k in range(rows * cols)]
    got["prims"] = [dict(np.load(root / "4x2" / f"prims_{k}.npz"))
                    for k in range(8)]
    return got


def _oracle(tables, c) -> int:
    r, s, t = (tables[n] for n in (c["tables"].values()
                                   if isinstance(c["tables"], dict)
                                   else c["tables"]))
    cyclic = c["kind"] == "cyclic" or len(c["kw"].get("preds", ())) == 3
    if cyclic:
        return oracle_cyclic3_count(r["a"], r["b"], s["b"], s["c"], t["c"],
                                    t["a"])
    return oracle_linear3_count(r["b"], s["b"], s["c"], t["c"])


@pytest.fixture(scope="module")
def parity_oracles():
    tables, cs = cases.parity_suite()
    return {c["name"]: _oracle(tables, c) for c in cs}


@pytest.mark.parametrize("name", PARITY)
def test_mesh_matches_reference(runs, parity_oracles, name):
    """4 × 2: the port's [count, overflowed, rounds, kind] is the
    reference's, and the count is the oracle's unless an overflow was
    signalled (only the one-shot zipf case may: the reference's runner
    accepts a signalled overflow there)."""
    port, ref = runs["4x2"][0][name], runs["ref"][name]
    assert port == ref, (port, ref)
    count, overflowed, rounds, _ = port
    if name != "oneshot_linear_zipf":
        assert not overflowed
    if not overflowed:
        assert count == parity_oracles[name]
    if name.startswith("skew"):
        assert rounds >= 2


@pytest.mark.parametrize("rank", range(8))
def test_shuffle_primitives_match_reference(runs, rank):
    """Each rank's received rows (two-phase routing, both broadcasts) in
    the reference device's order, slot for slot, its send-buffer overflow
    flags, and the mesh-wide OR and any."""
    ref, port = runs["ref_prims"], runs["prims"][rank]
    assert sorted(ref) == sorted(port)
    for key in ref:
        np.testing.assert_array_equal(port[key].reshape(-1), ref[key][rank],
                                      err_msg=key)
    # the tight send buffers drop rows somewhere, so order decided them
    assert ref["ovf1"].any()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_rank_returns_the_same_results(runs, shape):
    first, *rest = runs[shape]
    assert all(r == first for r in rest)


@pytest.fixture(scope="module")
def oracle_counts():
    out = {}
    for shape, rc in SHAPES.items():
        if shape != "4x2":
            tables, cs = cases.oracle_suite(*rc)
            out[shape] = {c["name"]: _oracle(tables, c) for c in cs}
    return out


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in ORACLE.items()
                                        for n in names])
def test_mesh_matches_oracle(runs, oracle_counts, shape, name):
    """2 × 2 and 1 × 1: exact against the oracle, never overflowed; the
    heavy case past 2^31 in int64; at 1 × 1 the single-card execute gives
    the same count as the mesh."""
    count, overflowed, rounds, _ = runs[shape][0][name]
    want = oracle_counts[shape][name]
    assert not overflowed
    assert count == want
    if name == "heavy_linear":
        assert want == 4_000_000_000 > 2**31
    if name.endswith("_tight") and shape == "2x2":
        assert rounds >= 2
    if name.startswith("execute_"):
        assert count == runs[shape][0]["session_" + name[8:]][0]


def test_stalled_rank_fails_within_the_timeout(tmp_path):
    """A rank that never joins the first collective: the other rank's
    collective times out after the groups' 3 s and the run fails; nothing
    waits for the wall-clock limit."""
    procs, logs = {}, {}
    for k in range(2):
        logs[k] = tmp_path / f"log{k}"
        procs[k] = cases.start(cases.port_argv(tmp_path, 1, 2, "oracle", k,
                                               3) + ["--stall"], logs[k])
    t0 = time.monotonic()
    codes = cases.wait({0: procs[0]}, 90)
    elapsed = time.monotonic() - t0
    cases.wait({1: procs[1]}, 0.1)
    assert codes[0] not in (0, None), cases.tail(logs[0])
    assert "timed out" in logs[0].read_text().lower(), cases.tail(logs[0])
    assert elapsed < 60, elapsed


def test_make_mesh_without_cuda_names_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        distributed.make_mesh(1, 1)


def test_make_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        distributed.make_mesh(1, 1, device="cpu")


def test_pad_to_multiple():
    from repro_torch.convert import relation_from_numpy
    rel = relation_from_numpy({"a": np.arange(10, dtype=np.int32)},
                              device="cpu")
    padded = distributed.pad_to_multiple(rel, 8)
    assert padded.capacity == 16 and int(padded.n) == 10
    assert distributed.pad_to_multiple(padded, 8) is padded
