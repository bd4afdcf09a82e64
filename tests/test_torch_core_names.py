"""Port vs JAX package: the last public names of ``repro.core``.

``partition.SortedPartition`` / ``partition_sorted`` / ``partition_sorted2``
on seeded layouts with skew (a hot key owning a share of the rows) and
invalid rows scattered through the capacity, held against the reference
array for array and against the invariants of
``tests/test_hash_partition.py``; ``sketches.merge`` as in
``tests/test_cost_sketches.py`` (the union of two sketches equals the
sketch of the union); ``binary_join.host_join_count``, the re-exported
oracle, and ``planner.exact_join_count``, the planner's alias of
``binary_join.exact_join_count``.  Tolerance: none (integers and flags).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary_join as jbinary
from repro.core import planner as jplanner
from repro.core import partition as jpartition
from repro.core import sketches as jsketches
from repro.core.relation import Relation as JRelation
from repro_torch.convert import relation_from_numpy
from repro_torch.core import binary_join, hashing, partition, planner, sketches

# (rows, one-level buckets, outer x inner buckets, key range, hot share,
# dead share, seed)
LAYOUTS = [(1, 1, (1, 1), 1, 0.0, 0.0, 0),
           (37, 5, (3, 4), 18, 0.0, 0.2, 1),
           (128, 16, (4, 8), 64, 0.5, 0.0, 2),
           (300, 32, (8, 4), 150, 0.3, 0.3, 3),
           (257, 7, (5, 3), 9, 0.8, 0.5, 4)]


def _layout(n, d, hot, dead, seed):
    rng = np.random.default_rng(seed)
    cols = {c: rng.integers(0, d, n).astype(np.int32) for c in ("k", "v")}
    for c in cols:
        cols[c][rng.random(n) < hot] = 3
    valid = rng.random(n) >= dead
    return cols, valid


def _both(cols, valid):
    jrel = JRelation({k: jnp.asarray(v) for k, v in cols.items()},
                     jnp.asarray(valid))
    return jrel, relation_from_numpy(cols, valid=valid, device="cpu")


def _assert_same(got: partition.SortedPartition, want):
    assert isinstance(got, partition.SortedPartition)
    np.testing.assert_array_equal(got.bucket_ids.numpy(),
                                  np.asarray(want.bucket_ids))
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    assert got.offsets.dtype == torch.int32
    np.testing.assert_array_equal(got.rel.valid.numpy(),
                                  np.asarray(want.rel.valid))
    for c in want.rel.columns:
        np.testing.assert_array_equal(got.rel.col(c).numpy(),
                                      np.asarray(want.rel.col(c)))


def _assert_csr(sp, n_buckets, ids_of):
    """The invariants of ``test_partition_sorted_invariants``: monotone
    offsets covering every valid row; rows of [offsets[i], offsets[i+1])
    carry bucket i and hash to it; invalid rows last, at n_buckets."""
    offs = sp.offsets.numpy()
    ids = sp.bucket_ids.numpy()
    valid = sp.rel.valid.numpy()
    assert (np.diff(offs) >= 0).all()
    assert offs[0] == 0 and offs[-1] == valid.sum()
    assert (ids[offs[-1]:] == n_buckets).all()
    assert not valid[offs[-1]:].any()
    for i in range(n_buckets):
        seg = slice(offs[i], offs[i + 1])
        assert (ids[seg] == i).all()
        assert (ids_of(sp.rel)[seg] == i).all()


@pytest.mark.parametrize("n,nb,nested,d,hot,dead,seed", LAYOUTS)
@pytest.mark.parametrize("salt", [0, 3])
def test_partition_sorted_matches_reference(n, nb, nested, d, hot, dead,
                                            seed, salt):
    cols, valid = _layout(n, d, hot, dead, seed)
    jrel, rel = _both(cols, valid)
    sp = partition.partition_sorted(rel, "k", nb, fn="H", salt=salt)
    _assert_same(sp, jpartition.partition_sorted(jrel, "k", nb, fn="H",
                                                 salt=salt))
    _assert_csr(sp, nb, lambda r: hashing.hash_bucket(
        r.col("k"), nb, "H", salt).numpy())


@pytest.mark.parametrize("n,nb,nested,d,hot,dead,seed", LAYOUTS)
def test_partition_sorted2_matches_reference(n, nb, nested, d, hot, dead,
                                             seed):
    cols, valid = _layout(n, d, hot, dead, seed)
    jrel, rel = _both(cols, valid)
    n_outer, n_inner = nested
    sp = partition.partition_sorted2(rel, "k", "v", n_outer, n_inner)
    _assert_same(sp, jpartition.partition_sorted2(jrel, "k", "v", n_outer,
                                                  n_inner))

    def composite(r):
        return (hashing.hash_bucket(r.col("k"), n_outer, "H") * n_inner
                + hashing.hash_bucket(r.col("v"), n_inner, "g")).numpy()

    _assert_csr(sp, n_outer * n_inner, composite)


@pytest.mark.parametrize("n_registers", [16, 32, 64])
def test_merge_is_the_union(n_registers):
    """``test_fm_merge_equals_union``: the union of two overlapping key
    sets' sketches is the sketch of the union, and the reference's."""
    def sk(lo, hi):
        keys = torch.arange(lo, hi, dtype=torch.int32)
        return sketches.add(sketches.empty(n_registers, device="cpu"), keys,
                            torch.ones(hi - lo, dtype=torch.bool))

    def jsk(lo, hi):
        return jsketches.add(jsketches.empty(n_registers),
                             jnp.arange(lo, hi, dtype=jnp.int32),
                             jnp.ones((hi - lo,), bool))

    merged = sketches.merge(sk(0, 3000), sk(1500, 4000))
    np.testing.assert_array_equal(merged.numpy(), sk(0, 4000).numpy())
    np.testing.assert_array_equal(
        merged.numpy(), np.asarray(jsketches.merge(jsk(0, 3000),
                                                   jsk(1500, 4000))))


@pytest.mark.parametrize("seed,hot", [(5, 0.0), (6, 0.6)])
def test_host_join_count_reexport(seed, hot):
    assert binary_join.host_join_count is not None
    a_cols, a_valid = _layout(200, 30, hot, 0.25, seed)
    b_cols, b_valid = _layout(170, 30, hot, 0.1, seed + 100)
    ja, a = _both(a_cols, a_valid)
    jb, b = _both(b_cols, b_valid)
    got = binary_join.host_join_count(a, "k", b, "v")
    assert got == int(jbinary.host_join_count(ja, "k", jb, "v"))
    ka, kb = a_cols["k"][a_valid], b_cols["v"][b_valid]
    assert got == int((ka[:, None] == kb[None, :]).sum())


@pytest.mark.parametrize("seed,hot", [(7, 0.0), (8, 0.7)])
def test_planner_exact_join_count_alias(seed, hot):
    assert planner.exact_join_count is binary_join.exact_join_count
    a_cols, a_valid = _layout(210, 25, hot, 0.2, seed)
    b_cols, b_valid = _layout(190, 25, hot, 0.15, seed + 100)
    ja, a = _both(a_cols, a_valid)
    jb, b = _both(b_cols, b_valid)
    got = planner.exact_join_count(a, "k", b, "v")
    assert got == jplanner.exact_join_count(ja, "k", jb, "v")
    ka, kb = a_cols["k"][a_valid], b_cols["v"][b_valid]
    assert got == int((ka[:, None] == kb[None, :]).sum())
