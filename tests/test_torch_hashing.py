"""Port vs JAX package: hashing, composite ids, bucket layouts, sketches.

Plans, layouts and recovery rounds all depend on these ids, so every
comparison here is exact equality (tolerance: none — integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jhash
from repro.core import partition as jpart
from repro.core import sketches as jsk
from repro.core.relation import SENTINEL as J_SENTINEL
from repro.core.relation import Relation as JRelation
from repro.kernels import ops as jops
from repro_torch.core import hashing, partition, sketches
from repro_torch.core.relation import SENTINEL, Relation
from repro_torch.kernels import ops

EDGE = np.array([0, 1, -1, 2**31 - 1, -(2**31), SENTINEL, -(2**30),
                 2**30, 12345, -98765] + list(ops._SENT.values()),
                dtype=np.int32)


def _keys(seed, n=3000):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(-(2**31), 2**31 - 1, size=n,
                                              dtype=np.int64).astype(np.int32)])


def test_sentinels_match_reference():
    assert SENTINEL == J_SENTINEL
    assert ops._SENT == jops._SENT
    assert ops.EXACT_F32_MAX == jops.EXACT_F32_MAX


@pytest.mark.parametrize("fn", ["H", "G", "h", "g", "f", "salt"])
@pytest.mark.parametrize("n_buckets,salt", [(1, 0), (7, 0), (64, 3),
                                            (1000003, 1), (2**31 - 1, 2)])
def test_hash_bucket_bit_exact(fn, n_buckets, salt):
    keys = _keys(n_buckets + salt)
    want = np.asarray(jhash.hash_bucket(jnp.asarray(keys), n_buckets, fn,
                                        salt))
    got = hashing.hash_bucket(torch.from_numpy(keys), n_buckets, fn,
                              salt).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reg", [0, 1, 17, 31])
def test_trailing_zeros_and_mix_bit_exact(reg):
    keys = _keys(reg)
    want = np.asarray(jhash.hash_trailing_zeros(jnp.asarray(keys), reg))
    got = hashing.hash_trailing_zeros(torch.from_numpy(keys), reg).numpy()
    np.testing.assert_array_equal(got, want)
    mj = np.asarray(jhash.mix32(jnp.asarray(keys), 0xDEADBEEF))
    mt = hashing.mix32(torch.from_numpy(keys), 0xDEADBEEF).numpy()
    np.testing.assert_array_equal(mt, mj.astype(np.int64))
    x = np.arange(0, 2**32, 2**32 // 4099, dtype=np.uint32)
    np.testing.assert_array_equal(
        hashing._popcount32(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(jhash._popcount32(jnp.asarray(x))))


def _pair(rng, n, cap, d, cols=("a", "b")):
    data = {c: rng.integers(0, d, size=n).astype(np.int32) for c in cols}
    return (JRelation.from_arrays(capacity=cap, **data),
            Relation.from_arrays(capacity=cap, device="cpu", **data))


@pytest.mark.parametrize("salt", [0, 2])
def test_composite_ids_and_bucketize_by_ids(salt):
    rng = np.random.default_rng(7 + salt)
    jr, tr = _pair(rng, 2500, 2600, 300)
    specs = [("a", 5, "H"), ("b", 3, "g"), ("a", 4, "h")]
    jids, jnb = jpart.composite_ids(jr, specs, salt)
    tids, tnb = partition.composite_ids(tr, specs, salt)
    assert jnb == tnb
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    for cap in (40, 200):        # overflowing and fitting capacities
        jb = jpart.bucketize_by_ids(jr, jids, jnb, cap, (5, 3, 4))
        tb = partition.bucketize_by_ids(tr, tids, tnb, cap, (5, 3, 4))
        for c in ("a", "b"):
            np.testing.assert_array_equal(tb.columns[c].numpy(),
                                          np.asarray(jb.columns[c]))
        np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
        np.testing.assert_array_equal(tb.counts.numpy(),
                                      np.asarray(jb.counts))
        assert bool(tb.overflowed) == bool(jb.overflowed)


def test_bucketize_single_level_matches():
    rng = np.random.default_rng(11)
    jr, tr = _pair(rng, 1800, 2048, 90)
    jb = jpart.bucketize(jr, "b", 16, 136, fn="g", salt=1)
    tb = partition.bucketize(tr, "b", 16, 136, fn="g", salt=1)
    np.testing.assert_array_equal(tb.columns["a"].numpy(),
                                  np.asarray(jb.columns["a"]))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert bool(tb.overflowed) == bool(jb.overflowed)


def test_int32_range_value_error_matches():
    rng = np.random.default_rng(3)
    jr, tr = _pair(rng, 64, 64, 10)
    specs = [("a", 2**16, "H"), ("b", 2**16, "g")]
    with pytest.raises(ValueError) as je:
        jpart.composite_ids(jr, specs)
    with pytest.raises(ValueError) as te:
        partition.composite_ids(tr, specs)
    assert str(te.value) == str(je.value)
    ids = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds the int32 id range"):
        partition.bucketize_by_ids(tr, ids, 2**20, 2**12, (2**20,))


@pytest.mark.parametrize("d,n", [(1, 50), (300, 2000), (100000, 4000)])
def test_sketch_registers_and_estimate(d, n):
    rng = np.random.default_rng(d)
    keys = rng.integers(0, d, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    jregs = jsk.add(jsk.empty(), jnp.asarray(keys), jnp.asarray(valid))
    tregs = sketches.add(sketches.empty(), torch.from_numpy(keys),
                         torch.from_numpy(valid))
    np.testing.assert_array_equal(tregs.numpy(), np.asarray(jregs))
    assert sketches.fm_estimate(tregs) == float(jsk.fm_estimate(jregs))
    jr = JRelation.from_arrays(a=keys)
    tr = Relation.from_arrays(device="cpu", a=keys)
    assert tr.distinct_estimate("a") == jr.distinct_estimate("a")


def test_fm_estimate_table_matches_reference():
    """Every value the estimate can take (mean index k/32, k in [0, 1024])
    equals the reference's float32 estimate."""
    for k in range(1025):
        q, rem = divmod(k, 32)
        idx = [q + 1] * rem + [q] * (32 - rem)
        regs = np.array([(1 << i) - 1 if i < 32 else -1 for i in idx],
                        np.int64).astype(np.int32)
        assert (sketches.fm_estimate(torch.from_numpy(regs))
                == float(jsk.fm_estimate(jnp.asarray(regs)))), k


def test_fm_estimate_over_random_registers():
    rng = np.random.default_rng(5)
    regs = rng.integers(-(2**31), 2**31 - 1, size=(64, 32),
                        dtype=np.int64).astype(np.int32)
    regs[::3] &= (1 << rng.integers(1, 30, size=(22, 1))) - 1
    for row in regs:
        assert (sketches.fm_estimate(torch.from_numpy(row))
                == float(jsk.fm_estimate(jnp.asarray(row))))


def test_suggest_capacity_matches():
    for args in [(1, 1), (4_000_000, 245, 2.5), (100, 64, 2.0),
                 (20_000_000, 64, 2.5)]:
        assert partition.suggest_capacity(*args) == \
            jpart.suggest_capacity(*args)


def test_relation_from_reference_arrays_keeps_padding_and_validity():
    """The JAX package's relation (padding slots and a holed validity mask
    included) carried into the port through numpy gives the same arrays
    and the same composite ids."""
    from repro_torch.convert import (relation_from_numpy,
                                     relation_from_reference_arrays,
                                     relation_to_numpy)
    rng = np.random.default_rng(21)
    jr, _ = _pair(rng, 300, 320, 40)
    jr = jr.mask_where(jnp.asarray(rng.random(320) < 0.9))
    d = {"columns": {k: np.asarray(v) for k, v in jr.columns.items()},
         "valid": np.asarray(jr.valid), "capacity": jr.capacity}
    tr = relation_from_reference_arrays(d, device="cpu")
    back = relation_to_numpy(tr)
    assert back["capacity"] == jr.capacity
    np.testing.assert_array_equal(back["valid"], d["valid"])
    for k in d["columns"]:
        np.testing.assert_array_equal(back["columns"][k], d["columns"][k])
    specs = [("a", 7, "H"), ("b", 5, "h")]
    np.testing.assert_array_equal(
        partition.composite_ids(tr, specs, 1)[0].numpy(),
        np.asarray(jpart.composite_ids(jr, specs, 1)[0]))
    assert int(tr.n) == int(jr.n)
    padded = relation_from_numpy({"a": [1, 2]}, capacity=5, device="cpu")
    assert padded.valid.tolist() == [True, True, False, False, False]
