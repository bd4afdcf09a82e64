"""Port vs JAX package: the FM DISTINCT sketch over the implicit 3-way join
(``ops.fm_registers``, ``linear3.linear3_fm_distinct``), the FM estimate
at every register count it takes, and the relation generators.

Registers, estimates and generated columns are compared exactly
(tolerance: none — integers and the reference's own float32 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import linear3 as jlinear3
from repro.core import sketches as jsk
from repro.core.relation import Relation as JRelation
from repro.data import relations as jrelations
from repro.kernels import ops as jops
from repro_torch.core import linear3, sketches
from repro_torch.core.relation import Relation
from repro_torch.data import relations
from repro_torch.kernels import ops


# --------------------------------------------------------------------------
# ops.fm_registers: per bucket
# --------------------------------------------------------------------------

def _bucket_rows(seed, b, cr, cs, ct, d, t_shared=False):
    """[B, C] rows of a few shared keys, ~20% invalid slots; with
    ``t_shared`` one T row serves every bucket (the linear scan's
    broadcast)."""
    rng = np.random.default_rng(seed)

    def keys(rows, c):
        return rng.integers(0, d, (rows, c)).astype(np.int32)

    def valid(rows, c):
        return rng.random((rows, c)) < 0.8

    tb = 1 if t_shared else b
    return {"ra": keys(b, cr), "rv": valid(b, cr), "rb": keys(b, cr),
            "sb": keys(b, cs), "sc": keys(b, cs), "sv": valid(b, cs),
            "tc": keys(tb, ct), "td": keys(tb, ct), "tv": valid(tb, ct)}


_ARGS = ("ra", "rv", "rb", "sb", "sc", "sv", "tc", "td", "tv")


@pytest.mark.parametrize("n_registers", [16, 32, 64])
@pytest.mark.parametrize("seed,shape,t_shared", [
    (0, (5, 30, 40, 35, 12), False),
    (1, (3, 64, 17, 90, 40), False),
    (2, (4, 50, 60, 70, 9), True),
])
def test_fm_registers_match_reference(seed, shape, t_shared, n_registers,
                                      monkeypatch):
    b, cr, cs, ct, d = shape
    rows = _bucket_rows(seed, b, cr, cs, ct, d, t_shared)
    jrows = {k: jnp.asarray(np.broadcast_to(v, (b, v.shape[1])))
             for k, v in rows.items()}
    want = np.asarray(jops.fm_registers(*(jrows[k] for k in _ARGS),
                                        n_registers=n_registers))
    trows = {k: torch.from_numpy(v).expand(b, v.shape[1])
             for k, v in rows.items()}
    got = ops.fm_registers(*(trows[k] for k in _ARGS),
                           n_registers=n_registers)
    assert got.dtype == torch.int32 and got.shape == (b, n_registers)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same registers when every join is expanded a few pairs a chunk
    monkeypatch.setattr(ops, "FM_CHUNK", 7)
    chunked = ops.fm_registers(*(trows[k] for k in _ARGS),
                               n_registers=n_registers)
    np.testing.assert_array_equal(chunked.numpy(), want)


def test_fm_registers_empty_and_dead_buckets():
    rows = _bucket_rows(3, 3, 8, 8, 8, 4)
    rows["rv"][:] = False
    trows = {k: torch.from_numpy(v) for k, v in rows.items()}
    got = ops.fm_registers(*(trows[k] for k in _ARGS), n_registers=32)
    want = jops.fm_registers(*(jnp.asarray(rows[k]) for k in _ARGS),
                             n_registers=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


class _LargestAlloc(TorchDispatchMode):
    """Records the largest tensor any torch op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in _pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor):
                self.numel = max(self.numel, x.numel())
        return out


def test_fm_registers_form_no_dense_existence_tensor():
    """At B = 2 buckets of 4,096 R and T slots the reference's existence
    tensor is [2, 4096, 4096]: 3.4e7 cells.  The port's largest tensor
    stays far below one bucket's Cr x Ct."""
    b, c = 2, 4096
    rows = _bucket_rows(4, b, c, c, c, 1 << 20)
    # the first 64 slots of each bucket join; the others' keys are apart
    rows["rb"][:, 64:] += 1 << 28
    rows["sb"][:, 64:] += 1 << 29
    rows["tc"][:, 64:] += (1 << 29) + (1 << 28)
    rows["sb"][:, :64] = rows["rb"][:, :64]
    rows["tc"][:, :64] = rows["sc"][:, :64]
    rows["rv"][:, :64] = rows["sv"][:, :64] = rows["tv"][:, :64] = True
    trows = {k: torch.from_numpy(v) for k, v in rows.items()}
    with _LargestAlloc() as probe:
        got = ops.fm_registers(*(trows[k] for k in _ARGS), n_registers=64)
    assert probe.numel < c * c // 64, probe.numel
    assert got.any(dim=1).all()
    # the registers of the joining slots, bucket by bucket, on a slice
    # the reference's dense form can afford
    small = {k: v[:, :64] for k, v in rows.items()}
    want = jops.fm_registers(*(jnp.asarray(small[k]) for k in _ARGS),
                             n_registers=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# linear3_fm_distinct: the whole Fig 2 layout
# --------------------------------------------------------------------------

_NAMES = {"rb": "b", "sb": "b", "sc": "c", "tc": "c", "ra_col": "a",
          "td_col": "d"}
_RENAMED = {"rb": "dst", "sb": "src", "sc": "dst", "tc": "src",
            "ra_col": "src", "td_col": "dst"}

# case -> (n_r, n_s, n_t, d, m_budget, u, slack, columns renamed)
_CASES = {
    "sizes": (150, 160, 140, 60, 64, 4, 6.0, False),   # test_cost_sketches
    "overflow": (400, 420, 380, 50, 64, 4, 1.0, False),
    "renamed": (300, 300, 300, 90, 128, 8, 2.5, True),
}
_reference_cache = {}


def _linear3_inputs(case, seed):
    n_r, n_s, n_t, d, m_budget, u, slack, renamed = _CASES[case]
    rng = np.random.default_rng(seed)
    names = _RENAMED if renamed else _NAMES
    cols = [(names["ra_col"], names["rb"]), (names["sb"], names["sc"]),
            (names["tc"], names["td_col"])]
    data = [{c: rng.integers(0, d, n).astype(np.int32) for c in pair}
            for n, pair in zip((n_r, n_s, n_t), cols)]
    plan = jlinear3.default_plan(n_r, n_s, n_t, m_budget=m_budget, u=u,
                                 slack=slack)
    return data, plan, names


def _reference(case, seed, n_registers):
    key = (case, seed, n_registers)
    if key not in _reference_cache:
        data, plan, names = _linear3_inputs(case, seed)
        regs, ovf = jlinear3.linear3_fm_distinct(
            *(JRelation.from_arrays(**x) for x in data), plan,
            n_registers=n_registers, **names)
        _reference_cache[key] = (np.asarray(regs), bool(ovf))
    return _reference_cache[key]


@pytest.mark.parametrize("path", ["dense", "sparse"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(_CASES))
def test_linear3_fm_distinct_matches_reference(case, seed, path,
                                               monkeypatch):
    n_registers = 64 if case == "sizes" else 32
    want, want_ovf = _reference(case, seed, n_registers)
    if case == "overflow":
        assert want_ovf          # the case must overflow to test drops
    if path == "sparse":
        monkeypatch.setattr(linear3, "_DENSE_CELLS", 0)
        monkeypatch.setattr(ops, "FM_CHUNK", 97)
    data, plan, names = _linear3_inputs(case, seed)
    regs, ovf = linear3.linear3_fm_distinct(
        *(Relation.from_arrays(device="cpu", **x) for x in data),
        linear3.Linear3Plan(*plan), n_registers=n_registers, **names)
    assert regs.dtype == torch.int32 and regs.shape == (n_registers,)
    np.testing.assert_array_equal(regs.numpy(), want)
    assert bool(ovf) == want_ovf
    assert sketches.fm_estimate(regs) == float(jsk.fm_estimate(want))


def test_linear3_fm_distinct_is_exported():
    from repro_torch.core import linear3_fm_distinct
    assert linear3_fm_distinct is linear3.linear3_fm_distinct


# --------------------------------------------------------------------------
# fm_estimate at every register count it takes; key_bits
# --------------------------------------------------------------------------

def _registers_with_sum(total, k):
    """[k] registers whose lowest-zero indexes sum to ``total``."""
    q, rem = divmod(total, k)
    idx = [q + 1] * rem + [q] * (k - rem)
    return np.array([(1 << i) - 1 if i < 32 else -1 for i in idx],
                    np.int64).astype(np.int32)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64])
def test_fm_estimate_matches_reference_at_every_sum(k):
    regs = np.stack([_registers_with_sum(s, k) for s in range(32 * k + 1)])
    want = np.asarray(jax.vmap(jsk.fm_estimate)(jnp.asarray(regs)))
    got = [sketches.fm_estimate(torch.from_numpy(row)) for row in regs]
    np.testing.assert_array_equal(np.array(got, np.float32), want)


def test_fm_table_is_the_reference_at_64_registers():
    from repro_torch.core._fm_table import FM_ESTIMATE_BITS
    assert len(FM_ESTIMATE_BITS) == 2049
    regs = np.stack([_registers_with_sum(s, 64) for s in range(2049)])
    want = np.asarray(jax.vmap(jsk.fm_estimate)(jnp.asarray(regs)))
    np.testing.assert_array_equal(np.array(FM_ESTIMATE_BITS, np.uint32),
                                  want.astype(np.float32).view(np.uint32))


def test_fm_estimate_of_a_bucket_array_averages_every_register():
    rng = np.random.default_rng(9)
    for shape in [(2, 32), (4, 16), (8, 8), (1, 64)]:
        regs = rng.integers(-(2**31), 2**31 - 1, size=shape,
                            dtype=np.int64).astype(np.int32)
        regs[::2] &= (1 << rng.integers(1, 30, size=(1, 1))) - 1
        assert (sketches.fm_estimate(torch.from_numpy(regs))
                == float(jsk.fm_estimate(jnp.asarray(regs))))


@pytest.mark.parametrize("k", [48, 3, 128])
def test_fm_estimate_rejects_other_register_counts(k):
    with pytest.raises(ValueError, match="1, 2, 4, 8, 16, 32, 64"):
        sketches.fm_estimate(torch.zeros(k, dtype=torch.int32))


@pytest.mark.parametrize("reg", [0, 5, 31, 63])
def test_key_bits_match_reference(reg):
    rng = np.random.default_rng(reg)
    keys = rng.integers(-(2**31), 2**31 - 1, size=4000,
                        dtype=np.int64).astype(np.int32)
    want = np.asarray(jsk.key_bits(jnp.asarray(keys), reg))
    np.testing.assert_array_equal(
        sketches.key_bits(torch.from_numpy(keys), reg).numpy(), want)


def test_add_with_64_registers_matches_reference():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 5000, size=3000).astype(np.int32)
    valid = rng.random(3000) < 0.7
    want = jsk.add(jsk.empty(64), jnp.asarray(keys), jnp.asarray(valid))
    got = sketches.add(sketches.empty(64), torch.from_numpy(keys),
                       torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# data/relations.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(n=1000, d=50),
    dict(n=777, d=13, columns=("x", "y", "z"), seed=4),
    dict(n=500, d=100, zipf=1.3, seed=2),
    dict(n=300, d=40, seed=7, capacity=512),
])
def test_gen_relation_matches_reference(cfg):
    want = jrelations.gen_relation(jrelations.RelGenConfig(**cfg))
    got = relations.gen_relation(relations.RelGenConfig(**cfg),
                                 device="cpu")
    assert got.capacity == want.capacity
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(got.columns[c].numpy(),
                                      np.asarray(want.columns[c]))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_friends_relation_matches_reference():
    want = jrelations.friends_relation(2000, 300, seed=3)
    got = relations.friends_relation(2000, 300, seed=3, device="cpu")
    for c in ("a", "b"):
        np.testing.assert_array_equal(got.columns[c].numpy(),
                                      np.asarray(want.columns[c]))
    assert got.capacity == want.capacity


def test_relation_generators_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default is the card")
    from repro_torch.data import RelGenConfig, gen_relation
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gen_relation(RelGenConfig(n=10, d=3))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        relations.friends_relation(10, 3)
