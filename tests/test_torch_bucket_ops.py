"""Port vs JAX package: the bucket-row ops of the baselines and the
all-pairs cyclic sweep.

The port's plain versions (what a CPU tensor takes) are held against the
reference's jnp path (``use_kernel=False``) and, at tiny shapes, against
its Pallas kernels in interpret mode (``use_kernel=True`` on the CPU), on
seeded rows with invalid (sentinel-masked) slots, hot keys and capacities
that are not multiples of 8, 32 or 128, so the port's unpadded shapes meet
the reference's padded-then-cropped ones.  Rows shared along a size-1
batch dimension (as the scan drivers pass them) are held against the
reference on the same rows copied out.  Counts are integers: the
tolerance is exact equality.  The CUDA kernels are compared with the same
plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops


def _grid(rng, shape, d, hot=False):
    keys = rng.integers(0, d, size=shape).astype(np.int32)
    if hot:
        keys[rng.random(shape) < 0.3] = 3
    valid = rng.random(shape) < 0.8
    return keys, valid


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _rows(arrays, batch):
    """Each array broadcast to ``batch`` and flattened to [B, C] (the
    reference's layout of the same buckets)."""
    return [np.broadcast_to(a, (*batch, a.shape[-1])).reshape(-1, a.shape[-1])
            for a in arrays]


# (B, Ca, Cb, key range, hot); interpret mode only at the tiny ones
PAIR_SHAPES = [(5, 37, 130, 11, True, True), (3, 129, 7, 4, False, True),
               (1, 1, 1, 2, False, True), (40, 300, 250, 97, True, False)]


@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_bucket_pair_count_matches_reference(shape):
    b, ca, cb, d, hot, interpret = shape
    rng = np.random.default_rng(sum(shape[:4]))
    ka, va = _grid(rng, (b, ca), d, hot)
    kb, vb = _grid(rng, (b, cb), d, hot)
    args = (ka, va, kb, vb)
    got = ops.bucket_pair_count(*_t(args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.bucket_pair_count(*_j(args))))
    if interpret:
        np.testing.assert_array_equal(got, np.asarray(
            jops.bucket_pair_count(*_j(args), use_kernel=True)))


# (R batch, S batch, T batch, Cr, Cs, Ct, key range, hot, interpret)
LINEAR_SHAPES = [
    ((4,), (4,), (4,), 13, 5, 37, 11, True, True),
    ((3,), (3,), (3,), 130, 7, 129, 7, False, True),
    ((1,), (1,), (1,), 1, 1, 1, 2, False, True),
    ((1, 5), (3, 5), (3, 1), 21, 9, 300, 9, True, False),   # linear driver
    ((4, 1), (4, 3), (1, 3), 50, 33, 17, 6, True, False),   # star driver
]


@pytest.mark.parametrize("shape", LINEAR_SHAPES)
def test_bucket_linear_and_per_r_match_reference(shape):
    br, bs, bt, cr, cs, ct, d, hot, interpret = shape
    rng = np.random.default_rng(cr + cs + ct + d)
    rb, rv = _grid(rng, (*br, cr), d, hot)
    sb, sv = _grid(rng, (*bs, cs), d, hot)
    sc, _ = _grid(rng, (*bs, cs), d, hot)
    tc, tv = _grid(rng, (*bt, ct), d, hot)
    batch = np.broadcast_shapes(br, bs, bt)
    args = (rb, rv, sb, sc, sv, tc, tv)
    flat = _rows(args, batch)
    got = ops.bucket_count3_linear(*_t(args)).numpy()
    assert got.shape == batch
    want = np.asarray(jops.bucket_count3_linear(*_j(flat)))
    np.testing.assert_array_equal(got.reshape(-1), want)
    got_r = ops.bucket_per_r_counts(*_t(args)).numpy()
    assert got_r.shape == (*batch, cr)
    want_r = np.asarray(jops.bucket_per_r_counts(*_j(flat)))
    np.testing.assert_array_equal(got_r.reshape(-1, cr), want_r)
    if interpret:
        np.testing.assert_array_equal(got, np.asarray(
            jops.bucket_count3_linear(*_j(args), use_kernel=True)))
        # the reference pads Cr to 128 lanes and crops back to the caller's
        np.testing.assert_array_equal(got_r, np.asarray(
            jops.bucket_per_r_counts(*_j(args), use_kernel=True)))


# (R batch, S batch, T batch, Cr, Cs, Ct, key range, hot, interpret)
CYCLIC_SHAPES = [
    ((3,), (3,), (3,), 13, 9, 17, 5, True, True),
    ((1,), (1,), (1,), 1, 1, 1, 2, False, True),
    ((2,), (2,), (2,), 129, 7, 130, 4, False, True),
    ((2, 3), (2, 1, 3), (2, 2, 1), 30, 41, 57, 6, True, False),  # (f, a, b)
]


@pytest.mark.parametrize("shape", CYCLIC_SHAPES)
def test_bucket_cyclic_forms_match_reference(shape):
    br, bs, bt, cr, cs, ct, d, hot, interpret = shape
    rng = np.random.default_rng(cr * cs + ct + d)
    ra, rv = _grid(rng, (*br, cr), d, hot)
    rb, _ = _grid(rng, (*br, cr), d, hot)
    sb, sv = _grid(rng, (*bs, cs), d, hot)
    sc, _ = _grid(rng, (*bs, cs), d, hot)
    tc, tv = _grid(rng, (*bt, ct), d, hot)
    ta, _ = _grid(rng, (*bt, ct), d, hot)
    batch = np.broadcast_shapes(br, bs, bt)
    args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
    flat = _rows(args, batch)
    got = ops.bucket_count3_cyclic(*_t(args)).numpy()
    assert got.shape == batch
    want = np.asarray(jops.bucket_count3_cyclic(*_j(flat)))
    np.testing.assert_array_equal(got.reshape(-1), want)
    # the pair-index form: T as the sorted (c, a) index, shared rows kept
    tcs, tas = ops.sorted_pair_index(*_t((tc, ta, tv)))
    got_p = ops.bucket_count3_cyclic_pairidx(*_t(args[:6]), tcs, tas).numpy()
    jtcs, jtas = jops.sorted_pair_index(*_j(_rows((tc, ta, tv), batch)))
    want_p = np.asarray(jops.bucket_count3_cyclic_pairidx(
        *_j(flat[:6]), jtcs, jtas))
    np.testing.assert_array_equal(got_p.reshape(-1), want_p)
    np.testing.assert_array_equal(got_p, got)
    if interpret:
        np.testing.assert_array_equal(got, np.asarray(
            jops.bucket_count3_cyclic(*_j(args), use_kernel=True)))


# (hp, gp, uh, ug, fp, Cr, Cs, Ct, key range, hot, interpret)
FUSED_CYCLIC_SHAPES = [(1, 2, 2, 1, 2, 5, 9, 7, 4, True, True),
                       (2, 1, 1, 2, 3, 13, 3, 11, 3, False, True),
                       (2, 3, 2, 2, 2, 40, 31, 35, 6, True, False)]


@pytest.mark.parametrize("shape", FUSED_CYCLIC_SHAPES)
def test_fused_all_pairs_cyclic_matches_reference(shape):
    hp, gp, uh, ug, fp, cr, cs, ct, d, hot, interpret = shape
    rng = np.random.default_rng(sum(shape[:8]))
    ra, rv = _grid(rng, (hp, gp, uh, ug, cr), d, hot)
    rb, _ = _grid(rng, (hp, gp, uh, ug, cr), d, hot)
    sb, sv = _grid(rng, (gp, fp, ug, cs), d, hot)
    sc, _ = _grid(rng, (gp, fp, ug, cs), d, hot)
    tc, tv = _grid(rng, (hp, fp, uh, ct), d, hot)
    ta, _ = _grid(rng, (hp, fp, uh, ct), d, hot)
    args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
    got = ops.fused_count3_cyclic(*_t(args), pair_index=False).numpy()
    want = np.asarray(jops.fused_count3_cyclic(*_j(args), pair_index=False))
    np.testing.assert_array_equal(got, want)
    if interpret:
        np.testing.assert_array_equal(got, np.asarray(jops.fused_count3_cyclic(
            *_j(args), pair_index=False, use_kernel=True)))


def test_bucket_ops_refuse_other_devices():
    x = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    v = torch.ones((2, 3), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.bucket_pair_count(x, v, x, v)
