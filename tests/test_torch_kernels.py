"""Port vs JAX package: the four fused partition-sweep ops.

The port's plain versions (what a CPU tensor takes) are held against the
reference's jnp path (``use_kernel=False``) and against its Pallas kernels
in interpret mode, on seeded layouts with invalid (sentinel-masked) slots,
hot keys and capacities that are not multiples of 8, 32 or 128.  Counts
are integers: the tolerance is exact equality.  The CUDA kernels are
compared with the same plain versions on the card by ``chip_smoke.py``
and by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bucket_join
from repro.kernels import ops as jops
from repro_torch.kernels import ops


def _grid(rng, shape, d, hot=False):
    keys = rng.integers(0, d, size=shape).astype(np.int32)
    if hot:
        keys[rng.random(shape) < 0.3] = 3
    valid = rng.random(shape) < 0.8
    return keys, valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (hp, gp, u, Cr, Cs, Ct): unaligned capacities on purpose
LINEAR_SHAPES = [(2, 3, 4, 13, 5, 37), (1, 2, 3, 130, 7, 129)]


@pytest.mark.parametrize("shape", LINEAR_SHAPES)
@pytest.mark.parametrize("hot", [False, True])
def test_fused_linear_and_per_r_match_reference(shape, hot):
    hp, gp, u, cr, cs, ct = shape
    rng = np.random.default_rng(sum(shape) + hot)
    d = 11
    rb, rv = _grid(rng, (hp, u, cr), d, hot)
    sb, sv = _grid(rng, (hp, gp, u, cs), d, hot)
    sc, _ = _grid(rng, (hp, gp, u, cs), d, hot)
    tc, tv = _grid(rng, (gp, ct), d, hot)
    args = (rb, rv, sb, sc, sv, tc, tv)
    got = ops.fused_count3_linear(*_t(*args)).numpy()
    want = np.asarray(jops.fused_count3_linear(*_j(*args)))
    np.testing.assert_array_equal(got, want)
    got_r = ops.fused_per_r_counts(*_t(*args)).numpy()
    want_r = np.asarray(jops.fused_per_r_counts(*_j(*args)))
    np.testing.assert_array_equal(got_r, want_r)
    # and against the Pallas kernels in interpret mode, on the same
    # sentinel-masked, 128-lane-padded operands the reference passes them
    m = {k: np.asarray(jops._mask(jnp.asarray(x), jnp.asarray(v), k))
         for k, (x, v) in {"r": (rb, rv), "t": (tc, tv)}.items()}
    msb = np.asarray(jops._mask(jnp.asarray(sb), jnp.asarray(sv), "s"))
    msc = np.asarray(jops._mask(jnp.asarray(sc), jnp.asarray(sv), "s"))
    pad = [jops._pad_lanes(jnp.asarray(x), side)
           for x, side in ((m["r"], "r"), (msb, "s"), (msc, "s"),
                           (m["t"], "t"))]
    kern = np.asarray(bucket_join.fused_count3_linear(*pad, interpret=True))
    np.testing.assert_array_equal(got, kern)
    kern_r = np.asarray(bucket_join.fused_per_r_counts(*pad, interpret=True))
    np.testing.assert_array_equal(got_r, kern_r[..., :cr])


# (uh, ug, chunks, Cr, Cs, Ct)
STAR_SHAPES = [(2, 3, 1, 21, 9, 17), (3, 2, 2, 5, 33, 130)]


@pytest.mark.parametrize("shape", STAR_SHAPES)
@pytest.mark.parametrize("hot", [False, True])
def test_fused_star_matches_reference(shape, hot):
    uh, ug, ch, cr, cs, ct = shape
    rng = np.random.default_rng(100 + sum(shape) + hot)
    d = 9
    rb, rv = _grid(rng, (uh, cr), d, hot)
    sb, sv = _grid(rng, (ch, uh, ug, cs), d, hot)
    sc, _ = _grid(rng, (ch, uh, ug, cs), d, hot)
    tc, tv = _grid(rng, (ug, ct), d, hot)
    args = (rb, rv, sb, sc, sv, tc, tv)
    got = ops.fused_count3_star(*_t(*args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_star(*_j(*args))))
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_star(*_j(*args), use_kernel=True)))


# (hp, gp, uh, ug, fp, Cr, Cs, Ct)
CYCLIC_SHAPES = [(1, 2, 2, 3, 2, 7, 11, 13), (2, 1, 3, 2, 3, 10, 6, 129)]


@pytest.mark.parametrize("shape", CYCLIC_SHAPES)
@pytest.mark.parametrize("hot", [False, True])
def test_fused_cyclic_pairidx_matches_reference(shape, hot):
    hp, gp, uh, ug, fp, cr, cs, ct = shape
    rng = np.random.default_rng(200 + sum(shape) + hot)
    d = 5
    ra, rv = _grid(rng, (hp, gp, uh, ug, cr), d, hot)
    rb, _ = _grid(rng, (hp, gp, uh, ug, cr), d, hot)
    sb, sv = _grid(rng, (gp, fp, ug, cs), d, hot)
    sc, _ = _grid(rng, (gp, fp, ug, cs), d, hot)
    tc, tv = _grid(rng, (hp, fp, uh, ct), d, hot)
    ta, _ = _grid(rng, (hp, fp, uh, ct), d, hot)
    args = (ra, rb, rv, sb, sc, sv, tc, ta, tv)
    got = ops.fused_count3_cyclic(*_t(*args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_cyclic(*_j(*args))))
    # interpret-mode Pallas pair-index kernel
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_cyclic(*_j(*args),
                                                 use_kernel=True)))
    # the all-pairs form computes the same counts
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_cyclic(*_j(*args),
                                                 pair_index=False)))


def _hard_layout(rng, kind, sides, d):
    """Seeded keys and validity of one join layout, as the card's layouts
    (``chip_smoke.hard_layout``) make them, small enough for interpret
    mode.  ``sides`` maps each side to (its shape, its key columns);
    "distinct": the first key column of R and T holds distinct keys in
    every row, 90% live; "hot": every key 7 and every slot live, so the
    cell counts pass 2^32 and wrap; "dead": whole rows and buckets dead on
    every side; "long" / "unaligned": uniform keys with a hot key, 80%
    live; any other kind ("a200", "a600", "chunks"): uniform keys, 80%
    live."""
    keys, valid = {}, {}
    for side, (shape, cols) in sides.items():
        for n, col in enumerate(cols):
            if kind == "hot":
                k = np.full(shape, 7, np.int32)
            elif kind == "distinct" and n == 0 and side in "rt":
                rows = int(np.prod(shape[:-1]))
                k = np.stack([rng.permutation(d[col])[:shape[-1]]
                              for _ in range(rows)]).reshape(shape)
            else:
                k = rng.integers(0, d[col], size=shape)
                if kind in ("long", "unaligned"):
                    k[rng.random(shape) < 0.3] = 3
            keys[col] = k.astype(np.int32)
        v = rng.random(shape) < {"hot": 1.0, "distinct": 0.9}.get(kind, 0.8)
        if kind == "dead":
            v[0, ...] = False
            v[1::2, -1, ...] = False
        valid[side] = v
    return keys, valid


# (hp, gp, u, Cr, Cs, Ct, kind, key range per column): every key of an R
# and a T row distinct; one hot key with 2000 x 2200 x 1000 per cell (int32
# wrap-around); dead rows and buckets; S blocks of 2,100 slots; capacities
# 1, 129 and 257
LINEAR_HARD = [
    ((1, 2, 2, 300, 40, 600), "distinct",
     dict(rb=2000, sb=2000, sc=2000, tc=2000)),
    ((1, 1, 1, 2000, 1000, 2200), "hot", dict(rb=1, sb=1, sc=1, tc=1)),
    ((3, 4, 5, 20, 9, 40), "dead", dict(rb=7, sb=7, sc=7, tc=7)),
    ((1, 2, 3, 10, 700, 50), "long", dict(rb=9, sb=9, sc=9, tc=9)),
    ((2, 1, 3, 1, 129, 257), "unaligned", dict(rb=3, sb=3, sc=3, tc=3)),
]


@pytest.mark.parametrize("case", LINEAR_HARD, ids=lambda c: c[1])
def test_fused_linear_hard_layouts_match_reference(case):
    (hp, gp, u, cr, cs, ct), kind, d = case
    rng = np.random.default_rng(300 + cr + cs)
    k, v = _hard_layout(rng, kind, {
        "r": ((hp, u, cr), ("rb",)), "s": ((hp, gp, u, cs), ("sb", "sc")),
        "t": ((gp, ct), ("tc",))}, d)
    args = (k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"], v["t"])
    got = ops.fused_count3_linear(*_t(*args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_linear(*_j(*args))))
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_linear(*_j(*args),
                                                 use_kernel=True)))
    if kind == "hot":   # every cell passes 2^32 and wraps as int32
        live = int(v["s"].sum(axis=(1, 3))[0, 0])
        assert got[0, 0] == np.int64(cr * ct * live).astype(np.int32)


@pytest.mark.parametrize("case", LINEAR_HARD, ids=lambda c: c[1])
def test_fused_per_r_hard_layouts_match_reference(case):
    """The per-R sweep on the linear sweep's layouts (same operands): a
    live R slot's sum, 0 for a dead one."""
    (hp, gp, u, cr, cs, ct), kind, d = case
    rng = np.random.default_rng(300 + cr + cs)
    k, v = _hard_layout(rng, kind, {
        "r": ((hp, u, cr), ("rb",)), "s": ((hp, gp, u, cs), ("sb", "sc")),
        "t": ((gp, ct), ("tc",))}, d)
    args = (k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"], v["t"])
    got = ops.fused_per_r_counts(*_t(*args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_per_r_counts(*_j(*args))))
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_per_r_counts(*_j(*args),
                                                use_kernel=True)))
    if kind == "hot":   # every live S slot of the row adds all of T
        live = int(v["s"].sum(axis=(1, 3))[0, 0])
        assert (got == ct * live).all()
    if kind == "dead":
        assert (got[~v["r"]] == 0).all()


# (uh, ug, chunks, Cr, Cs, Ct, kind, key range per column): R and T rows
# of distinct keys past 4,096 a row; one hot key with 2000 x 2200 x 1000
# per cell (int32 wrap-around); dead rows and chunks; an S cell of 9,003
# slots; capacities 1, 129 and 257; four chunks summed into each cell
STAR_HARD = [
    ((1, 2, 1, 4600, 300, 5000), "distinct",
     dict(rb=10_000, sb=10_000, sc=10_000, tc=10_000)),
    ((1, 1, 1, 2000, 1000, 2200), "hot", dict(rb=1, sb=1, sc=1, tc=1)),
    ((3, 4, 2, 20, 9, 40), "dead", dict(rb=7, sb=7, sc=7, tc=7)),
    ((2, 2, 1, 10, 9003, 50), "long", dict(rb=9, sb=9, sc=9, tc=9)),
    ((3, 2, 1, 1, 129, 257), "unaligned", dict(rb=3, sb=3, sc=3, tc=3)),
    ((2, 3, 4, 30, 70, 40), "chunks", dict(rb=11, sb=11, sc=11, tc=11)),
]


@pytest.mark.parametrize("case", STAR_HARD, ids=lambda c: c[1])
def test_fused_star_hard_layouts_match_reference(case):
    (uh, ug, ch, cr, cs, ct), kind, d = case
    rng = np.random.default_rng(500 + cr + cs)
    k, v = _hard_layout(rng, kind, {
        "r": ((uh, cr), ("rb",)), "s": ((ch, uh, ug, cs), ("sb", "sc")),
        "t": ((ug, ct), ("tc",))}, d)
    args = (k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"], v["t"])
    got = ops.fused_count3_star(*_t(*args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_star(*_j(*args))))
    # the Pallas kernel in interpret mode
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_star(*_j(*args),
                                               use_kernel=True)))
    if kind == "hot":   # cr x ct x live passes 2^32 and wraps as int32
        live = int(v["s"].sum())
        assert got[0, 0] == np.int64(cr * ct * live).astype(np.int32)


# (hp, gp, uh, ug, fp, Cr, Cs, Ct, kind, key range per column): R cells
# and T rows of distinct b and c; a hot key with 1700 x 1700 x 1500 per
# cell; dead rows and buckets; S buckets of 700 slots; capacities 1, 129
# and 257; T rows of ~160 and ~420 distinct a (the card's bit rows of 8
# words, and its multimap tier past 256 a)
CYCLIC_HARD = [
    ((1, 1, 1, 2, 2, 200, 300, 700), "distinct",
     dict(rb=400, ra=5, sb=400, sc=900, tc=900, ta=5)),
    ((1, 1, 1, 1, 1, 1700, 1700, 1500), "hot",
     dict(rb=1, ra=1, sb=1, sc=1, tc=1, ta=1)),
    ((2, 2, 2, 2, 2, 20, 15, 30), "dead",
     dict(rb=4, ra=4, sb=4, sc=4, tc=4, ta=4)),
    ((1, 1, 2, 1, 2, 10, 700, 40), "long",
     dict(rb=5, ra=5, sb=5, sc=5, tc=5, ta=5)),
    ((2, 1, 3, 1, 2, 1, 129, 257), "unaligned",
     dict(rb=3, ra=3, sb=3, sc=3, tc=3, ta=3)),
    ((1, 1, 1, 2, 1, 100, 200, 400), "a200",
     dict(rb=20, ra=200, sb=20, sc=100, tc=100, ta=200)),
    ((1, 1, 1, 2, 1, 100, 200, 900), "a600",
     dict(rb=20, ra=600, sb=20, sc=100, tc=100, ta=600)),
]


@pytest.mark.parametrize("case", CYCLIC_HARD, ids=lambda c: c[1])
def test_fused_cyclic_pairidx_hard_layouts_match_reference(case):
    (hp, gp, uh, ug, fp, cr, cs, ct), kind, d = case
    rng = np.random.default_rng(400 + cr + cs)
    k, v = _hard_layout(rng, kind, {
        "r": ((hp, gp, uh, ug, cr), ("rb", "ra")),
        "s": ((gp, fp, ug, cs), ("sb", "sc")),
        "t": ((hp, fp, uh, ct), ("tc", "ta"))}, d)
    args = (k["ra"], k["rb"], v["r"], k["sb"], k["sc"], v["s"], k["tc"],
            k["ta"], v["t"])
    got = ops.fused_count3_cyclic(*_t(*args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_cyclic(*_j(*args))))
    # the Pallas pair-index kernel in interpret mode
    np.testing.assert_array_equal(
        got, np.asarray(jops.fused_count3_cyclic(*_j(*args),
                                                 use_kernel=True)))
    if kind == "hot":   # cr x cs x ct passes 2^32 and wraps as int32
        assert got.reshape(-1)[0] == np.int64(cr * cs * ct).astype(np.int32)


def test_lex_sort_pairs_matches_reference():
    rng = np.random.default_rng(8)
    tc = rng.integers(-50, 50, size=(3, 4, 37)).astype(np.int32)
    ta = rng.integers(-(2**31), 2**31 - 1, size=(3, 4, 37),
                      dtype=np.int64).astype(np.int32)
    ta[0, 0, :5] = [-(2**31), 2**31 - 1, 0, -1, 1]
    tv = rng.random((3, 4, 37)) < 0.7
    got = ops.sorted_pair_index(*_t(tc, ta, tv))
    want = jops.sorted_pair_index(*_j(tc, ta, tv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bucket_multiplicity_matches_reference():
    """The port's ``_multiplicity`` (which also takes table rows shared
    along a batch dimension) on aligned rows, against the reference's
    ``_bucket_multiplicity``."""
    rng = np.random.default_rng(4)
    table = rng.integers(0, 7, size=(5, 23)).astype(np.int32)
    probes = rng.integers(0, 9, size=(5, 31)).astype(np.int32)
    np.testing.assert_array_equal(
        ops._multiplicity(*_t(table, probes), (5,)).numpy(),
        np.asarray(jops._bucket_multiplicity(*_j(table, probes))))


def test_cpu_tensors_never_touch_the_cuda_module(monkeypatch):
    """A CPU tensor takes the plain version only: the dispatch rule is the
    device, with no flag and no import of the kernel module."""
    import sys
    monkeypatch.delitem(sys.modules, "repro_torch.kernels.cuda",
                        raising=False)
    rng = np.random.default_rng(1)
    rb, rv = _grid(rng, (1, 2, 8), 4)
    sb, sv = _grid(rng, (1, 1, 2, 8), 4)
    tc, tv = _grid(rng, (1, 8), 4)
    ops.fused_count3_linear(*_t(rb, rv, sb, sb, sv, tc, tv))
    assert "repro_torch.kernels.cuda" not in sys.modules
