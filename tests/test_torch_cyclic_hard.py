"""Port vs JAX package: the all-pairs triangle ops on the hard layouts of
their Hopper kernel, the pair-index sweep's tables.

``bucket_count3_cyclic`` is held on two layouts: the scan driver's (f, a,
b) grid (R [uh, ug, Cr] shared along f, S [fp, 1, ug, Cs] shared along a,
T [fp, uh, 1, Ct] shared along b, as ``core.cyclic3`` passes one (H, G)
cell) and plain [B, C] rows; ``fused_count3_cyclic(pair_index=False)`` on
the fused grid.  The port's plain versions (what a CPU tensor takes, and
what ``chip_smoke.py`` holds the kernels to on the card at
``CYCLIC_HARD``'s and ``BUCKET_CYCLIC_HARD``'s sizes) are held against the
reference's jnp path (``use_kernel=False``) and its all-pairs Pallas
kernels in interpret mode (``use_kernel=True``), the bucket rows copied
out to [B, C].  The kinds are the card's at sizes interpret mode runs:
R and T rows of distinct keys, a hot key, dead rows (whole shared rows
among them), long S rows, capacities 1 and 257, and T rows of ~200 and
~600 distinct a (the card's 8-word bit rows, and its multimap tier past
256 a).  Counts are integers: the tolerance is exact equality.  For
"hot" every count passes 2^32 and wraps as int32, which the Pallas
kernels' f32 sums cannot hold (exact only to 2^24): there the port is
held to the jnp path and to numpy's int64 count cut to int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

COLS = ("ra", "rb", "sb", "sc", "tc", "ta")


def _hard_layout(rng, kind, shapes, d):
    """Seeded keys and validity of one layout's distinct rows, as
    ``chip_smoke.hard_layout`` makes them: "distinct" R rows of distinct b
    and T rows of distinct c, 90% live; "hot" every key 7 and every slot
    live; "dead" a whole leading row and the last row of every second
    leading index dead on every side; "long" / "unaligned" a hot key among
    uniform keys; any other kind uniform keys, 80% live.  Returns the six
    key columns and the three validity masks, in the op's order."""
    keys, valid = {}, {}
    for side, shape in shapes.items():
        for n, col in enumerate(c for c in COLS if c[0] == side):
            if kind == "hot":
                k = np.full(shape, 7)
            elif kind == "distinct" and col in ("rb", "tc"):
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
    return [keys["ra"], keys["rb"], valid["r"], keys["sb"], keys["sc"],
            valid["s"], keys["tc"], keys["ta"], valid["t"]]


# (layout, sizes, kind, key range per column).  "scan": sizes (fp, uh,
# ug, Cr, Cs, Ct), the (f, a, b) grid of one (H, G) cell; "rows": (B, Cr,
# Cs, Ct).  Hot: 1700 x 1700 x 1500 a bucket, past 2^32.
_D = dict(ra=5, rb=300, sb=300, sc=500, tc=500, ta=5)
_SMALL = dict(ra=4, rb=4, sb=4, sc=4, tc=4, ta=4)
_LONG = dict(ra=5, rb=5, sb=5, sc=5, tc=5, ta=5)
_UNAL = dict(ra=3, rb=3, sb=3, sc=3, tc=3, ta=3)
_A200 = dict(ra=200, rb=20, sb=20, sc=100, tc=100, ta=200)
_A600 = dict(ra=600, rb=20, sb=20, sc=100, tc=100, ta=600)
BUCKET_CYCLIC_HARD = [
    ("scan", (2, 2, 2, 60, 80, 120), "distinct", _D),
    ("rows", (3, 60, 80, 120), "distinct", _D),
    ("scan", (1, 1, 2, 1700, 1700, 1500), "hot", _D),
    ("rows", (2, 1700, 1700, 1500), "hot", _D),
    ("scan", (3, 2, 3, 20, 15, 30), "dead", _SMALL),
    ("rows", (6, 20, 15, 30), "dead", _SMALL),
    ("scan", (2, 2, 1, 10, 700, 40), "long", _LONG),
    ("rows", (3, 10, 700, 40), "long", _LONG),
    ("scan", (2, 3, 1, 1, 129, 257), "unaligned", _UNAL),
    ("rows", (4, 257, 1, 129), "unaligned", _UNAL),
    ("scan", (1, 1, 2, 100, 200, 400), "a200", _A200),
    ("scan", (1, 1, 2, 100, 200, 900), "a600", _A600),
    ("rows", (2, 100, 200, 900), "a600", _A600),
]


def _bucket_case(case):
    """The op's nine operands as the layout passes them (shared rows with
    their size-1 dimension) and the same rows broadcast to [B, C]."""
    layout, sizes, kind, d = case
    rng = np.random.default_rng(500 + sum(sizes) + len(kind))
    if layout == "scan":
        fp, uh, ug, cr, cs, ct = sizes
        a = _hard_layout(rng, kind, {"r": (uh, ug, cr), "s": (fp, ug, cs),
                                     "t": (fp, uh, ct)}, d)
        # S [fp, 1, ug] shared along a, T [fp, uh, 1] shared along b
        a[3:6] = [x[:, None] for x in a[3:6]]
        a[6:9] = [x[:, :, None] for x in a[6:9]]
        batch = (fp, uh, ug)
    else:
        b, cr, cs, ct = sizes
        a = _hard_layout(rng, kind, {"r": (b, cr), "s": (b, cs),
                                     "t": (b, ct)}, d)
        batch = (b,)
    flat = [np.broadcast_to(x, (*batch, x.shape[-1])).reshape(-1, x.shape[-1])
            for x in a]
    return a, batch, flat


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _j(arrays):
    return [jnp.asarray(x) for x in arrays]


def _wrapped_hot_count(cr, cs, ct):
    assert cr * cs * ct > 2**32
    return np.int64(cr * cs * ct).astype(np.int32)


@pytest.mark.parametrize("case", BUCKET_CYCLIC_HARD,
                         ids=lambda c: f"{c[0]}-{c[2]}")
def test_bucket_cyclic_hard_layouts_match_reference(case):
    args, batch, flat = _bucket_case(case)
    got = ops.bucket_count3_cyclic(*_t(args)).numpy()
    assert got.shape == batch
    np.testing.assert_array_equal(
        got.reshape(-1), np.asarray(jops.bucket_count3_cyclic(*_j(flat))))
    if case[2] == "hot":   # every bucket passes 2^32 and wraps as int32
        assert (got == _wrapped_hot_count(*case[1][-3:])).all()
    else:
        np.testing.assert_array_equal(got.reshape(-1), np.asarray(
            jops.bucket_count3_cyclic(*_j(flat), use_kernel=True)))
    if case[2] == "dead":
        # the scan's R row (a = 0, b) is shared along f, S (f = 0) along a
        # and T (f = 0) along b; plain rows: bucket 0 dead on every side
        if case[0] == "scan":
            assert (got[:, 0, :] == 0).all() and (got[0] == 0).all()
        else:
            assert got[0] == 0
    assert int(np.abs(got.astype(np.int64)).sum()) > 0


# (hp, gp, uh, ug, fp, Cr, Cs, Ct, kind, key range per column): the fused
# grid on the same kinds (hot: 1700 x 1700 x 1500 a cell)
FUSED_CYCLIC_HARD = [
    ((1, 1, 1, 2, 2, 60, 80, 120), "distinct", _D),
    ((1, 1, 1, 1, 1, 1700, 1700, 1500), "hot", _D),
    ((3, 3, 2, 2, 3, 20, 15, 30), "dead", _SMALL),
    ((1, 1, 2, 1, 2, 10, 700, 40), "long", _LONG),
    ((2, 1, 3, 1, 2, 1, 129, 257), "unaligned", _UNAL),
    ((1, 1, 1, 2, 1, 100, 200, 400), "a200", _A200),
    ((1, 1, 1, 2, 1, 100, 200, 900), "a600", _A600),
]


@pytest.mark.parametrize("case", FUSED_CYCLIC_HARD, ids=lambda c: c[1])
def test_fused_all_pairs_cyclic_hard_layouts_match_reference(case):
    (hp, gp, uh, ug, fp, cr, cs, ct), kind, d = case
    rng = np.random.default_rng(600 + cr + cs)
    args = _hard_layout(rng, kind, {"r": (hp, gp, uh, ug, cr),
                                    "s": (gp, fp, ug, cs),
                                    "t": (hp, fp, uh, ct)}, d)
    got = ops.fused_count3_cyclic(*_t(args), pair_index=False).numpy()
    assert got.shape == (hp, gp, uh, ug)
    np.testing.assert_array_equal(got, np.asarray(
        jops.fused_count3_cyclic(*_j(args), pair_index=False)))
    if kind == "hot":   # one cell, one f: cr x cs x ct wraps as int32
        assert got.reshape(-1)[0] == _wrapped_hot_count(cr, cs, ct)
    else:   # the all-pairs Pallas kernel in interpret mode
        np.testing.assert_array_equal(got, np.asarray(
            jops.fused_count3_cyclic(*_j(args), pair_index=False,
                                     use_kernel=True)))
    assert int(np.abs(got.astype(np.int64)).sum()) > 0
