"""Port vs JAX package: the bucket-row linear and per-R ops on the hard
layouts of their Hopper kernels, in both scans' layouts.

The linear scans pass R [1, u, Cr] shared along g, S [gp, u, Cs] and
T [gp, 1, Ct] shared along h; the star scan R [uh, 1, Cr], S [uh, ug,
Cs] and T [1, ug, Ct].  On each, the port's plain versions (what a CPU
tensor takes, and what ``chip_smoke.py`` holds the kernels to on the
card at ``BUCKET_HARD``'s sizes) are held against the reference's jnp
path (``use_kernel=False``) and its Pallas kernels in interpret mode
(``use_kernel=True``) on the same rows copied out to [B, C].  The kinds
are ``BUCKET_HARD``'s at sizes interpret mode runs: rows of distinct keys,
a hot key, dead rows and buckets (whole shared rows among them), long S
rows, capacities 1 and 257, and a shared R row whose slots get different
sums in different g buckets.  Counts are integers: the tolerance is exact
equality.  For "hot" the count of every bucket passes 2^32 and wraps as
int32, which the Pallas kernels' f32 sums cannot hold (the reference
documents counts up to 2^24 for them): there the port is held to the jnp
path and to numpy's int64 count cut to int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops


def _layout(rng, layout, sizes, kind, d):
    """The seven operands of one case, shaped as its scan passes them.
    Keys and validity are made on the distinct rows (R [n, Cr], S [a, b,
    Cs], T [m, Ct]) as ``chip_smoke.hard_layout`` makes them: "distinct"
    R and T rows of distinct keys, 90% live; "hot" every key 7, every slot
    live; "dead" a whole leading row (the shared R row 0, the shared T
    row 0, every bucket of a = 0) and the last slot or bucket of every
    second row dead; "long" / "unaligned" a hot key among uniform keys;
    any other kind uniform keys, 80% live."""
    a, b, cr, cs, ct = sizes
    n_r, n_t = (b, a) if layout == "linear" else (a, b)
    shapes = {"rb": (n_r, cr), "sb": (a, b, cs), "sc": (a, b, cs),
              "tc": (n_t, ct)}
    keys = {}
    for col, shape in shapes.items():
        if kind == "hot":
            k = np.full(shape, 7)
        elif kind == "distinct" and col in ("rb", "tc"):
            k = np.stack([rng.permutation(d)[:shape[-1]]
                          for _ in range(shape[0])])
        else:
            k = rng.integers(0, d, size=shape)
            if kind in ("long", "unaligned"):
                k[rng.random(shape) < 0.3] = 3
        keys[col] = k.astype(np.int32)
    valid = {}
    for side, col in (("r", "rb"), ("s", "sb"), ("t", "tc")):
        v = rng.random(shapes[col]) < {"hot": 1.0, "distinct": 0.9}.get(
            kind, 0.8)
        if kind == "dead":
            v[0, ...] = False
            v[1::2, -1, ...] = False
        valid[side] = v
    if layout == "linear":   # R [1, u] shared along g, T [gp, 1] along h
        r_of, t_of = (lambda x: x[None]), (lambda x: x[:, None])
    else:                    # R [uh, 1] shared along g, T [1, ug] along h
        r_of, t_of = (lambda x: x[:, None]), (lambda x: x[None])
    return (r_of(keys["rb"]), r_of(valid["r"]), keys["sb"], keys["sc"],
            valid["s"], t_of(keys["tc"]), t_of(valid["t"]))


# (scan layout, (gp, u) or (uh, ug), Cr, Cs, Ct, kind, key range)
BUCKET_HARD = [
    ("linear", (2, 3, 300, 40, 600), "distinct", 2000),
    ("star", (2, 2, 500, 60, 700), "distinct", 3000),
    ("linear", (2, 2, 1000, 1000, 5000), "hot", 1),
    ("star", (1, 2, 1000, 1000, 5000), "hot", 1),
    ("linear", (4, 5, 20, 9, 40), "dead", 7),
    ("star", (3, 4, 20, 9, 40), "dead", 7),
    ("linear", (2, 3, 10, 700, 50), "long", 9),
    ("star", (2, 2, 10, 1500, 50), "long", 9),
    ("linear", (3, 5, 1, 129, 257), "unaligned", 3),
    ("star", (3, 2, 257, 130, 1), "unaligned", 3),
    ("linear", (4, 3, 20, 50, 60), "shared_r", 3),
]


def _case(case):
    layout, sizes, kind, d = case
    rng = np.random.default_rng(sum(sizes) + len(kind))
    args = _layout(rng, layout, sizes, kind, d)
    batch = np.broadcast_shapes(*(x.shape[:-1] for x in args[::2]))
    flat = [np.broadcast_to(x, (*batch, x.shape[-1])).reshape(-1, x.shape[-1])
            for x in args]
    return args, batch, flat


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _ids(case):
    return f"{case[0]}-{case[2]}"


@pytest.mark.parametrize("case", BUCKET_HARD, ids=_ids)
def test_bucket_linear_hard_layouts_match_reference(case):
    args, batch, flat = _case(case)
    got = ops.bucket_count3_linear(*_t(args)).numpy()
    assert got.shape == batch
    np.testing.assert_array_equal(
        got.reshape(-1), np.asarray(jops.bucket_count3_linear(*_j(flat))))
    if case[2] == "hot":   # every bucket passes 2^32 and wraps as int32
        _, _, cr, cs, ct = case[1]
        assert cr * cs * ct > 2**32
        assert (got == np.int64(cr * cs * ct).astype(np.int32)).all()
    else:
        np.testing.assert_array_equal(got.reshape(-1), np.asarray(
            jops.bucket_count3_linear(*_j(flat), use_kernel=True)))


@pytest.mark.parametrize("case", BUCKET_HARD, ids=_ids)
def test_bucket_per_r_hard_layouts_match_reference(case):
    """A live R slot's sum over its own bucket, 0 for a dead one."""
    args, batch, flat = _case(case)
    cr = case[1][2]
    got = ops.bucket_per_r_counts(*_t(args)).numpy()
    assert got.shape == (*batch, cr)
    np.testing.assert_array_equal(
        got.reshape(-1, cr), np.asarray(jops.bucket_per_r_counts(*_j(flat))))
    np.testing.assert_array_equal(got.reshape(-1, cr), np.asarray(
        jops.bucket_per_r_counts(*_j(flat), use_kernel=True)))
    rv = np.broadcast_to(args[1], got.shape)
    assert (got[~rv] == 0).all()
    if case[2] == "hot":   # every S slot of the bucket adds all of T
        _, _, _, cs, ct = case[1]
        assert (got == cs * ct).all()
    if case[2] == "shared_r":
        # the linear scans' R row is shared along g: some slot's sum
        # differs between g buckets, so the sums are each bucket's own
        assert (got != got[:1]).any()
