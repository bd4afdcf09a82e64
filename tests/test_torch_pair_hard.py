"""Port vs JAX package: the bucket-row pair count on the hard layouts of its
Hopper kernel.

``ops.bucket_pair_count`` on the CPU (the plain version, what
``chip_smoke.py`` holds the kernel to on the card at ``PAIR_HARD``'s
sizes) against the reference's jnp path (``use_kernel=False``) and its
Pallas ``pair_count`` in interpret mode (``use_kernel=True``), on the
rows copied out to [B, C].  The kinds are ``PAIR_HARD``'s at sizes
interpret mode runs: rows of distinct keys, B6-like rows (~4 keys
repeated ~250 times, 20% live), a hot key, dead rows and buckets,
capacities 1, 257 and 4,099 with Ca != Cb, rows shared along size-1
batch dimensions, and keys just above the sentinels.  Counts are
integers: the tolerance is exact equality.

The hot key's count passes 2^32 (65,537 x 65,537 live slots of one key)
and wraps as int32.  The Pallas kernel's f32 sums are exact only to 2^24
and the jnp path materializes a [B, Ca, Cb] comparison, so the port is
held there to numpy's int64 count cut to int32 and to the jnp path summed
over chunks of ka (the count is additive over ka's slots; int32 sums wrap
alike).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

SENT_BASE = ops.SENT_BASE

# (kind, ka batch, kb batch, Ca, Cb, key range)
PAIR_HARD = [
    ("distinct", (2,), (2,), 3000, 2600, 4000),
    ("b6", (3,), (3,), 4896, 4896, 4),
    ("dead", (6, 5), (6, 5), 40, 33, 13),
    ("uniform", (7,), (7,), 1, 257, 3),
    ("uniform", (3,), (3,), 4099, 257, 50),
    ("uniform", (2,), (2,), 257, 4099, 50),
    ("uniform", (3, 1), (1, 4), 500, 300, 50),
    ("uniform", (1,), (5,), 700, 900, 60),
    ("sentinel", (4,), (4,), 300, 200, 6),
]


def _layout(rng, kind, ba, bb, ca, cb, d):
    """(ka, va, kb, vb) as ``chip_smoke.pair_layout`` makes them."""
    out = []
    for batch, c in ((ba, ca), (bb, cb)):
        shape = (*batch, c)
        if kind == "hot":
            keys = np.full(shape, 7)
        elif kind == "distinct":
            keys = np.stack([rng.permutation(d)[:c]
                             for _ in range(int(np.prod(batch)))])
            keys = keys.reshape(shape)
        else:
            keys = rng.integers(0, d, size=shape)
            if kind == "sentinel":
                keys = keys + SENT_BASE + 6
        valid = rng.random(shape) < {"hot": 1.0, "distinct": 0.9,
                                     "b6": 0.2}.get(kind, 0.8)
        if kind == "dead":
            valid[0] = False
            valid[1::2, -1] = False
        out += [keys.astype(np.int32), valid]
    return out


def _flat(args):
    """The four operands broadcast to the common batch, [B, C] each."""
    batch = np.broadcast_shapes(args[0].shape[:-1], args[2].shape[:-1])
    return batch, [np.broadcast_to(x, (*batch, x.shape[-1]))
                   .reshape(-1, x.shape[-1]) for x in args]


def _ids(case):
    return f"{case[0]}-{case[3]}x{case[4]}-{len(case[1])}d"


@pytest.mark.parametrize("case", PAIR_HARD, ids=_ids)
def test_pair_count_hard_layouts_match_reference(case):
    rng = np.random.default_rng(sum(case[3:]) + len(case[0]))
    args = _layout(rng, *case)
    batch, flat = _flat(args)
    got = ops.bucket_pair_count(*(torch.from_numpy(x) for x in args))
    assert got.dtype == torch.int32 and tuple(got.shape) == batch
    got = got.numpy().reshape(-1)
    j = [jnp.asarray(x) for x in flat]
    np.testing.assert_array_equal(got, np.asarray(jops.bucket_pair_count(*j)))
    np.testing.assert_array_equal(got, np.asarray(
        jops.bucket_pair_count(*j, use_kernel=True)))
    if case[0] == "dead":
        assert (got.reshape(batch)[0] == 0).all()
    if case[0] == "sentinel":   # the keys sit just above every sentinel
        assert flat[0].min() > max(ops._SENT.values())


def test_pair_count_hot_key_wraps_int32():
    c = 65_537   # c * c = 2^32 + 131,073 equal pairs in one bucket
    rng = np.random.default_rng(5)
    ka, va, kb, vb = _layout(rng, "hot", (1,), (1,), c, c, 1)
    got = ops.bucket_pair_count(*(torch.from_numpy(x)
                                  for x in (ka, va, kb, vb))).numpy()
    assert c * c > 2**32
    np.testing.assert_array_equal(got, [np.int64(c * c).astype(np.int32)])
    chunk = 1024
    want = np.int32(0)
    for k0 in range(0, c, chunk):   # int32 adds wrap as the count does
        part = jops.bucket_pair_count(
            *(jnp.asarray(x[:, k0:k0 + chunk]) for x in (ka, va)),
            jnp.asarray(kb), jnp.asarray(vb))
        want = (np.int64(want) + np.int64(part[0])).astype(np.int32)
    np.testing.assert_array_equal(got, [want])
