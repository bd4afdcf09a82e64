"""Port vs JAX package: the radix histogram on the hard layouts of its
Hopper kernel.

``ops.radix_histogram`` on the CPU (the plain version, what
``chip_smoke.py`` holds the kernel to on the card at ``RADIX_HARD``'s
sizes) against the reference's ``ops.radix_histogram``: its jnp path
(``use_kernel=False``) everywhere, and its Pallas kernel in interpret mode
(``use_kernel=True``) only where that stays small, a stream of at most
eight 1,024-key tiles and n_buckets <= 16,384 (each tile's one-hot
[1,024, n_buckets] f32 at most 64 MB).  The cases are ``RADIX_HARD``'s
kinds at CPU sizes: n of 1, 3, 4,097 and 2^20 + 5; views starting at
offsets 1-3 into longer streams (the keys' and the validity's at
different offsets too); n_buckets of 1, 12,288, 12,289, 65,536 and
100,003; every key in one bucket, every row dead, negative keys.  The jnp
path compares every key with every bucket, so it is fed in chunks of at
most 2^23 comparisons (the histogram is additive over the stream).
Counts are integers: the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

# (n, n_buckets, kind, key offset, validity offset)
RADIX_HARD = [
    (1, 1, "uniform", 0, 0),
    (1, 100_003, "hot", 1, 1),
    (3, 12_288, "negative", 1, 1),
    (3, 65_536, "dead", 2, 2),
    (4097, 12_288, "hot", 2, 2),
    (4097, 12_289, "uniform", 3, 3),
    (4097, 65_536, "negative", 1, 2),
    (4097, 100_003, "uniform", 0, 3),
    (2**20 + 5, 1, "uniform", 3, 3),
    (2**20 + 5, 1, "dead", 1, 1),
]


def _stream(n, kind, k_off, v_off):
    """keys (n,) int32 and valid (n,) bool, views at their offsets into
    streams of n + 3, as ``chip_smoke.radix_stream`` makes them."""
    rng = np.random.default_rng(n + k_off + 4 * v_off + len(kind))
    lo, hi = {"negative": (-2**31, 0)}.get(kind, (-2**31, 2**31 - 1))
    keys = rng.integers(lo, hi, size=n + 3).astype(np.int32)
    if kind == "hot":
        keys[:] = 7
    valid = rng.random(n + 3) < (0.0 if kind == "dead" else 0.9)
    return keys[k_off:k_off + n], valid[v_off:v_off + n]


def _jnp_histogram(keys, valid, nb):
    """The reference's jnp path over chunks of the stream, each padded to
    one length with dead rows (one compile per n_buckets)."""
    m = max(1, min(len(keys), (1 << 23) // nb))
    out = np.zeros(nb, np.int64)
    for k0 in range(0, len(keys), m):
        k = np.zeros(m, np.int32)
        v = np.zeros(m, bool)
        k[:len(keys[k0:k0 + m])] = keys[k0:k0 + m]
        v[:len(valid[k0:k0 + m])] = valid[k0:k0 + m]
        out += np.asarray(jops.radix_histogram(
            jnp.asarray(k), jnp.asarray(v), n_buckets=nb))
    return out.astype(np.int32)


def _ids(case):
    return f"n{case[0]}-nb{case[1]}-{case[2]}-at{case[3]},{case[4]}"


@pytest.mark.parametrize("case", RADIX_HARD, ids=_ids)
def test_radix_histogram_hard_layouts_match_reference(case):
    n, nb, kind, k_off, v_off = case
    keys, valid = _stream(n, kind, k_off, v_off)
    tk = torch.from_numpy(keys.base)[k_off:k_off + n]
    tv = torch.from_numpy(valid.base)[v_off:v_off + n]
    assert tk.storage_offset() == k_off and tv.storage_offset() == v_off
    got = ops.radix_histogram(tk, tv, n_buckets=nb)
    assert got.dtype == torch.int32 and tuple(got.shape) == (nb,)
    got = got.numpy()
    np.testing.assert_array_equal(got, _jnp_histogram(keys, valid, nb))
    assert int(got.sum()) == int(valid.sum())
    if kind == "hot" and valid.any():
        assert np.count_nonzero(got) == 1
    if n <= 8 * 1024 and nb <= 16_384:
        np.testing.assert_array_equal(got, np.asarray(jops.radix_histogram(
            jnp.asarray(keys), jnp.asarray(valid), n_buckets=nb,
            use_kernel=True)))
