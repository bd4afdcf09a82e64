"""``ops.radix_histogram`` against the JAX package, on the CPU: equal to
``repro``'s ``ops.radix_histogram`` both with ``use_kernel=False`` (the
jnp one-hot sum) and with ``use_kernel=True`` (the Pallas kernel in
interpret mode).  Counts are integers: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops


def _data(n, nb, frac=0.9):
    rng = np.random.default_rng(n + nb)
    keys = rng.integers(0, 10000, size=n).astype(np.int32)
    return keys, rng.random(n) < frac


# the (n, n_buckets) cases of tests/test_kernels.py
@pytest.mark.parametrize("n,nb", [(1024, 16), (2048, 64), (4096, 128),
                                  (1000, 32)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_radix_histogram_matches_repro(n, nb, use_kernel):
    keys, valid = _data(n, nb)
    got = ops.radix_histogram(torch.from_numpy(keys),
                              torch.from_numpy(valid), n_buckets=nb)
    want = jops.radix_histogram(jnp.asarray(keys), jnp.asarray(valid),
                                n_buckets=nb, use_kernel=use_kernel)
    assert got.dtype == torch.int32 and got.shape == (nb,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == int(valid.sum())


def test_radix_histogram_negative_keys_and_no_live_rows():
    keys = np.arange(-500, 500, dtype=np.int32)
    valid = np.ones(1000, bool)
    got = ops.radix_histogram(torch.from_numpy(keys),
                              torch.from_numpy(valid), n_buckets=7)
    want = jops.radix_histogram(jnp.asarray(keys), jnp.asarray(valid),
                                n_buckets=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = ops.radix_histogram(torch.from_numpy(keys),
                               torch.zeros(1000, dtype=torch.bool),
                               n_buckets=7)
    assert not none.any()


def test_radix_histogram_checks_its_stream():
    with pytest.raises(ValueError, match="one"):
        ops.radix_histogram(torch.zeros((2, 3), dtype=torch.int32),
                            torch.ones((2, 3), dtype=torch.bool),
                            n_buckets=4)
