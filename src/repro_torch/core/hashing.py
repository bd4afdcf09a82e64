"""Hash families for radix partitioning (bit-exact with the JAX package).

The paper partitions relations with "robust hash functions" [25] at two
levels: a coarse level (H, G) that sizes partitions to on-chip memory, and a
fine level (h, g, f) that routes tuples to PMUs / streaming buckets.  We use
a Murmur3-style finalizer (full avalanche) seeded per hash function, followed
by a modulo reduction to the bucket count.

Plans, layouts and recovery rounds all depend on these ids, so they must be
bit-exact with the uint32 arithmetic of the reference.  Torch's uint32
operators are not relied on: every value is held in int64 in [0, 2^32),
``>>`` on a non-negative int64 is a logical shift, ``%`` on it is unsigned,
and each multiply is masked back to 32 bits (the low 32 bits of an int64
product are the uint32 product, whatever the wrap above them).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF

# Distinct odd constants per hash-function "name" so H, h, g, f, G are
# independent, mirroring the paper's notation.
_SEEDS = {
    "H": 0x9E3779B1,
    "G": 0x85EBCA77,
    "h": 0xC2B2AE3D,
    "g": 0x27D4EB2F,
    "f": 0x165667B1,
    "salt": 0xB5297A4D,
}


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits as a non-negative int64 in [0, 2^32)."""
    return x.to(torch.int64) & _MASK32


def mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Murmur3 fmix32 with a seed xor; returns int64 in [0, 2^32)."""
    h = _as_u32(x) ^ (seed & _MASK32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    h = h ^ (h >> 16)
    return h


def hash_bucket(keys: torch.Tensor, n_buckets: int, fn: str = "H",
                salt: int = 0) -> torch.Tensor:
    """Map int keys -> bucket ids in [0, n_buckets) with hash family `fn`.

    `salt` re-randomizes the family (used for skew-overflow re-partitioning).
    Returns int32.
    """
    if fn not in _SEEDS:
        raise ValueError(f"unknown hash fn {fn!r}; choose from {sorted(_SEEDS)}")
    seed = (_SEEDS[fn] + 0x9E3779B9 * salt) & _MASK32
    h = mix32(keys, seed)
    return (h % int(n_buckets)).to(torch.int32)


def hash_trailing_zeros(keys: torch.Tensor, reg: int) -> torch.Tensor:
    """rho(hash(key)) for Flajolet-Martin: index of lowest set bit + 1 of a
    mixed hash, per register `reg` (independent family per register).

    Returns int32 in [1, 33]; 33 means hash == 0 (probability 2^-32).
    """
    h = mix32(keys, (0x5851F42D + 0x9E3779B9 * reg) & _MASK32)
    low = h & ((-h) & _MASK32)
    rho = _popcount32((low - 1) & _MASK32) + 1
    return torch.where(h == 0, torch.full_like(rho, 33), rho)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 values in [0, 2^32); returns int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _MASK32) >> 24).to(torch.int32)
