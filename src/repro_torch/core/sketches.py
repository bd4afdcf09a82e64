"""Flajolet–Martin / PCSA distinct-count sketches (paper Example 1).

Union is an elementwise bitwise OR of register bitmaps — associative and
commutative, so sketches combine across devices with plain reductions.

Faithful FM/PCSA: K register bitmaps; each key sets bit ρ(hash_k(key))-1 in
bitmap k, where ρ is the position of the lowest set bit of the hash.
Estimate = 2^(mean_k R_k) / φ with R_k = index of the lowest ZERO bit of
bitmap k and φ ≈ 0.77351 (Flajolet–Martin 1985).

Registers are int32 bitmaps, bit-identical to the JAX package's.  The
estimate is the reference's float32 value: the mean of 32 register
indexes is k/32 for an integer k, so it is read from the table of the
1,025 float32 estimates the reference computes (``_fm_table``).  The
planner's estimates, and with them the plans, depend on both.
"""

from __future__ import annotations

import math
import struct

import torch

from repro_torch.core import hashing
from repro_torch.core._fm_table import FM_ESTIMATE_BITS

PHI = 0.77351
N_REGISTERS = 32
_FM_ESTIMATES = struct.unpack(f"<{len(FM_ESTIMATE_BITS)}f",
                              struct.pack(f"<{len(FM_ESTIMATE_BITS)}I",
                                          *FM_ESTIMATE_BITS))


def card_bucket(n: int, *, per_octave: int = 1) -> int:
    """Log-bucketed cardinality estimate for plan-cache keys:
    ``round(log2(n) * per_octave)``.  A ±5% refresh of a served relation
    (away from a bucket boundary) maps to the same bucket and HITS; a 4x
    resize always moves ≥ ``2 * per_octave`` buckets and re-plans."""
    n = int(n)
    if n <= 0:
        return -1
    return int(round(math.log2(n) * per_octave))


def empty(*, device=None) -> torch.Tensor:
    """Zeroed register bitmaps, one int32 per register."""
    return torch.zeros((N_REGISTERS,), dtype=torch.int32, device=device)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def add(registers: torch.Tensor, keys: torch.Tensor,
        valid: torch.Tensor) -> torch.Tensor:
    """Fold a batch of keys into the sketch.

    Register k is the OR of ``1 << min(ρ_k(key) - 1, 31)`` over the live
    keys; torch has no OR-reduction, so the register is rebuilt from which
    of its 32 bits are present (a ``bincount`` over the bit positions)."""
    weights = torch.ones(32, dtype=torch.int64, device=keys.device)
    weights = weights << torch.arange(32, device=keys.device)
    regs = []
    for i in range(registers.shape[0]):
        rho = hashing.hash_trailing_zeros(keys, i)
        bit = torch.clamp(rho.to(torch.int64) - 1, max=31)
        bit = torch.where(valid, bit, torch.full_like(bit, 32))
        present = torch.bincount(bit, minlength=33)[:32] > 0
        regs.append((present.to(torch.int64) * weights).sum())
    new = _to_int32_bits(torch.stack(regs).to(registers.device))
    return registers | new


def _lowest_zero_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest zero bit of each int32 (32 if none)."""
    y = (~x).to(torch.int64) & 0xFFFFFFFF
    low = y & ((-y) & 0xFFFFFFFF)
    idx = hashing._popcount32((low - 1) & 0xFFFFFFFF)
    return torch.where(y == 0, torch.full_like(idx, 32), idx)


def fm_estimate(registers: torch.Tensor) -> float:
    """Distinct-count estimate ``2^mean(R) / PHI`` from the 32 register
    bitmaps, as the reference's float32 value."""
    if registers.shape != (N_REGISTERS,):
        raise ValueError(f"expected {N_REGISTERS} registers, got "
                         f"{tuple(registers.shape)}")
    return _FM_ESTIMATES[int(_lowest_zero_index(registers).sum())]
