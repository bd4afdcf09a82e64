"""Flajolet–Martin / PCSA distinct-count sketches (paper Example 1).

Union is an elementwise bitwise OR of register bitmaps — associative and
commutative, so sketches combine across devices with plain reductions.

Faithful FM/PCSA: K register bitmaps; each key sets bit ρ(hash_k(key))-1 in
bitmap k, where ρ is the position of the lowest set bit of the hash.
Estimate = 2^(mean_k R_k) / φ with R_k = index of the lowest ZERO bit of
bitmap k and φ ≈ 0.77351 (Flajolet–Martin 1985).

Registers are int32 bitmaps, bit-identical to the JAX package's.  The
estimate is the reference's float32 value: the mean of K register indexes,
K a power of two up to 64, is k/64 for an integer k, so it is read from
the table of the 2,049 float32 estimates the reference computes
(``_fm_table``).  Other register counts raise: the reference's XLA exp2
and torch's differ in the last bit for some means, and no caller uses
such a count.  The planner's estimates, and with them the plans, depend
on both.
"""

from __future__ import annotations

import math
import struct

import torch

from repro_torch.core import hashing
from repro_torch.core._fm_table import FM_ESTIMATE_BITS

PHI = 0.77351
N_REGISTERS = 32
# register counts whose mean index the table holds exactly (k / 64)
FM_REGISTER_COUNTS = (1, 2, 4, 8, 16, 32, 64)
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


def empty(n_registers: int = N_REGISTERS, *, device=None) -> torch.Tensor:
    """Zeroed register bitmaps, one int32 per register."""
    return torch.zeros((n_registers,), dtype=torch.int32, device=device)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def bit_index(keys: torch.Tensor, reg: int) -> torch.Tensor:
    """``min(ρ(hash_reg(key)) - 1, 31)``, the bit a key sets in register
    ``reg`` (int64)."""
    rho = hashing.hash_trailing_zeros(keys, reg)   # in [1, 33]
    return torch.clamp(rho.to(torch.int64) - 1, max=31)


def key_bits(keys: torch.Tensor, reg: int) -> torch.Tensor:
    """The bitmap contribution ``1 << (ρ(hash_reg(key)) - 1)`` per key, as
    the int32 with those bits."""
    return _to_int32_bits(torch.ones_like(keys, dtype=torch.int64)
                          << bit_index(keys, reg))


def or_bits(slots: torch.Tensor, n_words: int) -> torch.Tensor:
    """``[n_words]`` int32: word i is the OR of ``1 << (s % 32)`` over the
    slots s with ``s // 32 == i``; slots at or past ``32 * n_words`` are
    left out.  torch has no OR-reduction, so each word is rebuilt from
    which of its 32 bits are present (a ``bincount`` over the slots)."""
    nb = 32 * n_words
    present = torch.bincount(slots, minlength=nb + 1)[:nb] > 0
    weights = torch.ones(32, dtype=torch.int64, device=slots.device)
    weights = weights << torch.arange(32, device=slots.device)
    words = (present.view(n_words, 32).to(torch.int64) * weights).sum(1)
    return _to_int32_bits(words)


def add(registers: torch.Tensor, keys: torch.Tensor,
        valid: torch.Tensor) -> torch.Tensor:
    """Fold a batch of keys into the sketch: register k ORs in
    ``key_bits(key, k)`` of every live key."""
    regs = []
    for i in range(registers.shape[0]):
        bit = bit_index(keys, i)
        regs.append(or_bits(torch.where(valid, bit, 32).reshape(-1), 1))
    return registers | torch.cat(regs).to(registers.device)


def _lowest_zero_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest zero bit of each int32 (32 if none)."""
    y = (~x).to(torch.int64) & 0xFFFFFFFF
    low = y & ((-y) & 0xFFFFFFFF)
    idx = hashing._popcount32((low - 1) & 0xFFFFFFFF)
    return torch.where(y == 0, torch.full_like(idx, 32), idx)


def fm_estimate(registers: torch.Tensor) -> float:
    """Distinct-count estimate ``2^mean(R) / PHI`` from register bitmaps,
    the mean over all of them (a ``[B, K]`` array averages its B * K
    registers, as the reference does), as the reference's float32 value."""
    n = registers.numel()
    if n not in FM_REGISTER_COUNTS:
        raise ValueError(
            f"fm_estimate takes {', '.join(map(str, FM_REGISTER_COUNTS))} "
            f"registers, got {n} (shape {tuple(registers.shape)})")
    total = int(_lowest_zero_index(registers).sum())
    return _FM_ESTIMATES[total * (64 // n)]
