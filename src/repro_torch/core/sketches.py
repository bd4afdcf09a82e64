"""Flajolet–Martin / PCSA distinct-count sketches (paper Example 1).

Union is an elementwise bitwise OR of register bitmaps — associative and
commutative, so sketches combine across devices with plain reductions.

Faithful FM/PCSA: K register bitmaps; each key sets bit ρ(hash_k(key))-1 in
bitmap k, where ρ is the position of the lowest set bit of the hash.
Estimate = 2^(mean_k R_k) / φ with R_k = index of the lowest ZERO bit of
bitmap k and φ ≈ 0.77351 (Flajolet–Martin 1985).

Registers are int32 bitmaps, bit-identical to the JAX package's.  The
estimate is the reference's float32 value, ``exp2(mean(R)) / PHI`` as its
eager ops compute it on the CPU, for any register count K.  The same
float32 steps are computed here, in the reference's order: XLA turns the
mean's division by K into a product with the float32 ``1/K``, lowers
``exp2(x)`` to ``exp(x * f32(ln 2))``, and evaluates the float32 ``exp``
by the Cephes range reduction and polynomial with fused multiply-adds
(``_xla_exp``); the division by PHI is rounded once.  Each step is a
float32 operation on a tensor, a fused one emulated through float64
(``_fma32``), so the estimate is the reference's bit for bit.  The
planner's estimates, and with them the plans, depend on it.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import hashing

PHI = 0.77351
N_REGISTERS = 32
# XLA's float32 exp on the CPU (its Cephes constants): the input's clamp,
# log2(e), ln 2 in two parts, the polynomial's coefficients
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


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


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sketch union (distributive over any sharding of the data)."""
    return a | b


def _lowest_zero_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest zero bit of each int32 (32 if none)."""
    y = (~x).to(torch.int64) & 0xFFFFFFFF
    low = y & ((-y) & 0xFFFFFFFF)
    idx = hashing._popcount32((low - 1) & 0xFFFFFFFF)
    return torch.where(y == 0, torch.full_like(idx, 32), idx)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64, and the float64
    sum is rounded to odd (its error from a TwoSum moves an even result
    one step toward the exact value), which the cast to float32 then
    rounds as the fused operation does."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32).double()
               for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf),
                                             err))
    return torch.where((err != 0) & even, step, s).float()


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` on the CPU, step by step: ``n = floor(x log2 e
    + 1/2)`` clamped to [-127, 127], ``a = x - n ln 2`` in two parts, a
    degree-7 polynomial of ``a`` in Horner form, times ``2^n``; every
    multiply-add fused, as the CPU compiler contracts them."""
    x = x.clamp(_f32(_EXP_LO), _f32(_EXP_HI))
    n = torch.floor(_fma32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = _fma32(-_LN2_HI, n, x)
    a = _fma32(-_LN2_LO, n, a)
    z = _fma32(a, _EXP_POLY[0], _EXP_POLY[1])
    for coef in _EXP_POLY[2:]:
        z = _fma32(z, a, coef)
    z = _f32(1.0) + _fma32(z, a * a, a)
    return z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def _estimates(totals: torch.Tensor, n_registers: int) -> torch.Tensor:
    """float32 FM estimates of ``n_registers`` registers whose lowest-zero
    indexes sum to each of ``totals`` (integers below 2^24), in the
    reference's float32 steps.  On the CPU."""
    totals = torch.as_tensor(totals, dtype=torch.int64).cpu()
    mean = totals.float() * (_f32(1.0) / n_registers)
    return _xla_exp(mean * _f32(math.log(2))) / _f32(PHI)


@functools.lru_cache(maxsize=1024)
def _estimate(total: int, n_registers: int) -> float:
    """``_estimates`` of one sum, remembered: the planner asks again for
    the columns it has sketched."""
    return float(_estimates(torch.tensor([total]), n_registers)[0])


def fm_estimate(registers: torch.Tensor) -> float:
    """Distinct-count estimate ``2^mean(R) / PHI`` from register bitmaps,
    the mean over all of them (a ``[B, K]`` array averages its B * K
    registers, as the reference does), as the reference's float32 value
    (``_estimates``)."""
    total = int(_lowest_zero_index(registers).sum())
    return _estimate(total, registers.numel())
