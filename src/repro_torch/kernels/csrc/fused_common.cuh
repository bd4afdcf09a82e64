// Shared device code of the sorted-row join kernels (Hopper, sm_90a):
// binary searches of sorted bucket rows (bound and count_equal, used by
// pair_count.cu) and the per-cell atomic adds of a warp
// (warp_add_by_cell, also used by the fused linear sweep of
// linear_sweep.cuh).  The other join sweeps probe hash tables instead
// (smem_hash.cuh, key_lists.cuh, sweep_common.cuh, cyclic_sweep.cu).
//
// warp_add_by_cell reduces a warp's per-cell sums across its runs of equal
// cells and adds each run with one int32 atomic (int32 sums wrap
// identically in any order, so the value does not depend on it).
// Arithmetic on counts is unsigned 32-bit, which wraps as the reference's
// int32 products and sums do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace rj {

constexpr int kThreads = 256;

// First index of row[0, n) whose entry is >= key (< key: strict = false)
// or > key (strict = true).
template <typename K>
__device__ __forceinline__ long long bound(const K* __restrict__ row,
                                          long long lo, long long n, K key,
                                          bool strict) {
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const K v = __ldg(row + mid);
    if (v < key || (strict && v == key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Occurrences of key in the sorted row[0, n).
__device__ __forceinline__ unsigned count_equal(const int* __restrict__ row,
                                                long long n, int key) {
  const long long lo = bound(row, 0LL, n, key, false);
  if (lo == n || __ldg(row + lo) != key) return 0u;
  return (unsigned)(bound(row, lo + 1, n, key, true) - lo);
}

// Add v to out[cell] for every lane of the warp; a lane with cell < 0 adds
// nothing.  Lanes with the same cell in a contiguous run are summed first
// (a segmented scan over the warp), so a run costs one atomic.  Every lane
// of the warp must call this.
__device__ __forceinline__ void warp_add_by_cell(int* __restrict__ out,
                                                 long long cell, unsigned v) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(full, cell, 1);
  const long long next = __shfl_down_sync(full, cell, 1);
  const bool head = lane == 0 || prev != cell;
  const bool tail = lane == 31 || next != cell;
  const unsigned heads = __ballot_sync(full, head);
  const unsigned upto = lane == 31 ? full : ((2u << lane) - 1u);
  const int start = 31 - __clz(heads & upto);
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(full, x, o);
    if (lane - o >= start) x += y;
  }
  if (tail && cell >= 0 && x != 0u) atomicAdd(reinterpret_cast<unsigned*>(out) + cell, x);
}

}  // namespace rj
