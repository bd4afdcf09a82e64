// Shared device code of the fused linear sweep (linear_sweep.cuh): the
// per-cell atomic adds of a warp (warp_add_by_cell).  The join sweeps
// probe hash tables (smem_hash.cuh, key_lists.cuh, sweep_common.cuh,
// cyclic_sweep.cu); no kernel binary-searches a sorted row any more.
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
