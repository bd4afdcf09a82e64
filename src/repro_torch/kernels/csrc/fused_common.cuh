// Shared device code of the sorted-row join kernels (Hopper, sm_90a):
// binary searches of sorted bucket rows (bound, count_equal), the per-cell
// atomic adds of a warp (warp_add_by_cell, also used by the linear sweep
// of linear_sweep.cuh), and sweep3_kernel, the bucket-row linear count of
// the scan-driver baselines (bucket_linear.cu).  The fused sweeps of the
// session's path probe hash tables instead (smem_hash.cuh, key_lists.cuh).
//
// sweep3_kernel streams a slot grid S [P, Q, W, cs] (row-major, int32
// keys, invalid slots carry the S-side sentinel).  Subsets of its three
// outer dimensions select the R bucket and the T bucket a slot probes,
// and the output cell it adds to.  The R and T bucket rows arrive sorted
// (the wrapper sorts each row once; a dead slot holds its side's sentinel,
// which sorts first and equals no key).  So the multiplicity of a key in
// its bucket is the distance between two binary searches of the row:
// about 2*log2(C) dependent loads per live S slot instead of C compares.
// One thread takes one S slot; the slots of a warp probe the same few
// rows, so the top levels of their searches are shared and served from
// L1, and a whole row set stays in the 50 MB L2.  A dead S slot costs its
// two loads and nothing else.  The per-cell sums are reduced across the
// warp's runs of equal cells and added with one int32 atomic per run
// (int32 sums wrap identically in any order, so the value does not depend
// on it).  The bound is the bytes: the S grid is read once (most of the
// traffic), the sorted rows mostly from cache.
//
// Arithmetic on counts is unsigned 32-bit, which wraps as the reference's
// int32 products and sums do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace rj {

constexpr int kThreads = 256;

struct SlotGrid {
  long long dims[3];  // P, Q, W
  long long cs;       // innermost slot dimension
};

// Outer coordinates of slot s of the grid.
__device__ __forceinline__ void slot_coords(const SlotGrid& g, long long s,
                                            long long c[3]) {
  s /= g.cs;
  c[2] = s % g.dims[2];
  s /= g.dims[2];
  c[1] = s % g.dims[1];
  c[0] = s / g.dims[1];
}

// Row-major index over the outer dimensions whose bit is set in mask.
__device__ __forceinline__ long long masked_index(const SlotGrid& g,
                                                  const long long c[3],
                                                  int mask) {
  long long r = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if ((mask >> d) & 1) r = r * g.dims[d] + c[d];
  return r;
}

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

// out_cell[cell(s)] += #{R row of s: b == sb[s]} * #{T row of s: c == sc[s]}
// for every live S slot s.
__global__ void __launch_bounds__(kThreads)
sweep3_kernel(const int* __restrict__ sb, const int* __restrict__ sc,
              int dead_key, const int* __restrict__ r_sorted, long long cr,
              int r_mask, const int* __restrict__ t_sorted, long long ct,
              int t_mask, SlotGrid g, int cell_mask, long long n_slots,
              int* __restrict__ out_cell) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long cell = -1;
  unsigned v = 0u;
  if (s < n_slots) {
    const int c = sc[s];
    if (c != dead_key) {
      long long co[3];
      slot_coords(g, s, co);
      cell = masked_index(g, co, cell_mask);
      const unsigned wt =
          count_equal(t_sorted + masked_index(g, co, t_mask) * ct, ct, c);
      if (wt != 0u)
        v = wt * count_equal(r_sorted + masked_index(g, co, r_mask) * cr, cr,
                             sb[s]);
    }
  }
  warp_add_by_cell(out_cell, cell, v);
}

// Launch sweep3_kernel over every slot of the S grid [P, Q, W, cs].
inline cudaError_t launch_sweep3(const int* sb, const int* sc, int dead_key,
                                 const int* r_sorted, long long cr,
                                 int r_mask, const int* t_sorted,
                                 long long ct, int t_mask, long long P,
                                 long long Q, long long W, long long cs,
                                 int cell_mask, int* out_cell,
                                 cudaStream_t stream) {
  SlotGrid g;
  g.dims[0] = P;
  g.dims[1] = Q;
  g.dims[2] = W;
  g.cs = cs;
  const long long n = P * Q * W * cs;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sweep3_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      sb, sc, dead_key, r_sorted, cr, r_mask, t_sorted, ct, t_mask, g,
      cell_mask, n, out_cell);
  return cudaGetLastError();
}

}  // namespace rj
