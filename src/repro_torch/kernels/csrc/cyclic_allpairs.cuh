// Device code of the all-pairs triangle kernels (Hopper, sm_90a), shared
// by bucket_cyclic.cu (the bucket-row grid of the scan driver) and
// fused_cyclic.cu (the fused (i, j, a, b, f) sweep).
//
// Both TPU kernels compute, per bucket triple, Σ (M1ᵀ·M2) ⊙ M3 over the
// 0/1 equality matrices M1[s, r] = [s.b == r.b], M2[s, t] = [s.c == t.c],
// M3[r, t] = [r.a == t.a]: two f32 matrix products on the MXU, Cr·Cs·Ct
// multiply-adds per bucket (7.8e12 over the sweep at 1e5 edges, 3.6e15 at
// 4e6).  No simple kernel finishes that, and an f32 sum is exact only to
// 2^24.  The count is the same read row by row of M1ᵀ·M2:
//     count = Σ_r Σ_{s : s.b == r.b} Σ_{t : t.a == r.a} [s.c == t.c],
// for each R slot a merge join, on c, of the S entries with b == r.b and
// the T entries with a == r.a.  The wrapper sorts each distinct S row by
// the packed key (b << 32) + (c - INT32_MIN) and each distinct T row by
// (a << 32) + (c - INT32_MIN), so both runs are contiguous and ordered by
// c.  One thread per (R slot, batch element): two binary searches find
// the S run and two the T run, then one pass over both counts the equal-c
// pairs (run length times run length per c).  Work per R slot is about
// 4 log2(C) loads plus |S run| + |T run| steps, instead of Cs·Ct.
//
// The batch has up to kMaxDims dimensions; every operand is addressed by
// one row stride per dimension (0 where its row is shared along it), so
// the same body runs the bucket-row grid with broadcast S and T rows and
// the fused grid whose S rows ignore i and a and T rows ignore j and b.
// Per-cell sums are int32 (unsigned, wrapping like the reference's
// int32), reduced over a warp's run of equal cells and added with one
// atomic (warp_add_by_cell).  Dead slots hold their side's sentinel and
// match nothing; a dead R slot exits after one load.
#pragma once

#include "fused_common.cuh"

namespace rj {

constexpr int kMaxDims = 5;

struct RowGrid {
  int nd;
  long long dims[kMaxDims];
  long long r[kMaxDims], s[kMaxDims], t[kMaxDims], o[kMaxDims];  // row strides
};

// (x << 32) + (y - INT32_MIN): signed int64 order is the (x, then y) order.
__device__ __forceinline__ long long pack_key(int x, int y) {
  return (long long)(((unsigned long long)(unsigned)x << 32) |
                     (unsigned long long)((unsigned)y ^ 0x80000000u));
}

// Σ over equal low words of the two sorted runs of (run length x run length).
__device__ __forceinline__ unsigned merge_count(const long long* __restrict__ x,
                                                long long xi, long long xn,
                                                const long long* __restrict__ y,
                                                long long yi, long long yn) {
  unsigned acc = 0u;
  while (xi < xn && yi < yn) {
    const unsigned a = (unsigned)__ldg(x + xi);
    const unsigned b = (unsigned)__ldg(y + yi);
    if (a < b) {
      ++xi;
    } else if (b < a) {
      ++yi;
    } else {
      long long xe = xi + 1, ye = yi + 1;
      while (xe < xn && (unsigned)__ldg(x + xe) == a) ++xe;
      while (ye < yn && (unsigned)__ldg(y + ye) == a) ++ye;
      acc += (unsigned)(xe - xi) * (unsigned)(ye - yi);
      xi = xe;
      yi = ye;
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
cyclic_merge_kernel(const int* __restrict__ ra, const int* __restrict__ rb,
                    const long long* __restrict__ skey,
                    const long long* __restrict__ tkey, int dead_r, RowGrid g,
                    long long cr, long long cs, long long ct, long long n_items,
                    int* __restrict__ out) {
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long cell = -1;
  unsigned v = 0u;
  if (item < n_items) {
    long long rest = item / cr;
    long long r_row = 0, s_row = 0, t_row = 0, o_row = 0;
    for (int d = g.nd - 1; d >= 0; --d) {
      const long long c = rest % g.dims[d];
      rest /= g.dims[d];
      r_row += c * g.r[d];
      s_row += c * g.s[d];
      t_row += c * g.t[d];
      o_row += c * g.o[d];
    }
    const long long slot = r_row * cr + item % cr;
    const int b = rb[slot];
    if (b != dead_r) {
      cell = o_row;
      const long long* s = skey + s_row * cs;
      const long long s_lo = bound(s, 0LL, cs, pack_key(b, (int)0x80000000), false);
      const long long s_hi = bound(s, s_lo, cs, pack_key(b, 0x7fffffff), true);
      if (s_lo < s_hi) {
        const int a = ra[slot];
        const long long* t = tkey + t_row * ct;
        const long long t_lo = bound(t, 0LL, ct, pack_key(a, (int)0x80000000), false);
        const long long t_hi = bound(t, t_lo, ct, pack_key(a, 0x7fffffff), true);
        v = merge_count(s, s_lo, s_hi, t, t_lo, t_hi);
      }
    }
  }
  warp_add_by_cell(out, cell, v);
}

// Launch one thread per (R slot, batch element).  dims/r/s/t/o are host
// arrays of nd entries (row strides of R, S, T and the output per batch
// dimension).
inline cudaError_t launch_cyclic_merge(const int* ra, const int* rb,
                                       const long long* skey,
                                       const long long* tkey, int dead_r,
                                       int nd, const long long* dims,
                                       const long long* r, const long long* s,
                                       const long long* t, const long long* o,
                                       long long cr, long long cs,
                                       long long ct, int* out, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nd < 1 || nd > kMaxDims) return cudaErrorInvalidValue;
  RowGrid g;
  g.nd = nd;
  long long n = cr;
  for (int d = 0; d < nd; ++d) {
    g.dims[d] = dims[d];
    g.r[d] = r[d];
    g.s[d] = s[d];
    g.t[d] = t[d];
    g.o[d] = o[d];
    n *= dims[d];
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cyclic_merge_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      ra, rb, skey, tkey, dead_r, g, cr, cs, ct, n, out);
  return cudaGetLastError();
}

}  // namespace rj
