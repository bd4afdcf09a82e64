// bucket_count3_linear on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:87
// count3_linear (_count3_linear_kernel, :76): per bucket row,
//     out[bucket] = Σ over S slots s of the bucket of
//                   #{R slots with b == s.b} * #{T slots with c == s.c}.
// The Pallas grid has one program per bucket row, and the scan driver
// (core/linear3.py) launched it once per (H, g) step with the T row
// broadcast to all u buckets: 60,025 launches at 4e6 rows and
// m_budget = 16384, each comparing a broadcast T row of 40,824 slots with
// every S slot of every bucket.
//
// Here the bucket rows are a batch of up to three dimensions [P, Q, W] in
// which an R or T operand of size 1 along a dimension is one row shared
// across it, so the scans launch once per H partition (linear: the
// g loop as the batch) or per S chunk (star), and nothing is copied per
// bucket.  The count form of bucket_sweep.cuh: a (key, count) list per
// distinct R and T row, and hash tables probed once per live S slot, in
// shared memory where they fit; S rows of B2's length take the fused star
// sweep's split sweep.  Nothing is sorted or masked.
// Bound: the bytes, the probed rows and the S rows read once.
#include "bucket_sweep.cuh"

// Scratch from the caller as rj::bucket_sweep takes it; out [P, Q, W] int32
// (uninitialised: zeroed here).
extern "C" int rj_bucket_linear(const int* rb, const unsigned char* rv,
                                const int* sb, const int* sc,
                                const unsigned char* sv, const int* tc,
                                const unsigned char* tv, long long P,
                                long long Q, long long W, long long cr,
                                long long cs, long long ct, int r_mask,
                                int t_mask, int* lens, void* lists,
                                void* tabs, int* out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)rj::bucket_sweep<false>(
      rb, rv, sb, sc, sv, tc, tv, P, Q, W, cr, cs, ct, r_mask, t_mask, lens,
      static_cast<int2*>(lists), static_cast<int2*>(tabs), out, device,
      static_cast<cudaStream_t>(stream));
}
