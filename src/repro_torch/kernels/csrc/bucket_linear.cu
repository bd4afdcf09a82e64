// bucket_count3_linear on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:87
// count3_linear (_count3_linear_kernel, :76): per bucket row,
//     out[bucket] = Σ over S slots s of the bucket of
//                   #{R slots with b == s.b} * #{T slots with c == s.c}.
// The Pallas grid has one program per bucket row, and the scan driver
// (core/linear3.py) launched it once per (H, g) step with the T row
// broadcast to all u buckets: 60,025 launches at 4e6 rows and
// m_budget = 16384, each reading a broadcast T row of 40,824 slots per
// bucket.
//
// Here the bucket rows are a batch of up to three dimensions [P, Q, W],
// and an R or T operand of size 1 along a dimension is one row shared
// across it (the wrapper passes which dimensions each spans as a bit mask).
// So the scan driver launches once per H partition with the g loop as the
// batch (the T rows addressed by their g index, never copied per bucket),
// and the wrapper sorts each distinct R and T row once per launch.  The
// device code is the fused sweep's (sweep3_kernel, fused_common.cuh): one
// thread per S slot finds wr and wt by binary searches of its sorted R and
// T rows and adds wr * wt to its bucket, one atomic per run of a warp's
// slots in one bucket.
// Bound: the bytes of the S rows, read once; the searches take about
// 2 log2(C) loads per live S slot from L1 and L2.
#include "fused_common.cuh"

extern "C" int rj_bucket_linear(const int* r_sorted, const int* sb,
                                const int* sc, const int* t_sorted,
                                int dead_s, long long P, long long Q,
                                long long W, long long cr, long long cs,
                                long long ct, int r_mask, int t_mask,
                                int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // S [P, Q, W, Cs] spans every batch dimension; out [P, Q, W]
  err = rj::launch_sweep3(sb, sc, dead_s, r_sorted, cr, r_mask, t_sorted, ct,
                          t_mask, P, Q, W, cs, /*cell*/ 0b111, out,
                          static_cast<cudaStream_t>(stream));
  return (int)err;
}
