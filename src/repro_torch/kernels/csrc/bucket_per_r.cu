// bucket_per_r_counts on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:124
// per_r_counts (_per_r_kernel, :111): per R slot i of a bucket row,
//     out[bucket, i] = Σ over S slots s of the bucket with s.b == r_i.b of
//                      wt(s),  wt(s) = #{T slots of the bucket with c == s.c}.
// The Pallas body is a per-bucket f32 dot (1, Cs) @ (Cs, Cr); here
// everything is int32.
//
// The bucket rows are a batch [P, Q, W] in which an R or T operand may be
// one row shared along a dimension (bit masks, as in bucket_linear.cu), so
// the scan driver launches once per H partition with the g loop as the
// batch.  The fused per-R trick (sum in the R list's count words, over g)
// does not apply: R's row is shared along g but each bucket has sums of
// its own.  So the per-R form of bucket_sweep.cuh takes a warp per bucket:
// its table of the R row's keys accumulates wt per key from zero, and the
// warp then writes every R slot's sum (0 for a dead slot) into the
// bucket's output row.  An R row past the warp's table accumulates in the
// output row itself, at one slot per key.  Nothing is sorted or masked and
// no accumulator is allocated beside the output.
// Bound: the bytes, chiefly the [batch, Cr] output written once.
#include "bucket_sweep.cuh"

// Scratch from the caller as rj::bucket_sweep takes it; out [P, Q, W, cr]
// int32 (uninitialised: every slot is written).
extern "C" int rj_bucket_per_r(const int* rb, const unsigned char* rv,
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
  return (int)rj::bucket_sweep<true>(
      rb, rv, sb, sc, sv, tc, tv, P, Q, W, cr, cs, ct, r_mask, t_mask, lens,
      static_cast<int2*>(lists), static_cast<int2*>(tabs), out, device,
      static_cast<cudaStream_t>(stream));
}
