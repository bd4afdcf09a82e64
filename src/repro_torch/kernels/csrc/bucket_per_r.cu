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
// batch.  The wrapper sorts each distinct R and T row once per launch.
// Two kernels of one thread per slot, as in fused_per_r.cu:
//   1. per live S slot: wt by two binary searches of its sorted T row; if
//      wt != 0, the position of the first entry equal to s.b in its sorted
//      R row, and acc[bucket, position] += wt (int32 atomics);
//   2. per R slot of every bucket: the same position for its own key in
//      its sorted R row, out[bucket, i] = acc[bucket, position].  A dead R
//      slot's sentinel equals no S key, so its accumulator stays 0.
// Bound: the bytes (the S rows read once, the [batch, Cr] output written
// once); the searches hit the sorted rows in L1 and L2.
#include "fused_common.cuh"

namespace rj {

__device__ __forceinline__ void batch_coords(const SlotGrid& g, long long b,
                                             long long c[3]) {
  c[2] = b % g.dims[2];
  b /= g.dims[2];
  c[1] = b % g.dims[1];
  c[0] = b / g.dims[1];
}

__global__ void __launch_bounds__(kThreads)
bucket_per_r_scatter_kernel(const int* __restrict__ sb,
                            const int* __restrict__ sc, int dead_key,
                            const int* __restrict__ r_sorted, long long cr,
                            int r_mask, const int* __restrict__ t_sorted,
                            long long ct, int t_mask, SlotGrid g,
                            long long n_slots, int* __restrict__ acc) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int c = sc[s];
  if (c == dead_key) return;
  long long co[3];
  slot_coords(g, s, co);
  const unsigned wt =
      count_equal(t_sorted + masked_index(g, co, t_mask) * ct, ct, c);
  if (wt == 0u) return;
  const int b = sb[s];
  const int* r = r_sorted + masked_index(g, co, r_mask) * cr;
  const long long pos = bound(r, 0LL, cr, b, false);
  if (pos < cr && __ldg(r + pos) == b)
    atomicAdd(reinterpret_cast<unsigned*>(acc) + (s / g.cs) * cr + pos, wt);
}

__global__ void __launch_bounds__(kThreads)
bucket_per_r_gather_kernel(const int* __restrict__ rb,
                           const int* __restrict__ r_sorted, int r_mask,
                           const int* __restrict__ acc, SlotGrid g,
                           long long cr, long long n_out,
                           int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long bucket = i / cr;
  long long co[3];
  batch_coords(g, bucket, co);
  const long long row = masked_index(g, co, r_mask) * cr;
  const long long pos = bound(r_sorted + row, 0LL, cr, rb[row + i % cr], false);
  out[i] = acc[bucket * cr + pos];
}

}  // namespace rj

extern "C" int rj_bucket_per_r(const int* rb, const int* r_sorted,
                               const int* sb, const int* sc,
                               const int* t_sorted, int dead_s, long long P,
                               long long Q, long long W, long long cr,
                               long long cs, long long ct, int r_mask,
                               int t_mask, int* acc, int* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rj::SlotGrid g;
  g.dims[0] = P;
  g.dims[1] = Q;
  g.dims[2] = W;
  g.cs = cs;
  const long long n_s = P * Q * W * cs;
  const long long n_out = P * Q * W * cr;
  const long long blocks_s = (n_s + rj::kThreads - 1) / rj::kThreads;
  const long long blocks_o = (n_out + rj::kThreads - 1) / rj::kThreads;
  if (blocks_s > 0x7fffffffLL || blocks_o > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (blocks_s > 0) {
    rj::bucket_per_r_scatter_kernel<<<(unsigned)blocks_s, rj::kThreads, 0,
                                      st>>>(sb, sc, dead_s, r_sorted, cr,
                                            r_mask, t_sorted, ct, t_mask, g,
                                            n_s, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks_o > 0)
    rj::bucket_per_r_gather_kernel<<<(unsigned)blocks_o, rj::kThreads, 0,
                                     st>>>(rb, r_sorted, r_mask, acc, g, cr,
                                           n_out, out);
  return (int)cudaGetLastError();
}
