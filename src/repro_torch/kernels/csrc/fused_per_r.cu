// fused_per_r_counts on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:275
// fused_per_r_counts (_fused_per_r_kernel, :256): per-R-slot counts of the
// linear sweep (paper Example 1).  For R slot i of bucket (H, h):
//     out[H, h, i] = Σ over S slots (H, g, h, k) with s.b == r.b of wt(s),
//     wt(s) = #{T slots of bucket g with c == s.c}.
// The Pallas body does a per-step f32 dot; here everything is int32.
//
// The Pallas grid (hp, u, gp) would read a whole T bucket per Cs S slots
// (see fused_linear.cu).  Instead the R and T bucket rows arrive sorted
// (the wrapper sorts them), and two kernels of one thread per slot run:
//   1. per_r_scatter_kernel, per live S slot: wt by two binary searches of
//      its sorted T row (fused_common.cuh); if wt != 0, the position of the
//      first R entry equal to s.b in the sorted R row of (H, h), and
//      acc[H, h, position] += wt (int32 atomics; every R slot with that key
//      shares the position);
//   2. per_r_gather_kernel, per R slot: the same position for its own key,
//      out = acc[H, h, position].  A dead R slot's sentinel equals no S
//      key, so its position's accumulator stays 0.
// Bound: the bytes (the S grid read once); the searches touch the sorted
// rows mostly in L1 and L2.
#include "fused_common.cuh"

namespace rj {

__global__ void __launch_bounds__(kThreads)
per_r_scatter_kernel(const int* __restrict__ sb, const int* __restrict__ sc,
                     int dead_key, const int* __restrict__ r_sorted,
                     long long cr, const int* __restrict__ t_sorted,
                     long long ct, SlotGrid g, long long n_slots,
                     int* __restrict__ acc) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_slots) return;
  const int c = sc[s];
  if (c == dead_key) return;
  long long co[3];
  slot_coords(g, s, co);
  const unsigned wt = count_equal(t_sorted + co[1] * ct, ct, c);  // T row g
  if (wt == 0u) return;
  const int b = sb[s];
  const long long row = co[0] * g.dims[2] + co[2];                 // R row (H, h)
  const int* r = r_sorted + row * cr;
  const long long pos = bound(r, 0LL, cr, b, false);
  if (pos < cr && __ldg(r + pos) == b)
    atomicAdd(reinterpret_cast<unsigned*>(acc) + row * cr + pos, wt);
}

__global__ void __launch_bounds__(kThreads)
per_r_gather_kernel(const int* __restrict__ rb,
                    const int* __restrict__ r_sorted,
                    const int* __restrict__ acc, long long cr,
                    long long n_slots, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const long long row = i / cr;
  const long long pos = bound(r_sorted + row * cr, 0LL, cr, rb[i], false);
  out[i] = acc[row * cr + pos];
}

}  // namespace rj

extern "C" int rj_fused_per_r(const int* rb, const int* r_sorted,
                              const int* sb, const int* sc,
                              const int* t_sorted, int dead_s, long long hp,
                              long long gp, long long u, long long cr,
                              long long cs, long long ct, int* acc, int* out,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rj::SlotGrid g;
  g.dims[0] = hp;
  g.dims[1] = gp;
  g.dims[2] = u;
  g.cs = cs;
  const long long n_s = hp * gp * u * cs;
  const long long n_r = hp * u * cr;
  const long long blocks_s = (n_s + rj::kThreads - 1) / rj::kThreads;
  const long long blocks_r = (n_r + rj::kThreads - 1) / rj::kThreads;
  if (blocks_s > 0x7fffffffLL || blocks_r > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (blocks_s > 0) {
    rj::per_r_scatter_kernel<<<(unsigned)blocks_s, rj::kThreads, 0, st>>>(
        sb, sc, dead_s, r_sorted, cr, t_sorted, ct, g, n_s, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks_r > 0)
    rj::per_r_gather_kernel<<<(unsigned)blocks_r, rj::kThreads, 0, st>>>(
        rb, r_sorted, acc, cr, n_r, out);
  return (int)cudaGetLastError();
}
