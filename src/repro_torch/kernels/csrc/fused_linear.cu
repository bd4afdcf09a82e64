// fused_count3_linear on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:231
// fused_count3_linear (_fused_linear_kernel, :215): the whole linear 3-way
// sweep R(aB) ⋈ S(BC) ⋈ T(Cd).  For every S slot (H, g, h, k):
//     wr = #{R slots of bucket (H, h) with b == s.b}
//     wt = #{T slots of bucket g with c == s.c}
// and out[H, h] += wr * wt  (int32).
//
// The Pallas grid (hp, u, gp) gave one program per (H, h, g); on a TPU the
// grid ran in order and the T bucket stayed in VMEM.  On this card one
// block per (H, h, g) would hold only Cs S slots yet read its whole T
// bucket (at N = 4e6, m_budget = 16384: Cs = 8 against Ct = 40,824, about
// 630 GB of traffic over 3.8e6 blocks), and comparing every S slot with
// every bucket entry costs about 1.3e12 compares.  Instead the wrapper
// sorts each R and T bucket row once, and sweep3_kernel
// (fused_common.cuh) gives each S slot one thread that finds wt and wr by
// two binary searches of its sorted T and R rows, then adds wr * wt to
// out[H, h], one atomic per run of equal cells in a warp.
// Bound: the bytes, chiefly the S grid read once (a few hundred MB at the
// size above); the searches are ~2 log2(C) loads per live slot, served
// mostly from L1 and L2.
#include "fused_common.cuh"

extern "C" int rj_fused_linear(const int* r_sorted, const int* sb,
                               const int* sc, const int* t_sorted,
                               int dead_s, long long hp, long long gp,
                               long long u, long long cr, long long cs,
                               long long ct, int* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // S [hp, gp, u, Cs]: R row (H, h) = dims 0, 2; T row g = dim 1;
  // cell (H, h) = dims 0, 2
  err = rj::launch_sweep3(sb, sc, dead_s, r_sorted, cr, /*r*/ 0b101,
                          t_sorted, ct, /*t*/ 0b010, hp, gp, u, cs,
                          /*cell*/ 0b101, out,
                          static_cast<cudaStream_t>(stream));
  return (int)err;
}
