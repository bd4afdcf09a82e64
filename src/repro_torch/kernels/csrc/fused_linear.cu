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
// grid ran in order and the T bucket stayed in VMEM.  Here both probed
// sides become (key, count) tables, in shared memory where they fit and
// in global memory past that, each read once per live S slot: the count
// form of linear_sweep.cuh, which fused_per_r.cu shares.
// Bound: the bytes, chiefly the S grid read once (a few hundred MB at
// N = 4e6).
#include "linear_sweep.cuh"

// Scratch from the caller as rj::linear_sweep takes it; out [hp, u] int32
// zeroed.
extern "C" int rj_fused_linear(const int* rb, const unsigned char* rv,
                               const int* sb, const int* sc,
                               const unsigned char* sv, const int* tc,
                               const unsigned char* tv, long long hp,
                               long long gp, long long u, long long cr,
                               long long cs, long long ct, void* rkc,
                               int* rsub, int* rlen, void* tkc, int* tlen,
                               void* rtab, void* ttab, int* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hp * gp * u == 0 || cr == 0 || cs == 0 || ct == 0)
    return (int)cudaSuccess;
  return (int)rj::linear_sweep<false>(
      rb, rv, sb, sc, sv, tc, tv, hp, gp, u, cr, cs, ct,
      static_cast<int2*>(rkc), rsub, rlen, static_cast<int2*>(tkc), tlen,
      static_cast<int2*>(rtab), static_cast<int2*>(ttab), out, device,
      static_cast<cudaStream_t>(stream));
}
