// fused_count3_star on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:425
// fused_count3_star (_fused_star_kernel, :409): the star 3-way sweep with
// dimension R(aB) pinned by row bucket h(B), dimension T(Cd) pinned by
// column bucket g(C), and the fact relation S(BC) streamed in arrival-order
// chunks.  For every S slot (chunk, h, g, k):
//     wr = #{R slots of bucket h with b == s.b}
//     wt = #{T slots of bucket g with c == s.c}
// and out[h, g] += wr * wt  (int32).
//
// The Pallas grid (uh, ug, chunks) has only uh*ug*chunks programs (64 at
// the default plan), which cannot fill 132 SMs, and each program compares
// its whole S cell (Cs = 781,256 slots at a 2e7-row fact table) against
// whole R and T buckets (31,256 slots each): 3.1e12 compares.  Here the
// wrapper sorts each R and T bucket row once and sweep3_kernel
// (fused_common.cuh) gives each S slot one thread: wt and wr by two binary
// searches of its sorted T and R rows, wr * wt added to out[h, g] with one
// atomic per run of equal cells in a warp (a warp's slots almost always
// share one cell, so the 64 counters see few atomics).
// Bound: the bytes, chiefly the S grid read once (about 400 MB at the size
// above); the searches are ~2 log2(C) loads per live slot from L1 and L2.
#include "fused_common.cuh"

extern "C" int rj_fused_star(const int* r_sorted, const int* sb,
                             const int* sc, const int* t_sorted, int dead_s,
                             long long ch, long long uh, long long ug,
                             long long cr, long long cs, long long ct,
                             int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // S [ch, uh, ug, Cs]: R row h = dim 1; T row g = dim 2; cell (h, g)
  err = rj::launch_sweep3(sb, sc, dead_s, r_sorted, cr, /*r*/ 0b010,
                          t_sorted, ct, /*t*/ 0b100, ch, uh, ug, cs,
                          /*cell*/ 0b110, out,
                          static_cast<cudaStream_t>(stream));
  return (int)err;
}
