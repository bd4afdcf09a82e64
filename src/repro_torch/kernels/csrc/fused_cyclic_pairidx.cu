// fused_count3_cyclic_pairidx on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:377
// fused_count3_cyclic_pairidx (_fused_cyclic_pairidx_kernel, :349): the
// triangle sweep R(AB) ⋈ S(BC) ⋈ T(CA) over the H(A) x G(B) coarse grid,
// the uh x ug PMU grid and the f(C) stream.  For cell (i, j, a, b):
//     out[i, j, a, b] = Σ_f Σ_{s in S[j, f, b]} Σ_{r in R[i, j, a, b]}
//                       [s.b == r.b] * #{t in T[i, f, a] : (t.c, t.a) == (s.c, r.a)}.
//
// The Pallas body builds a (Ct+1) x Cr prefix table per program
// (bucket_join.py:369-371); at N = 4e6 that is about 12 MB, which no
// shared memory holds.  This kernel computes the same number another way.
// The wrapper packs each R slot's (b, a) and each T slot's (c, a) into one
// int64 key (x << 32) + (a - INT32_MIN) and sorts every R cell and T
// bucket row by it, so a row is ordered by its first key and then by a.
// One block per (cell, f); one thread per S slot of bucket (j, f, b):
//   1. two binary searches of the sorted R cell give the run of R entries
//      with b == s.b, two of the sorted T row the run with c == s.c; a
//      dead slot or an empty run ends there;
//   2. both runs are ordered by a, so each R entry's T count is found by
//      two searches of the T run that start where the previous entry's
//      ended.
// So the work is ~2 log2(Cr) + 2 log2(Ct) loads per live S slot visit plus
// a few per matching (s, r) pair; the R cell (Cr int64) and T row stay in
// L1 for the block.  S buckets are walked only up to their last live slot
// (s_len, computed by the caller).  The block's int32 partial is reduced
// in shared memory and added to out[cell] with one atomic.
// Bound: the search steps, about 2e10 at N = 4e6 (4.8e8 S slot visits),
// against about 240 MB of inputs read once; the steps bind.
#include "fused_common.cuh"

namespace rj {

// (x << 32) + (a - INT32_MIN): high word x, low word a with its sign bit
// flipped, so signed int64 order is the (x, then a) order.
__device__ __forceinline__ long long pair_key(int x, int a) {
  return (long long)(((unsigned long long)(unsigned)x << 32) |
                     (unsigned long long)((unsigned)a ^ 0x80000000u));
}

__global__ void __launch_bounds__(kThreads)
cyclic_pairidx_kernel(const long long* __restrict__ rkey,
                      const int* __restrict__ sb, const int* __restrict__ sc,
                      const long long* __restrict__ tkey,
                      const int* __restrict__ s_len, int dead_key,
                      long long gp, long long uh, long long ug, long long fp,
                      long long cr, long long cs, long long ct,
                      int* __restrict__ out) {
  __shared__ unsigned s_red[kThreads / 32];
  const long long f = blockIdx.x % fp;
  const long long cell = blockIdx.x / fp;
  const long long b = cell % ug;
  const long long a = (cell / ug) % uh;
  const long long j = (cell / (ug * uh)) % gp;
  const long long i = cell / (ug * uh * gp);
  const long long* r = rkey + cell * cr;
  const long long s_bucket = (j * fp + f) * ug + b;
  const long long s_off = s_bucket * cs;
  const long long* t = tkey + ((i * fp + f) * uh + a) * ct;
  const long long s_n = min((long long)s_len[s_bucket], cs);
  if (s_n == 0) return;  // uniform: nothing here can match

  unsigned acc = 0u;
  for (long long s = threadIdx.x; s < s_n; s += kThreads) {
    const int kb = sb[s_off + s];
    if (kb == dead_key) continue;
    const long long r_lo = bound(r, 0LL, cr, pair_key(kb, (int)0x80000000), false);
    const long long r_hi = bound(r, r_lo, cr, pair_key(kb, 0x7fffffff), true);
    if (r_lo == r_hi) continue;
    const int kc = sc[s_off + s];
    const long long t_lo = bound(t, 0LL, ct, pair_key(kc, (int)0x80000000), false);
    const long long t_hi = bound(t, t_lo, ct, pair_key(kc, 0x7fffffff), true);
    long long pos = t_lo;
    for (long long x = r_lo; x < r_hi && pos < t_hi; ++x) {
      // the low word of an R key is its a with the sign bit flipped, as in
      // the T keys: the T key of (s.c, r.a) keeps it and takes s.c on top
      const long long key = (long long)(((unsigned long long)(unsigned)kc << 32) |
                                        ((unsigned long long)__ldg(r + x) & 0xffffffffULL));
      const long long lo = bound(t, pos, t_hi, key, false);
      const long long hi = bound(t, lo, t_hi, key, true);
      acc += (unsigned)(hi - lo);
      pos = lo;
    }
  }

  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum = 0u;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_red[w];
    if (sum != 0u) atomicAdd(reinterpret_cast<unsigned*>(out) + cell, sum);
  }
}

}  // namespace rj

extern "C" int rj_fused_cyclic_pairidx(const long long* rkey, const int* sb,
                                       const int* sc, const long long* tkey,
                                       const int* s_len, int dead_s,
                                       long long hp, long long gp,
                                       long long uh, long long ug,
                                       long long fp, long long cr,
                                       long long cs, long long ct, int* out,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = hp * gp * uh * ug * fp;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rj::cyclic_pairidx_kernel<<<(unsigned)blocks, rj::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      rkey, sb, sc, tkey, s_len, dead_s, gp, uh, ug, fp, cr, cs, ct, out);
  return (int)cudaGetLastError();
}
