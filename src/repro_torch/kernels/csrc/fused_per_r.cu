// fused_per_r_counts on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:275
// fused_per_r_counts (_fused_per_r_kernel, :256): per-R-slot counts of the
// linear sweep (paper Example 1).  For R slot i of bucket (H, h):
//     out[H, h, i] = Σ over S slots (H, g, h, k) with s.b == r.b of wt(s),
//     wt(s) = #{T slots of bucket g with c == s.c};
// a dead R slot gives 0.  The Pallas body does a per-step f32 dot; here
// everything is int32.
//
// The per-R form of linear_sweep.cuh, which fused_linear.cu shares: the
// pre-pass turns H's R slots into a list keyed by (h, b) whose count words
// are accumulators, the sweep adds each live S slot's wt to its key's
// (in the warp's shared table, flushed once per key per H, or in H's
// global table past the shared budget), and then per_r_gather_kernel
// writes every R slot's key's sum into out.  Nothing is sorted or masked.
// Bound: the bytes, chiefly the S grid read once and out written once.
#include "linear_sweep.cuh"

namespace rj {

constexpr int kGatherSeg = 2048;  // R slots of one gather block

// out[H, h, i] = the sum of R slot i's key (h, b) in H, 0 for a dead slot.
// A list within the warp tables' budget is indexed again as the sweep
// indexed it (a key's sum sits at its first list entry); a longer one is
// read from H's global tables.  Block = (H, segment of kGatherSeg slots).
__global__ void __launch_bounds__(kLinThreads)
per_r_gather_kernel(const int* __restrict__ rb,
                    const unsigned char* __restrict__ rv,
                    const int2* __restrict__ rkc, const int* __restrict__ rsub,
                    const int* __restrict__ rlen, int u, int cr,
                    const int2* __restrict__ rtab, unsigned r_cap,
                    unsigned segs, int* __restrict__ out) {
  __shared__ unsigned long long key[kWarpSlots];
  __shared__ int first[kWarpSlots];
  const long long H = blockIdx.x / segs;
  const int rc = u * cr;
  const int n_r = rlen[H];
  const bool in_smem = n_r <= kWarpSlots / 2;  // block-uniform
  unsigned mask = 0u;
  if (in_smem) {
    const int slots = pow2_at_least(2 * n_r, 32, kWarpSlots);
    mask = slots - 1;
    for (int s = threadIdx.x; s < slots; s += kLinThreads) {
      key[s] = kEmptyPair;
      first[s] = kNoEntry;
    }
    __syncthreads();
    if ((int)threadIdx.x < n_r) {
      const long long q = H * rc + threadIdx.x;
      const int b = rkc[q].x, h = rsub[q];
      atomicMin(first + table_claim(key, mask, pair_key(h, b),
                                    hash_pair(h, b)),
                (int)threadIdx.x);
    }
    __syncthreads();
  }
  const int k0 = (int)(blockIdx.x % segs) * kGatherSeg;
  const int k1 = min(rc, k0 + kGatherSeg);
  for (int k = k0 + threadIdx.x; k < k1; k += kLinThreads) {
    const long long i = H * rc + k;
    unsigned v = 0u;
    if (rv[i] != 0) {
      const int b = rb[i], h = k / cr;
      if (in_smem) {
        const int s = table_find(key, mask, pair_key(h, b), hash_pair(h, b));
        if (s >= 0) v = (unsigned)rkc[H * rc + first[s]].y;
      } else {
        v = entry_count(rtab + (H * u + h) * r_cap, r_cap, b, hash_key(b));
      }
    }
    out[i] = (int)v;
  }
}

}  // namespace rj

// Scratch from the caller as rj::linear_sweep takes it; out [hp, u, cr]
// int32 (uninitialised: every slot is written).
extern "C" int rj_fused_per_r(const int* rb, const unsigned char* rv,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hp * u * cr == 0) return (int)cudaSuccess;
  int2* r_lists = static_cast<int2*>(rkc);
  int2* r_tabs = static_cast<int2*>(rtab);
  err = rj::linear_sweep<true>(rb, rv, sb, sc, sv, tc, tv, hp, gp, u, cr, cs,
                               ct, r_lists, rsub, rlen,
                               static_cast<int2*>(tkc), tlen, r_tabs,
                               static_cast<int2*>(ttab), nullptr, device, st);
  if (err != cudaSuccess) return (int)err;
  const long long segs = (u * cr + rj::kGatherSeg - 1) / rj::kGatherSeg;
  if (hp * segs > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rj::per_r_gather_kernel<<<(unsigned)(hp * segs), rj::kLinThreads, 0, st>>>(
      rb, rv, r_lists, rsub, rlen, (int)u, (int)cr, r_tabs,
      (unsigned)(2 * cr), (unsigned)segs, out);
  return (int)cudaGetLastError();
}
