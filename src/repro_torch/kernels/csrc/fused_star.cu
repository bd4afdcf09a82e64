// fused_count3_star on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:425
// fused_count3_star (_fused_star_kernel, :409): the star 3-way sweep with
// dimension R(aB) pinned by row bucket h(B), dimension T(Cd) pinned by
// column bucket g(C), and the fact relation S(BC) streamed in arrival-order
// chunks.  Operands: R [uh, Cr], S [ch, uh, ug, Cs], T [ug, Ct] int32 keys
// with their bool validity.  For every live S slot (chunk, h, g, k):
//     wr = #{R slots of bucket h with b == s.b}
//     wt = #{T slots of bucket g with c == s.c}
// and out[h, g] += wr * wt  (int32).
//
// The Pallas grid (uh, ug, chunks) has only uh*ug*chunks programs (64 at
// the default plan), which cannot fill 132 SMs, and each program compares
// its whole S cell (Cs = 781,256 slots at a 2e7-row fact table) against
// whole R and T buckets (31,256 slots each).  Here:
//   0. the pre-pass (key_lists.cuh) turns each R row and each T row into a
//      (key, count) list, reading the validity itself, and every R list
//      into a hash table in global memory (twice the row's slots: ~4 MB
//      for Q2's 8 rows, resident in the 50 MB L2).  A T list past half
//      the sweep's shared table goes into a global table too, and its
//      distinct keys are counted (a list holds a key once per 2,048-slot
//      segment it occurs in: ~12,400 entries at Q2 for ~7,900 keys);
//   1. one CTA of 1,024 threads per (g, split) stages g's list in a shared
//      count table of up to 8,192 slots (64 KB, so two CTAs share an SM)
//      once, or reads g's global table when its distinct keys pass half
//      of that, as Q2's do.  A 16,384-slot table would hold Q2's rows but
//      leave one CTA an SM, and the sweep is slower that way than with
//      both tables in L2 at twice the warps (tools/star_variants.py, on an
//      H100): its probes wait on memory, so warps in flight count for
//      more than where the table sits;
//   2. it sweeps split j of every cell (chunk, h, g) of column g: each
//      cell's Cs slots are cut into `splits` contiguous ranges (enough
//      CTAs for one wave on 132 SMs), read coalesced.  Each warp queues
//      its live slots in shared memory and probes 32 at a time (T, then
//      R's global table where wt != 0), so every lane carries a live
//      slot; the warp sums wr * wt in registers and adds the sum to
//      out[h, g] with one atomic per cell.
// Every S slot is read once; slot indices within a cell are 32-bit, with
// no division per slot.  Counts are unsigned 32-bit and wrap as the
// reference's int32.
// Bound: the bytes, chiefly the S grid read once (about 450 MB at Q2).
#include <algorithm>

#include "key_lists.cuh"

namespace rj {

constexpr int kStarThreads = 1024;
constexpr int kStarWarps = kStarThreads / 32;
constexpr int kStarTMax = 8192;   // T's shared table: 64 KB
constexpr int kStarRounds = 4;    // 32-slot rounds a warp loads at once
constexpr int kStarQueue = 64;    // a warp's queue of live S slots
constexpr int kStarMinSplit = kStarThreads * kStarRounds;  // slots a split

// wr * wt of the queued slots head .. head + n - 1 (n <= 32), one a lane.
__device__ __forceinline__ unsigned star_probe(
    const int* qb, const int* qc, int head, int n, const int* t_key,
    const unsigned* t_cnt, unsigned t_mask, const int2* t_glob,
    unsigned t_cap, const int2* r_tab, unsigned r_cap) {
  const int lane = threadIdx.x & 31;
  if (lane >= n) return 0u;
  const int q = (head + lane) & (kStarQueue - 1);
  const int c = qc[q];
  const unsigned wt = t_glob != nullptr
                          ? entry_count(t_glob, t_cap, c, hash_key(c))
                          : table_get(t_key, t_cnt, t_mask, c, hash_key(c));
  if (wt == 0u) return 0u;
  const int b = qb[q];
  return wt * entry_count(r_tab, r_cap, b, hash_key(b));
}

// rtab: R's global tables [uh, r_cap], rlen [uh]; sb, sc, sv: the S grid
// [ch, uh, ug, cs]; tkc: T's lists [ug, ct], tlen and tdist [ug] (tdist
// counted only for the lists spilled to ttab [ug, t_cap]).  Block =
// (g, split), g fastest.
__global__ void __launch_bounds__(kStarThreads)
star_sweep_kernel(const int2* __restrict__ rtab, unsigned r_cap,
                  const int* __restrict__ rlen, const int* __restrict__ sb,
                  const int* __restrict__ sc,
                  const unsigned char* __restrict__ sv,
                  const int2* __restrict__ tkc, const int* __restrict__ tlen,
                  const int* __restrict__ tdist, long long ct,
                  const int2* __restrict__ ttab, unsigned t_cap, int ch,
                  int uh, int ug, long long cs, int splits, int tslots,
                  int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* t_key = reinterpret_cast<int*>(smem);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + tslots);
  int* qb = reinterpret_cast<int*>(t_cnt + tslots) + warp * 2 * kStarQueue;
  int* qc = qb + kStarQueue;

  const int g = blockIdx.x % ug;
  const int j = blockIdx.x / ug;
  const int n_t = tlen[g];
  if (n_t == 0) return;  // uniform: no S slot of g has a T match
  const int budget = tslots / 2;
  const int2* t_glob = n_t <= budget || tdist[g] <= budget
                           ? nullptr : ttab + (long long)g * t_cap;
  const unsigned t_mask = tslots - 1;
  if (t_glob == nullptr) {
    table_clear(t_key, t_cnt, tslots, threadIdx.x, kStarThreads);
    __syncthreads();
    for (int k0 = 0; k0 < n_t; k0 += kStarRounds * kStarThreads) {
      int2 e[kStarRounds];  // (c, count)
#pragma unroll
      for (int it = 0; it < kStarRounds; ++it) {
        const int k = k0 + it * kStarThreads + threadIdx.x;
        e[it] = k < n_t ? tkc[(long long)g * ct + k] : make_int2(0, 0);
      }
#pragma unroll
      for (int it = 0; it < kStarRounds; ++it)
        if (e[it].y != 0)
          table_add(t_key, t_cnt, t_mask, e[it].x, hash_key(e[it].x),
                    (unsigned)e[it].y);
    }
    __syncthreads();
  }

  const long long k_lo = cs * j / splits;
  const int n_split = (int)(cs * (j + 1) / splits - k_lo);
  for (int chunk = 0; chunk < ch; ++chunk) {
    for (int h = 0; h < uh; ++h) {
      if (rlen[h] == 0) continue;  // uniform: no S slot of h has an R match
      const int2* r_tab = rtab + (long long)h * r_cap;
      const long long base =
          (((long long)chunk * uh + h) * ug + g) * cs + k_lo;
      unsigned v = 0u;
      int head = 0, tail = 0;
      for (int k0 = warp * kStarRounds * 32; k0 < n_split;
           k0 += kStarThreads * kStarRounds) {
        // kStarRounds rounds of slots loaded at once (keys of dead slots
        // too: they share the live slots' cache lines)
        bool live[kStarRounds];
        int b[kStarRounds], c[kStarRounds];
#pragma unroll
        for (int it = 0; it < kStarRounds; ++it) {
          const int k = k0 + it * 32 + lane;
          live[it] = k < n_split && sv[base + k] != 0;
          b[it] = k < n_split ? sb[base + k] : 0;
          c[it] = k < n_split ? sc[base + k] : 0;
        }
#pragma unroll
        for (int it = 0; it < kStarRounds; ++it) {
          const unsigned m = __ballot_sync(0xffffffffu, live[it]);
          if (live[it]) {
            const int q =
                (tail + __popc(m & lanemask_lt())) & (kStarQueue - 1);
            qb[q] = b[it];
            qc[q] = c[it];
          }
          tail += __popc(m);
          if (tail - head >= 32) {
            __syncwarp();
            v += star_probe(qb, qc, head, 32, t_key, t_cnt, t_mask, t_glob,
                            t_cap, r_tab, r_cap);
            head += 32;
            __syncwarp();
          }
        }
      }
      if (tail > head) {
        __syncwarp();
        v += star_probe(qb, qc, head, tail - head, t_key, t_cnt, t_mask,
                        t_glob, t_cap, r_tab, r_cap);
      }
      __syncwarp();  // the queue is free for the next cell
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && v != 0u)
        atomicAdd(reinterpret_cast<unsigned*>(out) + (long long)h * ug + g, v);
    }
  }
}

}  // namespace rj

// Scratch from the caller: rkc [uh, cr] int2, tkc [ug, ct] int2, rtab
// [uh, 2 * cr] int2 and ttab [ug, 2 * ct] int2 (uninitialised); rlen
// [uh], tlen and tdist [ug] int32 zeroed; out [uh, ug] int32 zeroed.
extern "C" int rj_fused_star(const int* rb, const unsigned char* rv,
                             const int* sb, const int* sc,
                             const unsigned char* sv, const int* tc,
                             const unsigned char* tv, long long ch,
                             long long uh, long long ug, long long cr,
                             long long cs, long long ct, void* rkc,
                             int* rlen, void* tkc, int* tlen, int* tdist,
                             void* rtab, void* ttab, int* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch * uh * ug == 0 || cr == 0 || cs == 0 || ct == 0)
    return (int)cudaSuccess;
  if (2 * cr > 0x7fffffffLL || 2 * ct > 0x7fffffffLL || cs > 0x3fffffffLL ||
      ch > 0x7fffffffLL || uh > 0x7fffffffLL || ug > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int2* r_lists = static_cast<int2*>(rkc);
  int2* t_lists = static_cast<int2*>(tkc);
  int2* r_tabs = static_cast<int2*>(rtab);
  int2* t_tabs = static_cast<int2*>(ttab);
  const int tslots = rj::pow2_at_least(2 * ct, 64, rj::kStarTMax);
  const unsigned r_cap = (unsigned)(2 * cr), t_cap = (unsigned)(2 * ct);
  // every R list into its global table; T's past the shared budget
  err = rj::count_keys(rb, rv, uh, cr, 0, true, r_lists, nullptr, rlen, st);
  if (err == cudaSuccess)
    err = rj::count_keys(tc, tv, ug, ct, 0, true, t_lists, nullptr, tlen, st);
  if (err == cudaSuccess)
    err = rj::spill(r_lists, nullptr, rlen, uh, cr, 0, 1, r_cap, r_tabs,
                    nullptr, st);
  if (err == cudaSuccess)
    err = rj::spill(t_lists, nullptr, tlen, ug, ct, tslots / 2, 1, t_cap,
                    t_tabs, tdist, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (size_t)tslots * 8 + (size_t)rj::kStarWarps * 2 * rj::kStarQueue * 4;
  err = cudaFuncSetAttribute(rj::star_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one wave of resident CTAs, each cell cut into as many splits as that
  // needs (never below kStarMinSplit slots)
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rj::star_sweep_kernel, rj::kStarThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long wave = (long long)std::max(per_sm, 1) * sms;
  const long long splits = std::max(
      1LL, std::min(wave / ug, cs / rj::kStarMinSplit));
  if (ug * splits > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rj::star_sweep_kernel<<<(unsigned)(ug * splits), rj::kStarThreads, smem,
                          st>>>(r_tabs, r_cap, rlen, sb, sc, sv, t_lists,
                                tlen, tdist, ct, t_tabs, t_cap, (int)ch,
                                (int)uh, (int)ug, cs, (int)splits, tslots,
                                out);
  return (int)cudaGetLastError();
}
