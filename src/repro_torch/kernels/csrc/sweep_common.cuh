// Device code shared by the hash-table join sweeps (Hopper, sm_90a): the
// fused linear and per-R sweeps (linear_sweep.cuh), the fused star sweep
// (fused_star.cu) and the bucket-row sweeps of the baselines
// (bucket_sweep.cuh).
//
//   stage_list: a (key, count) list of the pre-pass (key_lists.cuh) into a
//     shared count table, by every thread of a CTA;
//   queue_live: a warp streams a range of S slots (keys and validity, read
//     coalesced), queues the live ones in shared memory and hands them to
//     a probe 32 at a time, so every lane carries a live slot;
//   the split sweep (split_sweep_kernel, launch_split_sweep): for S cells
//     too long for one warp each.  One CTA of 1,024 threads per (T row,
//     split) stages the T row's list in a shared table of up to 8,192 slots
//     (64 KB, so two CTAs share an SM) when its distinct keys fit half of
//     it, else probes the row's global table; it sweeps split j of every S
//     cell that probes this T row (each cell's slots cut into `splits`
//     contiguous ranges, enough CTAs for one wave), probing T and then the
//     cell's R row in its global table where wt != 0, and adds each warp's
//     sum of wr * wt to the cell's output with one atomic.  A Cells type
//     says which cells probe a T row, and their S row, R row and output:
//     StarCells for the fused star layout, BucketCells (bucket_sweep.cuh)
//     for the bucket rows.
// Counts are unsigned 32-bit and wrap as the reference's int32.
#pragma once

#include <algorithm>

#include "key_lists.cuh"

namespace rj {

// *p += v for every lane whose p is set; lanes with the same p combine
// first, so an address takes one atomic.  Every lane of the warp calls.
__device__ __forceinline__ void warp_add_at(unsigned* p, unsigned v) {
  const unsigned peers =
      __match_any_sync(0xffffffffu, reinterpret_cast<unsigned long long>(p));
  const unsigned sum = __reduce_add_sync(peers, v);
  if (p != nullptr && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(p, sum);
}

// The list[0, n) of (key, count) entries into a shared count table of
// `slots` slots (cleared here), by thread tid of nt; kRounds rounds of
// entries are loaded before they are added.  Entries of count 0 add
// nothing.  Every thread of the CTA calls; the table is ready on return.
template <int kRounds>
__device__ __forceinline__ void stage_list(const int2* __restrict__ list,
                                           int n, int* key, unsigned* cnt,
                                           int slots, int tid, int nt) {
  table_clear(key, cnt, slots, tid, nt);
  __syncthreads();
  const unsigned mask = slots - 1;
  for (int k0 = 0; k0 < n; k0 += kRounds * nt) {
    int2 e[kRounds];  // (key, count)
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const int k = k0 + it * nt + tid;
      e[it] = k < n ? list[k] : make_int2(0, 0);
    }
#pragma unroll
    for (int it = 0; it < kRounds; ++it)
      if (e[it].y != 0)
        table_add(key, cnt, mask, e[it].x, hash_key(e[it].x),
                  (unsigned)e[it].y);
  }
  __syncthreads();
}

// The warp streams slots k of the S row at base, for k0 = k_begin,
// k_begin + step, ... below k_end and k = k0 + it * 32 + lane (it <
// kRounds; all kRounds rounds are loaded at once, the keys of dead slots
// too: they share the live slots' cache lines).  The live ones go to the
// warp's ring of kQueue entries (qk, when set, gets k; qb and qc the keys),
// and probe(head, n) takes the queued slots head .. head + n - 1, n <= 32,
// one a lane, whenever 32 are queued and once for the rest.  Every lane
// of the warp calls; the ring is free again on return.
template <int kRounds, int kQueue, typename Probe>
__device__ __forceinline__ void queue_live(
    const int* __restrict__ sb, const int* __restrict__ sc,
    const unsigned char* __restrict__ sv, long long base, int k_begin,
    int k_end, int step, int* qk, int* qb, int* qc, Probe&& probe) {
  static_assert(kQueue >= 64 && (kQueue & (kQueue - 1)) == 0,
                "the ring holds a full probe and a round");
  const int lane = threadIdx.x & 31;
  int head = 0, tail = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += step) {
    bool live[kRounds];
    int b[kRounds], c[kRounds];
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const int k = k0 + it * 32 + lane;
      live[it] = k < k_end && sv[base + k] != 0;
      b[it] = k < k_end ? sb[base + k] : 0;
      c[it] = k < k_end ? sc[base + k] : 0;
    }
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const unsigned m = __ballot_sync(0xffffffffu, live[it]);
      if (live[it]) {
        const int q = (tail + __popc(m & lanemask_lt())) & (kQueue - 1);
        if (qk != nullptr) qk[q] = k0 + it * 32 + lane;
        qb[q] = b[it];
        qc[q] = c[it];
      }
      tail += __popc(m);
      if (tail - head >= 32) {
        __syncwarp();
        probe(head, 32);
        head += 32;
        __syncwarp();
      }
    }
  }
  if (tail > head) {
    __syncwarp();
    probe(head, tail - head);
  }
  __syncwarp();
}

constexpr int kSplitThreads = 1024;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitTMax = 8192;   // T's shared table: 64 KB
constexpr int kSplitRounds = 4;    // 32-slot rounds a warp loads at once
constexpr int kSplitQueue = 64;    // a warp's queue of live S slots
constexpr int kMinSplit = kSplitThreads * kSplitRounds;  // slots a split

// The cells of the fused star layout: S [ch, uh, ug, cs], R rows h, T rows
// g, out [uh, ug] summed over the chunks.  Cell c of T row g is (chunk,
// h) = (c / uh, c % uh).
struct StarCells {
  int ch, uh, ug;
  __host__ __device__ long long t_rows() const { return ug; }
  __host__ __device__ long long per_t() const { return (long long)ch * uh; }
  __device__ void get(long long g, long long c, long long* s_row,
                      long long* r_row, long long* out) const {
    const long long h = c % uh;
    *s_row = c * ug + g;  // ((chunk * uh + h) * ug + g)
    *r_row = h;
    *out = h * ug + g;
  }
};

// wr * wt of the queued slots head .. head + n - 1 (n <= 32), one a lane.
__device__ __forceinline__ unsigned split_probe(
    const int* qb, const int* qc, int head, int n, const int* t_key,
    const unsigned* t_cnt, unsigned t_mask, const int2* t_glob,
    unsigned t_cap, const int2* r_tab, unsigned r_cap) {
  const int lane = threadIdx.x & 31;
  if (lane >= n) return 0u;
  const int q = (head + lane) & (kSplitQueue - 1);
  const int c = qc[q];
  const unsigned wt = t_glob != nullptr
                          ? entry_count(t_glob, t_cap, c, hash_key(c))
                          : table_get(t_key, t_cnt, t_mask, c, hash_key(c));
  if (wt == 0u) return 0u;
  const int b = qb[q];
  return wt * entry_count(r_tab, r_cap, b, hash_key(b));
}

// rtab: every R row's global table [r_rows, r_cap], rlen; sb, sc, sv: the
// S rows of cs slots; tkc: T's lists [t_rows, ct], tlen and tdist (tdist
// counted only for the lists spilled to ttab [t_rows, t_cap]).  Block =
// (T row, split), T row fastest.  out: the cells' outputs, zeroed.
template <typename Cells>
__global__ void __launch_bounds__(kSplitThreads)
split_sweep_kernel(Cells cells, const int2* __restrict__ rtab,
                   unsigned r_cap, const int* __restrict__ rlen,
                   const int* __restrict__ sb, const int* __restrict__ sc,
                   const unsigned char* __restrict__ sv,
                   const int2* __restrict__ tkc, const int* __restrict__ tlen,
                   const int* __restrict__ tdist, long long ct,
                   const int2* __restrict__ ttab, unsigned t_cap,
                   long long cs, int splits, int tslots,
                   int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* t_key = reinterpret_cast<int*>(smem);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + tslots);
  int* qb = reinterpret_cast<int*>(t_cnt + tslots) + warp * 2 * kSplitQueue;
  int* qc = qb + kSplitQueue;

  const long long t_rows = cells.t_rows();
  const long long t = blockIdx.x % t_rows;
  const int j = (int)(blockIdx.x / t_rows);
  const int n_t = tlen[t];
  if (n_t == 0) return;  // uniform: no S slot of this T row has a T match
  const int budget = tslots / 2;
  const int2* t_glob = n_t <= budget || tdist[t] <= budget
                           ? nullptr : ttab + t * t_cap;
  const unsigned t_mask = tslots - 1;
  if (t_glob == nullptr)
    stage_list<kSplitRounds>(tkc + t * ct, n_t, t_key, t_cnt, tslots,
                             threadIdx.x, kSplitThreads);

  const long long k_lo = cs * j / splits;
  const int n_split = (int)(cs * (j + 1) / splits - k_lo);
  const long long per_t = cells.per_t();
  for (long long cell = 0; cell < per_t; ++cell) {
    long long s_row, r_row, o;
    cells.get(t, cell, &s_row, &r_row, &o);
    if (rlen[r_row] == 0) continue;  // uniform: no S slot has an R match
    const int2* r_tab = rtab + r_row * r_cap;
    unsigned v = 0u;
    queue_live<kSplitRounds, kSplitQueue>(
        sb, sc, sv, s_row * cs + k_lo, warp * kSplitRounds * 32, n_split,
        kSplitThreads * kSplitRounds, nullptr, qb, qc,
        [&](int head, int n) {
          v += split_probe(qb, qc, head, n, t_key, t_cnt, t_mask, t_glob,
                           t_cap, r_tab, r_cap);
        });
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v != 0u)
      atomicAdd(reinterpret_cast<unsigned*>(out) + o, v);
  }
}

// The T row's shared table: slots for a row of ct slots.
inline int split_tslots(long long ct) {
  return pow2_at_least(2 * ct, 64, kSplitTMax);
}

// Launch the split sweep over `cells` after the pre-pass: one wave of
// resident CTAs, each cell cut into as many splits as that needs (never
// below kMinSplit slots).  Every R row must have its global table (spill
// with budget 0); T's lists past tslots / 2 theirs, with tdist.
template <typename Cells>
inline cudaError_t launch_split_sweep(const Cells& cells, const int2* rtab,
                                      unsigned r_cap, const int* rlen,
                                      const int* sb, const int* sc,
                                      const unsigned char* sv,
                                      const int2* tkc, const int* tlen,
                                      const int* tdist, long long ct,
                                      const int2* ttab, unsigned t_cap,
                                      long long cs, int* out, int device,
                                      cudaStream_t st) {
  if (cs > 0x3fffffffLL) return cudaErrorInvalidConfiguration;
  const int tslots = split_tslots(ct);
  const size_t smem =
      (size_t)tslots * 8 + (size_t)kSplitWarps * 2 * kSplitQueue * 4;
  cudaError_t err = cudaFuncSetAttribute(
      split_sweep_kernel<Cells>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, split_sweep_kernel<Cells>, kSplitThreads, smem);
  if (err != cudaSuccess) return err;
  const long long t_rows = cells.t_rows();
  const long long wave = (long long)std::max(per_sm, 1) * sms;
  const long long splits =
      std::max(1LL, std::min(wave / t_rows, cs / kMinSplit));
  if (t_rows * splits > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  split_sweep_kernel<Cells><<<(unsigned)(t_rows * splits), kSplitThreads,
                              smem, st>>>(
      cells, rtab, r_cap, rlen, sb, sc, sv, tkc, tlen, tdist, ct, ttab, t_cap,
      cs, (int)splits, tslots, out);
  return cudaGetLastError();
}

}  // namespace rj
