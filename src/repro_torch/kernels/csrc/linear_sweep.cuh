// The linear 3-way sweep R(aB) ⋈ S(BC) ⋈ T(Cd) over the fused layout
// (Hopper, sm_90a), shared by fused_count3_linear (fused_linear.cu) and
// fused_per_r_counts (fused_per_r.cu).  Operands: R [hp, u, Cr], S
// [hp, gp, u, Cs], T [gp, Ct] int32 keys with their bool validity.  For
// every live S slot (H, g, h, k):
//     wr = #{R slots of bucket (H, h) with b == s.b}
//     wt = #{T slots of bucket g with c == s.c}
// the count sweep adds wr * wt to out[H, h]; the per-R sweep adds wt to
// the accumulator of R's key (h, s.b) in H.
//
//   0. the pre-pass (key_lists.cuh) turns the R slots of each H (its u
//      rows, keyed by (h, b)) and the T slots of each g (keyed by c) into
//      (key, count) lists.  At N = 4e6 and m_budget = 16384 a T row of
//      ~16,300 live slots holds ~57 keys, the 64 R rows of an H ~70;
//   1. a list longer than its shared table's budget (T: half the CTA's
//      table, R: half a warp's) goes into a hash table in global memory
//      (one per g, one per (H, h), twice the row's slots), so a row whose
//      keys are all distinct costs one global probe per S slot, not a pass
//      per chunk;
//   2. one CTA per (g, range of H) loads g's list into a shared count
//      table once (or reads g's global table; stage_list, shared with the
//      other sweeps in sweep_common.cuh);
//   3. each warp takes one H at a time: it loads H's list into a table of
//      its own (or reads H's global tables), streams the u x Cs S slots of
//      (H, g) (contiguous, read coalesced; queue_live), queues the live
//      ones in shared memory and probes both tables for 32 queued slots at
//      a time, so every lane carries a live slot.  Count: wr * wt goes to
//      out[H, h] with one atomic per run of equal cells in the warp.
//      Per-R: the R lists carry 0 in their count words, which become
//      accumulators;
//      wt goes to the key's slot of the warp's table (lanes with the same
//      slot combine first), and after the H each slot's sum goes to the
//      count word of its key's first list entry, one atomic per slot; a
//      key in a global table accumulates in that table's count word.
// Every S slot is read once.  Slot indices are 32-bit within an (H, g)
// block: no 64-bit division per slot.  Counts are unsigned 32-bit and wrap
// as the reference's int32.
// Bound: the bytes, chiefly the S grid read once.
#pragma once

#include <algorithm>

#include "fused_common.cuh"
#include "sweep_common.cuh"

namespace rj {

constexpr int kLinThreads = kListThreads;
constexpr int kLinWarps = kLinThreads / 32;
constexpr int kTSlotsMax = 4096;      // the sweep's T table: 32 KB
constexpr int kWarpSlots = 256;       // a warp's R table: 3 KB (per-R 4 KB)
constexpr int kQueue = 64;            // a warp's queue of live S slots
constexpr int kRounds = 4;            // 32-slot rounds a warp loads at once
constexpr int kNoEntry = 0x7fffffff;  // a per-R slot's first entry, unset
static_assert(kWarpSlots / 2 == kRounds * 32, "a shared R list is one load round");

struct WarpTable {
  unsigned long long* key;  // (h, b)
  unsigned* cnt;            // R's count; per-R: the accumulator
  int* first;               // per-R: the key's first entry in H's list
  int* qk;                  // queued S slots: index in the (H, g) block,
  int* qb;                  // b and c
  int* qc;
};

// The probed tables of one warp: T (the CTA's shared table, or g's global
// one when t_glob is set) and R (the warp's shared table, or H's global
// tables, one per h, when r_rows is set).
struct Probe {
  const int* t_key;
  const unsigned* t_cnt;
  unsigned t_mask;
  const int2* t_glob;     // g's global table, or null
  unsigned t_cap;
  unsigned w_mask;
  int2* r_rows;           // H's global tables, r_cap slots each, or null
  unsigned r_cap;
};

// The queued slots head .. head + n - 1 (n <= 32): one per lane, both
// tables probed; count: wr * wt added to out[H, h]; per-R: wt added to
// the accumulator of (h, b).
template <bool kPerR>
__device__ __forceinline__ void probe_queued(const WarpTable& w,
                                             const Probe& p, int head, int n,
                                             int cs, long long cell0,
                                             int* out) {
  const int lane = threadIdx.x & 31;
  long long cell = -1;
  unsigned v = 0u;
  unsigned* acc = nullptr;
  if (lane < n) {
    const int q = (head + lane) & (kQueue - 1);
    const int h = w.qk[q] / cs;
    const int c = w.qc[q];
    const unsigned wt =
        p.t_glob != nullptr
            ? entry_count(p.t_glob, p.t_cap, c, hash_key(c))
            : table_get(p.t_key, p.t_cnt, p.t_mask, c, hash_key(c));
    if (wt != 0u) {
      const int b = w.qb[q];
      if (kPerR) {
        if (p.r_rows != nullptr) {
          int2* tab = p.r_rows + (long long)h * p.r_cap;
          const int s = entry_slot(tab, p.r_cap, b, hash_key(b));
          if (s >= 0) acc = reinterpret_cast<unsigned*>(&tab[s].y);
        } else {
          const int s = table_find(w.key, p.w_mask, pair_key(h, b),
                                   hash_pair(h, b));
          if (s >= 0) acc = w.cnt + s;
        }
        v = acc != nullptr ? wt : 0u;
      } else {
        v = wt * (p.r_rows != nullptr
                      ? entry_count(p.r_rows + (long long)h * p.r_cap,
                                    p.r_cap, b, hash_key(b))
                      : table_get(w.key, w.cnt, p.w_mask, pair_key(h, b),
                                  hash_pair(h, b)));
      }
    }
    cell = cell0 + h;
  }
  if (kPerR)
    warp_add_at(acc, v);
  else
    warp_add_by_cell(out, cell, v);
}

// rkc / rsub: H's (key, count) lists [hp, u * cr] with their h, rlen [hp];
// tkc: g's lists [gp, ct], tlen [gp]; rtab / ttab: the global tables of the
// lists past their budgets ([hp, u, r_cap], [gp, t_cap]); sb, sc, sv: the
// S grid [hp, gp, u, cs].  Block = (g, range of h_per_cta H's), g fastest.
// Count: out [hp, u]; per-R: the count words of rkc and rtab.
template <bool kPerR>
__global__ void __launch_bounds__(kLinThreads)
linear_sweep_kernel(int2* __restrict__ rkc, const int* __restrict__ rsub,
                    const int* __restrict__ rlen, long long rc,
                    int2* __restrict__ rtab, unsigned r_cap,
                    const int* __restrict__ sb, const int* __restrict__ sc,
                    const unsigned char* __restrict__ sv,
                    const int2* __restrict__ tkc, const int* __restrict__ tlen,
                    long long ct, const int2* __restrict__ ttab,
                    unsigned t_cap, int hp, int gp, int u, int cs,
                    int h_per_cta, int tslots, int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* cnt0 = reinterpret_cast<unsigned*>(smem + kLinWarps * kWarpSlots);
  int* first0 = reinterpret_cast<int*>(cnt0 + kLinWarps * kWarpSlots);
  int* t_key = first0 + (kPerR ? kLinWarps * kWarpSlots : 0);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + tslots);
  WarpTable w;
  w.key = smem + warp * kWarpSlots;
  w.cnt = cnt0 + warp * kWarpSlots;
  w.first = first0 + warp * kWarpSlots;
  w.qk = reinterpret_cast<int*>(t_cnt + tslots) + warp * 3 * kQueue;
  w.qb = w.qk + kQueue;
  w.qc = w.qb + kQueue;

  const int g = blockIdx.x % gp;
  const int h0 = (blockIdx.x / gp) * h_per_cta;
  const int h1 = min(hp, h0 + h_per_cta);
  const int n_t = tlen[g];
  if (n_t == 0) return;  // uniform: no S slot of g has a T match
  const int n_blk = u * cs;  // slots of one (H, g) block
  Probe p;
  p.t_key = t_key;
  p.t_cnt = t_cnt;
  p.t_mask = tslots - 1;
  p.t_glob = n_t > tslots / 2 ? ttab + (long long)g * t_cap : nullptr;
  p.t_cap = t_cap;
  p.r_cap = r_cap;

  if (p.t_glob == nullptr)
    stage_list<kRounds>(tkc + (long long)g * ct, n_t, t_key, t_cnt, tslots,
                        threadIdx.x, kLinThreads);

  for (int H = h0 + warp; H < h1; H += kLinWarps) {  // warp-uniform
    const int n_r = rlen[H];
    if (n_r == 0) continue;
    const long long sbase = ((long long)H * gp + g) * n_blk;
    p.r_rows = n_r > kWarpSlots / 2 ? rtab + (long long)H * u * r_cap
                                    : nullptr;
    const int w_slots = pow2_at_least(2 * n_r, 32, kWarpSlots);
    p.w_mask = w_slots - 1;
    if (p.r_rows == nullptr) {
      int2 e[kRounds];  // (b, count), loaded before the table is cleared
      int eh[kRounds];
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        const int k = it * 32 + lane;
        const long long q = (long long)H * rc + k;
        e[it] = k < n_r ? rkc[q] : make_int2(0, 0);
        eh[it] = k < n_r ? rsub[q] : 0;
      }
      __syncwarp();
      table_clear(w.key, w.cnt, w_slots, lane, 32);
      if (kPerR)
        for (int s = lane; s < w_slots; s += 32) w.first[s] = kNoEntry;
      __syncwarp();
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        const int k = it * 32 + lane;
        if (k >= n_r) continue;
        const unsigned long long kk = pair_key(eh[it], e[it].x);
        const unsigned hh = hash_pair(eh[it], e[it].x);
        if (kPerR)
          atomicMin(w.first + table_claim(w.key, p.w_mask, kk, hh), k);
        else
          table_add(w.key, w.cnt, p.w_mask, kk, hh, (unsigned)e[it].y);
      }
      __syncwarp();
    }
    queue_live<kRounds, kQueue>(
        sb, sc, sv, sbase, 0, n_blk, kRounds * 32, w.qk, w.qb, w.qc,
        [&](int head, int n) {
          probe_queued<kPerR>(w, p, head, n, cs, (long long)H * u, out);
        });
    if (kPerR && p.r_rows == nullptr) {
      // each key's sum to its first list entry; then the table is free
      for (int s = lane; s < w_slots; s += 32) {
        const unsigned a = w.cnt[s];
        if (a != 0u)
          atomicAdd(reinterpret_cast<unsigned*>(
                        &rkc[(long long)H * rc + w.first[s]].y), a);
      }
      __syncwarp();
    }
  }
}

// The pre-pass and the sweep over R [hp, u, cr], S [hp, gp, u, cs], T
// [gp, ct] (raw keys, bool validity).  Scratch from the caller: rkc
// [hp, u * cr] int2 and rsub [hp, u * cr] int32, tkc [gp, ct] int2, rtab
// [hp, u, 2 * cr] int2 and ttab [gp, 2 * ct] int2 (uninitialised); rlen
// [hp], tlen [gp] int32 zeroed.  Count: out [hp, u] int32 zeroed.  Per-R:
// R's lists (and their global tables) accumulate in their count words,
// even where gp, cs or ct is 0 (then nothing is added).
template <bool kPerR>
inline cudaError_t linear_sweep(const int* rb, const unsigned char* rv,
                                const int* sb, const int* sc,
                                const unsigned char* sv, const int* tc,
                                const unsigned char* tv, long long hp,
                                long long gp, long long u, long long cr,
                                long long cs, long long ct, int2* r_lists,
                                int* rsub, int* rlen, int2* t_lists,
                                int* tlen, int2* r_tabs, int2* t_tabs,
                                int* out, int device, cudaStream_t st) {
  if (hp * u == 0 || cr == 0) return cudaSuccess;
  if (u * cr > 0x7fffffffLL || u * cs > 0x7fffffffLL ||
      2 * ct > 0x7fffffffLL || 2 * cr > 0x7fffffffLL || hp > 0x7fffffffLL ||
      gp > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const unsigned r_cap = (unsigned)(2 * cr), t_cap = (unsigned)(2 * ct);
  // R: one list per H, its u rows of cr slots keyed by (h, b); past the
  // warp tables' budget, into global tables
  cudaError_t err = count_keys(rb, rv, hp, u * cr, (int)cr, !kPerR, r_lists,
                               rsub, rlen, st);
  if (err == cudaSuccess)
    err = spill(r_lists, rsub, rlen, hp, u * cr, kWarpSlots / 2, (int)u,
                r_cap, r_tabs, nullptr, st);
  if (err != cudaSuccess || gp == 0 || cs == 0 || ct == 0) return err;
  // T: one list per g
  const int tslots = pow2_at_least(2 * ct, 64, kTSlotsMax);
  err = count_keys(tc, tv, gp, ct, 0, true, t_lists, nullptr, tlen, st);
  if (err == cudaSuccess)
    err = spill(t_lists, nullptr, tlen, gp, ct, tslots / 2, 1, t_cap, t_tabs,
                nullptr, st);
  if (err != cudaSuccess) return err;
  // enough blocks for ~4 waves at 3 blocks an SM, with an H for every
  // warp of a block
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = 12LL * sms;
  const long long h_chunks = std::max(1LL, std::min(hp, (want + gp - 1) / gp));
  const int h_per_cta =
      (int)std::max((long long)kLinWarps, (hp + h_chunks - 1) / h_chunks);
  const long long blocks = gp * ((hp + h_per_cta - 1) / h_per_cta);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kLinWarps * kWarpSlots * (kPerR ? 16 : 12) +
                      (size_t)tslots * 8 + (size_t)kLinWarps * 3 * kQueue * 4;
  err = cudaFuncSetAttribute(linear_sweep_kernel<kPerR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  linear_sweep_kernel<kPerR><<<(unsigned)blocks, kLinThreads, smem, st>>>(
      r_lists, rsub, rlen, u * cr, r_tabs, r_cap, sb, sc, sv, t_lists, tlen,
      ct, t_tabs, t_cap, (int)hp, (int)gp, (int)u, (int)cs, h_per_cta, tslots,
      out);
  return cudaGetLastError();
}

}  // namespace rj
