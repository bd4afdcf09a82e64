// The bucket-row sweeps of the scan baselines (Hopper, sm_90a),
// shared by bucket_count3_linear (bucket_linear.cu) and bucket_per_r_counts
// (bucket_per_r.cu).  Operands are bucket rows [*batch, C] of int32 keys
// with their bool validity: the batch [P, Q, W] is padded to three
// dimensions, S spans all of it, and an R or T operand of size 1 along a
// dimension is one row shared along it (a bit per dimension it spans in
// r_mask / t_mask).  Per bucket row, for every live S slot s:
//     wr = #{R slots of the bucket's R row with b == s.b}
//     wt = #{T slots of the bucket's T row with c == s.c}
// count: out[bucket] = Σ wr * wt; per-R: out[bucket, i] = Σ over the S
// slots with s.b == r_i.b of wt, 0 for a dead R slot i.
//
//   0. the pre-pass (key_lists.cuh) makes one (key, count) list per
//      distinct R row and per distinct T row, so a row shared along a
//      dimension is listed once a launch, never per bucket.  Loads of keys
//      are predicated on validity and a segment with no live slot ends at
//      once: B1's T rows (163,296 slots, ~16,300 live) cost their validity
//      bytes and their live keys.  A list past its sweep's shared budget
//      goes into a global table (count: (key, count), spill; per-R: (key,
//      one of its slots), rep_fill_kernel);
//   1. S rows shorter than kLongRow (the linear scans: B1's 32 slots a
//      bucket, 15,680 buckets) take bucket_sweep_kernel: one CTA of eight
//      warps per (T row, range of the buckets that probe it) stages the T
//      row's list in a shared table once (or probes its global table when
//      its distinct keys pass half of that); each warp takes one bucket at
//      a time, loads its R row's list into a table of its own (or probes
//      the R row's global table past 128 entries), streams the bucket's S
//      slots through queue_live (sweep_common.cuh) and probes both tables.
//      Count: the warp's sum of wr * wt is out[bucket].  Per-R: the warp's
//      table counts nothing and accumulates wt per key (lanes with the
//      same key combine first); then each R slot i of the row writes
//      out[bucket, i] from its key's slot, or 0, so the output is written
//      once, in full, with no accumulator beside it.  Past the warp's
//      budget the output row itself accumulates: zeroed, wt added at the
//      slot that represents the key in the R row's table, then copied to
//      the key's other slots (one warp owns a bucket, so nothing races);
//   2. S rows of kLongRow slots or more (the star scan: B2's 64 cells of
//      781,256 slots) take the split sweep of sweep_common.cuh that the
//      fused star sweep runs (BucketCells): every R row in a global table,
//      each cell cut into splits over CTAs, so 64 cells fill 132 SMs.
//      The count form only: per-R takes step 1 at any row length.
// Every probed row is read once a launch (the paper's h_parts * |T| cost
// of the scan, kept: the op is stateless per call); every S slot is read
// once.  Counts are unsigned 32-bit and wrap as the reference's int32.
// Bound: the bytes (the keys and validity read once, the output written
// once).
#pragma once

#include <algorithm>

#include "sweep_common.cuh"

namespace rj {

constexpr int kBktThreads = 256;
constexpr int kBktWarps = kBktThreads / 32;
constexpr int kBktTMax = 4096;       // the CTA's T table: 32 KB
constexpr int kBktWarpSlots = 256;   // a warp's R table: 2 KB
constexpr int kBktRounds = 4;        // 32-slot rounds a warp loads at once
constexpr int kBktQueue = 64;        // a warp's queue of live S slots
constexpr long long kLongRow = 2LL * kMinSplit;  // from here, split sweep
static_assert(kBktWarpSlots / 2 == kBktRounds * 32,
              "a shared R list is one load round");

// The batch [P, Q, W] seen from its T rows: T row t (row-major over the
// dimensions in t_mask) is probed by per_t buckets, bucket c of them
// row-major over the other dimensions.
struct BucketGrid {
  long long dims[3];
  int r_mask, t_mask;
  long long n_t, per_t;

  // Bucket c of T row t: its index in the batch (row-major) and its R row.
  __device__ void get(long long t, long long c, long long* bucket,
                      long long* r_row) const {
    long long co[3];
#pragma unroll
    for (int d = 2; d >= 0; --d) {
      if ((t_mask >> d) & 1) {
        co[d] = t % dims[d];
        t /= dims[d];
      } else {
        co[d] = c % dims[d];
        c /= dims[d];
      }
    }
    *bucket = (co[0] * dims[1] + co[1]) * dims[2] + co[2];
    long long r = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if ((r_mask >> d) & 1) r = r * dims[d] + co[d];
    *r_row = r;
  }
};

// The bucket rows as cells of the split sweep: a cell is a bucket, its S
// row and its output.
struct BucketCells {
  BucketGrid g;
  __host__ __device__ long long t_rows() const { return g.n_t; }
  __host__ __device__ long long per_t() const { return g.per_t; }
  __device__ void get(long long t, long long c, long long* s_row,
                      long long* r_row, long long* out) const {
    g.get(t, c, s_row, r_row);
    *out = *s_row;
  }
};

// The global tables of the per-R form for the R rows whose list is longer
// than budget: each live key of the row maps to one of its slots (the slot
// whose claim won), where the key's sum accumulates in the output row.
// Tables cleared by the caller.  Block = (R row, j) as
// spill_clear_kernel's: segments j, j + per_row, ... of kSpillSeg slots.
__global__ void __launch_bounds__(kListThreads)
rep_fill_kernel(const int* __restrict__ rb,
                const unsigned char* __restrict__ rv, long long cr,
                const int* __restrict__ rlen, int budget, unsigned r_cap,
                unsigned per_row, int2* __restrict__ rtab) {
  const long long row = blockIdx.x / per_row;
  if (rlen[row] <= budget) return;
  int2* tab = rtab + row * r_cap;
  for (int k0 = (int)(blockIdx.x % per_row) * kSpillSeg; k0 < cr;
       k0 += (int)per_row * kSpillSeg) {
#pragma unroll
    for (int it = 0; it < kSpillItems; ++it) {
      const int k = k0 + it * kListThreads + threadIdx.x;
      if (k >= cr) break;
      if (rv[row * cr + k] == 0) continue;
      const int b = rb[row * cr + k];
      bool claimed;
      const unsigned s = entry_claim(tab, r_cap, b, hash_key(b), &claimed);
      if (claimed) tab[s].y = k;
    }
  }
}

// Block = (T row, range of per_cta buckets of it), T row fastest.  rkc /
// tkc: the lists [R rows, cr] / [T rows, ct] with rlen / tlen, tdist (T's
// distinct keys, counted for its spilled lists); rtab / ttab: the global
// tables of the lists past the budgets ([R rows, r_cap], [T rows, t_cap]).
// Count: out [batch] zeroed; per-R: out [batch, cr], every slot written.
template <bool kPerR>
__global__ void __launch_bounds__(kBktThreads)
bucket_sweep_kernel(BucketGrid grid, const int* __restrict__ rb,
                    const unsigned char* __restrict__ rv, long long cr,
                    const int2* __restrict__ rkc, const int* __restrict__ rlen,
                    const int2* __restrict__ rtab, unsigned r_cap,
                    const int* __restrict__ sb, const int* __restrict__ sc,
                    const unsigned char* __restrict__ sv, long long cs,
                    const int2* __restrict__ tkc, const int* __restrict__ tlen,
                    const int* __restrict__ tdist, long long ct,
                    const int2* __restrict__ ttab, unsigned t_cap,
                    long long per_cta, int tslots, int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* t_key = reinterpret_cast<int*>(smem);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + tslots);
  int* w_key0 = reinterpret_cast<int*>(t_cnt + tslots);
  unsigned* w_cnt0 =
      reinterpret_cast<unsigned*>(w_key0 + kBktWarps * kBktWarpSlots);
  int* w_key = w_key0 + warp * kBktWarpSlots;
  unsigned* w_cnt = w_cnt0 + warp * kBktWarpSlots;
  int* qb = reinterpret_cast<int*>(w_cnt0 + kBktWarps * kBktWarpSlots) +
            warp * 2 * kBktQueue;
  int* qc = qb + kBktQueue;

  const long long t = blockIdx.x % grid.n_t;
  const long long c0 = (blockIdx.x / grid.n_t) * per_cta;
  const long long c1 = min(grid.per_t, c0 + per_cta);
  const int n_t = tlen[t];
  if (!kPerR && n_t == 0) return;  // uniform: no S slot has a T match
  const int t_budget = tslots / 2;
  const int2* t_glob = n_t <= t_budget || tdist[t] <= t_budget
                           ? nullptr : ttab + t * t_cap;
  const unsigned t_mask = tslots - 1;
  if (n_t > 0 && t_glob == nullptr)  // uniform
    stage_list<kBktRounds>(tkc + t * ct, n_t, t_key, t_cnt, tslots,
                           threadIdx.x, kBktThreads);

  for (long long c = c0 + warp; c < c1; c += kBktWarps) {  // warp-uniform
    long long bucket, r_row;
    grid.get(t, c, &bucket, &r_row);
    const int n_r = rlen[r_row];
    if (!kPerR && n_r == 0) continue;  // out[bucket] stays 0
    const int2* r_glob =
        n_r > kBktWarpSlots / 2 ? rtab + r_row * r_cap : nullptr;
    const int w_slots = pow2_at_least(2 * n_r, 32, kBktWarpSlots);
    const unsigned w_mask = w_slots - 1;
    if (n_r > 0 && r_glob == nullptr) {
      int2 e[kBktRounds];  // (b, count), loaded before the table is cleared
#pragma unroll
      for (int it = 0; it < kBktRounds; ++it) {
        const int k = it * 32 + lane;
        e[it] = k < n_r ? rkc[r_row * cr + k] : make_int2(0, 0);
      }
      table_clear(w_key, w_cnt, w_slots, lane, 32);
      __syncwarp();
#pragma unroll
      for (int it = 0; it < kBktRounds; ++it) {
        if (it * 32 + lane >= n_r) continue;
        if (kPerR)
          table_claim(w_key, w_mask, e[it].x, hash_key(e[it].x));
        else
          table_add(w_key, w_cnt, w_mask, e[it].x, hash_key(e[it].x),
                    (unsigned)e[it].y);
      }
      __syncwarp();
    }
    int* orow = kPerR ? out + bucket * cr : out;  // per-R: its out row
    if (kPerR && r_glob != nullptr) {  // the output row accumulates
      for (long long i = lane; i < cr; i += 32) orow[i] = 0;
      __threadfence_block();
      __syncwarp();
    }
    unsigned v = 0u;
    if (n_t > 0 && n_r > 0)  // warp-uniform
      queue_live<kBktRounds, kBktQueue>(
          sb, sc, sv, bucket * cs, 0, (int)cs, kBktRounds * 32, nullptr, qb,
          qc, [&](int head, int n) {
            unsigned wt = 0u;
            int b = 0;
            if (lane < n) {
              const int q = (head + lane) & (kBktQueue - 1);
              const int key = qc[q];
              wt = t_glob != nullptr
                       ? entry_count(t_glob, t_cap, key, hash_key(key))
                       : table_get(t_key, t_cnt, t_mask, key, hash_key(key));
              b = qb[q];
            }
            if (kPerR) {
              unsigned* acc = nullptr;
              if (wt != 0u) {
                if (r_glob != nullptr) {
                  const int s = entry_slot(r_glob, r_cap, b, hash_key(b));
                  if (s >= 0)
                    acc = reinterpret_cast<unsigned*>(orow + r_glob[s].y);
                } else {
                  const int s = table_find(w_key, w_mask, b, hash_key(b));
                  if (s >= 0) acc = w_cnt + s;
                }
              }
              warp_add_at(acc, acc != nullptr ? wt : 0u);
            } else if (wt != 0u) {
              v += wt * (r_glob != nullptr
                             ? entry_count(r_glob, r_cap, b, hash_key(b))
                             : table_get(w_key, w_cnt, w_mask, b,
                                         hash_key(b)));
            }
          });
    if (!kPerR) {
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) out[bucket] = (int)v;
      continue;
    }
    // per-R: every R slot of the bucket, kBktRounds of them a lane at once
    const int* r_keys = rb + r_row * cr;
    const unsigned char* r_live = rv + r_row * cr;
    if (r_glob != nullptr) {
      __threadfence_block();
      __syncwarp();
    }
    for (long long i0 = 0; i0 < cr; i0 += kBktRounds * 32) {
      bool live[kBktRounds];
      int b[kBktRounds];
#pragma unroll
      for (int it = 0; it < kBktRounds; ++it) {
        const long long i = i0 + it * 32 + lane;
        live[it] = i < cr && r_live[i] != 0;
        b[it] = live[it] ? r_keys[i] : 0;
      }
#pragma unroll
      for (int it = 0; it < kBktRounds; ++it) {
        const long long i = i0 + it * 32 + lane;
        if (i >= cr) continue;
        if (r_glob != nullptr) {
          // the key's sum sits at its representative slot; a dead slot
          // keeps its 0
          if (!live[it]) continue;
          const int s = entry_slot(r_glob, r_cap, b[it], hash_key(b[it]));
          const int rep = s >= 0 ? r_glob[s].y : (int)i;
          if (rep != i) orow[i] = __ldcg(orow + rep);
        } else {
          unsigned a = 0u;
          if (live[it]) {
            const int s = table_find(w_key, w_mask, b[it], hash_key(b[it]));
            if (s >= 0) a = w_cnt[s];
          }
          orow[i] = (int)a;
        }
      }
    }
    __syncwarp();  // the warp's table is free for the next bucket
  }
}

// The pre-pass and the sweep over the bucket rows: R [*, cr] (r_mask), S
// [P, Q, W, cs], T [*, ct] (t_mask), raw keys with bool validity.  Scratch
// from the caller, sized per distinct row and uninitialised: lens [R rows +
// 2 T rows] int32 (rlen, tlen, tdist; zeroed here); lists [R rows * cr +
// T rows * ct] int2 and tabs [2 (R rows * cr + T rows * ct)] int2.  Count:
// out [P, Q, W] int32 (zeroed here); per-R: out [P, Q, W, cr] int32, every
// slot written.
template <bool kPerR>
inline cudaError_t bucket_sweep(const int* rb, const unsigned char* rv,
                                const int* sb, const int* sc,
                                const unsigned char* sv, const int* tc,
                                const unsigned char* tv, long long P,
                                long long Q, long long W, long long cr,
                                long long cs, long long ct, int r_mask,
                                int t_mask, int* lens, int2* lists,
                                int2* tabs, int* out, int device,
                                cudaStream_t st) {
  BucketGrid grid;
  grid.dims[0] = P;
  grid.dims[1] = Q;
  grid.dims[2] = W;
  grid.r_mask = r_mask;
  grid.t_mask = t_mask;
  long long n_r = 1, n_t = 1;
  for (int d = 0; d < 3; ++d) {
    if ((r_mask >> d) & 1) n_r *= grid.dims[d];
    if ((t_mask >> d) & 1) n_t *= grid.dims[d];
  }
  const long long n_b = P * Q * W;
  if (2 * cr > 0x7fffffffLL || 2 * ct > 0x7fffffffLL || cs > 0x3fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSuccess;
  if (!kPerR && n_b > 0) err = cudaMemsetAsync(out, 0, n_b * 4, st);
  if (err != cudaSuccess || n_b == 0 || cr == 0) return err;
  err = cudaMemsetAsync(lens, 0, (n_r + 2 * n_t) * 4, st);
  if (err != cudaSuccess) return err;
  grid.n_t = n_t;
  grid.per_t = n_b / n_t;
  int* rlen = lens;
  int* tlen = lens + n_r;
  int* tdist = tlen + n_t;
  int2* rkc = lists;
  int2* tkc = lists + n_r * cr;
  int2* rtab = tabs;
  int2* ttab = tabs + n_r * 2 * cr;
  const unsigned r_cap = (unsigned)(2 * cr), t_cap = (unsigned)(2 * ct);
  const bool split = !kPerR && cs >= kLongRow;
  const int r_budget = split ? 0 : kBktWarpSlots / 2;
  err = count_keys(rb, rv, n_r, cr, 0, true, rkc, nullptr, rlen, st);
  if (err == cudaSuccess && kPerR) {
    const long long per_row = spill_ctas(cr);
    if (n_r * per_row > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    err = clear_tables(rlen, n_r, r_budget, r_cap, rtab, st);
    if (err == cudaSuccess) {
      rep_fill_kernel<<<(unsigned)(n_r * per_row), kListThreads, 0, st>>>(
          rb, rv, cr, rlen, r_budget, r_cap, (unsigned)per_row, rtab);
      err = cudaGetLastError();
    }
  } else if (err == cudaSuccess) {
    err = spill(rkc, nullptr, rlen, n_r, cr, r_budget, 1, r_cap, rtab,
                nullptr, st);
  }
  const int tslots = split ? split_tslots(ct)
                           : pow2_at_least(2 * ct, 64, kBktTMax);
  if (err == cudaSuccess)
    err = count_keys(tc, tv, n_t, ct, 0, true, tkc, nullptr, tlen, st);
  if (err == cudaSuccess)
    err = spill(tkc, nullptr, tlen, n_t, ct, tslots / 2, 1, t_cap, ttab,
                tdist, st);
  if (err != cudaSuccess) return err;
  if (!kPerR && (cs == 0 || ct == 0)) return cudaSuccess;  // out stays 0
  if (split)
    return launch_split_sweep(BucketCells{grid}, rtab, r_cap, rlen, sb, sc,
                              sv, tkc, tlen, tdist, ct, ttab, t_cap, cs, out,
                              device, st);
  // about four CTAs an SM, with a bucket for every warp of a CTA
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = 4LL * sms;
  const long long chunks = std::max(
      1LL, std::min((want + n_t - 1) / n_t,
                    (grid.per_t + kBktWarps - 1) / kBktWarps));
  const long long per_cta = (grid.per_t + chunks - 1) / chunks;
  const long long blocks = n_t * ((grid.per_t + per_cta - 1) / per_cta);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)tslots * 8 +
                      (size_t)kBktWarps * kBktWarpSlots * 8 +
                      (size_t)kBktWarps * 2 * kBktQueue * 4;
  err = cudaFuncSetAttribute(bucket_sweep_kernel<kPerR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  bucket_sweep_kernel<kPerR><<<(unsigned)blocks, kBktThreads, smem, st>>>(
      grid, rb, rv, cr, rkc, rlen, rtab, r_cap, sb, sc, sv, cs, tkc, tlen,
      tdist, ct, ttab, t_cap, per_cta, tslots, out);
  return cudaGetLastError();
}

}  // namespace rj
