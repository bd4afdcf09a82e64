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
// sides become count tables, read once per S slot:
//   0. a pre-pass (count_keys_kernel) turns the R slots of each H (its u
//      rows, keyed by (h, b)) and the T slots of each g (keyed by c) into
//      compact (key, count) lists, reading the validity masks itself.  A
//      list is about as long as its keys are distinct: at N = 4e6 and
//      m_budget = 16384 a T row of ~16,300 live slots holds ~57 keys, the
//      64 R rows of an H ~70;
//   1. a list longer than its shared table's budget (T: half the CTA's
//      table, R: half a warp's) goes into a hash table in global memory
//      instead (spill_clear_kernel, spill_fill_kernel; one per g, one per
//      (H, h), twice the row's slots), so a row whose keys are all
//      distinct costs one global probe per S slot, not a pass per chunk;
//   2. one CTA per (g, range of H) loads g's list into a shared count
//      table once (or reads g's global table);
//   3. each warp takes one H at a time: it loads H's list into a table of
//      its own (or reads H's global tables), streams the u x Cs S slots of
//      (H, g) (contiguous, read coalesced), queues the live ones in shared
//      memory and probes both tables for 32 queued slots at a time, so
//      every lane carries a live slot; wr * wt goes to out[H, h] with one
//      atomic per run of equal cells in the warp.
// Every S slot is read once.  Slot indices are 32-bit within an (H, g)
// block: no 64-bit division per slot.  Counts are unsigned 32-bit and wrap
// as the reference's int32.
// Bound: the bytes, chiefly the S grid read once (a few hundred MB at the
// size above).
#include <algorithm>

#include "fused_common.cuh"
#include "smem_hash.cuh"

namespace rj {

constexpr int kLinThreads = 256;
constexpr int kLinWarps = kLinThreads / 32;
constexpr int kCountSeg = 2048;       // slots of one pre-pass block
constexpr int kCountSlots = 4096;     // its table: >= 2 x kCountSeg keys
constexpr int kTSlotsMax = 4096;      // the sweep's T table: 32 KB
constexpr int kWarpSlots = 256;       // a warp's R table: 3 KB
constexpr int kQueue = 64;            // a warp's queue of live S slots
constexpr int kCountItems = kCountSeg / kLinThreads;  // slots a thread counts
constexpr int kRounds = 4;            // 32-slot rounds a warp loads at once
static_assert(kWarpSlots / 2 == kRounds * 32, "a shared R list is one load round");

// Each row of keys [rows, c] (live where valid) becomes (key, count)
// entries at the front of its row of out, in any order; len[row] (zeroed
// by the caller) counts them.  With sub > 0 the key is (k / sub, key) for
// slot k of the row, and k / sub goes to out_sub.  Block = (row, segment
// of kCountSeg slots); a key of several segments appears once for each.
__global__ void __launch_bounds__(kLinThreads)
count_keys_kernel(const int* __restrict__ keys,
                  const unsigned char* __restrict__ valid, long long c,
                  int sub, unsigned segs, int slots, int2* __restrict__ out,
                  int* __restrict__ out_sub, int* __restrict__ len) {
  extern __shared__ unsigned long long smem[];
  __shared__ int n_used;
  unsigned long long* key = smem;  // (k / sub, key)
  unsigned* cnt = reinterpret_cast<unsigned*>(key + slots);
  int* used = reinterpret_cast<int*>(cnt + slots);  // the claimed slots
  const long long row = blockIdx.x / segs;
  const int seg = blockIdx.x % segs;
  const long long base = row * c;
  const unsigned mask = slots - 1;
  const int lane = threadIdx.x & 31;
  // every load of the segment first, then the table
  const int k0 = seg * kCountSeg;
  const int k1 = (int)min(c, (long long)k0 + kCountSeg);
  bool live[kCountItems];
  int x[kCountItems];
#pragma unroll
  for (int it = 0; it < kCountItems; ++it) {
    const int k = k0 + it * kLinThreads + threadIdx.x;
    live[it] = k < k1 && valid[base + k] != 0;
    x[it] = k < k1 ? keys[base + k] : 0;
  }
  table_clear(key, cnt, slots, threadIdx.x, kLinThreads);
  if (threadIdx.x == 0) n_used = 0;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kCountItems; ++it) {
    const int k = k0 + it * kLinThreads + threadIdx.x;
    const int h = sub > 0 ? k / sub : 0;
    const unsigned m = __ballot_sync(0xffffffffu, live[it]);
    if (!live[it]) continue;
    // lanes with the same key add once, with their number
    const unsigned long long kk = pair_key(h, x[it]);
    const unsigned peers = __match_any_sync(m, kk);
    if (lane != __ffs(peers) - 1) continue;
    for (unsigned s = hash_pair(h, x[it]) & mask;; s = (s + 1) & mask) {
      unsigned long long old = key[s];
      if (old == kEmptyPair) old = atomicCAS(key + s, kEmptyPair, kk);
      if (old == kEmptyPair) used[atomicAdd(&n_used, 1)] = (int)s;
      if (old == kEmptyPair || old == kk) {
        atomicAdd(cnt + s, __popc(peers));
        break;
      }
    }
  }
  __syncthreads();
  const int n = n_used;
  for (int e0 = 0; e0 < n; e0 += kLinThreads) {  // uniform trip count
    const int e = e0 + threadIdx.x;
    const bool has = e < n;
    const unsigned m = __ballot_sync(0xffffffffu, has);
    if (m == 0u) continue;
    int pos = 0;
    if (lane == 0) pos = atomicAdd(len + row, __popc(m));
    pos = __shfl_sync(0xffffffffu, pos, 0);
    if (has) {
      const int s = used[e];
      const long long p = base + pos + __popc(m & lanemask_lt());
      const unsigned long long kk = key[s];
      out[p] = make_int2((int)(unsigned)kk, (int)cnt[s]);
      if (sub > 0) out_sub[p] = (int)(kk >> 32);
    }
  }
}

constexpr int kSpillItems = 8;  // entries a thread of a spill kernel takes
constexpr int kSpillSeg = kSpillItems * kLinThreads;

// Empty the global tables of every row whose list is longer than budget:
// row r owns tab[r * span, (r + 1) * span).  Block = (row, segment).
__global__ void __launch_bounds__(kLinThreads)
spill_clear_kernel(const int* __restrict__ len, int budget, long long span,
                   unsigned segs, int2* __restrict__ tab) {
  const long long row = blockIdx.x / segs;
  if (len[row] <= budget) return;
  const long long k0 = row * span + (long long)(blockIdx.x % segs) * kSpillSeg;
  const long long k1 = min(k0 + kSpillSeg, (row + 1) * span);
  for (long long k = k0 + threadIdx.x; k < k1; k += kLinThreads)
    tab[k] = make_int2(kEmptyKey, 0);
}

// Put the (key, count) list of every row longer than budget into its
// global table: one table of cap slots per sub-row (sub: the list's sub-row
// index beside each entry, or null for one table a row).  Lists have row
// stride c, tables of a row span sub_rows * cap.  Block = (row, segment).
__global__ void __launch_bounds__(kLinThreads)
spill_fill_kernel(const int2* __restrict__ list, const int* __restrict__ sub,
                  const int* __restrict__ len, long long c, int budget,
                  int sub_rows, unsigned cap, unsigned segs,
                  int2* __restrict__ tab) {
  const long long row = blockIdx.x / segs;
  const int n = len[row];
  if (n <= budget) return;
  const int k0 = (int)(blockIdx.x % segs) * kSpillSeg;
#pragma unroll
  for (int it = 0; it < kSpillItems; ++it) {
    const int k = k0 + it * kLinThreads + threadIdx.x;
    if (k >= n) break;
    const int2 e = list[row * c + k];  // (key, count)
    const int h = sub != nullptr ? sub[row * c + k] : 0;
    entry_add(tab + (row * sub_rows + h) * (long long)cap, cap, e.x,
              hash_key(e.x), (unsigned)e.y);
  }
}

struct WarpTable {
  unsigned long long* key;  // (h, b)
  unsigned* cnt;
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
  const int2* r_rows;     // H's global tables, r_cap slots each, or null
  unsigned r_cap;
};

// The queued slots head .. head + n - 1 (n <= 32): one per lane, both
// tables probed, wr * wt added to out[H, h].
__device__ __forceinline__ void probe_queued(const WarpTable& w,
                                             const Probe& p, int head, int n,
                                             int cs, long long cell0,
                                             int* out) {
  const int lane = threadIdx.x & 31;
  long long cell = -1;
  unsigned v = 0u;
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
      v = wt * (p.r_rows != nullptr
                    ? entry_count(p.r_rows + (long long)h * p.r_cap, p.r_cap,
                                  b, hash_key(b))
                    : table_get(w.key, w.cnt, p.w_mask, pair_key(h, b),
                                hash_pair(h, b)));
    }
    cell = cell0 + h;
  }
  warp_add_by_cell(out, cell, v);
}

// rkc / rsub: H's (key, count) lists [hp, u * cr] with their h, rlen [hp];
// tkc: g's lists [gp, ct], tlen [gp]; rtab / ttab: the global tables of the
// lists past their budgets ([hp, u, r_cap], [gp, t_cap]); sb, sc, sv: the
// S grid [hp, gp, u, cs].  Block = (g, range of h_per_cta H's), g fastest.
__global__ void __launch_bounds__(kLinThreads)
linear_sweep_kernel(const int2* __restrict__ rkc, const int* __restrict__ rsub,
                    const int* __restrict__ rlen, long long rc,
                    const int2* __restrict__ rtab, unsigned r_cap,
                    const int* __restrict__ sb, const int* __restrict__ sc,
                    const unsigned char* __restrict__ sv,
                    const int2* __restrict__ tkc, const int* __restrict__ tlen,
                    long long ct, const int2* __restrict__ ttab,
                    unsigned t_cap, int hp, int gp, int u, int cs,
                    int h_per_cta, int tslots, int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpTable w;
  w.key = smem + warp * kWarpSlots;
  w.cnt = reinterpret_cast<unsigned*>(smem + kLinWarps * kWarpSlots) +
          warp * kWarpSlots;
  int* t_key = reinterpret_cast<int*>(smem + kLinWarps * kWarpSlots) +
               kLinWarps * kWarpSlots;
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + tslots);
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

  if (p.t_glob == nullptr) {
    table_clear(t_key, t_cnt, tslots, threadIdx.x, kLinThreads);
    __syncthreads();
    for (int k0 = 0; k0 < n_t; k0 += kRounds * kLinThreads) {
      int2 e[kRounds];  // (c, count)
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        const int k = k0 + it * kLinThreads + threadIdx.x;
        e[it] = k < n_t ? tkc[(long long)g * ct + k] : make_int2(0, 0);
      }
#pragma unroll
      for (int it = 0; it < kRounds; ++it)
        if (e[it].y != 0)
          table_add(t_key, t_cnt, p.t_mask, e[it].x, hash_key(e[it].x),
                    (unsigned)e[it].y);
    }
    __syncthreads();
  }

  for (int H = h0 + warp; H < h1; H += kLinWarps) {  // warp-uniform
    const int n_r = rlen[H];
    if (n_r == 0) continue;
    const long long sbase = ((long long)H * gp + g) * n_blk;
    p.r_rows = n_r > kWarpSlots / 2 ? rtab + (long long)H * u * r_cap
                                    : nullptr;
    if (p.r_rows == nullptr) {
      const int w_slots = pow2_at_least(2 * n_r, 32, kWarpSlots);
      p.w_mask = w_slots - 1;
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
      __syncwarp();
#pragma unroll
      for (int it = 0; it < kRounds; ++it)
        if (e[it].y != 0)
          table_add(w.key, w.cnt, p.w_mask, pair_key(eh[it], e[it].x),
                    hash_pair(eh[it], e[it].x), (unsigned)e[it].y);
      __syncwarp();
    }
    int head = 0, tail = 0;
    for (int k0 = 0; k0 < n_blk; k0 += kRounds * 32) {
      // kRounds rounds of slots loaded at once (keys of dead slots too:
      // they share the live slots' cache lines)
      bool live[kRounds];
      int b[kRounds], c[kRounds];
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        const int k = k0 + it * 32 + lane;
        live[it] = k < n_blk && sv[sbase + k] != 0;
        b[it] = k < n_blk ? sb[sbase + k] : 0;
        c[it] = k < n_blk ? sc[sbase + k] : 0;
      }
#pragma unroll
      for (int it = 0; it < kRounds; ++it) {
        const unsigned m = __ballot_sync(0xffffffffu, live[it]);
        if (live[it]) {
          const int q = (tail + __popc(m & lanemask_lt())) & (kQueue - 1);
          w.qk[q] = k0 + it * 32 + lane;
          w.qb[q] = b[it];
          w.qc[q] = c[it];
        }
        tail += __popc(m);
        if (tail - head >= 32) {
          __syncwarp();
          probe_queued(w, p, head, 32, cs, (long long)H * u, out);
          head += 32;
          __syncwarp();
        }
      }
    }
    if (tail > head) {
      __syncwarp();
      probe_queued(w, p, head, tail - head, cs, (long long)H * u, out);
    }
    __syncwarp();  // the queue and the table are free for the next H
  }
}

inline cudaError_t count_keys(const int* keys, const unsigned char* valid,
                              long long rows, long long c, int sub,
                              int2* out, int* out_sub, int* len,
                              cudaStream_t stream) {
  if (rows == 0 || c == 0) return cudaSuccess;
  const long long segs = (c + kCountSeg - 1) / kCountSeg;
  if (rows * segs > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int slots = pow2_at_least(2 * std::min(c, (long long)kCountSeg), 32,
                                  kCountSlots);
  const size_t smem = (size_t)slots * 12 + (size_t)kCountSeg * 4;
  cudaError_t err = cudaFuncSetAttribute(
      count_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  count_keys_kernel<<<(unsigned)(rows * segs), kLinThreads, smem, stream>>>(
      keys, valid, c, sub, (unsigned)segs, slots, out, out_sub, len);
  return cudaGetLastError();
}

// Empty and fill the global tables of the lists longer than budget: rows
// lists of stride c, tables of span slots a row (sub_rows of cap each).
inline cudaError_t spill(const int2* list, const int* sub, const int* len,
                         long long rows, long long c, int budget,
                         int sub_rows, unsigned cap, int2* tab,
                         cudaStream_t stream) {
  const long long span = (long long)sub_rows * cap;
  const long long clear_segs = (span + kSpillSeg - 1) / kSpillSeg;
  const long long fill_segs = (c + kSpillSeg - 1) / kSpillSeg;
  if (rows * clear_segs > 0x7fffffffLL || rows * fill_segs > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  spill_clear_kernel<<<(unsigned)(rows * clear_segs), kLinThreads, 0,
                       stream>>>(len, budget, span, (unsigned)clear_segs, tab);
  spill_fill_kernel<<<(unsigned)(rows * fill_segs), kLinThreads, 0, stream>>>(
      list, sub, len, c, budget, sub_rows, cap, (unsigned)fill_segs, tab);
  return cudaGetLastError();
}

}  // namespace rj

// Scratch from the caller: rkc [hp, u * cr] int2 and rsub [hp, u * cr]
// int32, tkc [gp, ct] int2, rtab [hp, u, 2 * cr] int2 and ttab
// [gp, 2 * ct] int2 (uninitialised); rlen [hp], tlen [gp] int32 zeroed;
// out [hp, u] int32 zeroed.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hp * gp * u == 0 || cr == 0 || cs == 0 || ct == 0)
    return (int)cudaSuccess;
  if (u * cr > 0x7fffffffLL || u * cs > 0x7fffffffLL ||
      2 * ct > 0x7fffffffLL || 2 * cr > 0x7fffffffLL || hp > 0x7fffffffLL ||
      gp > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int2* r_lists = static_cast<int2*>(rkc);
  int2* t_lists = static_cast<int2*>(tkc);
  int2* r_tabs = static_cast<int2*>(rtab);
  int2* t_tabs = static_cast<int2*>(ttab);
  const int tslots = rj::pow2_at_least(2 * ct, 64, rj::kTSlotsMax);
  const unsigned r_cap = (unsigned)(2 * cr), t_cap = (unsigned)(2 * ct);
  // R: one row per H, its u rows of cr slots keyed by (h, b); T: one per g
  err = rj::count_keys(rb, rv, hp, u * cr, (int)cr, r_lists, rsub, rlen, st);
  if (err == cudaSuccess)
    err = rj::count_keys(tc, tv, gp, ct, 0, t_lists, nullptr, tlen, st);
  // the lists past the shared tables' budgets, into global tables
  if (err == cudaSuccess)
    err = rj::spill(r_lists, rsub, rlen, hp, u * cr, rj::kWarpSlots / 2,
                    (int)u, r_cap, r_tabs, st);
  if (err == cudaSuccess)
    err = rj::spill(t_lists, nullptr, tlen, gp, ct, tslots / 2, 1, t_cap,
                    t_tabs, st);
  if (err != cudaSuccess) return (int)err;
  // enough blocks for ~4 waves at 3 blocks an SM
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = 12LL * sms;
  const long long h_chunks = std::max(1LL, std::min(hp, (want + gp - 1) / gp));
  const int h_per_cta = (int)((hp + h_chunks - 1) / h_chunks);
  const long long blocks = gp * ((hp + h_per_cta - 1) / h_per_cta);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)rj::kLinWarps * rj::kWarpSlots * 12 +
                      (size_t)tslots * 8 +
                      (size_t)rj::kLinWarps * 3 * rj::kQueue * 4;
  err = cudaFuncSetAttribute(rj::linear_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  rj::linear_sweep_kernel<<<(unsigned)blocks, rj::kLinThreads, smem, st>>>(
      r_lists, rsub, rlen, u * cr, r_tabs, r_cap, sb, sc, sv, t_lists, tlen,
      ct, t_tabs, t_cap, (int)hp, (int)gp, (int)u, (int)cs, h_per_cta, tslots,
      out);
  return (int)cudaGetLastError();
}
