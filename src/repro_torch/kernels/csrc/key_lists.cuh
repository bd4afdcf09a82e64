// The pre-pass of the hash-table join sweeps (Hopper, sm_90a): the fused
// linear, per-R and star sweeps and the bucket-row sweeps of the baselines.
// Each probed bucket row becomes a compact (key, count) list, and a list
// longer than its sweep's shared budget also a hash table in global memory.
//
//   count_keys: the live slots of each row of keys [rows, c] (validity read
//     here, nothing masked; a key is loaded only where its slot is live, so
//     a row's dead tail costs its validity bytes) become (key, count)
//     entries at the front of the row's list, in any order.  Block = (row,
//     segment of kCountSeg slots): a segment with no live slot ends at
//     once; otherwise it counts its keys in a shared table (lanes with equal
//     keys combine first), so a key of several segments appears once for
//     each, and a list is about as long as its row's keys are distinct per
//     segment;
//   spill: the lists longer than a budget go into global tables of
//     smem_hash.cuh's entry_add (twice the row's slots, so at most half
//     full), merging a key's entries, and can count the distinct keys of
//     each such row.  Its grid follows the rows and their length: few
//     long rows, up to kSpillCtas CTAs a row; many, a wave of CTAs walking
//     them, one a row, clear and fill in one launch.  clear_tables
//     empties those tables alone, for a caller that fills them otherwise.
#pragma once

#include <algorithm>

#include "error_string.cuh"
#include "occupancy.cuh"
#include "smem_hash.cuh"

namespace rj {

constexpr int kListThreads = 256;
constexpr int kCountSeg = 2048;       // slots of one pre-pass block
constexpr int kCountSlots = 4096;     // its table: >= 2 x kCountSeg keys
constexpr int kCountItems = kCountSeg / kListThreads;  // slots a thread counts

// Each row of keys [rows, c] (live where valid) becomes (key, count)
// entries at the front of its row of out, in any order; len[row] (zeroed
// by the caller) counts them.  With sub > 0 the key is (k / sub, key) for
// slot k of the row, and k / sub goes to out_sub.  Without with_counts an
// entry's count word is written 0 (a sweep's accumulator).
__global__ void __launch_bounds__(kListThreads)
count_keys_kernel(const int* __restrict__ keys,
                  const unsigned char* __restrict__ valid, long long c,
                  int sub, unsigned segs, int slots, bool with_counts,
                  int2* __restrict__ out, int* __restrict__ out_sub,
                  int* __restrict__ len) {
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
  bool any = false;
#pragma unroll
  for (int it = 0; it < kCountItems; ++it) {
    const int k = k0 + it * kListThreads + threadIdx.x;
    live[it] = k < k1 && valid[base + k] != 0;
    any |= live[it];
  }
#pragma unroll
  for (int it = 0; it < kCountItems; ++it)
    x[it] = live[it] ? keys[base + k0 + it * kListThreads + threadIdx.x] : 0;
  if (!__syncthreads_or(any)) return;  // uniform: a dead segment adds nothing
  table_clear(key, cnt, slots, threadIdx.x, kListThreads);
  if (threadIdx.x == 0) n_used = 0;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kCountItems; ++it) {
    const int k = k0 + it * kListThreads + threadIdx.x;
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
  for (int e0 = 0; e0 < n; e0 += kListThreads) {  // uniform trip count
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
      out[p] = make_int2((int)(unsigned)kk, with_counts ? (int)cnt[s] : 0);
      if (sub > 0) out_sub[p] = (int)(kk >> 32);
    }
  }
}

constexpr int kSpillItems = 8;  // entries a thread of a spill kernel takes
constexpr int kSpillSeg = kSpillItems * kListThreads;

constexpr int kSpillCtas = 16;  // CTAs a row of a spill kernel, at most

// Empty the global tables of every row whose list is longer than budget:
// row r owns tab[r * span, (r + 1) * span).  Block = (row, j): segments j,
// j + per_row, ... of the row, so a row that does not spill costs one
// load of each of its per_row CTAs.
__global__ void __launch_bounds__(kListThreads)
spill_clear_kernel(const int* __restrict__ len, int budget, long long span,
                   unsigned per_row, int2* __restrict__ tab) {
  const long long row = blockIdx.x / per_row;
  if (len[row] <= budget) return;
  const long long end = (row + 1) * span;
  for (long long k0 = row * span + (long long)(blockIdx.x % per_row) *
                                       kSpillSeg;
       k0 < end; k0 += (long long)per_row * kSpillSeg) {
    const long long k1 = min(k0 + kSpillSeg, end);
    for (long long k = k0 + threadIdx.x; k < k1; k += kListThreads)
      tab[k] = make_int2(kEmptyKey, 0);
  }
}

// Put the (key, count) list of every row longer than budget into its
// global table: one table of cap slots per sub-row (sub: the list's sub-row
// index beside each entry, or null for one table a row).  Lists have row
// stride c, tables of a row span sub_rows * cap.  distinct (or null) counts
// the keys of each row's tables.  Block = (row, j) as spill_clear_kernel's.
__global__ void __launch_bounds__(kListThreads)
spill_fill_kernel(const int2* __restrict__ list, const int* __restrict__ sub,
                  const int* __restrict__ len, long long c, int budget,
                  int sub_rows, unsigned cap, unsigned per_row,
                  int2* __restrict__ tab, int* __restrict__ distinct) {
  const long long row = blockIdx.x / per_row;
  const int n = len[row];
  if (n <= budget) return;
  for (int k0 = (int)(blockIdx.x % per_row) * kSpillSeg; k0 < n;
       k0 += (int)per_row * kSpillSeg) {
#pragma unroll
    for (int it = 0; it < kSpillItems; ++it) {
      const int k = k0 + it * kListThreads + threadIdx.x;
      if (k >= n) break;
      const int2 e = list[row * c + k];  // (key, count)
      const int h = sub != nullptr ? sub[row * c + k] : 0;
      const bool claimed =
          entry_add(tab + (row * sub_rows + h) * (long long)cap, cap, e.x,
                    hash_key(e.x), (unsigned)e.y);
      if (claimed && distinct != nullptr) atomicAdd(distinct + row, 1);
    }
  }
}

// CTAs a row of a spill kernel over n items: one per segment of
// kSpillSeg, at most kSpillCtas.
inline long long spill_ctas(long long n) {
  return std::max(1LL, std::min((long long)kSpillCtas,
                                (n + kSpillSeg - 1) / kSpillSeg));
}

// Empty and fill the global tables of the rows whose list is longer than
// budget, as the two kernels above do, one CTA a row (its barrier orders
// the clear before the fill) and a wave of them walking the rows, so a row
// that does not spill costs one load.
__global__ void __launch_bounds__(kListThreads)
spill_rows_kernel(const int2* __restrict__ list, const int* __restrict__ sub,
                  const int* __restrict__ len, long long rows, long long c,
                  int budget, int sub_rows, unsigned cap,
                  int2* __restrict__ tab, int* __restrict__ distinct) {
  const long long span = (long long)sub_rows * cap;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int n = len[row];
    if (n <= budget) continue;  // uniform
    int2* t = tab + row * span;
    for (long long k = threadIdx.x; k < span; k += kListThreads)
      t[k] = make_int2(kEmptyKey, 0);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += kListThreads) {
      const int2 e = list[row * c + k];  // (key, count)
      const int h = sub != nullptr ? sub[row * c + k] : 0;
      if (entry_add(t + (long long)h * cap, cap, e.x, hash_key(e.x),
                    (unsigned)e.y) &&
          distinct != nullptr)
        atomicAdd(distinct + row, 1);
    }
  }
}

// CTAs a row of the per-row spill kernels over rows of n items:
// spill_ctas(n), at most the card's wave (*wave CTAs) over the rows.
inline cudaError_t spill_per_row(long long rows, long long n,
                                 long long* per_row, long long* wave) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = resident_ctas((const void*)spill_rows_kernel, kListThreads, 0, 1,
                        device, wave);
  if (err == cudaSuccess)
    *per_row = std::max(1LL, std::min(spill_ctas(n), *wave / rows));
  return err;
}

inline cudaError_t count_keys(const int* keys, const unsigned char* valid,
                              long long rows, long long c, int sub,
                              bool with_counts, int2* out, int* out_sub,
                              int* len, cudaStream_t stream) {
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
  count_keys_kernel<<<(unsigned)(rows * segs), kListThreads, smem, stream>>>(
      keys, valid, c, sub, (unsigned)segs, slots, with_counts, out, out_sub,
      len);
  return cudaGetLastError();
}

// Empty the global tables (span slots a row) of the rows whose list is
// longer than budget.
inline cudaError_t clear_tables(const int* len, long long rows, int budget,
                                long long span, int2* tab,
                                cudaStream_t stream) {
  if (rows == 0 || span == 0) return cudaSuccess;
  long long per_row = 0, wave = 0;
  cudaError_t err = spill_per_row(rows, span, &per_row, &wave);
  if (err != cudaSuccess) return err;
  if (rows * per_row > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spill_clear_kernel<<<(unsigned)(rows * per_row), kListThreads, 0,
                       stream>>>(len, budget, span, (unsigned)per_row, tab);
  return cudaGetLastError();
}

// Empty and fill the global tables of the lists longer than budget: rows
// lists of stride c, tables of span slots a row (sub_rows of cap each);
// distinct as spill_fill_kernel's.  Up to kSpillCtas CTAs a row clear
// and then fill them where the rows leave the card room for more than
// one CTA each (Q2's 8 star rows of 31,256 slots take 16); otherwise
// (B6's 4,096 pair lists, few of which spill, or short lists) a wave of
// spill_rows_kernel walks the rows, one CTA a row doing both.
inline cudaError_t spill(const int2* list, const int* sub, const int* len,
                         long long rows, long long c, int budget,
                         int sub_rows, unsigned cap, int2* tab,
                         int* distinct, cudaStream_t stream) {
  if (rows == 0 || c == 0) return cudaSuccess;
  const long long span = (long long)sub_rows * cap;
  long long per_row = 0, wave = 0;
  cudaError_t err = spill_per_row(rows, c, &per_row, &wave);
  if (err != cudaSuccess) return err;
  if (per_row == 1) {
    spill_rows_kernel<<<(unsigned)std::min(rows, wave), kListThreads, 0,
                        stream>>>(list, sub, len, rows, c, budget, sub_rows,
                                  cap, tab, distinct);
    return cudaGetLastError();
  }
  if (rows * per_row > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  err = clear_tables(len, rows, budget, span, tab, stream);
  if (err != cudaSuccess) return err;
  spill_fill_kernel<<<(unsigned)(rows * per_row), kListThreads, 0, stream>>>(
      list, sub, len, c, budget, sub_rows, cap, (unsigned)per_row, tab,
      distinct);
  return cudaGetLastError();
}

}  // namespace rj
