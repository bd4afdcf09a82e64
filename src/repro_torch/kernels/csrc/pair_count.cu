// bucket_pair_count on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:55 pair_count
// (_pair_count_kernel, :47): per bucket row b, the number of equal key
// pairs #{(i, j) : ka[b, i] == kb[b, j], both slots live}, the inner loop
// of the bucketed binary join.  The Pallas body compares all Ca x Cb pairs
// of a bucket in VMEM and sums the 0/1 matrix in f32.
//
// The count is sum over keys k of count_a(k) * count_b(k): the linear
// sweep's R-side weight, probed once per live slot of the other side.
// Operands are raw keys with their bool validity, rows of a batch of up to
// kPairDims dimensions in which a side of size 1 along a dimension is one
// row shared along it (a zero row stride: listed once a launch and read,
// never copied, per bucket).  Nothing is sorted or masked.
//   0. the pre-pass (key_lists.cuh count_keys) makes each distinct row of
//      the listed side a (key, count) list: it reads the validity itself,
//      loads a key only where its slot is live, ends a segment with no live
//      slot at once, and combines a warp's lanes with equal keys before
//      they add (__match_any_sync), so B6's rows (~3.4 distinct keys in
//      ~977 live slots) do not serialise on a shared counter.  The listed
//      side is the one with the shorter rows, a on a tie (the wrapper
//      passes it first): its tables are the smaller.  A list longer than
//      the sweep's shared budget (kPairTMax / 2 entries) goes into a global
//      hash table with its distinct keys counted (key_lists.cuh's spill;
//      at B6's 4,096 rows its grid is a wave of CTAs walking the rows, so
//      a row that does not spill costs one load);
//   1. the sweep: one CTA per (bucket, split of the streamed row) stages
//      its listed row's list in a shared count table sized to the list
//      (sweep_common.cuh's stage_list; a list that repeats its keys past the
//      budget but holds at most budget distinct keys too), or probes the
//      row's global table; it streams the other side's row (validity
//      coalesced, keys loaded where live), probes once per live slot (reads
//      only: lanes with equal keys read one word, a broadcast) and adds
//      its sum to out[bucket] with one atomic.
// The output and the lengths are zeroed here (memsets, no fill kernel).
// Counts are unsigned 32-bit and wrap as the reference's int32 sums.
// Bound: the bytes this run needs, both sides' validity at 1 B a slot
// and their live keys at 4 B each (a dead slot's key is never read) and
// the counts written once; the table formulation needs one insert per
// live listed slot and one probe per live streamed slot.
#include <algorithm>

#include "occupancy.cuh"
#include "sweep_common.cuh"

namespace rj {

constexpr int kPairDims = 5;
constexpr int kPairThreads = 256;
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kPairTMax = 4096;     // the shared table: 32 KB
constexpr int kPairBudget = kPairTMax / 2;
constexpr int kPairRounds = 4;      // slots a thread loads at once
constexpr long long kPairMinSplit = 4LL * kPairThreads * kPairRounds;

// The batch and the two sides' row strides per dimension (0 where a side
// is one row shared along it); bucket i is row-major over dims.
struct PairGrid {
  long long dims[kPairDims], l[kPairDims], s[kPairDims];
  __device__ void rows(long long i, long long* l_row,
                       long long* s_row) const {
    long long lr = 0, sr = 0;
#pragma unroll
    for (int d = kPairDims - 1; d >= 0; --d) {
      const long long c = i % dims[d];
      i /= dims[d];
      lr += c * l[d];
      sr += c * s[d];
    }
    *l_row = lr;
    *s_row = sr;
  }
};

// Block = (bucket, split j of the streamed row), bucket fastest.  lists
// [listed rows, cl] with len and distinct; tabs [listed rows, cap] the
// global tables of the lists past the budget; sk, sv the streamed rows of
// cs slots.  out [buckets] zeroed.
__global__ void __launch_bounds__(kPairThreads)
pair_sweep_kernel(PairGrid grid, const int2* __restrict__ lists,
                  const int* __restrict__ len,
                  const int* __restrict__ distinct, long long cl,
                  const int2* __restrict__ tabs, unsigned cap,
                  const int* __restrict__ sk,
                  const unsigned char* __restrict__ sv, long long cs,
                  long long n_buckets, int splits, int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ unsigned warp_sum[kPairWarps];
  int* t_key = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bucket = blockIdx.x % n_buckets;
  const int j = (int)(blockIdx.x / n_buckets);
  long long l_row, s_row;
  grid.rows(bucket, &l_row, &s_row);
  const int n = len[l_row];
  if (n == 0) return;  // uniform: out[bucket] stays 0
  const int2* glob = n <= kPairBudget || distinct[l_row] <= kPairBudget
                         ? nullptr : tabs + l_row * cap;
  const int slots =
      pow2_at_least(2LL * min(n, kPairBudget), 64, kPairTMax);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + slots);
  if (glob == nullptr)
    stage_list<kPairRounds>(lists + l_row * cl, n, t_key, t_cnt, slots,
                            threadIdx.x, kPairThreads);
  const unsigned mask = slots - 1;

  const long long k_lo = cs * j / splits, k_hi = cs * (j + 1) / splits;
  const int* keys = sk + s_row * cs;
  const unsigned char* live_of = sv + s_row * cs;
  unsigned v = 0u;
  for (long long k0 = k_lo; k0 < k_hi;
       k0 += (long long)kPairRounds * kPairThreads) {
    bool live[kPairRounds];
    int x[kPairRounds];
#pragma unroll
    for (int it = 0; it < kPairRounds; ++it) {
      const long long k = k0 + it * kPairThreads + threadIdx.x;
      live[it] = k < k_hi && live_of[k] != 0;
    }
#pragma unroll
    for (int it = 0; it < kPairRounds; ++it)
      x[it] = live[it] ? keys[k0 + it * kPairThreads + threadIdx.x] : 0;
#pragma unroll
    for (int it = 0; it < kPairRounds; ++it)
      if (live[it])
        v += glob != nullptr
                 ? entry_count(glob, cap, x[it], hash_key(x[it]))
                 : table_get(t_key, t_cnt, mask, x[it], hash_key(x[it]));
  }
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = __reduce_add_sync(0xffffffffu, lane < kPairWarps ? warp_sum[lane]
                                                         : 0u);
    if (lane == 0 && v != 0u)
      atomicAdd(reinterpret_cast<unsigned*>(out) + bucket, v);
  }
}

// lk, lv: the listed side's rows [l_rows, cl]; sk, sv: the streamed side's
// [*, cs]; dims and the row strides l, s of nd <= kPairDims dimensions
// (trailing); scratch [2 l_rows + 6 l_rows cl] int32 (uninitialised): the
// lengths and distinct counts, the lists, the global tables.  out
// [buckets] int32 (zeroed here).
inline cudaError_t pair_count(const int* lk, const unsigned char* lv,
                              const int* sk, const unsigned char* sv, int nd,
                              const long long* dims, const long long* l,
                              const long long* s, long long cl, long long cs,
                              long long l_rows, int* scratch, int* out,
                              int device, cudaStream_t st) {
  if (nd < 1 || nd > kPairDims) return cudaErrorInvalidValue;
  PairGrid grid;
  long long n_b = 1;
  for (int d = 0; d < kPairDims; ++d) {
    const int e = d - (kPairDims - nd);  // the caller's dimension
    grid.dims[d] = e < 0 ? 1 : dims[e];
    grid.l[d] = e < 0 ? 0 : l[e];
    grid.s[d] = e < 0 ? 0 : s[e];
    n_b *= grid.dims[d];
  }
  if (n_b == 0) return cudaSuccess;
  if (2 * cl > 0xffffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaMemsetAsync(out, 0, n_b * 4, st);
  if (err != cudaSuccess || cl == 0 || cs == 0 || l_rows == 0) return err;
  int* len = scratch;
  int* distinct = scratch + l_rows;
  int2* lists = reinterpret_cast<int2*>(scratch + 2 * l_rows);
  int2* tabs = lists + l_rows * cl;
  const unsigned cap = (unsigned)(2 * cl);
  err = cudaMemsetAsync(scratch, 0, 2 * l_rows * 4, st);
  if (err == cudaSuccess)
    err = count_keys(lk, lv, l_rows, cl, 0, true, lists, nullptr, len, st);
  if (err == cudaSuccess && cl > kPairBudget)  // a list may spill
    err = spill(lists, nullptr, len, l_rows, cl, kPairBudget, 1, cap, tabs,
                distinct, st);
  if (err != cudaSuccess) return err;
  // the listed row's table, at most kPairTMax slots
  const size_t smem = (size_t)pow2_at_least(2 * cl, 64, kPairTMax) * 8;
  long long wave = 0;
  err = cudaFuncSetAttribute(pair_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = resident_ctas((const void*)pair_sweep_kernel, kPairThreads, smem,
                        1, device, &wave);
  if (err != cudaSuccess) return err;
  // enough CTAs for a wave, no split under kPairMinSplit slots
  const long long splits =
      std::max(1LL, std::min(wave / n_b, cs / kPairMinSplit));
  if (n_b * splits > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  pair_sweep_kernel<<<(unsigned)(n_b * splits), kPairThreads, smem, st>>>(
      grid, lists, len, distinct, cl, tabs, cap, sk, sv, cs, n_b,
      (int)splits, out);
  return cudaGetLastError();
}

}  // namespace rj

extern "C" int rj_pair_count(const int* lk, const unsigned char* lv,
                             const int* sk, const unsigned char* sv, int nd,
                             const long long* dims, const long long* l,
                             const long long* s, long long cl, long long cs,
                             long long l_rows, int* scratch, int* out,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)rj::pair_count(lk, lv, sk, sv, nd, dims, l, s, cl, cs, l_rows,
                             scratch, out, device,
                             static_cast<cudaStream_t>(stream));
}
