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
// shared memory holds.  This kernel stages the probed sides in shared
// memory instead:
//   0. a pre-pass (pack_live_pairs_kernel) packs the live slots of every
//      R cell, S bucket and T row to the front of its row as int2 pairs,
//      (b, a), (b, c) and (c, a), reading the validity masks itself, so the
//      sweep reads live entries only and every lane carries one;
//   1. one CTA per (i, a, f) indexes its T row (i, f, a) in shared memory
//      once, in chunks;
//   2. it then walks the gp x ug cells (j, b): it indexes the R cell
//      (i, j, a, b) in shared memory, streams the S bucket (j, f, b) in
//      coalesced (each thread loads kSItems entries before it waits on the
//      barriers, and the next cell's lengths are loaded ahead), and counts
//      each S entry's triangles;
//   3. the cell's partial is reduced in the block and added to
//      out[i, j, a, b] with one atomic per (CTA, cell).
//
// Two tiers index a T chunk, chosen per chunk:
//   * bit rows (when the chunk holds at most kMaxA distinct a and its rows
//     fit kTBitsWords): a dense index per distinct a (a bit position) and
//     per distinct c; T as one row of bits over a per c, R as one row per
//     b.  An S entry (b, c) then costs two hash lookups and the popcount
//     of (row b AND row c), 4 or 8 words: no walk over matching entries.
//     A pair that occurs more than once has its multiplicity less one in a
//     small count table (kDupMax pairs a chunk); where row b or row c has
//     such a pair, the entry adds, for each a of the AND, mR mT - 1;
//   * multimaps (any chunk): T entries hashed by the pair (c, a), R as b ->
//     a; an S entry walks b's run and looks up (s.c, r.a) per matching R
//     entry.
// Every input goes through in chunks of a bounded size (T kTChunk entries,
// or kTSlots / 2 for a multimap chunk, R kRChunk a cell pass, S kSItems x
// 512 a batch), so any row size counts right; the sum over chunks is the
// same sum, and every count is exact.
// CTAs of one f run together (f is the slowest grid index), so the S
// buckets they share stay in L2.
// Bound: the table operations, one per T entry, one per R entry and cell
// pass, one per S entry visit and one per matching (s, r) pair (about
// 1.7e9 at N = 4e6, against about 240 MB of inputs read once); the bit
// rows replace the per-pair lookups by a few word operations a visit.
#include "fused_common.cuh"
#include "smem_hash.cuh"

namespace rj {

constexpr int kPackThreads = 256;
constexpr int kPackItems = 4;                     // slots a thread packs
constexpr int kPackSeg = kPackThreads * kPackItems;
constexpr int kCycThreads = 512;
constexpr int kSItems = 4;          // S entries a thread loads at once
constexpr int kTChunk = 2560;       // T entries a chunk indexes
constexpr int kTItems = kTChunk / kCycThreads;
constexpr int kRChunk = kCycThreads;  // R entries a cell pass indexes
// bit rows
constexpr int kCSlots = 4096;         // c -> row: >= kTChunk / 0.625
constexpr int kMaxA = 256;            // bit positions: distinct a
constexpr int kASlots = 2 * kMaxA;
constexpr int kTBitsWords = 8192;     // T rows: distinct c x 4 or 8 words
constexpr int kDupMax = 256;          // pairs seen more than once
constexpr int kDupSlots = 2 * kDupMax;
constexpr int kBSlots = 2 * kRChunk;  // b -> row
constexpr int kRBitsWords = kRChunk * 8;
constexpr int kIdxMask = 0xffff;      // row index in a c -> row value
constexpr int kDupFlag = 0x40000000;  // ... whose row has a repeated pair
// multimaps
constexpr int kTSlots = 8192;
constexpr int kRSlots = 2 * kRChunk;

// shared memory, in ints: the bit-row tier, and the multimap tier over the
// same bytes; a hash table of the bit-row tier is an array of int2 entries
// (key, value), so a lookup reads both at once
constexpr int kOffC = 0;
constexpr int kOffTBits = kOffC + 2 * kCSlots;
constexpr int kOffA = kOffTBits + kTBitsWords;
constexpr int kOffTd = kOffA + 2 * kASlots;
constexpr int kOffB = kOffTd + 2 * kDupSlots;
constexpr int kOffRBits = kOffB + 2 * kBSlots;
constexpr int kOffRd = kOffRBits + kRBitsWords;
constexpr int kOffRFlag = kOffRd + 2 * kDupSlots;
constexpr int kSmemInts = kOffRFlag + kRChunk / 32;
constexpr int kOffTc = 0, kOffTa = kTSlots, kOffRb = 2 * kTSlots,
              kOffRa = 2 * kTSlots + kRSlots;
static_assert(kOffRa + kRSlots <= kSmemInts, "the tiers share one buffer");
static_assert(kOffTBits % 4 == 0 && kOffRBits % 4 == 0, "uint4 rows");
static_assert(kOffA % 2 == 0 && kOffTd % 2 == 0 && kOffB % 2 == 0 &&
              kOffRd % 2 == 0, "int2 entries");

// counters in static shared memory
enum { kACount, kAIndex, kCIndex, kTdCount, kBIndex, kFailed, kCounters };

// For each row of [rows, c] slots: the live (x, y) pairs to the front of
// its row of out, in any order; len[row] (zeroed by the caller) counts
// them.  Block = (row, segment of kPackSeg slots).
__global__ void __launch_bounds__(kPackThreads)
pack_live_pairs_kernel(const int* __restrict__ x, const int* __restrict__ y,
                       const unsigned char* __restrict__ valid, long long c,
                       unsigned segs, int2* __restrict__ out,
                       int* __restrict__ len) {
  const long long row = blockIdx.x / segs;
  const long long seg = blockIdx.x % segs;
  const long long base = row * c;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < kPackItems; ++it) {
    const long long k = seg * kPackSeg + it * kPackThreads + threadIdx.x;
    const bool live = k < c && valid[base + k] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (m == 0u) continue;
    int pos = 0;
    if (lane == 0) pos = atomicAdd(len + row, __popc(m));
    pos = __shfl_sync(0xffffffffu, pos, 0);
    if (live)
      out[base + pos + __popc(m & lanemask_lt())] =
          make_int2(x[base + k], y[base + k]);
  }
}

__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned sum = 0u;
  if (threadIdx.x == 0)
    for (int w = 0; w < kCycThreads / 32; ++w) sum += red[w];
  return sum;
}

// Hash tables of int2 entries (key, value); a free slot has key kEmptyKey.

// The slot of key k (hash h), or -1; e gets its entry.
__device__ __forceinline__ int entry_find(const int2* tab, unsigned mask,
                                          int k, unsigned h, int2& e) {
  for (unsigned s = h & mask;; s = (s + 1) & mask) {
    e = tab[s];
    if (e.x == k) return (int)s;
    if (e.x == kEmptyKey) return -1;
  }
}

// The slot of key k (hash h), claimed if k is new; claimed says whether
// this thread claimed it.  For a table that has room for every key it can
// be given.
__device__ __forceinline__ int entry_claim(int2* tab, unsigned mask, int k,
                                           unsigned h, bool& claimed) {
  claimed = false;
  for (unsigned s = h & mask;; s = (s + 1) & mask) {
    int* key = reinterpret_cast<int*>(tab + s);
    int x = *key;
    if (x == kEmptyKey) x = atomicCAS(key, kEmptyKey, k);
    if (x == kEmptyKey) {
      claimed = true;
      return (int)s;
    }
    if (x == k) return (int)s;
  }
}

// entry_claim for a table of 2 x limit slots that may be given more keys:
// the claim that makes count pass limit sets *failed, and every probe
// stops (-1) once *failed is set, so no walk meets a full table (at most
// one claim a thread gets in after the limit).
__device__ __forceinline__ int entry_claim_bounded(int2* tab, unsigned mask,
                                                   int k, unsigned h,
                                                   int* count, int limit,
                                                   int* failed,
                                                   bool& claimed) {
  claimed = false;
  for (unsigned s = h & mask;; s = (s + 1) & mask) {
    if (*reinterpret_cast<volatile int*>(failed) != 0) return -1;
    int* key = reinterpret_cast<int*>(tab + s);
    int x = *key;
    if (x == kEmptyKey) x = atomicCAS(key, kEmptyKey, k);
    if (x == kEmptyKey) {
      if (atomicAdd(count, 1) >= limit)
        *reinterpret_cast<volatile int*>(failed) = 1;
      claimed = true;
      return (int)s;
    }
    if (x == k) return (int)s;
  }
}

// The next value of *counter for every lane with want, in lane order: one
// atomic a warp.  Every lane of the warp calls this.
__device__ __forceinline__ int warp_ticket(int* counter, bool want) {
  const unsigned m = __ballot_sync(0xffffffffu, want);
  const int leader = m != 0u ? __ffs(m) - 1 : 0;
  int base = 0;
  if (m != 0u && (int)(threadIdx.x & 31) == leader)
    base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(m & lanemask_lt());
}

__device__ __forceinline__ void entry_clear(int2* tab, int n) {
  for (int k = threadIdx.x; k < n; k += kCycThreads)
    tab[k] = make_int2(kEmptyKey, 0);
}

__device__ __forceinline__ int2 load_or_pad(const int2* row, int k, int n) {
  return k < n ? row[k] : make_int2(kEmptyKey, 0);
}

// ---------------------------------------------------------------------------
// the bit-row tier
// ---------------------------------------------------------------------------

// The buffer's arrays: constant offsets from one base, so no pointer
// takes a register.
extern __shared__ int smem_buf[];
__device__ __forceinline__ unsigned* as_words(int* p) {
  return reinterpret_cast<unsigned*>(p);
}
__device__ __forceinline__ int2* entries(int off) {
  return reinterpret_cast<int2*>(smem_buf + off);
}
// c -> T row (| kDupFlag) of the T chunk's distinct c, and the T rows
__device__ __forceinline__ int2* c_tab() { return entries(kOffC); }
__device__ __forceinline__ unsigned* t_bits() { return as_words(smem_buf + kOffTBits); }
// a -> bit position of the T chunk's distinct a
__device__ __forceinline__ int2* a_tab() { return entries(kOffA); }
// (T row, bit) -> multiplicity - 1 of each repeated T pair
__device__ __forceinline__ int2* td_tab() { return entries(kOffTd); }
// b -> R row of the pass's distinct b, and the R rows
__device__ __forceinline__ int2* b_tab() { return entries(kOffB); }
__device__ __forceinline__ unsigned* r_bits() { return as_words(smem_buf + kOffRBits); }
// (R row, bit) -> multiplicity - 1 of each repeated R pair; rows with one
__device__ __forceinline__ int2* rd_tab() { return entries(kOffRd); }
__device__ __forceinline__ unsigned* r_flag() { return as_words(smem_buf + kOffRFlag); }

// Index the T entries t[t0, t1) as bit rows; stride gets the words a row:
// 4 (<= 128 distinct a) or 8.  Returns false (the same in every thread)
// when the chunk does not fit the tier.  Every thread calls this; it ends
// on a barrier.
__device__ bool build_t_bits(int& stride, const int2* t, int t0, int t1,
                             int* ctr) {
  const int tid = threadIdx.x;
  entry_clear(c_tab(), kCSlots);
  entry_clear(a_tab(), kASlots);
  entry_clear(td_tab(), kDupSlots);
  if (tid < kCounters) ctr[tid] = 0;
  int2 e[kTItems];  // (c, a)
#pragma unroll
  for (int u = 0; u < kTItems; ++u)
    e[u] = load_or_pad(t, t0 + u * kCycThreads + tid, t1);
  __syncthreads();
  // pass 1: a dense index per distinct a (its bit) and per distinct c
#pragma unroll
  for (int u = 0; u < kTItems; ++u) {
    bool new_a = false, new_c = false;
    int sa = -1, sc = -1;
    if (e[u].x != kEmptyKey) {
      sa = entry_claim_bounded(a_tab(), kASlots - 1, e[u].y, hash_key(e[u].y),
                               ctr + kACount, kMaxA, ctr + kFailed, new_a);
      sc = entry_claim(c_tab(), kCSlots - 1, e[u].x, hash_key(e[u].x),
                       new_c);  // at most kTChunk keys
    }
    const int ia = warp_ticket(ctr + kAIndex, new_a);
    const int ic = warp_ticket(ctr + kCIndex, new_c);
    if (new_a) a_tab()[sa].y = ia;
    if (new_c) c_tab()[sc].y = ic;
  }
  __syncthreads();
  const int n_a = ctr[kAIndex], n_c = ctr[kCIndex];
  stride = n_a <= 128 ? 4 : 8;
  if (ctr[kFailed] != 0 || n_c * stride > kTBitsWords) return false;
  for (int k = tid; k < n_c * stride; k += kCycThreads) t_bits()[k] = 0u;
  __syncthreads();
  // pass 2: the bits, and the multiplicities above one
#pragma unroll
  for (int u = 0; u < kTItems; ++u) {
    if (e[u].x == kEmptyKey) continue;
    int2 ce, ae;
    const int sc = entry_find(c_tab(), kCSlots - 1, e[u].x, hash_key(e[u].x), ce);
    entry_find(a_tab(), kASlots - 1, e[u].y, hash_key(e[u].y), ae);
    const int row = ce.y & kIdxMask, bit = ae.y;
    const unsigned mask = 1u << (bit & 31);
    if (atomicOr(t_bits() + row * stride + (bit >> 5), mask) & mask) {
      const int key = row * kMaxA + bit;
      bool claimed;
      const int s = entry_claim_bounded(td_tab(), kDupSlots - 1, key,
                                        hash_key(key), ctr + kTdCount,
                                        kDupMax, ctr + kFailed, claimed);
      if (s >= 0) atomicAdd(&td_tab()[s].y, 1);
      atomicOr(&c_tab()[sc].y, kDupFlag);
    }
  }
  __syncthreads();
  return ctr[kFailed] == 0;
}

// Index this thread's R entry re = (b, a) (b = kEmptyKey: none) as bit rows
// over the T chunk's a.  Every thread calls this; it ends on a barrier.
__device__ void build_r_bits(int stride, int2 re, int* ctr) {
  const int tid = threadIdx.x;
  entry_clear(b_tab(), kBSlots);
  entry_clear(rd_tab(), kDupSlots);
  if (tid < kRChunk / 32) r_flag()[tid] = 0u;
  if (tid == 0) ctr[kBIndex] = 0;
  __syncthreads();
  // pass 1: a row per distinct b; an entry whose a is not in the T chunk
  // cannot close a triangle
  int2 ae = make_int2(kEmptyKey, 0);
  int sb = -1;
  bool new_b = false;
  if (re.x != kEmptyKey &&
      entry_find(a_tab(), kASlots - 1, re.y, hash_key(re.y), ae) >= 0)
    sb = entry_claim(b_tab(), kBSlots - 1, re.x, hash_key(re.x),
                     new_b);  // at most kRChunk keys
  const int row = warp_ticket(ctr + kBIndex, new_b);
  if (new_b) {
    b_tab()[sb].y = row;
    for (int w = 0; w < stride; ++w) r_bits()[row * stride + w] = 0u;
  }
  __syncthreads();
  // pass 2: the bit, and the multiplicity above one
  if (sb >= 0) {
    const int r = b_tab()[sb].y, bit = ae.y;
    const unsigned mask = 1u << (bit & 31);
    if (atomicOr(r_bits() + r * stride + (bit >> 5), mask) & mask) {
      const int key = r * kMaxA + bit;
      bool new_pair;  // at most kRChunk / 2 repeated pairs
      const int s = entry_claim(rd_tab(), kDupSlots - 1, key, hash_key(key),
                                new_pair);
      atomicAdd(&rd_tab()[s].y, 1);
      atomicOr(r_flag() + (r >> 5), 1u << (r & 31));
    }
  }
  __syncthreads();
}

// The multiplicity less one of key k in a table of repeated pairs.
__device__ __forceinline__ unsigned extra(const int2* tab, int k) {
  int2 e;
  return entry_find(tab, kDupSlots - 1, k, hash_key(k), e) >= 0
             ? (unsigned)e.y : 0u;
}

// Σ over the a common to R row r_row and T row t_row of mR mT - 1: what
// the repeated pairs add to the popcount.
__device__ __noinline__ unsigned repeated_pairs(int stride, int r_row,
                                                int t_row) {
  unsigned n = 0u;
  for (int w = 0; w < stride; ++w) {
    unsigned both = r_bits()[r_row * stride + w] & t_bits()[t_row * stride + w];
    while (both != 0u) {
      const int bit = w * 32 + __ffs(both) - 1;
      both &= both - 1u;
      const unsigned mr = 1u + extra(rd_tab(), r_row * kMaxA + bit);
      const unsigned mt = 1u + extra(td_tab(), t_row * kMaxA + bit);
      n += mr * mt - 1u;
    }
  }
  return n;
}

// The triangles of the S entry s = (b, c) (b = kEmptyKey: none) with the
// indexed R pass and T chunk: Σ over a of mR(b, a) mT(c, a).
__device__ __forceinline__ unsigned count_bits(int stride, int2 s) {
  if (s.x == kEmptyKey) return 0u;
  int2 be, ce;
  if (entry_find(b_tab(), kBSlots - 1, s.x, hash_key(s.x), be) < 0) return 0u;
  if (entry_find(c_tab(), kCSlots - 1, s.y, hash_key(s.y), ce) < 0) return 0u;
  const int r_row = be.y;
  const int t_row = ce.y & kIdxMask;
  const uint4* rb = reinterpret_cast<const uint4*>(r_bits() + r_row * stride);
  const uint4* tb = reinterpret_cast<const uint4*>(t_bits() + t_row * stride);
  unsigned n = 0u;
  for (int q = 0; q < stride / 4; ++q) {
    const uint4 x = rb[q], y = tb[q];
    n += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
  }
  if (n != 0u && ((ce.y & kDupFlag) != 0 ||
                  ((r_flag()[r_row >> 5] >> (r_row & 31)) & 1u)))
    n += repeated_pairs(stride, r_row, t_row);
  return n;
}

// ---------------------------------------------------------------------------
// the multimap tier
// ---------------------------------------------------------------------------

// T chunk: entries (c, a), hashed by the pair; R pass: b -> a
__device__ __forceinline__ int* t_c() { return smem_buf + kOffTc; }
__device__ __forceinline__ int* t_a() { return smem_buf + kOffTa; }
__device__ __forceinline__ int* r_b() { return smem_buf + kOffRb; }
__device__ __forceinline__ int* r_a() { return smem_buf + kOffRa; }

// Every thread calls this; it ends on a barrier.
__device__ void build_t_multimap(const int2* t, int t0, int t1) {
  for (int k = threadIdx.x; k < kTSlots; k += kCycThreads) t_c()[k] = kEmptyKey;
  __syncthreads();
  for (int k = t0 + threadIdx.x; k < t1; k += kCycThreads) {
    const int2 e = t[k];  // (c, a)
    multimap_put(t_c(), t_a(), kTSlots - 1, e.x, e.y, hash_pair(e.x, e.y));
  }
  __syncthreads();
}

// Every thread calls this; it ends on a barrier.
__device__ void build_r_multimap(int2 re) {
  for (int k = threadIdx.x; k < kRSlots; k += kCycThreads) r_b()[k] = kEmptyKey;
  __syncthreads();
  if (re.x != kEmptyKey)
    multimap_put(r_b(), r_a(), kRSlots - 1, re.x, re.y, hash_key(re.x));
  __syncthreads();
}

// Σ over the R entries r with r.b == s.b of #{T entries (s.c, r.a)}, for
// the S entry s = (b, c) (b = kEmptyKey: none).
__device__ __forceinline__ unsigned count_multimaps(int2 s) {
  unsigned n = 0u;
  if (s.x == kEmptyKey) return n;
  for (unsigned k = hash_key(s.x) & (kRSlots - 1);; k = (k + 1) & (kRSlots - 1)) {
    const int b = r_b()[k];
    if (b == kEmptyKey) return n;
    if (b == s.x) {
      const int a = r_a()[k];
      n += multimap_count(t_c(), t_a(), kTSlots - 1, s.y, a, hash_pair(s.y, a));
    }
  }
}

// ---------------------------------------------------------------------------

// rpair (b, a) [cells, cr], spair (b, c) [gp*fp*ug, cs], tpair (c, a)
// [hp*fp*uh, ct], each with its live count per row; out [cells] += counts.
__global__ void __launch_bounds__(kCycThreads, 2)
cyclic_table_kernel(const int2* __restrict__ rpair,
                    const int* __restrict__ rlen,
                    const int2* __restrict__ spair,
                    const int* __restrict__ slen,
                    const int2* __restrict__ tpair,
                    const int* __restrict__ tlen, int hp, int gp, int uh,
                    int ug, int fp, long long cr, long long cs, long long ct,
                    int* __restrict__ out) {
  __shared__ unsigned red[kCycThreads / 32];
  __shared__ int ctr[kCounters];

  // blockIdx.x = (f * hp + i) * uh + a
  const int a = blockIdx.x % uh;
  const int i = (blockIdx.x / uh) % hp;
  const int f = blockIdx.x / (uh * hp);
  const long long trow = ((long long)i * fp + f) * uh + a;
  const int n_t = tlen[trow];
  if (n_t == 0) return;  // uniform: nothing here can match
  const int tid = threadIdx.x;
  const int n_cells = gp * ug;
  // R cell and S bucket of cell jb = (j, b)
  const long long cell00 = ((long long)i * gp * uh + a) * ug;
  auto cell_of = [&](int jb) {
    const int j = jb / ug;
    return cell00 + (long long)j * uh * ug + (jb - j * ug);
  };
  auto bucket_of = [&](int jb) {
    const int j = jb / ug;
    return ((long long)j * fp + f) * ug + (jb - j * ug);
  };

  for (int t0 = 0; t0 < n_t;) {
    __syncthreads();  // the previous chunk is done with the buffer
    int stride = 8;
    const bool use_bits = build_t_bits(stride, tpair + trow * ct, t0,
                                       min(n_t, t0 + kTChunk), ctr);
    // a chunk the bit rows refuse takes a multimap of up to kTSlots / 2
    // entries: fewer passes over the S buckets
    const int t1 = min(n_t, t0 + (use_bits ? kTChunk : kTSlots / 2));
    if (!use_bits) build_t_multimap(tpair + trow * ct, t0, t1);

    int n_r = rlen[cell_of(0)], n_s = slen[bucket_of(0)];
    for (int jb = 0; jb < n_cells; ++jb) {
      const long long cell = cell_of(jb);
      const int2* r_row = rpair + cell * cr;
      const int2* s_row = spair + bucket_of(jb) * cs;
      const int cur_r = n_r, cur_s = n_s;
      if (jb + 1 < n_cells) {  // the next cell's lengths, ahead of need
        n_r = rlen[cell_of(jb + 1)];
        n_s = slen[bucket_of(jb + 1)];
      }
      if (cur_r == 0 || cur_s == 0) continue;  // uniform
      unsigned acc = 0u;
      for (int r0 = 0; r0 < cur_r; r0 += kRChunk) {
        // this pass's R entry and the thread's first S entries are loaded
        // before the barriers, so their latencies overlap
        const int2 re = load_or_pad(r_row, r0 + tid, cur_r);
        int2 se[kSItems];  // (b, c)
#pragma unroll
        for (int u = 0; u < kSItems; ++u)
          se[u] = load_or_pad(s_row, u * kCycThreads + tid, cur_s);
        if (r0 > 0) __syncthreads();  // the previous pass's counts are done
        if (use_bits) build_r_bits(stride, re, ctr);
        else build_r_multimap(re);
        for (int k0 = 0; k0 < cur_s; k0 += kSItems * kCycThreads) {
          if (k0 > 0) {
#pragma unroll
            for (int u = 0; u < kSItems; ++u)
              se[u] = load_or_pad(s_row, k0 + u * kCycThreads + tid, cur_s);
          }
          // one counting body a tier, entries shifted through se[0] (a
          // register, where se[u] would put the array in local memory)
#pragma unroll 1
          for (int u = 0; u < kSItems; ++u) {
            acc += use_bits ? count_bits(stride, se[0]) : count_multimaps(se[0]);
#pragma unroll
            for (int v = 0; v + 1 < kSItems; ++v) se[v] = se[v + 1];
          }
        }
      }
      // the barrier inside block_sum also ends this cell's counts
      const unsigned sum = block_sum(acc, red);
      if (tid == 0 && sum != 0u)
        atomicAdd(reinterpret_cast<unsigned*>(out) + cell, sum);
    }
    t0 = t1;
  }
}

inline cudaError_t pack_live_pairs(const int* x, const int* y,
                                   const unsigned char* valid,
                                   long long rows, long long c, int2* out,
                                   int* len, cudaStream_t stream) {
  if (rows == 0 || c == 0) return cudaSuccess;
  const long long segs = (c + kPackSeg - 1) / kPackSeg;
  if (rows * segs > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  pack_live_pairs_kernel<<<(unsigned)(rows * segs), kPackThreads, 0,
                           stream>>>(x, y, valid, c, (unsigned)segs, out,
                                     len);
  return cudaGetLastError();
}

}  // namespace rj

// Scratch from the caller: rpair [hp*gp*uh*ug, cr], spair [gp*fp*ug, cs],
// tpair [hp*fp*uh, ct] int2 (uninitialised) and rlen, slen, tlen int32 per
// row (zeroed); out [hp, gp, uh, ug] int32 zeroed.
extern "C" int rj_fused_cyclic_pairidx(
    const int* ra, const int* rb, const unsigned char* rv, const int* sb,
    const int* sc, const unsigned char* sv, const int* tc, const int* ta,
    const unsigned char* tv, long long hp, long long gp, long long uh,
    long long ug, long long fp, long long cr, long long cs, long long ct,
    void* rpair, void* spair, void* tpair, int* rlen, int* slen, int* tlen,
    int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = hp * fp * uh;
  if (blocks == 0 || gp * ug == 0 || cr == 0 || cs == 0 || ct == 0)
    return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL || gp * ug > 0x7fffffffLL || cr > 0x7fffffffLL ||
      cs > 0x7fffffffLL || ct > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int2* rp = static_cast<int2*>(rpair);
  int2* sp = static_cast<int2*>(spair);
  int2* tp = static_cast<int2*>(tpair);
  // R keyed by b with a beside it, S by b with c, T by c with a
  err = rj::pack_live_pairs(rb, ra, rv, hp * gp * uh * ug, cr, rp, rlen, st);
  if (err == cudaSuccess)
    err = rj::pack_live_pairs(sb, sc, sv, gp * fp * ug, cs, sp, slen, st);
  if (err == cudaSuccess)
    err = rj::pack_live_pairs(tc, ta, tv, hp * fp * uh, ct, tp, tlen, st);
  if (err != cudaSuccess) return (int)err;
  // one buffer for either tier: two CTAs of 512 threads an SM
  const size_t smem = (size_t)rj::kSmemInts * sizeof(int);
  err = cudaFuncSetAttribute(rj::cyclic_table_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        rj::cyclic_table_kernel,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  rj::cyclic_table_kernel<<<(unsigned)blocks, rj::kCycThreads, smem, st>>>(
      rp, rlen, sp, slen, tp, tlen, (int)hp, (int)gp, (int)uh, (int)ug,
      (int)fp, cr, cs, ct, out);
  return (int)cudaGetLastError();
}
