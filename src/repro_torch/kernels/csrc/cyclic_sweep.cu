// The triangle sweep R(AB) ⋈ S(BC) ⋈ T(CA) on Hopper (sm_90a), the one
// kernel of the three triangle ops (kernels/cuda.py counts each op's
// launches apart; they share this library and its entry point,
// rj_cyclic_sweep).  It replaces three TPU kernels of
// src/repro/kernels/bucket_join.py, which compute per bucket (or cell and
// stream bucket f)
//     Σ_{r, s, t} [r.b == s.b][s.c == t.c][t.a == r.a]
//   = Σ_{s} Σ_{r : r.b == s.b} #{t : (t.c, t.a) == (s.c, r.a)}:
//   * :377 fused_count3_cyclic_pairidx (_fused_cyclic_pairidx_kernel,
//     :349): the sweep over the H(A) x G(B) coarse grid, the uh x ug PMU
//     grid and the f(C) stream, by binary searches of a (Ct+1) x Cr
//     prefix table per program (about 12 MB at N = 4e6, which no shared
//     memory holds);
//   * :317 fused_count3_cyclic (_fused_cyclic_kernel, :296), the
//     all-pairs form of the same sweep: per step Σ (M1ᵀ·M2) ⊙ M3 on the
//     MXU in f32 over the 0/1 equality matrices, Cr·Cs·Ct multiply-adds a
//     step and an f32 sum exact only to 2^24;
//   * :164 count3_cyclic (_count3_cyclic_kernel, :148): the same product
//     per bucket row, one program per row, which the scan driver
//     (core/cyclic3.py) launched once per (i, j, f) step.
// Here the first two run on the fused grid (f, i, j, a, b), the sum over
// f in the atomics, and the third on the scan's bucket rows (f, a, b),
// one output per bucket, S shared along a and T along b, no row copied.
// Bound (chip_smoke.py): the bytes read once, or the table operations
// (one per T entry, one per R entry and cell pass, one per S entry visit
// and one per matching (s, r) pair; about 1.7e9 at N = 4e6, against about
// 240 MB of inputs read once); the bit rows replace the per-pair lookups
// by a few word operations a visit.
//
// The batch has up to kMaxDims dimensions; R, S, T and the output are
// addressed by one row stride per dimension (0 where a row is shared
// along it).  The dimensions T spans index its rows; the others index the
// cells one T row serves (CyclicGrid).  The fused grid has T rows
// (f, i, a) and cells (j, b), its output ignoring f; the scan's (f, a, b)
// grid has T rows (f, a) and cells b, one output per bucket.
//
//   0. a pre-pass (pack_live_pairs_kernel, one launch for the three sides)
//      packs the live slots of every distinct R, S and T row to the front
//      of its row as int2 pairs, (b, a), (b, c) and (c, a), reading the
//      validity masks itself, so the sweep reads live entries only and
//      every lane carries one; a row shared along a dimension is packed
//      once a launch, never per bucket;
//   1. one CTA per (T row, split of its cells) indexes the T row in shared
//      memory once, in chunks;
//   2. it then walks its cells: it indexes the cell's R row in shared
//      memory, streams the cell's S row in coalesced (each thread loads
//      kSItems entries before it waits on the barriers, and the next
//      cell's lengths are loaded ahead), and counts each S entry's
//      triangles;
//   3. the cell's partial is reduced in the block and added to its output
//      with one atomic per (CTA, cell) and T chunk.
// A T row serves every cell of the dimensions it is shared along; where
// there are too few T rows to fill the card, each one's cells are cut
// into splits over CTAs (at most one wave), each split indexing the row.
//
// Two tiers index a T chunk, chosen per chunk:
//   * bit rows (when the chunk holds at most kMaxA distinct a and its rows
//     fit kTBitsWords): a dense index per distinct a (a bit position) and
//     per distinct c; T as one row of bits over a per c, R as one row per
//     b.  An S entry (b, c) then costs two hash lookups and the popcount
//     of (row b AND row c), 4 or 8 words: no walk over matching entries.
//     A pair that occurs more than once marks its row.  A T row gets the
//     bits of (multiplicity - 1) as bit planes beside it, so a marked T
//     row adds Σ_q 2^q popc(R row AND plane_q) with no walk (the planes
//     are built once a chunk and serve every cell); a marked R row keeps
//     its multiplicities less one in a small count table, and its entry
//     walks the a of the AND, adding eR (1 + eT) for each (an R pass is
//     rebuilt every cell, so it takes no extra barrier to index).  The
//     repeated pairs of a T chunk are counted in the R pass's bytes while
//     the chunk is indexed (never full, as R's table is not);
//   * multimaps (any chunk): T entries hashed by the pair (c, a), R as b ->
//     a; an S entry walks b's run and looks up (s.c, r.a) per matching R
//     entry.
// Every input goes through in chunks of a bounded size (T kTChunk entries,
// or kTSlots / 2 for a multimap chunk, R kRChunk a cell pass, S kSItems x
// 512 a batch), so any row size counts right; the sum over chunks is the
// same sum, and every count is exact.  Counts are unsigned 32-bit and
// wrap as the reference's int32.
// Nothing is sorted or masked around the sweep: the pre-pass, the memsets
// of the lengths and the output, and the sweep are all a call launches.
#include <algorithm>

#include "error_string.cuh"
#include "smem_hash.cuh"

namespace rj {

constexpr int kMaxDims = 5;
constexpr int kPackThreads = 256;
constexpr int kPackItems = 4;                     // slots a thread packs
constexpr int kPackSeg = kPackThreads * kPackItems;
constexpr int kCycThreads = 512;
constexpr int kCycPerSm = 2;        // CTAs of kCycThreads an SM
constexpr int kSItems = 2;          // S entries a thread loads at once
constexpr int kTChunk = 2560;       // T entries a chunk indexes
constexpr int kTItems = kTChunk / kCycThreads;
constexpr int kRChunk = kCycThreads;  // R entries a cell pass indexes
// bit rows
constexpr int kCSlots = 4096;         // c -> row: >= kTChunk / 0.625
constexpr int kMaxA = 256;            // bit positions: distinct a
constexpr int kASlots = 2 * kMaxA;
constexpr int kTBitsWords = 8192;     // T rows and planes, in words
constexpr int kTDupSlots = 2048;      // repeated T pairs: <= kTChunk / 2
constexpr int kBSlots = 2 * kRChunk;  // b -> row
constexpr int kRDupSlots = kRChunk;   // repeated R pairs: <= kRChunk / 2
constexpr int kRBitsWords = kRChunk * 8;
constexpr int kIdxMask = 0xffff;      // row index in a c or b -> row value
constexpr int kPlaneShift = 16;       // ... a T row's planes' index + 1
constexpr int kRDupFlag = 1 << 30;    // ... an R row with a repeated pair
// multimaps
constexpr int kTSlots = 8192;
constexpr int kRSlots = 2 * kRChunk;

// shared memory, in ints: the bit-row tier (the T chunk's tables, rows
// and planes, then the R pass's, whose bytes hold the repeated T pairs
// while a chunk is indexed), and the multimap tier over the same bytes; a hash table of
// the bit-row tier is an array of int2 entries (key, value), so a lookup
// reads both at once
constexpr int kOffC = 0;
constexpr int kOffTBits = kOffC + 2 * kCSlots;
constexpr int kOffA = kOffTBits + kTBitsWords;
constexpr int kOffR = kOffA + 2 * kASlots;
constexpr int kOffTd = kOffR;                      // while a chunk is indexed
constexpr int kOffTX = kOffTd + 2 * kTDupSlots;    // ... row -> planes
constexpr int kOffB = kOffR;
constexpr int kOffRd = kOffB + 2 * kBSlots;
constexpr int kOffRBits = kOffRd + 2 * kRDupSlots;
constexpr int kSmemInts = kOffRBits + kRBitsWords;
constexpr int kOffTc = 0, kOffTa = kTSlots, kOffRb = 2 * kTSlots,
              kOffRa = 2 * kTSlots + kRSlots;
static_assert(kOffTX + kTChunk <= kSmemInts, "T's pairs fit R's bytes");
static_assert(kOffRa + kRSlots <= kSmemInts, "the tiers share one buffer");
static_assert(kOffTBits % 4 == 0 && kOffRBits % 4 == 0, "uint4 rows");
static_assert(kOffA % 2 == 0 && kOffB % 2 == 0 && kOffRd % 2 == 0,
              "int2 entries");
static_assert(kCycPerSm * (kSmemInts * 4 + 1024) <= 232448,
              "two CTAs an SM");

// counters in static shared memory: the T chunk's (indexing, and its
// planes while the cells count; the last four in fill_planes' order), the
// R pass's
enum {
  kACount, kAIndex, kCIndex, kFailed, kTMaxE, kTXIndex, kTPlanes, kTXBase,
  kBIndex, kCounters
};
__shared__ int ctr[kCounters];

// The batch as the CTAs walk it: T row t is a row-major index over the
// n_tdim dimensions T spans (slowest first), and its cells a row-major
// index over the n_cdim others of size > 1.  Per dimension, the row
// strides of R, S, T (T dimensions only) and the output.  Every count of
// rows fits an int (checked by cyclic_sweep).
struct CyclicGrid {
  int n_tdim, n_cdim;
  int tsize[kMaxDims], csize[kMaxDims];
  int t_r[kMaxDims], t_s[kMaxDims], t_t[kMaxDims], t_o[kMaxDims];
  int c_r[kMaxDims], c_s[kMaxDims], c_o[kMaxDims];
  int per_t;    // cells a T row serves
  int splits;   // CTAs a T row's cells are cut over

  // T row t's own row and the R, S and output rows of its cell 0.
  __device__ __forceinline__ void t_rows(int t, int* trow, int* r, int* s,
                                         int* o) const {
    *trow = *r = *s = *o = 0;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d >= n_tdim) continue;
      const int x = t % tsize[d];
      t /= tsize[d];
      *trow += x * t_t[d];
      *r += x * t_r[d];
      *s += x * t_s[d];
      *o += x * t_o[d];
    }
  }

  // The R, S and output row offsets of cell c from cell 0's.
  __device__ __forceinline__ void cell(int c, int* r, int* s, int* o) const {
    *r = *s = *o = 0;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d >= n_cdim) continue;
      const int x = c % csize[d];
      c /= csize[d];
      *r += x * c_r[d];
      *s += x * c_s[d];
      *o += x * c_o[d];
    }
  }
};

// One side of the pre-pass: [rows, c] slots of keys x, y and validity;
// blocks = rows x segs.
struct PackSide {
  const int* x;
  const int* y;
  const unsigned char* valid;
  long long c;
  unsigned segs, blocks;
  int2* out;
  int* len;
};

// For each row of each side: the live (x, y) pairs to the front of its
// row of out, in any order; len[row] (zeroed by the caller) counts them.
// Block = (side, row, segment of kPackSeg slots).
__global__ void __launch_bounds__(kPackThreads)
pack_live_pairs_kernel(PackSide r, PackSide s, PackSide t) {
  unsigned blk = blockIdx.x;
  PackSide p = r;
  if (blk >= r.blocks) {
    blk -= r.blocks;
    p = s;
    if (blk >= s.blocks) {
      blk -= s.blocks;
      p = t;
    }
  }
  const long long row = blk / p.segs;
  const long long seg = blk % p.segs;
  const long long base = row * p.c;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < kPackItems; ++it) {
    const long long k = seg * kPackSeg + it * kPackThreads + threadIdx.x;
    const bool live = k < p.c && p.valid[base + k] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (m == 0u) continue;
    int pos = 0;
    if (lane == 0) pos = atomicAdd(p.len + row, __popc(m));
    pos = __shfl_sync(0xffffffffu, pos, 0);
    if (live)
      p.out[base + pos + __popc(m & lanemask_lt())] =
          make_int2(p.x[base + k], p.y[base + k]);
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
// c -> T row (and planes) of the T chunk's distinct c, and the T rows
__device__ __forceinline__ int2* c_tab() { return entries(kOffC); }
__device__ __forceinline__ unsigned* t_bits() { return as_words(smem_buf + kOffTBits); }
// a -> bit position of the T chunk's distinct a
__device__ __forceinline__ int2* a_tab() { return entries(kOffA); }
// (T row, bit) -> multiplicity - 1 of each repeated T pair, while
// indexing, and T row -> its planes' index + 1 (0: none)
__device__ __forceinline__ int2* td_tab() { return entries(kOffTd); }
__device__ __forceinline__ int* t_xmap() { return smem_buf + kOffTX; }
// b -> R row (| kRDupFlag) of the pass's distinct b, and the R rows
__device__ __forceinline__ int2* b_tab() { return entries(kOffB); }
__device__ __forceinline__ unsigned* r_bits() { return as_words(smem_buf + kOffRBits); }
// (R row, bit) -> multiplicity - 1 of each repeated R pair
__device__ __forceinline__ int2* rd_tab() { return entries(kOffRd); }

// The bit planes of the repeated pairs of T rows: after the n_rows base
// rows (row r at bits + r * stride), marked row x has planes p < planes
// at bits + xbase + (x * planes + p) * stride, plane p holding bit p of
// (multiplicity - 1) per a.  The rows' table maps a key to row | (x + 1)
// << kPlaneShift (mark_row), or to row alone where the row has no
// repeated pair.

// Mark a row that has a repeated pair, once: its planes' index (in order
// of marking) into xmap_row (0 until marked) and its table value.
__device__ __forceinline__ void mark_row(int2* slot, int* xmap_row,
                                         int* counters) {
  enum { kXIndex = 1 };
  if (atomicCAS(xmap_row, 0, -1) == 0) {
    const int x = atomicAdd(counters + kXIndex, 1);
    *xmap_row = x + 1;
    atomicOr(&slot->y, (x + 1) << kPlaneShift);
  }
}

// Fill the planes once the rows' bits and the repeated pairs are in: dup
// (keys row * kMaxA + bit, counting multiplicity - 1) and the marked rows'
// xmap; counters[0] the largest count and counters[1] the marked rows;
// counters[2 .. 3] get planes and xbase.  Returns false (the same in every
// thread) when rows and planes pass `words`.  Every thread calls this
// after a barrier; it ends on one.
__device__ bool fill_planes(unsigned* bits, int words, int stride,
                            int n_rows, const int2* dup, int dup_slots,
                            const int* xmap, int* counters) {
  enum { kMaxE, kXIndex, kPlanes, kXBase };
  const int max_e = counters[kMaxE];
  if (max_e == 0) return true;  // uniform: no repeated pair
  const int planes = 32 - __clz(max_e);
  const int xbase = n_rows * stride;
  const int n_words = xbase + counters[kXIndex] * planes * stride;
  if (n_words > words) return false;
  if (threadIdx.x == 0) {
    counters[kPlanes] = planes;
    counters[kXBase] = xbase;
  }
  for (int k = xbase + threadIdx.x; k < n_words; k += kCycThreads) bits[k] = 0u;
  __syncthreads();
  // bit p of each repeated pair's count into plane p of its row
  for (int k = threadIdx.x; k < dup_slots; k += kCycThreads) {
    const int2 d = dup[k];
    if (d.x == kEmptyKey) continue;
    const int row = d.x / kMaxA, bit = d.x % kMaxA;
    unsigned* w = bits + xbase + (xmap[row] - 1) * planes * stride + (bit >> 5);
    for (int p = 0; p < planes; ++p)
      if ((d.y >> p) & 1) atomicOr(w + p * stride, 1u << (bit & 31));
  }
  __syncthreads();
  return true;
}

// Index the T entries t[t0, t1) as bit rows; stride gets the words a row:
// 4 (<= 128 distinct a) or 8.  Returns false (the same in every thread)
// when the chunk does not fit the tier.  Every thread calls this; it ends
// on a barrier.
__device__ bool build_t_bits(int& stride, const int2* t, int t0, int t1) {
  const int tid = threadIdx.x;
  entry_clear(c_tab(), kCSlots);
  entry_clear(a_tab(), kASlots);
  entry_clear(td_tab(), kTDupSlots);
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
    if (new_c) {
      c_tab()[sc].y = ic;
      t_xmap()[ic] = 0;
    }
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
      bool claimed;  // at most kTChunk / 2 repeated pairs
      const int s = entry_claim(td_tab(), kTDupSlots - 1, key, hash_key(key),
                                claimed);
      atomicMax(ctr + kTMaxE, atomicAdd(&td_tab()[s].y, 1) + 1);
      mark_row(c_tab() + sc, t_xmap() + row, ctr + kTMaxE);
    }
  }
  __syncthreads();
  return fill_planes(t_bits(), kTBitsWords, stride, n_c, td_tab(),
                     kTDupSlots, t_xmap(), ctr + kTMaxE);
}

// Index this thread's R entry re = (b, a) (b = kEmptyKey: none) as bit rows
// over the T chunk's a.  Every thread calls this; it ends on a barrier.
__device__ void build_r_bits(int stride, int2 re) {
  const int tid = threadIdx.x;
  entry_clear(b_tab(), kBSlots);
  entry_clear(rd_tab(), kRDupSlots);
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
    const int r = b_tab()[sb].y & kIdxMask, bit = ae.y;
    const unsigned mask = 1u << (bit & 31);
    if (atomicOr(r_bits() + r * stride + (bit >> 5), mask) & mask) {
      const int key = r * kMaxA + bit;
      bool claimed;  // at most kRChunk / 2 repeated pairs
      const int s = entry_claim(rd_tab(), kRDupSlots - 1, key, hash_key(key),
                                claimed);
      atomicAdd(&rd_tab()[s].y, 1);
      atomicOr(&b_tab()[sb].y, kRDupFlag);
    }
  }
  __syncthreads();
}

// Σ over the words of popc(x AND y).
__device__ __forceinline__ unsigned and_popc(const unsigned* x,
                                             const unsigned* y, int stride) {
  unsigned n = 0u;
  for (int w = 0; w < stride; ++w) n += __popc(x[w] & y[w]);
  return n;
}

// What the repeated pairs add to the popcount of R row rv and T row tv
// (their tables' values): with eR, eT the multiplicities less one, Σ over
// the a of the AND of eT + eR (1 + eT), eT from the T row's planes and eR
// from R's count table.
__device__ __noinline__ unsigned repeated_pairs(int stride, int rv, int tv) {
  const int tx = tv >> kPlaneShift;
  const unsigned* r0 = r_bits() + (rv & kIdxMask) * stride;
  const unsigned* t0 = t_bits() + (tv & kIdxMask) * stride;
  const int tp = ctr[kTPlanes];
  const unsigned* xt = t_bits() + ctr[kTXBase] + (tx > 0 ? tx - 1 : 0) * tp * stride;
  unsigned n = 0u;
  if (tx > 0)
    for (int q = 0; q < tp; ++q) n += and_popc(r0, xt + q * stride, stride) << q;
  if ((rv & kRDupFlag) != 0) {
    const int key0 = (rv & kIdxMask) * kMaxA;
    for (int w = 0; w < stride; ++w) {
      unsigned both = r0[w] & t0[w];
      while (both != 0u) {
        const int bit = w * 32 + __ffs(both) - 1;
        both &= both - 1u;
        int2 d;
        if (entry_find(rd_tab(), kRDupSlots - 1, key0 + bit,
                       hash_key(key0 + bit), d) < 0)
          continue;
        unsigned et = 0u;
        if (tx > 0)
          for (int q = 0; q < tp; ++q)
            et |= ((xt[q * stride + w] >> (bit & 31)) & 1u) << q;
        n += (unsigned)d.y * (1u + et);
      }
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
  const uint4* rb =
      reinterpret_cast<const uint4*>(r_bits() + (be.y & kIdxMask) * stride);
  const uint4* tb =
      reinterpret_cast<const uint4*>(t_bits() + (ce.y & kIdxMask) * stride);
  unsigned n = 0u;
  for (int q = 0; q < stride / 4; ++q) {
    const uint4 x = rb[q], y = tb[q];
    n += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
  }
  // only where a repeated pair can add: none without a common a
  if (n != 0u && ((be.y | ce.y) >> kPlaneShift) != 0)
    n += repeated_pairs(stride, be.y, ce.y);
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

// This thread's part of the triangles of a cell: its R row r_row[0,
// cur_r) against its S row s_row[0, cur_s), with the T chunk indexed in
// the tier kBits says (one copy of the loop a tier, so neither carries the
// other's registers).  Every thread calls this; the caller's block_sum
// ends the counts.
template <bool kBits>
__device__ __forceinline__ unsigned count_cell(int stride, const int2* r_row,
                                               int cur_r, const int2* s_row,
                                               int cur_s) {
  const int tid = threadIdx.x;
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
    if (kBits) build_r_bits(stride, re);
    else build_r_multimap(re);
    for (int k0 = 0; k0 < cur_s; k0 += kSItems * kCycThreads) {
      if (k0 > 0) {
#pragma unroll
        for (int u = 0; u < kSItems; ++u)
          se[u] = load_or_pad(s_row, k0 + u * kCycThreads + tid, cur_s);
      }
      // one counting body, entries shifted through se[0] (a register,
      // where se[u] would put the array in local memory)
#pragma unroll 1
      for (int u = 0; u < kSItems; ++u) {
        acc += kBits ? count_bits(stride, se[0]) : count_multimaps(se[0]);
#pragma unroll
        for (int v = 0; v + 1 < kSItems; ++v) se[v] = se[v + 1];
      }
    }
  }
  return acc;
}

// The multimap tier's cell as a call of its own: inlined beside the bit
// rows' it shares the kernel's 64 registers with them and spills in its
// loop (about 1% slower at "Q3 shape, 600 a" on an NVIDIA H100 80GB HBM3
// at 700 W, tools/kernel_variants.py --stem cyclic_sweep).
__device__ __noinline__ unsigned count_cell_multimaps(int stride,
                                                      const int2* r_row,
                                                      int cur_r,
                                                      const int2* s_row,
                                                      int cur_s) {
  return count_cell<false>(stride, r_row, cur_r, s_row, cur_s);
}

// rpair (b, a) [R rows, cr], spair (b, c) [S rows, cs], tpair (c, a)
// [T rows, ct], each with its live count per row; out [outputs] += counts.
// Block = (T row, split), split fastest.
__global__ void __launch_bounds__(kCycThreads, kCycPerSm)
cyclic_sweep_kernel(CyclicGrid g, const int2* __restrict__ rpair,
                    const int* __restrict__ rlen,
                    const int2* __restrict__ spair,
                    const int* __restrict__ slen,
                    const int2* __restrict__ tpair,
                    const int* __restrict__ tlen, long long cr, long long cs,
                    long long ct, int* __restrict__ out) {
  __shared__ unsigned red[kCycThreads / 32];
  // this CTA's T row and its cell 0's R, S and output rows: in shared
  // memory, read where they are needed, so they hold no register across
  // the S loop
  __shared__ int cta[4];
  const int tid = threadIdx.x;
  if (tid == 0) g.t_rows(blockIdx.x / g.splits, cta, cta + 1, cta + 2, cta + 3);
  __syncthreads();
  const int n_t = tlen[cta[0]];
  if (n_t == 0) return;  // uniform: nothing here can match
  const int split = blockIdx.x % g.splits;
  const int c_begin = (int)((long long)g.per_t * split / g.splits);
  const int c_end = (int)((long long)g.per_t * (split + 1) / g.splits);

  for (int t0 = 0; t0 < n_t;) {
    __syncthreads();  // the previous chunk is done with the buffer
    const int2* t_row = tpair + (long long)cta[0] * ct;
    int stride = 8;
    const bool use_bits =
        build_t_bits(stride, t_row, t0, min(n_t, t0 + kTChunk));
    // a chunk the bit rows refuse takes a multimap of up to kTSlots / 2
    // entries: fewer passes over the S rows
    const int t1 = min(n_t, t0 + (use_bits ? kTChunk : kTSlots / 2));
    if (!use_bits) build_t_multimap(t_row, t0, t1);

    // each cell's rows, and the next cell's lengths loaded once this
    // cell's counts are done (so no register holds them across the S
    // loop, and the loads overlap the block's reduction)
    int r_at, s_at, o_at;
    g.cell(c_begin, &r_at, &s_at, &o_at);
    int n_r = rlen[cta[1] + r_at], n_s = slen[cta[2] + s_at];
    for (int c = c_begin; c < c_end; ++c) {
      unsigned acc = 0u;
      if (n_r != 0 && n_s != 0) {  // uniform
        const int2* r_row = rpair + (long long)(cta[1] + r_at) * cr;
        const int2* s_row = spair + (long long)(cta[2] + s_at) * cs;
        acc = use_bits
                  ? count_cell<true>(stride, r_row, n_r, s_row, n_s)
                  : count_cell_multimaps(stride, r_row, n_r, s_row, n_s);
      }
      const bool counted = n_r != 0 && n_s != 0;
      if (c + 1 < c_end) {
        g.cell(c + 1, &r_at, &s_at, &o_at);
        n_r = rlen[cta[1] + r_at];
        n_s = slen[cta[2] + s_at];
      }
      if (!counted) continue;
      // the barrier inside block_sum also ends this cell's counts
      const unsigned sum = block_sum(acc, red);
      if (tid == 0 && sum != 0u) {
        int dr, ds, o;  // the cell's output, found again: one register
        g.cell(c, &dr, &ds, &o);  // fewer across the S loop
        atomicAdd(reinterpret_cast<unsigned*>(out) + cta[3] + o, sum);
      }
    }
    t0 = t1;
  }
}

// The rows of an operand with the given row strides over dims: the
// product of the dimensions it spans.
inline long long spanned_rows(int nd, const long long* dims,
                              const long long* stride) {
  long long n = 1;
  for (int d = 0; d < nd; ++d)
    if (stride[d] != 0) n *= dims[d];
  return n;
}

inline bool fits_int(long long x) { return x >= 0 && x <= 0x7fffffffLL; }

// The per-device facts a launch needs once: the SM count, and the sweep's
// shared-memory attributes set.
cudaError_t sweep_setup(int device, int* sms) {
  static int sm_count[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sm_count[device] > 0) {
    *sms = sm_count[device];
    return cudaSuccess;
  }
  const size_t smem = (size_t)kSmemInts * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cyclic_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cyclic_sweep_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) sm_count[device] = *sms;
  return err;
}

// The pre-pass and the sweep.  Keys ra, rb / sb, sc / tc, ta and validity
// rv / sv / tv of the distinct rows of each side, [*, cr] / [*, cs] /
// [*, ct]; the batch dims[nd] with the row strides r, s, t and o of R, S,
// T and the output per dimension (0 where a row is shared along it), in
// the order the CTAs walk it (the first dimension slowest).  Scratch from
// the caller, uninitialised: pairs [R rows * cr + S rows * cs + T rows *
// ct] int2 and lens [R rows + S rows + T rows] int32 (zeroed here); out
// [outputs] int32 (zeroed here, then the counts added).
inline cudaError_t cyclic_sweep(const int* ra, const int* rb,
                                const unsigned char* rv, const int* sb,
                                const int* sc, const unsigned char* sv,
                                const int* tc, const int* ta,
                                const unsigned char* tv, int nd,
                                const long long* dims, const long long* r,
                                const long long* s, const long long* t,
                                const long long* o, long long cr,
                                long long cs, long long ct, int2* pairs,
                                int* lens, int* out, int device,
                                cudaStream_t st) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nd < 1 || nd > kMaxDims) return cudaErrorInvalidValue;
  if (!fits_int(cr) || !fits_int(cs) || !fits_int(ct))
    return cudaErrorInvalidConfiguration;
  const long long n_r = spanned_rows(nd, dims, r);
  const long long n_s = spanned_rows(nd, dims, s);
  const long long n_out = spanned_rows(nd, dims, o);
  if (n_out > 0) {
    err = cudaMemsetAsync(out, 0, n_out * sizeof(int), st);
    if (err != cudaSuccess) return err;
  }
  CyclicGrid g = {};
  long long n_t = 1, per_t = 1;
  for (int d = 0; d < nd; ++d) {
    if (!fits_int(dims[d])) return cudaErrorInvalidValue;
    if (dims[d] == 1) continue;
    if (t[d] != 0) {
      const int k = g.n_tdim++;
      g.tsize[k] = (int)dims[d];
      g.t_r[k] = (int)r[d];
      g.t_s[k] = (int)s[d];
      g.t_t[k] = (int)t[d];
      g.t_o[k] = (int)o[d];
      n_t *= dims[d];
    } else {
      const int k = g.n_cdim++;
      g.csize[k] = (int)dims[d];
      g.c_r[k] = (int)r[d];
      g.c_s[k] = (int)s[d];
      g.c_o[k] = (int)o[d];
      per_t *= dims[d];
    }
  }
  if (n_t * per_t == 0 || cr == 0 || cs == 0 || ct == 0) return cudaSuccess;
  if (!fits_int(n_r) || !fits_int(n_s) || !fits_int(n_t) ||
      !fits_int(n_out) || !fits_int(per_t))
    return cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(lens, 0, (n_r + n_s + n_t) * sizeof(int), st);
  if (err != cudaSuccess) return err;
  int2* rp = pairs;
  int2* sp = rp + n_r * cr;
  int2* tp = sp + n_s * cs;
  int* rlen = lens;
  int* slen = rlen + n_r;
  int* tlen = slen + n_s;
  // R keyed by b with a beside it, S by b with c, T by c with a
  PackSide side[3] = {{rb, ra, rv, cr, 0, 0, rp, rlen},
                      {sb, sc, sv, cs, 0, 0, sp, slen},
                      {tc, ta, tv, ct, 0, 0, tp, tlen}};
  const long long rows[3] = {n_r, n_s, n_t};
  long long blocks = 0;
  for (int k = 0; k < 3; ++k) {
    const long long segs = (side[k].c + kPackSeg - 1) / kPackSeg;
    if (!fits_int(segs) || !fits_int(rows[k] * segs))
      return cudaErrorInvalidConfiguration;
    side[k].segs = (unsigned)segs;
    side[k].blocks = (unsigned)(rows[k] * segs);
    blocks += rows[k] * segs;
  }
  if (!fits_int(blocks)) return cudaErrorInvalidConfiguration;
  pack_live_pairs_kernel<<<(unsigned)blocks, kPackThreads, 0, st>>>(
      side[0], side[1], side[2]);
  err = cudaGetLastError();
  int sms = 0;
  if (err == cudaSuccess) err = sweep_setup(device, &sms);
  if (err != cudaSuccess) return err;
  // too few T rows for one wave: cut each one's cells over more CTAs
  const long long wave = (long long)kCycPerSm * sms;
  g.per_t = (int)per_t;
  g.splits = (int)std::max(1LL, std::min(per_t, wave / n_t));
  if (!fits_int(n_t * g.splits)) return cudaErrorInvalidConfiguration;
  cyclic_sweep_kernel<<<(unsigned)(n_t * g.splits), kCycThreads,
                        (size_t)kSmemInts * sizeof(int), st>>>(
      g, rp, rlen, sp, slen, tp, tlen, cr, cs, ct, out);
  return cudaGetLastError();
}

}  // namespace rj

// The C entry point of the three triangle ops (kernels/cuda.py).
extern "C" int rj_cyclic_sweep(
    const int* ra, const int* rb, const unsigned char* rv, const int* sb,
    const int* sc, const unsigned char* sv, const int* tc, const int* ta,
    const unsigned char* tv, int nd, const long long* dims,
    const long long* r, const long long* s, const long long* t,
    const long long* o, long long cr, long long cs, long long ct,
    void* pairs, int* lens, int* out, int device, void* stream) {
  return (int)rj::cyclic_sweep(ra, rb, rv, sb, sc, sv, tc, ta, tv, nd, dims,
                               r, s, t, o, cr, cs, ct,
                               static_cast<int2*>(pairs), lens, out, device,
                               static_cast<cudaStream_t>(stream));
}
