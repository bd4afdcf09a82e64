// Hash tables for the join kernels that probe a staged side instead of
// binary-searching a global row (Hopper, sm_90a): in shared memory, and,
// for a row past the shared budget, in global memory (entry_add /
// entry_count).
//
// Open addressing with linear probing over a power-of-two number of slots.
// A slot is empty while its key holds the empty key: INT32_MIN for a 32-bit
// key, INT32_MIN in the high word for a 64-bit pair key (pair_key).
// Neither is ever a key: every join key lies above the engine's sentinels
// (> -2^31 + 15), and the high word of a pair key is a key or a sub-row
// index >= 0.
//
// A count table maps a key to an unsigned count.  table_add claims the
// key's slot with atomicCAS and adds with atomicAdd, so any number of
// threads may add at once; readers wait for a barrier.  A multimap keeps a
// slot per entry (a key and a value).  Callers put at most n/2 keys or
// entries in a table of n slots, so a lookup reads about 1.5 slots on a
// hit and 2.5 on a miss.
//
// Counts are unsigned 32-bit and wrap as the reference's int32 sums do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rj {

constexpr int kEmptyKey = (int)0x80000000;
constexpr unsigned long long kEmptyPair = 0x8000000000000000ULL;

__device__ __forceinline__ int empty_of(const int*) { return kEmptyKey; }
__device__ __forceinline__ unsigned long long empty_of(
    const unsigned long long*) {
  return kEmptyPair;
}

// murmur3's 32-bit finalizer
__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned hash_key(int x) {
  return fmix32((unsigned)x);
}

constexpr unsigned kHashX = 0x9e3779b1u, kHashY = 0x85ebca77u;

__device__ __forceinline__ unsigned hash_pair(int x, int y) {
  return fmix32(((unsigned)x * kHashX) ^ ((unsigned)y * kHashY));
}

// (x, y) as one 64-bit key: x in the high word, y in the low word.
__device__ __forceinline__ unsigned long long pair_key(int x, int y) {
  return ((unsigned long long)(unsigned)x << 32) | (unsigned long long)(unsigned)y;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A multimap keeps one slot per entry: put() claims the first empty slot
// from the key's hash h (atomicCAS on the key) and writes the value beside
// it, so equal keys and equal entries each take their own slot; a lookup
// walks from h to the first empty slot.
__device__ __forceinline__ void multimap_put(int* key, int* val,
                                             unsigned mask, int k, int v,
                                             unsigned h) {
  unsigned s = h & mask;
  while (atomicCAS(key + s, kEmptyKey, k) != kEmptyKey) s = (s + 1) & mask;
  val[s] = v;
}

// The number of entries (k, v) in a multimap whose entries were put with
// the hash h of (k, v).
__device__ __forceinline__ unsigned multimap_count(const int* key,
                                                   const int* val,
                                                   unsigned mask, int k,
                                                   int v, unsigned h) {
  unsigned n = 0u;
  for (unsigned s = h & mask;; s = (s + 1) & mask) {
    const int x = key[s];
    if (x == kEmptyKey) return n;
    if (x == k && val[s] == v) ++n;
  }
}

// Empty every slot of a count table; thread t of nt clears slots t, t + nt, ...
template <typename K>
__device__ __forceinline__ void table_clear(K* key, unsigned* cnt, int n,
                                            int t, int nt) {
  for (int s = t; s < n; s += nt) {
    key[s] = empty_of(key);
    cnt[s] = 0u;
  }
}

// The slot of k, claimed (hash h) if k is new.
template <typename K>
__device__ __forceinline__ unsigned table_claim(K* key, unsigned mask, K k,
                                                unsigned h) {
  for (unsigned s = h & mask;; s = (s + 1) & mask) {
    K old = key[s];
    if (old == empty_of(key)) old = atomicCAS(key + s, empty_of(key), k);
    if (old == empty_of(key) || old == k) return s;
  }
}

// cnt[k] += c, claiming k's slot (hash h) if k is new.
template <typename K>
__device__ __forceinline__ void table_add(K* key, unsigned* cnt,
                                          unsigned mask, K k, unsigned h,
                                          unsigned c) {
  atomicAdd(cnt + table_claim(key, mask, k, h), c);
}

// The slot of k, or -1 when k is absent.
template <typename K>
__device__ __forceinline__ int table_find(const K* key, unsigned mask, K k,
                                          unsigned h) {
  for (unsigned s = h & mask;; s = (s + 1) & mask) {
    const K v = key[s];
    if (v == k) return (int)s;
    if (v == empty_of(key)) return -1;
  }
}

// cnt[k] (0 when k is absent).
template <typename K>
__device__ __forceinline__ unsigned table_get(const K* key,
                                              const unsigned* cnt,
                                              unsigned mask, K k,
                                              unsigned h) {
  const int s = table_find(key, mask, k, h);
  return s < 0 ? 0u : cnt[s];
}

// A table of int2 entries (key, count) in global memory with any number n
// of slots: a key's probe starts at slot (h * n) >> 32 and walks forward,
// wrapping at n.  entry_claim and entry_add may run in any number of
// threads at once; entry_count after a kernel boundary.  A slot, once
// claimed, keeps its key, so a stale read of an empty slot only sends the
// claim to the CAS.
// The slot of k, claimed (hash h) if k is new; *claimed says whether this
// call claimed it.
__device__ __forceinline__ unsigned entry_claim(int2* tab, unsigned n, int k,
                                                unsigned h, bool* claimed) {
  for (unsigned s = __umulhi(h, n);; s = s + 1u == n ? 0u : s + 1u) {
    int* key = &tab[s].x;
    int old = *key;
    if (old == kEmptyKey) old = atomicCAS(key, kEmptyKey, k);
    if (old == kEmptyKey || old == k) {
      *claimed = old == kEmptyKey;
      return s;
    }
  }
}

// count[k] += c; returns whether it claimed a new slot.
__device__ __forceinline__ bool entry_add(int2* tab, unsigned n, int k,
                                          unsigned h, unsigned c) {
  bool claimed;
  const unsigned s = entry_claim(tab, n, k, h, &claimed);
  atomicAdd(reinterpret_cast<unsigned*>(&tab[s].y), c);
  return claimed;
}

// The count of k in a table of entry_add (0 when k is absent).
__device__ __forceinline__ unsigned entry_count(const int2* tab, unsigned n,
                                                int k, unsigned h) {
  for (unsigned s = __umulhi(h, n);; s = s + 1u == n ? 0u : s + 1u) {
    const int2 e = tab[s];
    if (e.x == k) return (unsigned)e.y;
    if (e.x == kEmptyKey) return 0u;
  }
}

// The slot of k in a table of entry_add, or -1 when k is absent.
__device__ __forceinline__ int entry_slot(const int2* tab, unsigned n, int k,
                                          unsigned h) {
  for (unsigned s = __umulhi(h, n);; s = s + 1u == n ? 0u : s + 1u) {
    const int x = tab[s].x;
    if (x == k) return (int)s;
    if (x == kEmptyKey) return -1;
  }
}

// Smallest power of two >= n, clamped to [lo, hi].
__host__ __device__ inline int pow2_at_least(long long n, int lo, int hi) {
  long long p = lo;
  while (p < n && p < hi) p <<= 1;
  return (int)p;
}

}  // namespace rj
