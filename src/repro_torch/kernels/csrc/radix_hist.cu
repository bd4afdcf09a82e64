// radix_histogram on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/radix_hist.py:51
// radix_histogram (_hist_kernel, :24): hash every key with Murmur3's fmix32
// (seed 0x9E3779B1, hash_bucket's "H" family), reduce it modulo n_buckets,
// and count the live keys per bucket.  The Pallas body turns each tile into
// a one-hot [tile, n_buckets] matrix and sums it on the MXU in f32, which
// is exact only up to 2^24 keys per bucket.
//
// Here every live key is one int32 atomic add (or a warp's lanes with
// equal bins one add, with their number): exact in any order, past 2^24
// a bucket too.  Where the bins live is chosen by n_buckets alone:
//   * up to kCtaBins (32,768 buckets, 128 KB): each CTA counts into its own
//     copy in shared memory.  CTAs run in clusters of kCopyCluster (8); at
//     the end CTA r of a cluster sums slice r of the bins over the
//     cluster's copies through distributed shared memory and adds the
//     non-zero sums to the output, so a bin takes one global atomic a
//     cluster, not one a CTA;
//   * up to kClusterBins (8 x 32,768 = 262,144 buckets, 1 MB): a cluster
//     of the fewest CTAs (2, 4 or 8) whose slices hold the bins splits them
//     (65,536 buckets: two slices of 128 KB, one CTA an SM); a key adds to
//     its bin in the owning CTA's slice through distributed shared memory
//     (map_shared_rank), so no key pays a global atomic, and each CTA adds
//     its slice's non-zero bins to the output once.  Half the keys add to
//     the peer's slice at 65,536 buckets; four slices of 64 KB (two CTAs an
//     SM, three quarters of the keys remote) are slower on R
//     (tools/kernel_variants.py --stem radix_hist, PERF.md);
//   * above 262,144 buckets: every live key adds to the output in global
//     memory.
// A cluster that cannot be launched is an error, never another path.  The
// grid is as many CTAs of 1,024 threads as the card holds at once (or
// fewer for a short stream); a CTA's shared bytes decide how many an SM
// holds (two up to 113 KB, limited by threads).  Keys stream four at a time,
// one 16-byte load of keys and one 4-byte load of their validity bytes; a
// scalar head up to the keys' 16-byte boundary and a scalar tail take the
// rest, so a view that starts mid-vector (keys[1:]) and any n count right.
// A stream whose validity does not share the keys' phase (keys and valid
// offset differently into their storage) streams scalar.
// Lanes of a warp whose keys fall in one bin add once, with their number
// (__match_any_sync), on the global path: a stream of one hot key would
// otherwise serialise on one word of L2.  On the shared paths every live
// key adds alone: aggregating there slows R (4e6 keys over 14,000 values)
// at 4,096 and at 65,536 buckets and speeds only a stream of one hot key
// at 65,536, whose adds go to one word of a peer's slice
// (tools/kernel_variants.py --stem radix_hist with an edited copy;
// PERF.md has the numbers).
// The output is zeroed here with a memset (no fill kernel).
// Bound: the bytes, 4 B of key and 1 B of validity per row read once and
// the histogram written once; the hash is ~11 integer operations a key.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "error_string.cuh"
#include "occupancy.cuh"

namespace cg = cooperative_groups;

namespace rj {

constexpr int kHistThreads = 1024;
constexpr int kHistUnroll = 2;       // 16-byte groups a thread loads at once
constexpr unsigned kCtaBins = 32768;  // a CTA's bins: 128 KB
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr unsigned kClusterBins = kMaxCluster * kCtaBins;  // 262,144
constexpr int kCopyCluster = 8;

enum HistMode { kCopies, kSlices, kGlobal };

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Where a bin's count goes: the CTA's copy, the owning CTA's slice of the
// cluster, or the output.
template <int kMode>
struct Bins {
  int* local;
  unsigned slice;
  int* out;
  __device__ __forceinline__ void add(unsigned b, int c) const {
    if constexpr (kMode == kCopies) {
      atomicAdd(local + b, c);
    } else if constexpr (kMode == kSlices) {
      const unsigned r = b / slice;
      atomicAdd(cg::this_cluster().map_shared_rank(local, r) + (b - r * slice),
                c);
    } else {
      atomicAdd(out + b, c);
    }
  }
};

// Count bin b where live.  Every lane of the warp calls.
template <int kMode>
__device__ __forceinline__ void count(const Bins<kMode>& bins, bool live,
                                      unsigned b) {
  if (kMode == kGlobal) {
    const unsigned peers =
        __match_any_sync(0xffffffffu, live ? b : 0xffffffffu);
    if (live && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      bins.add(b, __popc(peers));
  } else if (live) {
    bins.add(b, 1);
  }
}

// keys[0, n) with valid; the 16-byte groups are keys head + 4 g .. + 3 for
// g < n4, the rest scalar.  out [n_buckets] zeroed.
template <int kMode>
__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const int* __restrict__ keys,
                  const unsigned char* __restrict__ valid, long long n,
                  long long head, long long n4, unsigned n_buckets,
                  unsigned slice, uint32_t seed, int* __restrict__ out) {
  extern __shared__ int bins_smem[];
  if constexpr (kMode != kGlobal) {
    const unsigned n_local = kMode == kCopies ? n_buckets : slice;
    for (unsigned b = threadIdx.x; b < n_local; b += kHistThreads)
      bins_smem[b] = 0;
    if constexpr (kMode == kSlices)
      cg::this_cluster().sync();  // every slice empty before a peer adds
    else
      __syncthreads();
  }
  const Bins<kMode> bins{bins_smem, slice, out};
  auto bin = [&](int key) { return fmix32((uint32_t)key ^ seed) % n_buckets; };

  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kHistThreads;
  const long long w0 = (long long)blockIdx.x * kHistThreads + threadIdx.x -
                       lane;  // the warp's first thread
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  const unsigned* v4 = reinterpret_cast<const unsigned*>(valid + head);
  for (long long g0 = w0; g0 < n4; g0 += kHistUnroll * stride) {  // uniform
    int4 k[kHistUnroll];
    unsigned v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long g = g0 + u * stride + lane;
      k[u] = g < n4 ? __ldg(k4 + g) : make_int4(0, 0, 0, 0);
      v[u] = g < n4 ? __ldg(v4 + g) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      count(bins, (v[u] & 0xffu) != 0u, bin(k[u].x));
      count(bins, (v[u] & 0xff00u) != 0u, bin(k[u].y));
      count(bins, (v[u] & 0xff0000u) != 0u, bin(k[u].z));
      count(bins, (v[u] & 0xff000000u) != 0u, bin(k[u].w));
    }
  }
  // the scalar keys: [0, head) and [head + 4 n4, n)
  const long long n_scalar = n - 4 * n4;
  for (long long i0 = w0; i0 < n_scalar; i0 += stride) {  // uniform
    const long long i = i0 + lane;
    const long long idx = i < head ? i : i + 4 * n4;
    const bool live = i < n_scalar && valid[idx] != 0;
    count(bins, live, live ? bin(keys[idx]) : 0u);
  }

  if constexpr (kMode == kCopies) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every copy complete
    const unsigned nc = cluster.num_blocks(), r = cluster.block_rank();
    const unsigned per = (n_buckets + nc - 1) / nc;
    const unsigned b1 = min(n_buckets, (r + 1) * per);
    for (unsigned b = r * per + threadIdx.x; b < b1; b += kHistThreads) {
      unsigned s = 0u;
      for (unsigned q = 0; q < nc; ++q)
        s += (unsigned)cluster.map_shared_rank(bins_smem, q)[b];
      if (s != 0u) atomicAdd(reinterpret_cast<unsigned*>(out) + b, s);
    }
    cluster.sync();  // peers read this CTA's copy until here
  } else if constexpr (kMode == kSlices) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every remote add done
    const unsigned base = cluster.block_rank() * slice;
    for (unsigned o = threadIdx.x; o < slice && base + o < n_buckets;
         o += kHistThreads)
      if (bins_smem[o] != 0) atomicAdd(out + base + o, bins_smem[o]);
  }
}

template <int kMode>
cudaError_t launch_hist(const int* keys, const unsigned char* valid,
                        long long n, long long head, long long n4,
                        unsigned n_buckets, unsigned slice, int cluster,
                        uint32_t seed, int* out, int device,
                        cudaStream_t st) {
  auto* kernel = radix_hist_kernel<kMode>;
  const unsigned n_local =
      kMode == kCopies ? n_buckets : kMode == kSlices ? slice : 0u;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = (size_t)n_local * 4;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  long long resident = 0;
  if (err == cudaSuccess)
    err = resident_ctas((const void*)kernel, kHistThreads,
                        cfg.dynamicSmemBytes, cluster, device, &resident);
  if (err != cudaSuccess) return err;
  // a thread for every kHistUnroll groups (or scalar key), at most the
  // CTAs the card holds, in whole clusters
  const long long work = std::max(n4 / kHistUnroll + 1, n - 4 * n4);
  long long blocks =
      std::min((work + kHistThreads - 1) / kHistThreads, resident);
  blocks = std::max(1LL, (blocks + cluster - 1) / cluster) * cluster;
  cfg.gridDim = dim3((unsigned)blocks);
  return cudaLaunchKernelEx(&cfg, kernel, keys, valid, n, head, n4,
                            n_buckets, slice, seed, out);
}

}  // namespace rj

// out [n_buckets] int32 (uninitialised: zeroed here).
extern "C" int rj_radix_histogram(const int* keys, const unsigned char* valid,
                                  long long n, int n_buckets,
                                  unsigned int seed, int* out, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_buckets <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)n_buckets * 4, st);
  if (err != cudaSuccess || n == 0) return (int)err;
  // the 16-byte groups start where the keys reach a 16-byte boundary, if
  // the validity bytes reach a 4-byte one there too
  const uintptr_t pk = reinterpret_cast<uintptr_t>(keys);
  const uintptr_t pv = reinterpret_cast<uintptr_t>(valid);
  long long head = n, n4 = 0;
  if (((pk >> 2) & 3u) == (pv & 3u)) {
    head = std::min(n, (long long)((4u - ((pk >> 2) & 3u)) & 3u));
    n4 = (n - head) / 4;
  }
  const unsigned nb = (unsigned)n_buckets;
  if (nb <= rj::kCtaBins)
    return (int)rj::launch_hist<rj::kCopies>(keys, valid, n, head, n4, nb,
                                             nb, rj::kCopyCluster, seed, out,
                                             device, st);
  if (nb <= rj::kClusterBins) {
    int cluster = 2;
    while ((unsigned)cluster * rj::kCtaBins < nb) cluster *= 2;
    const unsigned slice = (nb + cluster - 1) / cluster;
    return (int)rj::launch_hist<rj::kSlices>(keys, valid, n, head, n4, nb,
                                             slice, cluster, seed, out,
                                             device, st);
  }
  return (int)rj::launch_hist<rj::kGlobal>(keys, valid, n, head, n4, nb, 0u,
                                           1, seed, out, device, st);
}
