// radix_histogram on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/radix_hist.py:51
// radix_histogram (_hist_kernel, :24): hash every key with Murmur3's fmix32
// (seed 0x9E3779B1, hash_bucket's "H" family), reduce it modulo n_buckets,
// and count the live keys per bucket.  The Pallas body turns each tile into
// a one-hot [tile, n_buckets] matrix and sums it on the MXU in f32, which
// is exact only up to 2^24 keys per bucket.
//
// Here one thread hashes one key (a grid-stride loop).  While the
// histogram fits in shared memory (n_buckets * 4 B <= kSmemBuckets * 4 B =
// 48 KB), each block counts into its own shared copy with int32 atomics
// and adds the non-zero bins to the global int32 output once at the end;
// above that, every key adds to the global histogram directly.  Int32
// atomics are exact in any order, so the counts equal the plain version's
// bit for bit, past 2^24 per bucket too.  Dead rows (valid == 0) are
// skipped.
// Bound: the bytes, 4 B of key and 1 B of validity per row read once and
// the histogram written once; the hash is ~10 integer operations a key.
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace rj {

constexpr int kHistThreads = 256;
constexpr int kSmemBuckets = 12288;  // 48 KB of int32 bins
constexpr int kMaxBlocks = 264;      // two per SM of an H100

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <bool kShared>
__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const int* __restrict__ keys,
                  const unsigned char* __restrict__ valid, long long n,
                  unsigned n_buckets, uint32_t seed, int* __restrict__ out) {
  extern __shared__ int bins[];
  if (kShared) {
    for (unsigned b = threadIdx.x; b < n_buckets; b += kHistThreads)
      bins[b] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kHistThreads;
  for (long long i = (long long)blockIdx.x * kHistThreads + threadIdx.x;
       i < n; i += stride) {
    if (!valid[i]) continue;
    const unsigned b = fmix32((uint32_t)keys[i] ^ seed) % n_buckets;
    if (kShared)
      atomicAdd(&bins[b], 1);
    else
      atomicAdd(&out[b], 1);
  }
  if (kShared) {
    __syncthreads();
    for (unsigned b = threadIdx.x; b < n_buckets; b += kHistThreads)
      if (bins[b]) atomicAdd(&out[b], bins[b]);
  }
}

}  // namespace rj

// out must hold n_buckets zeros.
extern "C" int rj_radix_histogram(const int* keys, const unsigned char* valid,
                                  long long n, int n_buckets,
                                  unsigned int seed, int* out, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_buckets <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + rj::kHistThreads - 1) / rj::kHistThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > rj::kMaxBlocks) blocks = rj::kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_buckets <= rj::kSmemBuckets) {
    rj::radix_hist_kernel<true>
        <<<(unsigned)blocks, rj::kHistThreads, n_buckets * sizeof(int), s>>>(
            keys, valid, n, (unsigned)n_buckets, seed, out);
  } else {
    rj::radix_hist_kernel<false><<<(unsigned)blocks, rj::kHistThreads, 0, s>>>(
        keys, valid, n, (unsigned)n_buckets, seed, out);
  }
  return (int)cudaGetLastError();
}
