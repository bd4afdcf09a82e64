// bucket_pair_count on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/bucket_join.py:55 pair_count
// (_pair_count_kernel, :47): per bucket row b, the number of equal key
// pairs #{(i, j) : ka[b, i] == kb[b, j]}, the inner loop of the bucketed
// binary join.  The Pallas body compares all Ca x Cb pairs of a bucket in
// VMEM and sums the 0/1 matrix in f32.
//
// Comparing all pairs would cost Ca * Cb compares per bucket (6e6 at 4,096
// buckets of ~2,450 slots).  Instead the wrapper sorts each kb row once,
// and one thread per ka slot counts its key in its bucket's sorted kb row
// by two binary searches (count_equal, fused_common.cuh).  The counts of a
// warp's run of slots in one bucket are summed in the warp and added with
// one int32 atomic (warp_add_by_cell); int32 sums wrap the same in any
// order.  A dead ka slot (the a-side sentinel) costs one load.
// Bound: the bytes, both grids read once; the searches take about
// 2 log2(Cb) loads per live slot, mostly from L1 and L2.
#include "fused_common.cuh"

namespace rj {

__global__ void __launch_bounds__(kThreads)
pair_count_kernel(const int* __restrict__ ka, const int* __restrict__ kb_sorted,
                  int dead_a, long long ca, long long cb, long long n_slots,
                  int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long cell = -1;
  unsigned v = 0u;
  if (i < n_slots) {
    const int key = ka[i];
    if (key != dead_a) {
      cell = i / ca;
      v = count_equal(kb_sorted + cell * cb, cb, key);
    }
  }
  warp_add_by_cell(out, cell, v);
}

}  // namespace rj

extern "C" int rj_pair_count(const int* ka, const int* kb_sorted, int dead_a,
                             long long n_rows, long long ca, long long cb,
                             int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = n_rows * ca;
  const long long blocks = (n + rj::kThreads - 1) / rj::kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rj::pair_count_kernel<<<(unsigned)blocks, rj::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ka, kb_sorted, dead_a, ca, cb, n, out);
  return (int)cudaGetLastError();
}
