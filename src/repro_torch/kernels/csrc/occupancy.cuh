// The CTAs of a launch that the card holds at once, for the kernels that
// size their grids to one wave (pair_count.cu, radix_hist.cu, key_lists.cuh's
// spill): the CTAs an SM holds at the kernel's threads and dynamic shared
// bytes times the SMs, or, for a cluster launch, whole clusters
// (cudaOccupancyMaxActiveClusters; none fitting is an error).  Cached per
// (kernel, device, bytes, cluster size), so the queries run once a
// process, not on every call.  Internal linkage: each library keeps its
// own cache (a static of an inline function would be one object across
// the libraries).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace rj {

static inline cudaError_t resident_ctas(const void* kernel, int threads,
                                        size_t smem, int cluster, int device,
                                        long long* out) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
    int cluster;
    long long n;
  };
  static thread_local Entry cache[4] = {};
  for (const Entry& e : cache)
    if (e.kernel == kernel && e.device == device && e.smem == smem &&
        e.cluster == cluster) {
      *out = e.n;
      return cudaSuccess;
    }
  cudaError_t err;
  if (cluster > 1) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err == cudaSuccess && clusters == 0)
      err = cudaErrorInvalidConfiguration;
    *out = (long long)clusters * cluster;
  } else {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    *out = (long long)std::max(per_sm, 1) * sms;
  }
  if (err != cudaSuccess) return err;
  for (int i = 3; i > 0; --i) cache[i] = cache[i - 1];
  cache[0] = Entry{kernel, device, smem, cluster, *out};
  return cudaSuccess;
}

}  // namespace rj
