// Thread-block cluster helpers for NVIDIA Hopper (sm_90a), shared by the
// kernels that spread one region over the CTAs of a cluster: the segment
// encode from P = 1024 on (segment_cluster.cuh) and the region encode above
// P = 4096 (region_encode.cuh, encode_region_cluster_kernel).

#pragma once

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;   // non-portable above 8 CTAs

// A barrier of every thread of the cluster; shared-memory writes before it,
// also into other CTAs' shared memory, are visible after it.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// p's counterpart in the shared memory of CTA `rank` of the cluster.
template <class T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// The low `bits` bits of x in reverse order (0 for no bits).
__device__ __forceinline__ int bit_rev(int x, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)x) >> (32 - bits));
}

// A launch in clusters of cs CTAs of `threads` threads on `st`; attr holds
// the cluster dimension, so it must outlive the launch.
inline void cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr, int cs,
                           int threads, cudaStream_t st) {
  config = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.blockDim = dim3(threads, 1, 1);
  config.stream = st;
  config.attrs = &attr;
  config.numAttrs = 1;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory and, above 8
// CTAs, clusters of a non-portable size.
template <class Kernel>
cudaError_t allow_cluster(Kernel kernel, int cs, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace
