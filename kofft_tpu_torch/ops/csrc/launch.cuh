// Launch helpers shared by the kernel sources with dynamic shared memory
// (fft_stages.cu, stage1_odd.cu, axis_fft.cu, dense_dft.cu) and with
// thread-block clusters (fft_stages.cu, axis_fft.cu).
#pragma once

#include <cuda_runtime.h>

namespace kofft {

constexpr int kMaxDevices = 64;

// Selects the device (only if it is not current) and raises the kernel's
// dynamic shared-memory limit once per device: the attribute persists, and
// setting it on every launch cost host time on the hot path. ``allowed``
// is the caller's per-kernel record (the attribute is per function).
inline int prepare(const void* fn, int* allowed, int device, int smem) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  if (allowed[device] < smem) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    allowed[device] = smem;
  }
  return cudaSuccess;
}

// Launches kernel(args...) on a 1-D grid of `grid` CTAs in clusters of
// `csize`, after checking once per device and cluster size that such a
// cluster fits (cudaOccupancyMaxActiveClusters > 0; ``fits`` is the
// caller's per-kernel record, bit csize per device). Clusters of more than
// 8 CTAs are allowed on request (Hopper takes 16).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int* fits, int device,
                   long long grid, int threads, int smem, void* stream,
                   int csize, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (!(fits[device] >> csize & 1)) {
    if (csize > 8) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    fits[device] |= 1 << csize;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace kofft
