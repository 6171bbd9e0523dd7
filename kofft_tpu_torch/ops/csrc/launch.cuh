// Launch helper shared by the kernel sources with dynamic shared memory
// (fft_stages.cu, stage1_odd.cu, axis_fft.cu, dense_dft.cu).
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

}  // namespace kofft
