// Global element access of the stage kernels' float32 and bfloat16 I/O
// forms (fft_stages.cu, stage1_odd.cu): a load widens to float32, a
// store rounds to the nearest even bfloat16 (__float2bfloat16_rn, as
// torch's .to(torch.bfloat16) and XLA's convert do). Shared memory and
// registers stay float32.
#pragma once

#include <cuda_bf16.h>

namespace kofft {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(bf16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

}  // namespace kofft
