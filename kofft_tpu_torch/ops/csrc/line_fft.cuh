// Block-wide line FFT in shared memory by dense DFT leaves, the recursion
// of _fft_axis0_traced (kofft_tpu/ops/pallas_kernels.py:378-412). Only
// stage 1 of a smooth n1 = o * 2^a runs it (smooth_stage.cu): the register
// radix line (radix_line.cuh) serves every power-of-two line.
//
// A block holds T lines of length m as an (m, T) array of float2 in shared
// memory: element (j, c) at j*T + c. The recursion m = a*b, j = ja*b + jb,
// output k = ka + a*kb, with dense DFT-matrix leaves of size <= 128
// (_ML_LEAF), is flattened by the host into a chain of steps (LinePlan):
// step s views its source as (mm, R), R = total / mm, computes y[k, r] =
// sum_j F[j, k] x[j, r], and, for the leading factor of a split (bb > 1),
// fuses the twiddle w_{m'}^{ka*jb} and the (a, b) -> (b, a) digit swap into
// its store. Real input: the first step reads (m, T) floats and does 2
// FFMAs per MAC. Each thread computes KB = 8, 4 or 1 outputs of one column
// (register blocking), reading the table two entries per 16-byte load.
// A leaf costs mm complex MACs per point (a smooth line of 768 = 3 * 256
// splits into leaves of 16 and 48: 64 MACs per point).
#pragma once

#include <cuda_runtime.h>

namespace kofft {

constexpr int kMaxSteps = 6;

struct LinePlan {
  int nsteps;
  int mm[kMaxSteps];      // leaf DFT size of the step
  int kb[kMaxSteps];      // outputs per thread: 8 or 4 (mm divisible), or 1
  int bb[kMaxSteps];      // cofactor b of a twiddle+swap step; 1 for the last
  int inner[kMaxSteps];   // contiguous columns below the (mm, bb) digits
  int f_off[kMaxSteps];   // float2 offset of the (mm, mm) DFT matrix
  int tw_off[kMaxSteps];  // float2 offset of the (mm, bb) twiddle
};

__device__ __forceinline__ float2 cmulf(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc += w * x, one complex MAC; kReal: x is real (x.y is not read)
template <bool kReal>
__device__ __forceinline__ void cmac(float2& acc, float wr, float wi,
                                     float2 x) {
  if constexpr (kReal) {
    acc.x = fmaf(wr, x.x, acc.x);
    acc.y = fmaf(wi, x.x, acc.y);
  } else {
    acc.x = fmaf(wr, x.x, fmaf(-wi, x.y, acc.x));
    acc.y = fmaf(wr, x.y, fmaf(wi, x.x, acc.y));
  }
}

// One step of the chain: src (mm, R) -> dst, KB outputs k per thread.
// KB > 1 reads F two entries at a time: the host keeps every table offset
// even, so F + j*mm + k0 (mm and k0 even) is 16-byte aligned. kReal: src
// holds (mm, R) floats.
template <int KB, bool kReal>
__device__ void leaf_step(const float2* __restrict__ src,
                          float2* __restrict__ dst, int total, int mm,
                          int bb, int inner, const float2* __restrict__ F,
                          const float2* __restrict__ tw) {
  const int R = total / mm;
  const int work = (mm / KB) * R;
  for (int idx = threadIdx.x; idx < work; idx += blockDim.x) {
    const int kq = idx / R;
    const int r = idx - kq * R;
    const int k0 = kq * KB;
    float2 acc[KB];
#pragma unroll
    for (int q = 0; q < KB; ++q) acc[q] = make_float2(0.f, 0.f);
    for (int j = 0; j < mm; ++j) {
      float2 x;
      if constexpr (kReal) {
        x = make_float2(reinterpret_cast<const float*>(src)[j * R + r], 0.f);
      } else {
        x = src[j * R + r];
      }
      if constexpr (KB == 1) {
        const float2 w = __ldg(F + j * mm + k0);
        cmac<kReal>(acc[0], w.x, w.y, x);
      } else {
        const float4* f = reinterpret_cast<const float4*>(F + j * mm + k0);
#pragma unroll
        for (int q = 0; q < KB / 2; ++q) {
          const float4 w = __ldg(f + q);
          cmac<kReal>(acc[2 * q], w.x, w.y, x);
          cmac<kReal>(acc[2 * q + 1], w.z, w.w, x);
        }
      }
    }
    if (bb == 1) {
#pragma unroll
      for (int q = 0; q < KB; ++q) dst[(k0 + q) * R + r] = acc[q];
    } else {
      const int jb = r / inner;
      const int c = r - jb * inner;
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        const int k = k0 + q;
        dst[(jb * mm + k) * inner + c] = cmulf(acc[q], __ldg(tw + k * bb + jb));
      }
    }
  }
}

template <bool kReal>
__device__ __forceinline__ void run_step(const float2* src, float2* dst,
                                         int total, const LinePlan& p, int s,
                                         const float2* __restrict__ tab) {
  const int mm = p.mm[s];
  const float2* F = tab + p.f_off[s];
  const float2* tw = tab + p.tw_off[s];
  if (p.kb[s] == 8) {
    leaf_step<8, kReal>(src, dst, total, mm, p.bb[s], p.inner[s], F, tw);
  } else if (p.kb[s] == 4) {
    leaf_step<4, kReal>(src, dst, total, mm, p.bb[s], p.inner[s], F, tw);
  } else {
    leaf_step<1, kReal>(src, dst, total, mm, p.bb[s], p.inner[s], F, tw);
  }
}

// Runs the chain on buf0 (input) with buf1 as the ping-pong partner and
// returns the buffer that holds the natural-order result, (m, T) float2.
// kRealInput: buf0 holds the real (m, T) input as floats.
template <bool kRealInput = false>
__device__ __forceinline__ float2* line_fft(float2* buf0, float2* buf1,
                                            int total, const LinePlan& p,
                                            const float2* __restrict__ tab) {
  float2* src = buf0;
  float2* dst = buf1;
  int s = 0;
  if constexpr (kRealInput) {
    __syncthreads();
    run_step<true>(src, dst, total, p, 0, tab);
    src = buf1;
    dst = buf0;
    s = 1;
  }
  for (; s < p.nsteps; ++s) {
    __syncthreads();
    run_step<false>(src, dst, total, p, s, tab);
    float2* t = src;
    src = dst;
    dst = t;
  }
  __syncthreads();
  return src;
}

}  // namespace kofft
