// Block-wide line FFT in shared memory: the Hopper counterpart of
// _fft_axis0_traced (kofft_tpu/ops/pallas_kernels.py:378-412).
//
// A block holds T lines of length m as an (m, T) array of float2 in shared
// memory: element (j, c) at j*T + c, line index major, line c minor. The
// transform is the recursive four-step of the JAX routine, m = a*b,
// j = ja*b + jb, output k = ka + a*kb in natural order, with dense
// DFT-matrix leaves of size <= 128 (_ML_LEAF). Every recursion level works
// on the whole buffer, so the host flattens the recursion into a chain of
// steps (LinePlan). Step s views its source as (mm, R), R = total / mm,
// and computes y[k, r] = sum_j F[j, k] x[j, r] with the (mm, mm) leaf DFT.
// A step with bb > 1 is the leaf of the leading factor a = mm of a split
// m' = a*b (b = bb): R = b*inner, r = jb*inner + c, and the step fuses the
// inter-level twiddle tw[ka, jb] = w_{m'}^{ka*jb} and the (a, b) -> (b, a)
// digit swap into its store. The last step (bb == 1) is the plain leaf.
// On every size the stage kernels serve, the leading factor of each split
// is itself a leaf (the host asserts it), so this chain is the whole
// recursion.
//
// Bound: a dense leaf costs mm complex MACs per point, so a line of 1024
// (32 x 32) costs 64 MACs per point and a line of 8192 (64 x 128) 192.
// Each thread computes KB outputs k of one column r (register blocking,
// KB = 8, 4 or 1 as the host plan picks per step): the shared-memory
// operand x[j, r] is read once for KB MACs, and the table row F[j, k0..]
// is the same address across the warp (a broadcast), read two entries
// per 16-byte load. The pair is bound by the load/store unit and the
// FFMA pipe, not by HBM. Radix butterflies or tensor-core leaves are the
// later fix.
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

// One step of the chain: src (mm, R) -> dst, KB outputs k per thread.
// KB > 1 reads F two entries at a time: the host keeps every table offset
// even, so F + j*mm + k0 (mm and k0 even) is 16-byte aligned.
template <int KB>
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
      const float2 x = src[j * R + r];
      if constexpr (KB == 1) {
        const float2 w = __ldg(F + j * mm + k0);
        acc[0].x = fmaf(w.x, x.x, fmaf(-w.y, x.y, acc[0].x));
        acc[0].y = fmaf(w.x, x.y, fmaf(w.y, x.x, acc[0].y));
      } else {
        const float4* f = reinterpret_cast<const float4*>(F + j * mm + k0);
#pragma unroll
        for (int q = 0; q < KB / 2; ++q) {
          const float4 w = __ldg(f + q);
          float2& a0 = acc[2 * q];
          float2& a1 = acc[2 * q + 1];
          a0.x = fmaf(w.x, x.x, fmaf(-w.y, x.y, a0.x));
          a0.y = fmaf(w.x, x.y, fmaf(w.y, x.x, a0.y));
          a1.x = fmaf(w.z, x.x, fmaf(-w.w, x.y, a1.x));
          a1.y = fmaf(w.z, x.y, fmaf(w.w, x.x, a1.y));
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

// Runs the chain on buf0 (input) with buf1 as the ping-pong partner and
// returns the buffer that holds the natural-order result, (m, T).
__device__ __forceinline__ float2* line_fft(float2* buf0, float2* buf1,
                                            int total, const LinePlan& p,
                                            const float2* __restrict__ tab) {
  float2* src = buf0;
  float2* dst = buf1;
  for (int s = 0; s < p.nsteps; ++s) {
    __syncthreads();
    const int mm = p.mm[s];
    const float2* F = tab + p.f_off[s];
    const float2* tw = tab + p.tw_off[s];
    if (p.kb[s] == 8) {
      leaf_step<8>(src, dst, total, mm, p.bb[s], p.inner[s], F, tw);
    } else if (p.kb[s] == 4) {
      leaf_step<4>(src, dst, total, mm, p.bb[s], p.inner[s], F, tw);
    } else {
      leaf_step<1>(src, dst, total, mm, p.bb[s], p.inner[s], F, tw);
    }
    float2* t = src;
    src = dst;
    dst = t;
  }
  __syncthreads();
  return src;
}

}  // namespace kofft
