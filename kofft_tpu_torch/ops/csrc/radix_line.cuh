// Block-wide line FFT in registers: radix passes of 16, 8, 4 or 2 points,
// exchanged through one shared-memory buffer in Stockham order. It is the
// axis kernels' replacement (axis_fft.cu) for the dense-leaf chain of
// line_fft.cuh; both compute _fft_axis0_traced's function
// (kofft_tpu/ops/pallas_kernels.py:378-412), the DFT of each line.
//
// A block holds T lines of m = 2^p points; each thread holds E points of
// one line in registers (E = 16, or m below 16), so a line has tpl = m/E
// threads, and thread ti of a line holds points ti + s*tpl, s = 0 .. E-1,
// on entry and after every pass.
//
// The host splits m into radices R_0 R_1 ... (hopper_kernels._radices:
// ceil(p/4) passes, largest first: 128 = 16*8, 1024 = 16*8*8) and gives
// them as a RadixPlan. Pass p (radix R, stride Ns = R_0 ... R_{p-1}) runs
// the m/R butterflies j of the Stockham autosort FFT:
//   u_r = x[j + r*m/R] * w^(r*(j mod Ns)),  w = exp(-2 pi i / (Ns*R)),
//   U = DFT_R(u),  y[(j / Ns)*Ns*R + (j mod Ns) + r*Ns] = U_r.
// Thread ti runs butterflies j = ti + q*tpl, q < E/R. Their inputs
// j + r*m/R = ti + tpl*(q + r*E/R) are exactly the points the thread
// holds, so every pass reads its operands from registers at indices
// known at compile time. The last pass has Ns*R = m, so it writes point
// j + r*m/R, again the thread's own: the result is in natural order in
// registers, and the kernel stores it straight to device memory. Only the
// passes between exchange: each thread writes its U to shared memory at
// the Stockham positions, the block synchronises, each thread reads back
// its points ti + s*tpl, and the block synchronises again. One buffer
// (T*m floats for re, T*m for im) serves every exchange.
//
// Bank conflicts: the buffer's logical word (line-major for row_fft,
// column-fastest for col_fft) goes through a swizzle chosen by the host
// per exchange, a ^ (((h >> x1) << y1) ^ ((h >> x2) << y2)) & 31 with
// h = a >> 5, a permutation within each row of 32 words, so no memory is
// padded. Every address is an XOR of disjoint bit fields of the lane, the
// instruction and the warp, so the host reads the conflicts of all
// accesses off one warp's first write and read
// (hopper_kernels._pick_swizzle), and the tests check whole blocks: one
// wavefront per warp-wide access at every tile the routes use.
//
// Twiddles: pass p (Ns > 1) reads w[jj*(R-1) + r-1] from a float2 table
// built on the host in float64 with the phase jj*r reduced mod Ns*R in
// integers, rounded once to float32. The butterflies' own constants
// (w_8, w_16) are hard-coded float32 values rounded from float64, as in
// kofft's fixed-size fft2/fft4/fft8/fft16 kernels.
//
// Cost per point and pass: a radix-16 butterfly is two radix-8 halves and
// 16 complex additions with 6 constant products, about 11 floating-point
// instructions per point, plus (R-1)/R twiddle products of 4 instructions
// and one 8-byte table load each; radix 8 about 8, radix 4 about 4. A line
// of 128 (16*8) takes ~30 instructions per point where the dense 128-point
// leaf took 512 FFMA; a line of 1024 (16*8*8) ~40 against 256. Shared
// memory: per exchange one 4-byte store and one 4-byte load per plane and
// point (pass count - 1 exchanges: 1 at 128, 2 at 1024, 3 at 8192), half
// of the dense chain's per step (two ping-pong buffers, plus its table
// reads), and no shared memory at all for lines of 16 or fewer.
#pragma once

#include <cuda_runtime.h>

namespace kofft {
namespace radix {

constexpr int kMaxPasses = 6;

struct RadixPlan {
  int npass;
  int radix[kMaxPasses];   // R of the pass: 16, 8, 4 or 2
  int ns[kMaxPasses];      // Ns, the product of the earlier radices
  int tw_off[kMaxPasses];  // float2 offset of the pass's (Ns, R-1) table
  int sw[kMaxPasses][4];   // swizzle (x1, y1, x2, y2) of the exchange after
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// w_R^k = exp(-2 pi i k / R) for the radix-2 combine of a size-R DFT
template <int R>
__device__ __forceinline__ float2 wconst(int k) {
  constexpr float c8 = 0.707106781186547524f;   // cos(pi/4)
  constexpr float c16 = 0.923879532511286756f;  // cos(pi/8)
  constexpr float s16 = 0.382683432365089772f;  // sin(pi/8)
  if constexpr (R == 8) {
    return k == 1 ? make_float2(c8, -c8) : make_float2(-c8, -c8);  // k = 3
  } else {
    switch (k) {
      case 1: return make_float2(c16, -s16);
      case 2: return make_float2(c8, -c8);
      case 3: return make_float2(s16, -c16);
      case 5: return make_float2(-s16, -c16);
      case 6: return make_float2(-c8, -c8);
      default: return make_float2(-c16, -s16);  // k = 7
    }
  }
}

// In-place forward DFT of R points (radix-2 decimation in time, fully
// unrolled; every index is a compile-time constant)
template <int R>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  if constexpr (R == 2) {
    const float2 t = u[0];
    u[0] = cadd(t, u[1]);
    u[1] = csub(t, u[1]);
  } else if constexpr (R == 4) {
    const float2 a0 = cadd(u[0], u[2]);
    const float2 a1 = csub(u[0], u[2]);
    const float2 a2 = cadd(u[1], u[3]);
    const float2 d = csub(u[1], u[3]);
    const float2 a3 = make_float2(d.y, -d.x);  // (u1 - u3) * -i
    u[0] = cadd(a0, a2);
    u[2] = csub(a0, a2);
    u[1] = cadd(a1, a3);
    u[3] = csub(a1, a3);
  } else {
    constexpr int H = R / 2;
    float2 e[H], o[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      e[i] = u[2 * i];
      o[i] = u[2 * i + 1];
    }
    dft<H>(e);
    dft<H>(o);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float2 t = o[k];
      if (k == H / 2) {
        t = make_float2(t.y, -t.x);  // * -i
      } else if (k != 0) {
        t = cmul(t, wconst<R>(k));
      }
      u[k] = cadd(e[k], t);
      u[k + H] = csub(e[k], t);
    }
  }
}

struct Swizzle {
  int x1, y1, x2, y2;
};

// Physical word of logical word a in the exchange buffer (see the note)
__device__ __forceinline__ int swizzle(int a, Swizzle sw) {
  const int h = a >> 5;
  return a ^ ((((h >> sw.x1) << sw.y1) ^ ((h >> sw.x2) << sw.y2)) & 31);
}

// One radix-R pass over the E points the thread holds (v[s] = point
// ti + s*tpl). Not the last pass: exchange through shared memory, where
// point k of the thread's line is logical word line0 + k*kstride.
template <int E, int R>
__device__ __forceinline__ void radix_pass(float2 (&v)[E], int ti, int tpl,
                                           int ns,
                                           const float2* __restrict__ tw,
                                           bool last, float* sre, float* sim,
                                           int line0, int kstride,
                                           Swizzle sw) {
  constexpr int Q = E / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = ti + q * tpl;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[q + r * Q];
    if (ns > 1) {
      const float2* w = tw + (j & (ns - 1)) * (R - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) u[r] = cmul(u[r], __ldg(w + r - 1));
    }
    dft<R>(u);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q + r * Q] = u[r];
  }
  if (last) return;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = ti + q * tpl;
    const int k0 = (j & ~(ns - 1)) * R + (j & (ns - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = swizzle(line0 + (k0 + r * ns) * kstride, sw);
      sre[a] = v[q + r * Q].x;
      sim[a] = v[q + r * Q].y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int a = swizzle(line0 + (ti + s * tpl) * kstride, sw);
    v[s] = make_float2(sre[a], sim[a]);
  }
  __syncthreads();
}

// The whole line FFT: v holds points ti + s*tpl of the thread's line on
// entry and their DFT, in the same places, on exit. Every thread of the
// block must call it (it synchronises between passes).
template <int E>
__device__ __forceinline__ void line_fft(float2 (&v)[E], int ti, int tpl,
                                         const RadixPlan& p,
                                         const float2* __restrict__ tab,
                                         float* sre, float* sim, int line0,
                                         int kstride) {
  for (int s = 0; s < p.npass; ++s) {
    const bool last = s == p.npass - 1;
    const float2* tw = tab + p.tw_off[s];
    const int ns = p.ns[s];
    const Swizzle sw{p.sw[s][0], p.sw[s][1], p.sw[s][2], p.sw[s][3]};
    switch (p.radix[s]) {
      case 16:
        if constexpr (E >= 16)
          radix_pass<E, 16>(v, ti, tpl, ns, tw, last, sre, sim, line0,
                            kstride, sw);
        break;
      case 8:
        if constexpr (E >= 8)
          radix_pass<E, 8>(v, ti, tpl, ns, tw, last, sre, sim, line0,
                           kstride, sw);
        break;
      case 4:
        if constexpr (E >= 4)
          radix_pass<E, 4>(v, ti, tpl, ns, tw, last, sre, sim, line0,
                           kstride, sw);
        break;
      default:
        radix_pass<E, 2>(v, ti, tpl, ns, tw, last, sre, sim, line0, kstride,
                         sw);
    }
  }
}

// steps: host int32 array, 7 entries per pass (R, Ns, tw_off, x1, y1, x2,
// y2), hopper_kernels._axis_plan. The radices must multiply to m, none
// above E, each Ns the product of the radices before it. The last pass's
// swizzle is that of an exchange after the line FFT, where a kernel has
// one (stage 2's transposed store).
inline int fill_plan(RadixPlan* p, const int* steps, int npass, int m,
                     int E) {
  if (npass < 1 || npass > kMaxPasses) return cudaErrorInvalidValue;
  p->npass = npass;
  int ns = 1;
  for (int s = 0; s < npass; ++s) {
    const int* q = steps + 7 * s;
    const int r = q[0];
    if ((r != 2 && r != 4 && r != 8 && r != 16) || r > E || q[1] != ns ||
        q[2] < 0) {
      return cudaErrorInvalidValue;
    }
    p->radix[s] = r;
    p->ns[s] = ns;
    p->tw_off[s] = q[2];
    for (int i = 0; i < 4; ++i) p->sw[s][i] = q[3 + i];
    ns *= r;
  }
  return ns == m ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace radix
}  // namespace kofft
