// Stage 1 of the four-step FFT for a smooth first factor n1 = o * 2^a
// (odd o = 3 ... 23: 3*2^18 splits as 768 x 1024, 9*2^14 as 1152 x 128,
// 23*2^14 as 2944 x 128), with a plain C interface bound by ctypes
// (kofft_tpu_torch/ops/_cuda_build.py). The register radix line
// (radix_line.cuh) takes power-of-two lines only, so these shapes keep the
// dense-leaf chain of line_fft.cuh, chosen by shape on the host
// (hopper_kernels._static_args) and counted under the stage-1 launch
// names. Every other stage launch is a radix kernel of fft_stages.cu.
//
// It computes what s1_kernel and s1r_kernel compute
// (kofft_tpu/ops/pallas_kernels.py:547, :558) and phase 1 of the phased
// kernel (:847): one block per (batch row, tile of T columns) loads the
// (n1, T) column tile of the (b, n1, n2) input into shared memory, runs T
// line FFTs of length n1, multiplies by W[k1, j2] = col[k1, j2 / t] *
// base[k1, j2 mod t] from _twiddle_factors' tables (float2-interleaved,
// one 8-byte load per factor), and writes C, (b, n1, n2). The inverse
// negates the imaginary part on load; the real form reads one real plane
// and runs a real first leaf (2 FFMAs per MAC). Two (n1, T) float2
// buffers per block (ping-pong), T from hopper_kernels._kernel_tile;
// stage 1 reads T consecutive floats per row.
#include <cuda_runtime.h>

#include "elem_io.cuh"
#include "launch.cuh"
#include "line_fft.cuh"

using kofft::bf16;
using kofft::kMaxDevices;
using kofft::LinePlan;
using kofft::ld;
using kofft::prepare;
using kofft::st;

namespace {

// 512 threads: 256 measured slower at every shape (H100, 700 W); more
// registers per thread (3 blocks of 512 per SM) spilled and lost too
constexpr int kThreads = 512;

// kReal: ar is one real plane (ai and sgn are not read). TIn, TOut:
// element types of the loaded planes and of the stored C (float or bf16)
template <bool kReal, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
stage1_smooth_kernel(const TIn* __restrict__ ar, const TIn* __restrict__ ai,
                     TOut* __restrict__ cr, TOut* __restrict__ ci, int n1,
                     int n2, int T, LinePlan plan,
                     const float2* __restrict__ tab,
                     const float2* __restrict__ wb,
                     const float2* __restrict__ wc, int tw_t, float sgn) {
  extern __shared__ float2 smem[];
  const int total = n1 * T;
  float2* buf0 = smem;
  float2* buf1 = smem + total;
  const int tiles = n2 / T;
  const long long row = blockIdx.x / tiles;
  const int j2_0 = (blockIdx.x - static_cast<int>(row) * tiles) * T;
  const long long base = row * n1 * static_cast<long long>(n2);
  const TIn* a_r = ar + base;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int j1 = idx / T;
    const int c = idx - j1 * T;
    const long long g = static_cast<long long>(j1) * n2 + j2_0 + c;
    if constexpr (kReal) {
      reinterpret_cast<float*>(buf0)[idx] = ld(a_r, g);
    } else {
      buf0[idx] = make_float2(ld(a_r, g), sgn * ld(ai, base + g));
    }
  }
  const float2* y =
      kofft::line_fft<kReal>(buf0, buf1, total, plan, tab);
  TOut* c_r = cr + base;
  TOut* c_i = ci + base;
  const int ncol = n2 / tw_t;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1 = idx / T;
    const int c = idx - k1 * T;
    const int j2 = j2_0 + c;
    const int col = j2 / tw_t;
    const float2 f = __ldg(wc + static_cast<long long>(k1) * ncol + col);
    const float2 g = __ldg(wb + static_cast<long long>(k1) * tw_t + j2 -
                           col * tw_t);
    const float2 w = make_float2(f.x * g.x - f.y * g.y, f.x * g.y + f.y * g.x);
    const float2 v = kofft::cmulf(y[idx], w);
    const long long o = static_cast<long long>(k1) * n2 + j2;
    st(c_r, o, v.x);
    st(c_i, o, v.y);
  }
}

// steps: host int32 array, 6 entries per step
// (mm, kb, bb, inner, f_off, tw_off); kb must divide mm, and a kb > 1 step
// needs an even f_off (16-byte aligned table rows)
int fill_plan(LinePlan* p, const int* steps, int nsteps) {
  if (nsteps < 1 || nsteps > kofft::kMaxSteps) return cudaErrorInvalidValue;
  p->nsteps = nsteps;
  for (int s = 0; s < nsteps; ++s) {
    const int* q = steps + 6 * s;
    p->mm[s] = q[0];
    p->kb[s] = q[1];
    p->bb[s] = q[2];
    p->inner[s] = q[3];
    p->f_off[s] = q[4];
    p->tw_off[s] = q[5];
    const bool kb_ok = q[1] == 1 || ((q[1] == 4 || q[1] == 8) &&
                                     q[0] % q[1] == 0 && q[4] % 2 == 0);
    if (!kb_ok) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Each instance keeps its own record of the dynamic shared memory already
// allowed per device (the attribute is per kernel function).
template <bool kReal, typename TIn, typename TOut>
int launch(const void* ar, const void* ai, void* cr, void* ci, int b, int n1,
           int n2, int T, const LinePlan& p, const void* tab, const void* wb,
           const void* wc, int tw_t, int conj, int device, void* stream) {
  if (T < 1 || n2 % T != 0 || tw_t < 1 || n2 % tw_t != 0) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(2 * sizeof(float2) * n1 * T);
  static int allowed[kMaxDevices];
  const auto kernel = stage1_smooth_kernel<kReal, TIn, TOut>;
  const int r =
      prepare(reinterpret_cast<const void*>(kernel), allowed, device, smem);
  if (r != cudaSuccess) return r;
  const unsigned grid = static_cast<unsigned>(b) * (n2 / T);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(ar), static_cast<const TIn*>(ai),
      static_cast<TOut*>(cr), static_cast<TOut*>(ci), n1, n2, T, p,
      static_cast<const float2*>(tab), static_cast<const float2*>(wb),
      static_cast<const float2*>(wc), tw_t, conj ? -1.f : 1.f);
  return cudaGetLastError();
}

// The instances by I/O form (hopper_kernels._IO_FORMS): in_bf16 / out_bf16
// select bf16 loaded planes and bf16 stored planes; stage 1 has no
// f32 -> bf16 form.
template <bool kReal, typename... Args>
int forms(int in_bf16, int out_bf16, Args... a) {
  if (!in_bf16 && !out_bf16) return launch<kReal, float, float>(a...);
  if (in_bf16 && !out_bf16) return launch<kReal, bf16, float>(a...);
  if (in_bf16 && out_bf16) return launch<kReal, bf16, bf16>(a...);
  return cudaErrorInvalidValue;
}

}  // namespace

// (b, n1, n2) planes -> C (b, n1, n2); real = 1 reads one real plane ar
// (ai is not read). T, steps, nsteps, tab: hopper_kernels._kernel_tile and
// _line_plan; wb (n1, tw_t) and wc (n1, n2 / tw_t): the float2 twiddle
// factors (hopper_kernels._stage1_twiddle).
extern "C" int kofft_stage1_smooth(const void* ar, const void* ai, void* cr,
                                   void* ci, int b, int n1, int n2, int T,
                                   const int* steps, int nsteps,
                                   const void* tab, const void* wb,
                                   const void* wc, int tw_t, int conj,
                                   int real, int in_bf16, int out_bf16,
                                   int device, void* stream) {
  LinePlan p;
  const int r = fill_plan(&p, steps, nsteps);
  if (r != cudaSuccess) return r;
  if (real) {
    return forms<true>(in_bf16, out_bf16, ar, ai, cr, ci, b, n1, n2, T, p,
                       tab, wb, wc, tw_t, 0, device, stream);
  }
  return forms<false>(in_bf16, out_bf16, ar, ai, cr, ci, b, n1, n2, T, p,
                      tab, wb, wc, tw_t, conj, device, stream);
}
