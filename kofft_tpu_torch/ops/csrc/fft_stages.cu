// The two stages of the Bailey four-step FFT, X = F_n2 . ((F_n1 . A) o W),
// for a batch of (n1, n2) float32 planes, with a plain C interface bound
// by ctypes (kofft_tpu_torch/ops/_cuda_build.py).
//
// stage1 replaces s1_kernel (kofft_tpu/ops/pallas_kernels.py:547) and
// phase 1 of the phased kernel (_build_phased kern, :847-913): one block
// per (batch row, tile of T columns) loads the (n1, T) column tile of the
// (b, n1, n2) input into shared memory, runs T line FFTs of length n1,
// multiplies by W[k1, j2] = col[k1, j2 / t] * base[k1, j2 mod t] from
// _twiddle_factors' tables (t = 128), and writes C, (b, n1, n2).
//
// stage2 replaces s2_kernel (:569) and phases 2-3 of the phased kernel
// (:915-1013): one block per (batch row, tile of T rows of C) runs T line
// FFTs of length n2 along the rows and writes Y[b, k2, k1] into
// (b, n2, n1), whose row-major flattening is the natural-order spectrum
// (the phased flat form's output, with no extra pass).
//
// The TPU kept C in VMEM (phased) or HBM (two-call pair); here C always
// goes through device memory between the two launches. At 2^20 it is 8 MB
// and stays in the 50 MB L2. Blocks are independent; nothing is carried
// between them.
//
// Inverse: conj = 1 negates the imaginary part on load in stage 1 and on
// store in stage 2 (the conjugation identity of pallas_fft.py:75-80), so
// the inverse costs no extra pass.
//
// The real FFT (rfft) runs two more instances of the same kernels:
// - stage1_real replaces s1r_kernel (:558) and phase 1 of the phased
//   real form (real=True, :847): it reads ONE real (b, n1, n2) plane into
//   shared memory as floats, and the first leaf step of the line FFT does
//   2 FFMAs per MAC instead of 4 (line_fft.cuh). 4 bytes in, 8 out per
//   point.
// - stage2_half replaces s2h_kernel (:579), phases 2-3 of the phased real
//   form and the Nyquist epilogue (:1347-1356): it runs the full row FFTs
//   and stores only the flat bins k = k2*n1 + k1 <= n/2 straight into
//   one-sided (b, n/2 + 1) planes. That set is the rows k2 < n2/2 plus the
//   Nyquist bin X[n/2] (k2 = n2/2, k1 = 0), which the block holding line
//   k1 = 0 has in shared memory, so no pass runs after the kernel. The
//   row stride n/2 + 1 is odd, so the stores stay scalar.
//
// The N-D FFT's axis kernels (col_fft, row_fft) are in axis_fft.cu, on
// the register radix line FFT of radix_line.cuh.
//
// Where trouble is likely, and what the design does about it:
// - Shared memory: a block holds two (m, T) float2 buffers (ping-pong),
//   16*m*T bytes. The host picks T (16 down to 1) so that this stays
//   <= 64 KB where it can (up to three blocks per SM): T = 4 at m = 1024,
//   T = 1 from m = 4096 (128 KB for one line of 8192). Everything above
//   48 KB needs cudaFuncAttributeMaxDynamicSharedMemorySize, raised once
//   per device before the first launch that needs it; every error is
//   returned to the caller.
// - Coalescing: stage 1 reads and stage 2 writes T consecutive floats per
//   row (64-byte segments at T = 16, 4-byte at T = 1 for n = 2^26).
//   Tiling the transposes through shared memory is later work.
// - Leaf cost: see line_fft.cuh; the dense leaves, not device memory,
//   limit the pair.
//
// bfloat16 I/O: stage1, stage1_real, stage2 and stage2_half also load and
// store bfloat16 planes, the counterparts of _build_ml's cdt='bfloat16' C
// (:490, :555) and of _build_phased's io='bfloat16' output and sdt C
// (:750, :1078), with bf16 input planes read as the Pallas kernels read
// any non-f32 block (:543-545, :835-838). Only the element type of the
// global loads and stores changes: a load widens to float32
// (__bfloat162float), a store rounds to nearest even (__float2bfloat16_rn,
// as torch's .to(torch.bfloat16) and XLA's convert do), and everything in
// shared memory and registers stays float32. stage2_half's Nyquist bin is
// computed in float32 like every other bin and rounded once, at its store
// (the f32 epilogue of :1277-1287). The instances are the I/O forms the
// routing uses (hopper_kernels._IO_FORMS): stage 1 loads f32 or bf16 and
// stores C in f32 or bf16, but never f32 -> bf16 (the `default` tier casts
// its input whenever its C is bf16); stage 2 takes all four.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "line_fft.cuh"

using kofft::kMaxDevices;
using kofft::LinePlan;
using kofft::prepare;

namespace {

// 512 threads: 256 measured slower at every shape (H100, 700 W); more
// registers per thread (3 blocks of 512 per SM) spilled and lost too
constexpr int kThreads = 512;

using bf16 = __nv_bfloat16;

// global element access: a load widens to float32, a store rounds to the
// nearest even bf16
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

// kReal: ar is one real plane (ai and sgn are not read). TIn, TOut:
// element types of the loaded planes and of the stored C (float or bf16)
template <bool kReal, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
stage1_kernel(const TIn* __restrict__ ar, const TIn* __restrict__ ai,
              TOut* __restrict__ cr, TOut* __restrict__ ci, int n1, int n2,
              int T, LinePlan plan, const float2* __restrict__ tab,
              const float* __restrict__ ebr, const float* __restrict__ ebi,
              const float* __restrict__ ecr, const float* __restrict__ eci,
              int tw_t, float sgn) {
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
    const int u = j2 - col * tw_t;
    const float wcr = ecr[k1 * ncol + col];
    const float wci = eci[k1 * ncol + col];
    const float wbr = ebr[k1 * tw_t + u];
    const float wbi = ebi[k1 * tw_t + u];
    const float2 w =
        make_float2(wcr * wbr - wci * wbi, wcr * wbi + wci * wbr);
    const float2 v = kofft::cmulf(y[idx], w);
    const long long g = static_cast<long long>(k1) * n2 + j2;
    st(c_r, g, v.x);
    st(c_i, g, v.y);
  }
}

// How stage2_kernel stores its lines: transposed into (b, n2, n1) (the
// 1-D spectrum), or only the one-sided bins into (b, n/2 + 1) (sgn is not
// read)
enum Store { kTransposed, kHalf };

template <int kStore, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
stage2_kernel(const TIn* __restrict__ cr, const TIn* __restrict__ ci,
              TOut* __restrict__ yr, TOut* __restrict__ yi, int n1, int n2,
              int T, LinePlan plan, const float2* __restrict__ tab,
              float sgn) {
  extern __shared__ float2 smem[];
  const int total = n2 * T;
  float2* buf0 = smem;
  float2* buf1 = smem + total;
  const int tiles = n1 / T;
  const long long row = blockIdx.x / tiles;
  const int k1_0 = (blockIdx.x - static_cast<int>(row) * tiles) * T;
  const long long base = row * n1 * static_cast<long long>(n2);
  const TIn* c_r = cr + base + static_cast<long long>(k1_0) * n2;
  const TIn* c_i = ci + base + static_cast<long long>(k1_0) * n2;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx / n2;
    const int j2 = idx - c * n2;
    const long long g = static_cast<long long>(c) * n2 + j2;
    buf0[j2 * T + c] = make_float2(ld(c_r, g), ld(c_i, g));
  }
  const float2* y = kofft::line_fft(buf0, buf1, total, plan, tab);
  if constexpr (kStore == kHalf) {
    // flat bins k = k2*n1 + k1 <= n/2: rows k2 < n2/2 and, from the
    // k1 = 0 line, the Nyquist bin
    const long long half = static_cast<long long>(n1) * (n2 / 2);
    TOut* o_r = yr + row * (half + 1);
    TOut* o_i = yi + row * (half + 1);
    const int stored = (n2 / 2 + 1) * T;
    for (int idx = threadIdx.x; idx < stored; idx += blockDim.x) {
      const int k2 = idx / T;
      const int c = idx - k2 * T;
      const long long g = static_cast<long long>(k2) * n1 + k1_0 + c;
      if (g <= half) {
        st(o_r, g, y[idx].x);
        st(o_i, g, y[idx].y);
      }
    }
  } else {
    TOut* o_r = yr + base;
    TOut* o_i = yi + base;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int k2 = idx / T;
      const int c = idx - k2 * T;
      const long long g = static_cast<long long>(k2) * n1 + k1_0 + c;
      st(o_r, g, y[idx].x);
      st(o_i, g, sgn * y[idx].y);
    }
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

// Each instance of a launcher keeps its own record of the dynamic shared
// memory already allowed per device (the attribute is per kernel function).
template <bool kReal, typename TIn = float, typename TOut = float>
int launch_stage1(const void* ar, const void* ai, void* cr, void* ci,
                  int b, int n1, int n2, int T, const int* steps, int nsteps,
                  const void* tab, const float* ebr, const float* ebi,
                  const float* ecr, const float* eci, int tw_t, int conj,
                  int device, void* stream) {
  LinePlan p;
  int r = fill_plan(&p, steps, nsteps);
  if (r != cudaSuccess) return r;
  if (T < 1 || n2 % T != 0 || n2 % tw_t != 0) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(2 * sizeof(float2) * n1 * T);
  static int allowed[kMaxDevices];
  const auto kernel = stage1_kernel<kReal, TIn, TOut>;
  r = prepare(reinterpret_cast<const void*>(kernel), allowed, device, smem);
  if (r != cudaSuccess) return r;
  const unsigned grid = static_cast<unsigned>(b) * (n2 / T);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(ar), static_cast<const TIn*>(ai),
      static_cast<TOut*>(cr), static_cast<TOut*>(ci), n1, n2, T, p,
      static_cast<const float2*>(tab), ebr, ebi, ecr, eci, tw_t,
      conj ? -1.f : 1.f);
  return cudaGetLastError();
}

template <int kStore, typename TIn = float, typename TOut = float>
int launch_stage2(const void* cr, const void* ci, void* yr, void* yi,
                  int b, int n1, int n2, int T, const int* steps, int nsteps,
                  const void* tab, int conj, int device, void* stream) {
  LinePlan p;
  int r = fill_plan(&p, steps, nsteps);
  if (r != cudaSuccess) return r;
  if (T < 1 || n1 % T != 0 || (kStore == kHalf && n2 % 2 != 0))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(2 * sizeof(float2) * n2 * T);
  static int allowed[kMaxDevices];
  const auto kernel = stage2_kernel<kStore, TIn, TOut>;
  r = prepare(reinterpret_cast<const void*>(kernel), allowed, device, smem);
  if (r != cudaSuccess) return r;
  const unsigned grid = static_cast<unsigned>(b) * (n1 / T);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(cr), static_cast<const TIn*>(ci),
      static_cast<TOut*>(yr), static_cast<TOut*>(yi), n1, n2, T, p,
      static_cast<const float2*>(tab), conj ? -1.f : 1.f);
  return cudaGetLastError();
}

// The launchers by I/O form: in_bf16 / out_bf16 select bf16 loaded planes
// and bf16 stored planes. Stage 1 has no f32 -> bf16 form.
template <bool kReal, typename... Args>
int stage1_forms(int in_bf16, int out_bf16, Args... a) {
  if (!in_bf16 && !out_bf16)
    return launch_stage1<kReal, float, float>(a...);
  if (in_bf16 && !out_bf16)
    return launch_stage1<kReal, bf16, float>(a...);
  if (in_bf16 && out_bf16) return launch_stage1<kReal, bf16, bf16>(a...);
  return cudaErrorInvalidValue;
}

template <int kStore, typename... Args>
int stage2_forms(int in_bf16, int out_bf16, Args... a) {
  if (!in_bf16 && !out_bf16) return launch_stage2<kStore, float, float>(a...);
  if (!in_bf16 && out_bf16) return launch_stage2<kStore, float, bf16>(a...);
  if (in_bf16 && out_bf16) return launch_stage2<kStore, bf16, bf16>(a...);
  return launch_stage2<kStore, bf16, float>(a...);
}

}  // namespace

extern "C" int kofft_stage1(const void* ar, const void* ai, void* cr,
                            void* ci, int b, int n1, int n2, int T,
                            const int* steps, int nsteps, const void* tab,
                            const float* ebr, const float* ebi,
                            const float* ecr, const float* eci, int tw_t,
                            int conj, int in_bf16, int out_bf16, int device,
                            void* stream) {
  return stage1_forms<false>(in_bf16, out_bf16, ar, ai, cr, ci, b, n1, n2, T,
                             steps, nsteps, tab, ebr, ebi, ecr, eci, tw_t,
                             conj, device, stream);
}

// ar: one real (b, n1, n2) plane
extern "C" int kofft_stage1_real(const void* ar, void* cr, void* ci, int b,
                                 int n1, int n2, int T, const int* steps,
                                 int nsteps, const void* tab,
                                 const float* ebr, const float* ebi,
                                 const float* ecr, const float* eci,
                                 int tw_t, int in_bf16, int out_bf16,
                                 int device, void* stream) {
  return stage1_forms<true>(in_bf16, out_bf16, ar, nullptr, cr, ci, b, n1,
                            n2, T, steps, nsteps, tab, ebr, ebi, ecr, eci,
                            tw_t, 0, device, stream);
}

extern "C" int kofft_stage2(const void* cr, const void* ci, void* yr,
                            void* yi, int b, int n1, int n2, int T,
                            const int* steps, int nsteps, const void* tab,
                            int conj, int in_bf16, int out_bf16, int device,
                            void* stream) {
  return stage2_forms<kTransposed>(in_bf16, out_bf16, cr, ci, yr, yi, b, n1,
                                   n2, T, steps, nsteps, tab, conj, device,
                                   stream);
}

// yr, yi: one-sided (b, n1*n2/2 + 1) planes
extern "C" int kofft_stage2_half(const void* cr, const void* ci, void* yr,
                                 void* yi, int b, int n1, int n2, int T,
                                 const int* steps, int nsteps,
                                 const void* tab, int in_bf16, int out_bf16,
                                 int device, void* stream) {
  return stage2_forms<kHalf>(in_bf16, out_bf16, cr, ci, yr, yi, b, n1, n2,
                             T, steps, nsteps, tab, 0, device, stream);
}
