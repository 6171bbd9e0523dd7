// The one-sided STFT of real float32 signals in one pass: framing, window,
// real line FFT and the one-sided store, for power-of-two windows of 64 ...
// 2048 points, on the register radix line FFT (radix_line.cuh), with a
// plain C interface bound by ctypes (kofft_tpu_torch/ops/_cuda_build.py).
// It computes ops/stft.py's one-sided frames: F = ceil(N / hop) frames
// (or the caller's nf), frame f starting at f*hop and zero-padded past the
// signal's end, times the window, bins 0 ... win/2 of its DFT in two
// float32 planes (..., F, win/2 + 1).
//
// It replaces no TPU kernel: the JAX package builds the frame matrix,
// multiplies it by the window and hands it to XLA's engines
// (kofft_tpu/ops/stft.py). The port did the same on the plain factor tree
// (cuBLAS products, twiddle products, transposes): 24 device kernels and
// about 1 GB of device-memory traffic for 8 clips of 2^20 samples at
// hann(1024), hop 256, where the function needs 168 MB.
//
// What bounds it: bytes. Each sample is read once and each one-sided bin
// written once, 4 * (b*N + 2*F*(win/2 + 1)) bytes: 50.2 us at 3.35 TB/s for
// that shape, where its 2.5 win log2 win operations per frame take 12.5 us
// at 67 TFLOP/s. The output is 80 % of the bytes. So nothing goes through
// device memory but the signal and the spectra, and the stores run straight
// from registers in contiguous runs.
//
// A block takes a tile of T consecutive frames f0 ... f0+T-1 of one signal
// row, m = win/2 complex points per frame and tpl = m/16 threads per frame
// (T = 128/tpl: 4 frames at win 1024, one warp each):
// 1. It loads the window and the tile's samples into shared memory once:
//    with hop < win the span [f0*hop, (f0+T-1)*hop + win), in 16-byte loads
//    where the span starts 16-byte aligned; with hop >= win each frame's win
//    samples; zeros past the signal's end. No frame matrix exists; adjacent
//    tiles share win - hop samples, which L2 holds.
// 2. Each thread packs E = 16 window-weighted points of its frame,
//    z[j] = x[2j] w[2j] + i x[2j+1] w[2j+1], j = ti + s*tpl.
// 3. The m-point line FFT Z of radix_line.cuh (the host's plan of
//    hopper_kernels._axis_plan("row", m, T, 16)) in registers, the samples'
//    buffer reused as its exchange.
// 4. The split pass. With A = Z[k], B = Z[m-k] (Z[m] = Z[0]),
//    E = (A + B*)/2, O = (A - B*)/2, P = w^k O, w = exp(-2 pi i / win):
//      X[k] = E - i P  and  X[m-k] = (E + i P)*,  k = 0 ... m/2 - 1,
//    and X[m/2] = Z[m/2]*. The thread holding Z[k] for k = ti + s*tpl,
//    s < E/2, computes both bins of the pair; the upper half of Z crosses
//    shared memory once, each line at a stride S (hopper_kernels.
//    _frames_tile) that puts every warp-wide write and read in one
//    wavefront. w^k comes from a float2 table built on the host in float64
//    and rounded once to float32.
// 5. The stores: a frame's bins are contiguous, so the threads of a line
//    write consecutive floats (a warp writes 128-byte runs from windows of
//    1024), with streaming stores, since nothing reads the spectra again.
//
// Shared memory: the window (win floats), then one region of 2 * T *
// max(m, S) floats that holds the samples (at most T * win), the exchange
// (T*m per plane) and the half lines (T*S per plane) in turn: 17-24 KB.
// Blocks of 128 threads, eight per SM (64 registers a thread): a block
// loads, computes and stores in turn, and small blocks keep the SM's
// blocks in different phases, so that loads, arithmetic and stores
// overlap. At hann(1024), hop 256 on (8, 2^20) the block of 128 threads
// took 98.3 us a call where 256 took 107.0 and 512 131.4 (CUDA graphs, one
// H100 80GB HBM3 at 700 W).
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "radix_line.cuh"

using kofft::kMaxDevices;
using kofft::prepare;
using kofft::radix::fill_plan;
using kofft::radix::RadixPlan;

namespace {

constexpr int kE = 16;         // points per thread
constexpr int kThreads = 128;  // threads per block, T * m / kE
constexpr int kMinWin = 64;    // m >= 32: the line has two passes
constexpr int kMaxWin = 2048;

// eight blocks per SM at 64 registers a thread
__global__ void __launch_bounds__(kThreads, 8)
stft_frames_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ yr, float* __restrict__ yi,
                   long long n, int nf, long long hop, int win, int T,
                   int S, RadixPlan plan, const float2* __restrict__ tab,
                   const float2* __restrict__ stw) {
  extern __shared__ __align__(16) float smem[];
  float* const swin = smem;
  float* const work = smem + win;
  const int m = win >> 1;
  const int h = m >> 1;
  const int tpl = m / kE;
  const int tiles = (nf + T - 1) / T;
  const int row = blockIdx.x / tiles;
  const int f0 = (blockIdx.x - row * tiles) * T;
  const int c = threadIdx.x / tpl;
  const int ti = threadIdx.x - c * tpl;
  const float* __restrict__ src = x + static_cast<long long>(row) * n;

  // 1. the window and the tile's samples
  for (int i = threadIdx.x; i < win; i += kThreads) swin[i] = __ldg(w + i);
  const int hstep = static_cast<int>(hop < win ? hop : win);
  if (hop < win) {
    const long long g0 = f0 * hop;
    const int span = (T - 1) * hstep + win;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src + g0) & 15) == 0) {
      const int quads = span >> 2;
      for (int q = threadIdx.x; q < quads; q += kThreads) {
        const long long g = g0 + 4LL * q;
        float4 v;
        if (g + 3 < n) {
          v = __ldg(reinterpret_cast<const float4*>(src + g));
        } else {
          v = make_float4(g < n ? __ldg(src + g) : 0.f,
                          g + 1 < n ? __ldg(src + g + 1) : 0.f,
                          g + 2 < n ? __ldg(src + g + 2) : 0.f, 0.f);
        }
        reinterpret_cast<float4*>(work)[q] = v;
      }
      done = quads << 2;
    }
    for (int i = done + threadIdx.x; i < span; i += kThreads) {
      const long long g = g0 + i;
      work[i] = g < n ? __ldg(src + g) : 0.f;
    }
  } else {
    const int lw = __ffs(win) - 1;
    for (int i = threadIdx.x; i < T * win; i += kThreads) {
      const long long g = (f0 + (i >> lw)) * hop + (i & (win - 1));
      work[i] = g < n ? __ldg(src + g) : 0.f;
    }
  }
  __syncthreads();

  // 2. the frame's window-weighted samples as m complex points
  float2 v[kE];
  const float* const fr = work + c * hstep;
  if ((hstep & 1) == 0) {
    const float2* const f2 = reinterpret_cast<const float2*>(fr);
    const float2* const w2 = reinterpret_cast<const float2*>(swin);
#pragma unroll
    for (int s = 0; s < kE; ++s) {
      const int j = ti + s * tpl;
      const float2 a = f2[j];
      const float2 b = w2[j];
      v[s] = make_float2(a.x * b.x, a.y * b.y);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kE; ++s) {
      const int j = 2 * (ti + s * tpl);
      v[s] = make_float2(fr[j] * swin[j], fr[j + 1] * swin[j + 1]);
    }
  }
  __syncthreads();  // the exchange below overwrites the samples

  // 3. the m-point line FFT, natural order in registers
  kofft::radix::line_fft<kE>(v, ti, tpl, plan, tab, work, work + T * m,
                             c * m, 1);

  // 4. the upper half of Z through shared memory: point k >= m/2 of line
  // c at word c*S + k - m/2 (line_fft ends on a barrier after its last
  // exchange, so the buffer is free)
  float* const hre = work;
  float* const him = work + T * S;
#pragma unroll
  for (int s = kE / 2; s < kE; ++s) {
    const int a = c * S + ti + (s - kE / 2) * tpl;
    hre[a] = v[s].x;
    him[a] = v[s].y;
  }
  __syncthreads();
  const int f = f0 + c;
  if (f >= nf) return;

  // 5. the pairs (k, m-k) and the bin m/2, stored straight to the planes
  const long long o = (static_cast<long long>(row) * nf + f) * (m + 1);
  float* const ore = yr + o;
  float* const oim = yi + o;
#pragma unroll
  for (int s = 0; s < kE / 2; ++s) {
    const int k = ti + s * tpl;
    const float2 A = v[s];
    float2 B = A;  // k = 0: Z[m] = Z[0]
    if (k != 0) {
      const int a = c * S + h - k;
      B = make_float2(hre[a], him[a]);
    }
    const float2 wk = __ldg(stw + k);
    const float er = 0.5f * (A.x + B.x);
    const float ei = 0.5f * (A.y - B.y);
    const float od = 0.5f * (A.x - B.x);
    const float oi = 0.5f * (A.y + B.y);
    const float pr = wk.x * od - wk.y * oi;
    const float pim = wk.x * oi + wk.y * od;
    __stcs(ore + k, er + pim);
    __stcs(oim + k, ei - pr);
    __stcs(ore + (m - k), er - pim);
    __stcs(oim + (m - k), -(ei + pr));
  }
  if (ti == 0) {
    __stcs(ore + h, v[kE / 2].x);
    __stcs(oim + h, -v[kE / 2].y);
  }
}

}  // namespace

// real (rows, n) float32 signals -> one-sided frame spectra in y: the real
// plane (rows, nf, win/2 + 1), then the imaginary plane; frame f of row r
// is x[r, f*hop : f*hop + win] zero-padded past n, times w. plan points to
// the int64 words (win, T, S, steps, npass, tab, split_tw, device) of
// hopper_kernels._frames_args: T frames per block and the split pass's
// stride S (hopper_kernels._frames_tile); steps / npass / tab the m-point
// line's plan (hopper_kernels._axis_plan("row", win/2, T, 16)); split_tw
// the float2 table w^k, k < win/4 (hopper_kernels._frames_twiddle).
extern "C" int kofft_stft_frames(const float* x, const float* w, float* y,
                                 int rows, long long n, int nf, long long hop,
                                 const long long* plan, void* stream) {
  const int win = static_cast<int>(plan[0]);
  const int T = static_cast<int>(plan[1]);
  const int S = static_cast<int>(plan[2]);
  const int npass = static_cast<int>(plan[4]);
  const int device = static_cast<int>(plan[7]);
  if (win < kMinWin || win > kMaxWin || (win & (win - 1)) != 0 ||
      rows < 1 || n < 1 || nf < 1 || hop < 1 ||
      T * (win / 2 / kE) != kThreads || S < win / 4) {
    return cudaErrorInvalidValue;
  }
  RadixPlan p;
  int r = fill_plan(&p, reinterpret_cast<const int*>(plan[3]), npass,
                    win / 2, kE);
  if (r != cudaSuccess) return r;
  const long long grid = static_cast<long long>(rows) * ((nf + T - 1) / T);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the window, then one region of 2 * T * max(m, S) floats
  const int m = win / 2;
  const int smem = static_cast<int>(sizeof(float) *
                                    (win + 2LL * T * (m > S ? m : S)));
  static int allowed[kMaxDevices];
  r = prepare(reinterpret_cast<const void*>(stft_frames_kernel), allowed,
              device, smem);
  if (r != cudaSuccess) return r;
  float* const yr = y;
  float* const yi = y + static_cast<long long>(rows) * nf * (m + 1);
  stft_frames_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w, yr, yi, n, nf, hop, win, T, S, p,
      reinterpret_cast<const float2*>(plan[5]),
      reinterpret_cast<const float2*>(plan[6]));
  return cudaGetLastError();
}
