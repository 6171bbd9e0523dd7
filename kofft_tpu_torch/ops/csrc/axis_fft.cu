// The N-D FFT's axis kernels on the register radix line FFT
// (radix_line.cuh), with a plain C interface bound by ctypes
// (kofft_tpu_torch/ops/_cuda_build.py). Every axis of an N-D grid is the
// (prod(d[:a]), d[a], prod(d[a+1:])) view of the contiguous planes, so two
// kernels serve every pass, with no twiddle between passes:
//
// - row_fft_kernel: line FFTs along the last axis of (lines, m) planes,
//   stored in natural order. It replaces sb_kern of _build_fft2_big
//   (kofft_tpu/ops/pallas_kernels.py:1708 -> :1727), phase 2 of the
//   one-call 2-D kernel (_build_fft2 kern, :1617-1639 -> :1653) and the
//   last-axis pass of the fused all-axes kernel (_build_fused_nd kern,
//   :1415 -> :1435). A block holds T whole lines (T*m/E threads, 256 where
//   the tile allows). The first pass loads straight from device memory
//   into registers and the last pass stores straight from registers: a
//   warp instruction covers 32-float runs of one row from lines of 512, or
//   tpl consecutive floats of each of 32/tpl rows (32-byte runs from lines
//   of 128). The inverse conjugates on store.
// - col_fft_kernel: line FFTs along axis 1 of (b, m, inner) planes, stored
//   in the input layout. It replaces sa_kern of _build_fft2_big (:1701 ->
//   :1720), phase 1 of the one-call 2-D kernel (:1597-1615) and the passes
//   of the fused kernel over axes 0 ... d-2. A block holds an (m, T) tile
//   of T >= 8 consecutive columns, the column fastest across the threads,
//   so every row access covers >= 32 bytes. The inverse conjugates on load.
//   Lines up to 2048. Its fused twiddle and digit-swapped store (tw,
//   tw_div, swap) are those of a column four-step over this kernel, which
//   nothing launches: col_fft passes none, and longer lines take
//   col_cluster_kernel.
// - col_cluster_kernel: col_fft on lines of 4096 and 8192 in one launch.
//   An (m, 8) tile of such lines needs 256 KB or more, over a block's
//   227 KB, so a thread-block cluster of C = 16 CTAs holds an (m, T = 16)
//   tile, by one decimation in time across the cluster: CTA r loads rows
//   r + 16 j (64-byte runs), runs their line FFT of m / 16 points (256 or
//   512: one or two exchanges in its own buffer), multiplies point k by
//   w_m^(r k), sends it to CTA k mod 16 through distributed shared memory
//   and, after the cluster barrier, runs the radix-16 DFTs of the points
//   it received and stores them to the rows it loaded. It replaces the
//   column four-step of two launches of col_fft_kernel (lines of m1 with
//   the twiddle w_m^(k1*j2) fused into the store, then lines of m2 stored
//   digit-swapped: two full reads and writes of the planes and an
//   intermediate pair): in CUDA graphs on one H100, (1, 4096, 4096) 146 us
//   against the four-step's 208 (row_fft: 103), (1, 8192, 8192) 710
//   against 820 (row_fft: 475). Measured and not kept (PERF.md section
//   6): clusters of 2, 4 and 8 CTAs and tiles of 8 or 32 columns (170-250
//   us at 4096), two CTAs of four columns each (241 us), and CTAs that
//   each receive a contiguous slice of k (203 us at C = 8, T = 8): storing
//   rows in another order than the CTA loaded them cost 41 us of it.
//
// What bounds them: bytes. Each pass must read and write 16 bytes per
// point (two float32 planes), 10.02 us at 3.35 TB/s for 2^21 points; an
// FFT's 5 m log2 m flop per line is under a fifth of that time at 67
// TFLOP/s for every line length served. What the design does about the
// three causes that held the dense-leaf instances (fft_stages.cu) at 8-16 %
// of that bound:
// 1. Leaf work: radix butterflies in registers, ~30-45 floating-point
//    instructions per point for lines of 128 ... 8192 where the dense
//    leaves took 128-192 complex MACs (retired); one exchange through
//    shared memory per pass boundary instead of a ping-pong round trip and
//    table reads per step.
// 2. Bank conflicts: the exchange buffer is swizzled per exchange so that
//    every warp-wide shared-memory access is one wavefront (the old
//    row_fft read its (m, T) buffer at a 128-byte stride at T = 16).
// 3. Uncoalesced columns: col_fft's tiles keep T >= 8 columns at every
//    line length (the old instance fell to T = 1, 4-byte row accesses,
//    from lines of 4096), on a cluster above 2048.
//
// Shared memory is one (re, im) buffer of T*m floats each: 32 KB for the
// 256-thread tiles and the cluster's (256, 16) CTAs at 4096, 64 KB for
// col_fft's (1024, 8), the cluster's (512, 16) at 8192 and row_fft's
// (8192, 1), 128 KB for col_fft's (2048, 8); none for lines of 16 or
// fewer. Above 48 KB it needs cudaFuncAttributeMaxDynamicSharedMemorySize,
// raised once per device and kernel instance; a cluster launch first
// checks that the cluster fits (cudaOccupancyMaxActiveClusters > 0). Every
// error is returned to the caller.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "radix_line.cuh"

namespace cg = cooperative_groups;

using kofft::kMaxDevices;
using kofft::prepare;
using kofft::radix::ArriveAfterLastExchange;
using kofft::radix::cluster_addr;
using kofft::radix::cmul;
using kofft::radix::fill_plan;
using kofft::radix::RadixPlan;
using kofft::radix::st_cluster;

namespace {

// 1024 threads for col_fft's (2048, 8) tile; it caps every instance at
// 64 registers, which the E = 16 instances use
constexpr int kMaxThreads = 1024;

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
row_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, int lines,
               int m, int T, RadixPlan plan, const float2* __restrict__ tab,
               float sgn) {
  extern __shared__ float smem[];
  const int tpl = m / E;
  const int c = threadIdx.x / tpl;
  const int ti = threadIdx.x - c * tpl;
  const int line = blockIdx.x * T + c;
  const bool live = line < lines;
  const long long g = static_cast<long long>(line) * m + ti;
  float2 v[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    v[s] = live ? make_float2(xr[g + s * tpl], xi[g + s * tpl])
                : make_float2(0.f, 0.f);
  }
  kofft::radix::line_fft<E>(v, ti, tpl, plan, tab, smem, smem + T * m,
                            c * m, 1);
  if (live) {
#pragma unroll
    for (int s = 0; s < E; ++s) {
      yr[g + s * tpl] = v[s].x;
      yi[g + s * tpl] = sgn * v[s].y;
    }
  }
}

// tw != nullptr: multiply point k of column col by tw[k*(inner/tw_div) +
// col/tw_div] on store (the first launch of the column four-step). swap:
// row `row` of the (rows, m, inner) view stores point k to row
// k*swap + row % swap of block row / swap (1: the input layout).
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
col_fft_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
               float* __restrict__ yr, float* __restrict__ yi, int m,
               int inner, int T, RadixPlan plan,
               const float2* __restrict__ tab, float sgn,
               const float2* __restrict__ tw, int tw_div, int swap) {
  extern __shared__ float smem[];
  const int tiles = (inner + T - 1) / T;
  const int row = blockIdx.x / tiles;
  const int c = threadIdx.x % T;
  const int ti = threadIdx.x / T;
  const int col = (blockIdx.x - row * tiles) * T + c;
  const bool live = col < inner;
  const int tpl = m / E;
  const long long step = static_cast<long long>(tpl) * inner;
  const long long g =
      static_cast<long long>(row) * m * inner +
      static_cast<long long>(ti) * inner + col;
  float2 v[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    v[s] = live ? make_float2(ar[g + s * step], sgn * ai[g + s * step])
                : make_float2(0.f, 0.f);
  }
  kofft::radix::line_fft<E>(v, ti, tpl, plan, tab, smem, smem + T * m, c,
                            T);
  if (!live) return;
  const long long o =
      static_cast<long long>(row / swap) * swap * m * inner +
      static_cast<long long>(row % swap) * inner +
      static_cast<long long>(ti) * swap * inner + col;
  const long long ostep = step * swap;
  const int j2 = col / tw_div;
  const int tw_cols = inner / tw_div;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    float2 y = v[s];
    if (tw != nullptr) {
      y = kofft::radix::cmul(
          y, __ldg(tw + static_cast<long long>(ti + s * tpl) * tw_cols + j2));
    }
    yr[o + s * ostep] = y.x;
    yi[o + s * ostep] = y.y;
  }
}

// col_fft on lines of m = C * M points, one (m, T) column tile per cluster
// of C CTAs (1-D, so blockIdx.x % C is the CTA's rank r in it), by one
// decimation in time across the cluster: CTA r loads rows r + C * j of
// the tile and runs their M-point line FFT Y_r (the plan of lines of M),
// multiplies Y_r[k] by w_m^(r * k) (ctw, the (C, M) table) and sends it to
// CTA k mod C; then CTA q holds Z_r[k] for its k = q + C * j' and every
// r, runs the radix-C DFTs X[k + M * s] = sum_r Z_r[k] w_C^(r * s) and
// stores rows k + M * s = q + C * (j' + s * M / C): the rows it loaded.
// Thread ti of a column holds k = ti + i * tpl, and tpl is a multiple of
// C, so all its points go to CTA ti mod C, to local k' = k / C: word
// (r * slice + k') * T + c (slice = M / C), each warp store T-word runs
// to 32 / T CTAs.
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
col_cluster_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   float* __restrict__ yr, float* __restrict__ yi, int m,
                   int inner, int T, RadixPlan plan,
                   const float2* __restrict__ tab, float sgn,
                   const float2* __restrict__ ctw) {
  constexpr int E = 16;
  // radix-C butterflies a thread runs after the exchange
  constexpr int P = E / C;
  extern __shared__ float smem[];
  const int M = m / C;
  float* sre = smem;
  float* sim = smem + T * M;
  const int rank = static_cast<int>(blockIdx.x % C);
  const int tile = static_cast<int>(blockIdx.x / C);
  const int tiles = (inner + T - 1) / T;
  const int row = tile / tiles;
  const int c = threadIdx.x % T;
  const int ti = threadIdx.x / T;
  const int col = (tile - row * tiles) * T + c;
  const bool live = col < inner;
  const int tpl = M / E;
  const int slice = M / C;
  // point i of the thread, and after the exchange output s of butterfly
  // p: row rank + C * (ti + i * tpl), and rank + C * (ti + p * tpl) +
  // s * M
  const long long g = static_cast<long long>(row) * m * inner + col +
                      static_cast<long long>(rank + C * ti) * inner;
  const long long step = static_cast<long long>(C) * tpl * inner;
  float2 v[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    v[i] = live ? make_float2(ar[g + i * step], sgn * ai[g + i * step])
                : make_float2(0.f, 0.f);
  }
  // every line of M >= 256 points has >= 2 passes, so one exchange at
  // least before the arrival
  kofft::radix::line_fft<E>(v, ti, tpl, plan, tab, sre, sim, c, T,
                            ArriveAfterLastExchange{2 * plan.npass - 2});
  const float2* w = ctw + static_cast<long long>(rank) * M + ti;
  const unsigned a0 = cluster_addr(
      static_cast<unsigned>(__cvta_generic_to_shared(sre)) +
          4u * ((rank * slice + ti / C) * T + c),
      ti % C);
  const unsigned im = 4u * T * M;  // from a word of sre to sim's
  const unsigned kstep = 4u * (tpl / C) * T;
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float2 y = v[i];
    if (rank > 0) y = cmul(y, __ldg(w + i * tpl));
    st_cluster(a0 + i * kstep, y.x);
    st_cluster(a0 + i * kstep + im, y.y);
  }
  // no CTA touches another's buffer after this, so each may exit
  cg::this_cluster().sync();
  if (!live) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = ti + p * tpl;
    float2 u[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int a = (r * slice + j) * T + c;
      u[r] = make_float2(sre[a], sim[a]);
    }
    kofft::radix::dft<C>(u);
    const long long o = g + static_cast<long long>(p) * step;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      yr[o + static_cast<long long>(s) * M * inner] = u[s].x;
      yi[o + static_cast<long long>(s) * M * inner] = u[s].y;
    }
  }
}

// The block shape the plan implies; returns 0 if it is not one the
// kernels take
int block_threads(int m, int T, int E) {
  if (T < 1 || E < 1 || m % E != 0 || T > kMaxThreads) return 0;
  const long long n = static_cast<long long>(T) * (m / E);
  return n <= kMaxThreads ? static_cast<int>(n) : 0;
}

int smem_bytes(const RadixPlan& p, int m, int T) {
  return p.npass > 1 ? static_cast<int>(2 * sizeof(float) * m * T) : 0;
}

// Each instance keeps its own record of the dynamic shared memory already
// allowed per device (the attribute is per kernel function).
template <int E>
int launch_row(const float* xr, const float* xi, float* yr, float* yi,
               int lines, int m, int T, const RadixPlan& p, const void* tab,
               int conj, int device, void* stream) {
  const int threads = block_threads(m, T, E);
  if (threads == 0 || lines < 1) return cudaErrorInvalidValue;
  const int smem = smem_bytes(p, m, T);
  static int allowed[kMaxDevices];
  const auto kernel = row_fft_kernel<E>;
  int r = prepare(reinterpret_cast<const void*>(kernel), allowed, device,
                  smem);
  if (r != cudaSuccess) return r;
  const unsigned grid = static_cast<unsigned>((lines + T - 1) / T);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, lines, m, T, p, static_cast<const float2*>(tab),
      conj ? -1.f : 1.f);
  return cudaGetLastError();
}

template <int E>
int launch_col(const float* ar, const float* ai, float* yr, float* yi,
               int b, int m, int inner, int T, const RadixPlan& p,
               const void* tab, int conj, const void* tw, int tw_div,
               int swap, int device, void* stream) {
  const int threads = block_threads(m, T, E);
  if (threads == 0 || b < 1 || inner < 1 || swap < 1 || b % swap != 0 ||
      (tw != nullptr && (tw_div < 1 || inner % tw_div != 0))) {
    return cudaErrorInvalidValue;
  }
  const long long grid =
      static_cast<long long>(b) * ((inner + T - 1) / T);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = smem_bytes(p, m, T);
  static int allowed[kMaxDevices];
  const auto kernel = col_fft_kernel<E>;
  int r = prepare(reinterpret_cast<const void*>(kernel), allowed, device,
                  smem);
  if (r != cudaSuccess) return r;
  kernel<<<static_cast<unsigned>(grid), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      ar, ai, yr, yi, m, inner, T, p, static_cast<const float2*>(tab),
      conj ? -1.f : 1.f, static_cast<const float2*>(tw),
      tw == nullptr ? 1 : tw_div, swap);
  return cudaGetLastError();
}

template <int C>
int launch_col_cluster(const float* ar, const float* ai, float* yr,
                       float* yi, int b, int m, int inner, int T,
                       const RadixPlan& p, const void* tab, int conj,
                       const void* ctw, int device, void* stream) {
  const int mc = m / C;
  const int threads = block_threads(mc, T, 16);
  // every point of a thread goes to one CTA: tpl = mc / 16 is a multiple
  // of C
  if (threads == 0 || m % C != 0 || (mc / 16) % C != 0 || p.npass < 2 ||
      b < 1 || inner < 1 || ctw == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long grid =
      static_cast<long long>(b) * ((inner + T - 1) / T) * C;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = smem_bytes(p, mc, T);
  static int allowed[kMaxDevices];
  // bit C: a cluster of C CTAs was checked to fit, per device
  static int fits[kMaxDevices];
  const auto kernel = col_cluster_kernel<C>;
  const int r = prepare(reinterpret_cast<const void*>(kernel), allowed,
                        device, smem);
  if (r != cudaSuccess) return r;
  return kofft::launch_cluster(kernel, fits, device, grid, threads, smem,
                               stream, C, ar, ai, yr, yi, m, inner, T, p,
                               static_cast<const float2*>(tab),
                               conj ? -1.f : 1.f,
                               static_cast<const float2*>(ctw));
}

}  // namespace

// (lines, m) planes -> (lines, m): line FFTs of length m along the last
// axis in natural order; conj negates the imaginary part on store. T lines
// per block, E points per thread, steps / npass / tab from
// hopper_kernels._axis_plan.
extern "C" int kofft_row_fft(const float* xr, const float* xi, float* yr,
                             float* yi, int lines, int m, int T, int E,
                             const int* steps, int npass, const void* tab,
                             int conj, int device, void* stream) {
  RadixPlan p;
  const int r = fill_plan(&p, steps, npass, m, E);
  if (r != cudaSuccess) return r;
  switch (E) {
    case 2: return launch_row<2>(xr, xi, yr, yi, lines, m, T, p, tab, conj,
                                 device, stream);
    case 4: return launch_row<4>(xr, xi, yr, yi, lines, m, T, p, tab, conj,
                                 device, stream);
    case 8: return launch_row<8>(xr, xi, yr, yi, lines, m, T, p, tab, conj,
                                 device, stream);
    case 16: return launch_row<16>(xr, xi, yr, yi, lines, m, T, p, tab,
                                   conj, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// (b, m, inner) planes -> line FFTs of length m along axis 1; conj negates
// the imaginary part on load. tw (nullable), tw_div and swap: the column
// four-step's fused twiddle and digit-swapped store (see col_fft_kernel);
// tw = nullptr and swap = 1 store in the input layout.
extern "C" int kofft_col_fft(const float* ar, const float* ai, float* yr,
                             float* yi, int b, int m, int inner, int T,
                             int E, const int* steps, int npass,
                             const void* tab, int conj, const void* tw,
                             int tw_div, int swap, int device,
                             void* stream) {
  RadixPlan p;
  const int r = fill_plan(&p, steps, npass, m, E);
  if (r != cudaSuccess) return r;
  switch (E) {
    case 2: return launch_col<2>(ar, ai, yr, yi, b, m, inner, T, p, tab,
                                 conj, tw, tw_div, swap, device, stream);
    case 4: return launch_col<4>(ar, ai, yr, yi, b, m, inner, T, p, tab,
                                 conj, tw, tw_div, swap, device, stream);
    case 8: return launch_col<8>(ar, ai, yr, yi, b, m, inner, T, p, tab,
                                 conj, tw, tw_div, swap, device, stream);
    case 16: return launch_col<16>(ar, ai, yr, yi, b, m, inner, T, p, tab,
                                   conj, tw, tw_div, swap, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// (b, m, inner) planes -> line FFTs of length m along axis 1 in one
// launch of col_cluster_kernel<16> (csize = 16 CTAs per cluster, the one
// instance built); conj negates the imaginary part on load. T columns per
// tile; steps / npass / tab the plan of lines of m / 16 and ctw the (16,
// m / 16) twiddle w_m^(r * k), from hopper_kernels._static_args.
extern "C" int kofft_col_cluster(const float* ar, const float* ai,
                                 float* yr, float* yi, int b, int m,
                                 int inner, int T, int csize,
                                 const int* steps, int npass,
                                 const void* tab, int conj, const void* ctw,
                                 int device, void* stream) {
  if (csize != 16 || m % csize != 0) return cudaErrorInvalidValue;
  RadixPlan p;
  const int r = fill_plan(&p, steps, npass, m / csize, 16);
  if (r != cudaSuccess) return r;
  return launch_col_cluster<16>(ar, ai, yr, yi, b, m, inner, T, p, tab, conj,
                                ctw, device, stream);
}
