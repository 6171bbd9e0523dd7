// Stage 1 of the four-step FFT for a smooth first factor n1 = m = o * q
// (odd o = 3 ... 23, q = 2^a = 128 ... 1024, m <= 3072: 3*2^18 splits as
// 768 x 1024, 9*2^14 as 1152 x 128, 23*2^14 as 2944 x 128), on the
// register radix line of radix_line.cuh with its odd pass last. It
// computes what stage1_kernel (fft_stages.cu) computes for a power-of-two
// n1, and what s1_kernel, s1r_kernel (kofft_tpu/ops/pallas_kernels.py:547,
// :558, called at :613, :630) and phase 1 of the phased kernel (:847 ->
// :1104) compute: the DFT of length n1 along axis 1 of the (b, n1, n2)
// input, times W[k1, j2] = col[k1, j2 / t] * base[k1, j2 mod t] (the
// float2 factor tables of hopper_kernels._stage1_twiddle), stored as C.
// kofft_stage1 (fft_stages.cu) launches it when the plan's last radix is
// odd; the wrapper counts it under the stage-1 form names.
//
// A block holds the (m, T) column tile of T = 8 consecutive columns j2
// (the column fastest across the threads, so every row access covers 32
// bytes) in one shared-memory buffer (re and im planes, 8*m*T bytes: 192
// KB at m = 3072), seen as o sub-tiles of (q, T).
// 1. The power-of-two passes. Points x[i + o*l] of a column form the
//    sub-line i (l = 0 ... q-1). The block's threads form P groups of
//    T*q/16 threads (warp multiples); group g runs the sub-lines i = g,
//    g + P, ... < o in turn, each as stage1_kernel runs a line of q:
//    thread (c, ti) loads points l = ti + s*q/16 of sub-line i of column
//    c straight from device memory (rows i + o*l: 32-byte runs), the
//    radix passes exchange through sub-tile i under the same swizzles,
//    and the natural-order result times the odd pass's twiddle,
//    Y_i[k'] * w_m^(i*k') (the plan's (q, o-1) table), goes to word
//    k'*T + c of sub-tile i. A group waits only for its own threads
//    (named barrier g + 1), so groups with different numbers of
//    sub-lines never stall one another; P <= 15 (barrier 0 is the
//    block's).
// 2. The odd pass, after one block barrier: the q*T butterflies
//    bi = k'*T + c go to the threads in turn; each reads word bi of every
//    sub-tile (a warp: 32 consecutive words, one wavefront) and runs
//    dft_odd<o>. For o <= 15 each output X[k' + q*r] goes straight to
//    row k1 = k' + q*r of C times W[k1, j2] (two float2 table loads): a
//    warp stores 32 / T rows of T consecutive columns.
// 3. For o >= 17 the butterfly instead writes X[k' + q*r] back to word
//    bi of sub-tile r, that is word (k' + q*r)*T + c (C's rows in natural
//    order), and after one more barrier a store pass gives thread t the
//    column t mod T and the rows t / T, t / T + threads / T, ..., each
//    word times W (the same runs). The butterfly of o >= 17 holds 2*(o-1)
//    floats of pair sums, and with W's loads in it too ptxas spilled
//    hundreds of bytes per thread; for o <= 15 the extra pass and
//    barrier cost more than they saved. Both were timed on the card
//    (PERF.md).
// Why two thread maps: the power-of-two passes need E = 16 points per
// thread, and the odd pass o of them; E = o * 16 points (48 at o = 3,
// 368 at o = 23) would not fit the 80 registers a 768-thread block
// allows. The exchange before the odd pass goes through shared memory
// anyway, so the odd pass reads with its own map. Why sub-lines in
// groups: T*m/16 threads (one map over the whole line) would need 1088
// ... 1536 threads above 2048 points; P = ceil(o / rounds) groups in
// the fewest rounds that keep the block at <= 768 threads
// (hopper_kernels._odd_tile) take any m <= 3072 in one block.
//
// The inverse conjugates on load; the real form reads one real plane
// and sets the imaginary part to zero in registers; bfloat16 planes load
// and store through elem_io.cuh (the forms of hopper_kernels._IO_FORMS).
// The real form is the complex instance with ai = nullptr (a uniform
// branch per load), so this file holds 11 radices x 3 I/O forms, built by
// their own nvcc process beside fft_stages.cu's power-of-two instances.
#include <cuda_runtime.h>

#include "elem_io.cuh"
#include "launch.cuh"
#include "radix_line.cuh"

using kofft::bf16;
using kofft::kMaxDevices;
using kofft::ld;
using kofft::prepare;
using kofft::st;
using kofft::radix::cmul;
using kofft::radix::dft_odd;
using kofft::radix::RadixPlan;

namespace {

constexpr int kE = 16;
// 768 threads give each 80 registers; at 1024 (64 registers) every
// instance spilled more and all but the (3072, 8) tile ran slower
// (PERF.md)
constexpr int kMaxThreads = 768;
// the largest o whose butterflies store C with W themselves; above it
// they write back in place and a store pass follows (see the note)
constexpr int kFusedMaxO = 15;
// named barriers 1 ... 15, one per sub-line group
constexpr int kMaxGroups = 15;
constexpr int kMinQ = 128;
constexpr int kMaxQ = 1024;
constexpr int kMaxM = 3072;

// The barrier of one sub-line group: its n threads only
struct GroupSync {
  int id, n;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
  }
};

// ai == nullptr: one real plane ar (the imaginary part is zero)
template <int O, typename TIn, typename TOut>
__global__ void __launch_bounds__(kMaxThreads)
stage1_odd_kernel(const TIn* __restrict__ ar, const TIn* __restrict__ ai,
                  TOut* __restrict__ yr, TOut* __restrict__ yi, int q,
                  int inner, int T, int groups, RadixPlan plan,
                  const float2* __restrict__ tab,
                  const float2* __restrict__ otw, float sgn,
                  const float2* __restrict__ wb,
                  const float2* __restrict__ wc, int tw_t) {
  extern __shared__ float smem[];
  const int m = O * q;
  const int tiles = inner / T;
  const int row = blockIdx.x / tiles;
  const int col0 = (blockIdx.x - row * tiles) * T;
  const int tpl = q / kE;
  const int gsize = T * tpl;
  const int g = threadIdx.x / gsize;
  const int lt = threadIdx.x - g * gsize;
  const int c = lt % T;
  const int ti = lt / T;
  const int sub = q * T;
  const long long base = static_cast<long long>(row) * m * inner;
  const long long step = static_cast<long long>(O) * tpl * inner;
  float* sre = smem;
  float* sim = smem + T * m;
  const GroupSync sync{g + 1, gsize};
  for (int i = g; i < O; i += groups) {
    const long long gi =
        base + static_cast<long long>(i + O * ti) * inner + col0 + c;
    float2 v[kE];
#pragma unroll
    for (int s = 0; s < kE; ++s) {
      v[s] = make_float2(ld(ar, gi + s * step),
                         ai == nullptr ? 0.f : sgn * ld(ai, gi + s * step));
    }
    float* tre = sre + i * sub;
    float* tim = sim + i * sub;
    kofft::radix::line_fft<kE>(v, ti, tpl, plan, tab, tre, tim, c, T, sync);
    // the last exchange ended with the group's barrier: sub-tile i is
    // free; the odd pass's twiddle w_m^(i*k') rides on this store
#pragma unroll
    for (int s = 0; s < kE; ++s) {
      const int kp = ti + s * tpl;
      const float2 y =
          i == 0 ? v[s] : cmul(v[s], __ldg(otw + kp * (O - 1) + i - 1));
      tre[kp * T + c] = y.x;
      tim[kp * T + c] = y.y;
    }
  }
  __syncthreads();
  if constexpr (O <= kFusedMaxO) {
    // each butterfly stores X[k' + q*r] times W[k1, j2] itself
    const int ncol = inner / tw_t;
    for (int bi = threadIdx.x; bi < sub; bi += blockDim.x) {
      const int kp = bi / T;
      const int col = col0 + bi - kp * T;
      const int wj = col / tw_t;
      const int wu = col - wj * tw_t;
      dft_odd<O>(
          [&](int i) {
            return make_float2(sre[i * sub + bi], sim[i * sub + bi]);
          },
          [&](int r, float2 y) {
            const long long k1 = kp + r * q;
            const float2 f = __ldg(wc + k1 * ncol + wj);
            const float2 b = __ldg(wb + k1 * tw_t + wu);
            y = cmul(y, make_float2(f.x * b.x - f.y * b.y,
                                    f.x * b.y + f.y * b.x));
            const long long o = base + k1 * inner + col;
            st(yr, o, y.x);
            st(yi, o, y.y);
          });
    }
  } else {
    // in place: butterfly bi reads word i*sub + bi of each sub-tile i and
    // writes X[k' + q*r] to word r*sub + bi, which is (k' + q*r)*T + c:
    // the tile is then C's rows in natural order
    for (int bi = threadIdx.x; bi < sub; bi += blockDim.x) {
      dft_odd<O>(
          [&](int i) {
            return make_float2(sre[i * sub + bi], sim[i * sub + bi]);
          },
          [&](int r, float2 y) {
            sre[r * sub + bi] = y.x;
            sim[r * sub + bi] = y.y;
          });
    }
    __syncthreads();
    // the store with W: word k1*T + cc is row k1, column col0 + cc (cc is
    // the thread's own: the block is a multiple of T threads), so a warp
    // writes 32 / T rows of T consecutive columns
    const int cc = threadIdx.x % T;
    const int col = col0 + cc;
    const int ncol = inner / tw_t;
    const int wj = col / tw_t;
    const int wu = col - wj * tw_t;
    const int kstep = blockDim.x / T;
#pragma unroll 4
    for (int k1 = threadIdx.x / T; k1 < m; k1 += kstep) {
      const float2 f = __ldg(wc + static_cast<long long>(k1) * ncol + wj);
      const float2 b = __ldg(wb + static_cast<long long>(k1) * tw_t + wu);
      const float2 y = cmul(make_float2(sre[k1 * T + cc], sim[k1 * T + cc]),
                            make_float2(f.x * b.x - f.y * b.y,
                                        f.x * b.y + f.y * b.x));
      const long long o = base + static_cast<long long>(k1) * inner + col;
      st(yr, o, y.x);
      st(yi, o, y.y);
    }
  }
}

// Each instance keeps its own record of the dynamic shared memory already
// allowed per device (the attribute is per kernel function).
template <int O, typename TIn, typename TOut>
int launch(const void* ar, const void* ai, void* yr, void* yi, int rows,
           int q, int inner, int T, int groups, const RadixPlan& p,
           const void* tab, int otw_off, int conj, const void* wb,
           const void* wc, int tw_t, int device, void* stream) {
  const long long gsize = static_cast<long long>(T) * (q / kE);
  const long long threads = gsize * groups;
  const long long grid =
      static_cast<long long>(rows) * (inner / (T > 0 ? T : 1));
  if (T < 1 || (T & (T - 1)) != 0 || inner % T != 0 || q < kMinQ ||
      q > kMaxQ || (q & (q - 1)) != 0 || O * q > kMaxM || groups < 1 ||
      groups > kMaxGroups || groups > O || gsize % 32 != 0 ||
      threads > kMaxThreads || rows < 1 || otw_off < 0 || wb == nullptr ||
      wc == nullptr || tw_t < 1 || inner % tw_t != 0 ||
      grid > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(2 * sizeof(float) * O * q * T);
  static int allowed[kMaxDevices];
  const auto kernel = stage1_odd_kernel<O, TIn, TOut>;
  const int r =
      prepare(reinterpret_cast<const void*>(kernel), allowed, device, smem);
  if (r != cudaSuccess) return r;
  const float2* t = static_cast<const float2*>(tab);
  kernel<<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(ar), static_cast<const TIn*>(ai),
      static_cast<TOut*>(yr), static_cast<TOut*>(yi), q, inner, T, groups, p,
      t, t + otw_off, conj ? -1.f : 1.f, static_cast<const float2*>(wb),
      static_cast<const float2*>(wc), tw_t);
  return cudaGetLastError();
}

// The instances by I/O form: in_bf16 / out_bf16 select bf16 loaded planes
// and bf16 stored planes; stage 1 has no f32 -> bf16 form.
template <int O, typename... Args>
int forms(int in_bf16, int out_bf16, Args... a) {
  if (!in_bf16 && !out_bf16) return launch<O, float, float>(a...);
  if (in_bf16 && !out_bf16) return launch<O, bf16, float>(a...);
  if (in_bf16 && out_bf16) return launch<O, bf16, bf16>(a...);
  return cudaErrorInvalidValue;
}

}  // namespace

namespace kofft {

// One launch of stage1_odd_kernel over the (rows, o * q, inner) view:
// plan holds the power-of-two passes of q, tab + otw_off the odd pass's
// (q, o-1) twiddle table (hopper_kernels._stage1_plan), T and groups come
// from hopper_kernels._odd_tile. Every other odd radix or shape returns
// cudaErrorInvalidValue.
int launch_stage1_odd(int o, int real, int in_bf16, int out_bf16,
                      const void* ar, const void* ai, void* yr, void* yi,
                      int rows, int q, int inner, int T, int groups,
                      const RadixPlan& p, const void* tab, int otw_off,
                      int conj, const void* wb, const void* wc, int tw_t,
                      int device, void* stream) {
  if (real) ai = nullptr;
#define KOFFT_ODD(O)                                                     \
  case O:                                                                \
    return forms<O>(in_bf16, out_bf16, ar, ai, yr, yi, rows, q, inner, T, \
                    groups, p, tab, otw_off, real ? 0 : conj, wb, wc,    \
                    tw_t, device, stream);
  switch (o) {
    KOFFT_ODD(3)
    KOFFT_ODD(5)
    KOFFT_ODD(7)
    KOFFT_ODD(9)
    KOFFT_ODD(11)
    KOFFT_ODD(13)
    KOFFT_ODD(15)
    KOFFT_ODD(17)
    KOFFT_ODD(19)
    KOFFT_ODD(21)
    KOFFT_ODD(23)
    default:
      return cudaErrorInvalidValue;
  }
#undef KOFFT_ODD
}

}  // namespace kofft
