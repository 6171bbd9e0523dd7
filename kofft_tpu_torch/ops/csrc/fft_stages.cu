// The two stages of the Bailey four-step FFT, X = F_n2 . ((F_n1 . A) o W),
// for a batch of (n1, n2) planes on the register radix line FFT
// (radix_line.cuh), with a plain C interface bound by ctypes
// (kofft_tpu_torch/ops/_cuda_build.py). n = n1 * n2 from
// hopper_kernels._pow2_split: n2 is a power of two of 128 ... 8192, n1 one
// of 128 ... 8192 or a smooth o * 2^a <= 3072 (see below).
//
// stage1_kernel replaces s1_kernel and s1r_kernel
// (kofft_tpu/ops/pallas_kernels.py:547, :558, called at :613, :630) and
// phase 1 of the phased kernel (_build_phased kern, :847 -> :1104): line
// FFTs of length n1 along axis 1 of the (b, n1, n2) input, then
// C = Y o W with W[k1, j2] = col[k1, j2 / t] * base[k1, j2 mod t]
// (_twiddle_factors' factored tables, t = 128, float2-interleaved: one
// 8-byte load per factor; the product is the one the JAX function forms,
// pallas_kernels.py:447). A block holds an (n1, T) column tile of T >= 8
// consecutive columns j2, the column fastest across the threads, so every
// row access covers >= 32 bytes ((1024, 8): 512 threads, 64 KB; (2048, 8):
// 1024 threads, 128 KB). The inverse conjugates on load; the real form
// (stage1_real) reads one real plane and sets the imaginary part to zero
// in registers.
//
// stage1_cluster_kernel is stage 1 at n1 = 4096 and 8192, where an (n1, 8)
// tile needs 256 KB or more, over a block's 227 KB: one launch in which a
// thread-block cluster of C = 16 CTAs holds an (n1, T = 16) column tile,
// by the decimation in time across the cluster of axis_fft.cu's
// col_cluster_kernel (hopper_kernels._COL_CLUSTER: the same n1, C and T).
// CTA r loads rows r + 16 j (64-byte runs; 32 for bf16), runs their line
// FFT of M = n1 / 16 points (256 or 512), multiplies point k by
// w_n1^(r k), sends it to CTA k mod 16 through distributed shared memory
// and, after the cluster barrier, runs one radix-16 DFT a thread and
// stores the rows it loaded: row k1 = k + M s of output s, k = q + 16 ti
// on CTA q. W rides on that store, factored at M: W[k1, j2] = w_n^(k j2)
// * w_n^(M s j2) (hopper_kernels._stage1_cluster_twiddle), one 8-byte
// load a thread from the (M, n2) table and one a point from the (16, n2)
// table, whose 16 rows a column's threads share in L1. It replaces a
// column four-step of two launches of stage1_kernel (lines of 64 with a
// split twiddle, then lines of 64 or 128 stored digit-swapped with W),
// which read and wrote the planes twice through an intermediate pair: in
// CUDA graphs on one H100, (1, 4096, 4096) 151-153 us against the
// four-step's 247 (stage1_real 130 against 225; col_cluster_kernel, the
// same line FFTs without W, 145-147), (1, 8192, 8192) 724-731 against
// 950-954. Measured and not kept (PERF.md section 6): W from the
// four-step's factor tables on the same store, wc[k1, j2 / 128] *
// wb[k1, j2 mod 128], two loads a point from 5 MiB of tables (155 us at
// 4096, 767 at 8192; as accurate).
//
// stage2_kernel replaces s2_kernel and s2h_kernel (:569, :579, called at
// :649, :668), phases 2-3 of the phased kernel and its real form's Nyquist
// epilogue (:1347-1356): line FFTs of length n2 along the rows of C,
// written transposed to Y[b, k2, k1] in (b, n2, n1), whose flat order is
// the natural-order spectrum, or (kHalf) only the flat bins k = k2 * n1 +
// k1 <= n/2, the rows k2 < n2/2 and the Nyquist bin X[n/2] from the k1 = 0
// line, into one-sided (b, n/2 + 1) planes. A tile is T >= 8 consecutive
// whole lines k1 (T = 8 from lines of 512; T = 16 measured slower at
// lines of 512 and 1024). Each thread loads its points
// straight into registers (coalesced runs of one row), the radix passes
// run, and the transposed store goes through the exchange buffer: each
// thread writes its natural-order points k2 of line c to word c * slice +
// k2 (a warp writes one 128-byte row), the block synchronises, and each
// warp reads back 32 / T rows k2 of T consecutive k1 each and stores them
// as >= 32-byte runs. Lines up to 2048 points: one block holds the tile
// ((1024, 8): 512 threads, 64 KB). Lines of 4096 and 8192: T lines of
// 8192 would need 512 KB, so a thread-block cluster of T = 8 CTAs holds
// the tile, each CTA one whole line (256 threads and 32 KB at 4096, four
// CTAs per SM; 512 threads and 64 KB at 8192, two per SM), and each CTA
// stores a slice of n2 / 8 output rows. After the passes the cluster
// synchronises (every CTA is done with its exchange buffer), each thread
// writes its points into the buffer of the CTA that stores their rows
// (distributed shared memory, one 128-byte row per warp store; CTA q
// starts with CTA q's slice, so the CTAs write to different CTAs at each
// step), the cluster synchronises again, and each CTA stores its slice
// from its own buffer (no CTA touches another's memory after the second
// sync, so each may exit). The first synchronisation is split: a CTA
// arrives as soon as its last exchange has been read back (the buffer is
// free) and waits only before the push, so its last radix pass runs while
// the cluster gathers (8192: 790 against 821-826 us; 4096: no change).
// One line per CTA runs as many CTAs per SM as row_fft's blocks: (1, 4096,
// 4096) in CUDA graphs on one H100 takes 163 us against 192 for the
// earlier 4 CTAs of two lines (row_fft: 103 us). Measured and not kept
// (PERF.md section 6): tiles of T = 4 or fewer lines without a cluster
// (16-byte runs fill 32-byte sectors in halves: 337 us and up), pulling
// 16-byte words from the peers, cp.async.bulk or st.async into a second
// buffer (169-181 us), persistent clusters (214 us), clusters of 16 (178
// us); earlier, a distributed-shared-memory store of 32 words 32 bytes
// apart, or all CTAs writing to one CTA at a time, each made the cluster
// several times slower. The inverse conjugates on
// store. kHalf stores scalars at the odd row stride n/2 + 1,
// in runs of T.
//
// What bounds them: bytes. A stage must read and write its planes once,
// 16 bytes per point in float32 (12 for stage1_real, 8 + 8 * (n/2 + 1) / n
// for stage2_half), 5.01 us at 3.35 TB/s for 2^20 points; the FFT's 5 m
// log2 m flop per line is under a fifth of that at 67 TFLOP/s. What the
// design does about the three causes that held the earlier dense-chain
// stage kernels (dense DFT-matrix leaves) at 2.5-15 % of that bound:
// 1. Leaf work: radix-16/8/4/2 butterflies in registers, ~30-45
//    floating-point instructions per point for lines of 128 ... 8192
//    where the dense leaves took 64-192 complex MACs, and one exchange
//    per pass boundary instead of a ping-pong round trip with table reads
//    per step.
// 2. Coalescing: stage 1 reads and stores T >= 8 consecutive columns per
//    row at every n1 (the dense chain fell to T = 1, 4-byte runs, from
//    lines of 4096); stage 2 loads whole rows and tiles its transposed
//    store through shared memory (one block) or distributed shared memory
//    (a cluster), so each warp stores >= 32-byte runs (T = 4 at 1024 and
//    T = 1 at 8192 before). Every shared-memory exchange, the transposed
//    one included, goes through a swizzle the host picks so that each
//    warp-wide access is one wavefront (hopper_kernels._best_swizzle).
//    bf16 planes move 16-byte runs at T = 8.
// 3. The twiddle epilogue: two 8-byte loads of float2 factors per point
//    (the dense chain made four 4-byte loads from four planes); the base
//    factors of a warp are T-float2 runs, the column factor one broadcast;
//    on the cluster one load per point and one per thread (above).
//
// A smooth n1 = o * 2^a (odd o = 3 ... 23: 3*2^18 splits as 768 x 1024,
// 9*2^14 as 1152 x 128, 23*2^14 as 2944 x 128) is one more radix plan of
// stage 1: its power-of-two passes, then one pass of radix o
// (radix_line.cuh). kofft_stage1 sends such a plan to stage1_odd.cu,
// whose kernel runs the o sub-lines of 2^a in thread groups and the odd
// pass with its own thread map; stage 2 lines are always powers of two.
//
// bfloat16 I/O: every kernel also loads and stores bfloat16 planes (the
// forms of hopper_kernels._IO_FORMS, the counterparts of _build_ml's
// cdt='bfloat16' C (:490, :555) and of _build_phased's io='bfloat16'
// output and sdt C (:750, :1078)); only the element type of the global
// loads and stores changes (elem_io.cuh).
//
// Shared memory above 48 KB needs cudaFuncAttributeMaxDynamicSharedMemorySize,
// raised once per device and instance; a cluster launch first checks that
// the cluster fits (cudaOccupancyMaxActiveClusters > 0). Every error is
// returned to the caller, which raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "elem_io.cuh"
#include "launch.cuh"
#include "radix_line.cuh"

namespace cg = cooperative_groups;

namespace kofft {
// stage1_odd.cu: stage 1 on a plan whose last radix is odd
int launch_stage1_odd(int o, int real, int in_bf16, int out_bf16,
                      const void* ar, const void* ai, void* yr, void* yi,
                      int rows, int q, int inner, int T, int groups,
                      const radix::RadixPlan& p, const void* tab,
                      int otw_off, int conj, const void* wb, const void* wc,
                      int tw_t, int device, void* stream);
}  // namespace kofft
using kofft::bf16;
using kofft::kMaxDevices;
using kofft::ld;
using kofft::prepare;
using kofft::st;
using kofft::radix::ArriveAfterLastExchange;
using kofft::radix::cluster_addr;
using kofft::radix::cmul;
using kofft::radix::fill_plan;
using kofft::radix::RadixPlan;
using kofft::radix::st_cluster;
using kofft::radix::Swizzle;
using kofft::radix::swizzle;

namespace {

// points per thread: every stage line has >= 128 points
constexpr int kE = 16;
// the largest block (stage 1's and stage 2's tiles of 2048-point lines);
// it caps the instances that may launch it at 64 registers
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
// the largest CTA of a stage-2 cluster (one line of 8192 points,
// hopper_kernels._stage2_tile); two per SM keep the instances at 64
// registers, so the 256-thread CTAs of lines of 4096 run four per SM (one
// CTA of 512 threads per SM, with the ~80 registers ptxas takes
// otherwise, and three of 256 per SM were each measured slower)
constexpr int kClusterThreads = 512;
// stage1_cluster_kernel: CTAs per cluster and columns per tile
// (hopper_kernels._COL_CLUSTER); C = kE, so each thread runs one radix-C
// DFT after the exchange
constexpr int kS1Cluster = 16;
constexpr int kS1Tile = 16;

// wb != nullptr: multiply the point stored at row k1 (of its batch row)
// and column col by W[k1, col] = wc[k1, col / tw_t] * wb[k1, col mod tw_t].
// The launcher passes tw = nullptr, tw_div = 1 and swap = 1: the split
// twiddle (point k of column col times tw[k * (inner / tw_div) + col /
// tw_div]) and digit swap (row `row` of the (rows, m, inner) view storing
// point k to row k * swap + row % swap of block row / swap) of a column
// four-step, which no launch takes since lines of 4096 and 8192 run on
// stage1_cluster_kernel; they stay so that the instances keep their code.
template <bool kReal, typename TIn, typename TOut>
__global__ void __launch_bounds__(kMaxThreads)
stage1_kernel(const TIn* __restrict__ ar, const TIn* __restrict__ ai,
              TOut* __restrict__ yr, TOut* __restrict__ yi, int m, int inner,
              int T, RadixPlan plan, const float2* __restrict__ tab,
              float sgn, const float2* __restrict__ tw, int tw_div, int swap,
              const float2* __restrict__ wb, const float2* __restrict__ wc,
              int tw_t) {
  extern __shared__ float smem[];
  const int tiles = inner / T;
  const int row = blockIdx.x / tiles;
  const int c = threadIdx.x % T;
  const int ti = threadIdx.x / T;
  const int col = (blockIdx.x - row * tiles) * T + c;
  const int tpl = m / kE;
  const long long step = static_cast<long long>(tpl) * inner;
  const long long g = static_cast<long long>(row) * m * inner +
                      static_cast<long long>(ti) * inner + col;
  float2 v[kE];
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    if constexpr (kReal) {
      v[s] = make_float2(ld(ar, g + s * step), 0.f);
    } else {
      v[s] = make_float2(ld(ar, g + s * step), sgn * ld(ai, g + s * step));
    }
  }
  kofft::radix::line_fft<kE>(v, ti, tpl, plan, tab, smem, smem + T * m, c,
                             T);
  const int rs = row % swap;
  const long long o =
      static_cast<long long>(row / swap) * swap * m * inner +
      static_cast<long long>(rs) * inner +
      static_cast<long long>(ti) * swap * inner + col;
  const long long ostep = step * swap;
  const int tw_cols = inner / tw_div;
  const int j2 = col / tw_div;
  const int ncol = inner / tw_t;
  const int wj = col / tw_t;
  const int wu = col - wj * tw_t;
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    const int k = ti + s * tpl;
    float2 y = v[s];
    if (tw != nullptr) {
      y = cmul(y, __ldg(tw + static_cast<long long>(k) * tw_cols + j2));
    }
    if (wb != nullptr) {
      const long long k1 = static_cast<long long>(k) * swap + rs;
      const float2 f = __ldg(wc + k1 * ncol + wj);
      const float2 b = __ldg(wb + k1 * tw_t + wu);
      y = cmul(y, make_float2(f.x * b.x - f.y * b.y, f.x * b.y + f.y * b.x));
    }
    st(yr, o + s * ostep, y.x);
    st(yi, o + s * ostep, y.y);
  }
}

// Stage 1 on lines of m = C * M points (4096 and 8192), one (m, T) column
// tile per cluster of C CTAs (1-D, so blockIdx.x % C is the CTA's rank r
// in it), as col_cluster_kernel (axis_fft.cu) runs the line FFTs: CTA r
// loads rows r + C * (ti + i * tpl) of the tile and runs their M-point
// line FFT Y_r (the plan of lines of M), multiplies Y_r[k] by
// w_m^(r * k) (ctw, the (C, M) table) and sends it to CTA k mod C = ti
// mod C (tpl = M / kE is a multiple of C), word (r * tpl + k / C) * T + c;
// then thread ti of CTA q runs the radix-C DFT X[k + M * s] = sum_r
// Z_r[k] w_C^(r * s), k = q + C * ti, and stores output s, times
// W[k + M * s, col] = wk[k, col] * ws[s, col], to row k + M * s = q +
// C * (ti + s * tpl): the row of its load i = s. The inverse conjugates on
// load; the real form reads one plane.
template <bool kReal, typename TIn, typename TOut>
__global__ void __launch_bounds__(kClusterThreads, 2)
stage1_cluster_kernel(const TIn* __restrict__ ar, const TIn* __restrict__ ai,
                      TOut* __restrict__ yr, TOut* __restrict__ yi, int m,
                      int inner, RadixPlan plan,
                      const float2* __restrict__ tab, float sgn,
                      const float2* __restrict__ ctw,
                      const float2* __restrict__ wk,
                      const float2* __restrict__ ws) {
  constexpr int C = kS1Cluster;
  constexpr int T = kS1Tile;
  static_assert(C == kE, "one radix-C DFT a thread after the exchange");
  extern __shared__ float smem[];
  const int M = m / C;
  const int tpl = M / kE;
  float* sre = smem;
  float* sim = smem + T * M;
  const int rank = static_cast<int>(blockIdx.x % C);
  const int tile = static_cast<int>(blockIdx.x / C);
  const int tiles = inner / T;
  const int row = tile / tiles;
  const int c = threadIdx.x % T;
  const int ti = threadIdx.x / T;
  const int col = (tile - row * tiles) * T + c;
  // load i and store s of the thread: row rank + C * ti + M * i
  const long long g = static_cast<long long>(row) * m * inner + col +
                      static_cast<long long>(rank + C * ti) * inner;
  const long long step = static_cast<long long>(M) * inner;
  float2 v[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    if constexpr (kReal) {
      v[i] = make_float2(ld(ar, g + i * step), 0.f);
    } else {
      v[i] = make_float2(ld(ar, g + i * step), sgn * ld(ai, g + i * step));
    }
  }
  // every line of M >= 256 points has >= 2 passes, so one exchange at
  // least before the arrival
  kofft::radix::line_fft<kE>(v, ti, tpl, plan, tab, sre, sim, c, T,
                             ArriveAfterLastExchange{2 * plan.npass - 2});
  const float2* w = ctw + static_cast<long long>(rank) * M + ti;
  const unsigned a0 = cluster_addr(
      static_cast<unsigned>(__cvta_generic_to_shared(sre)) +
          4u * ((rank * tpl + ti / C) * T + c),
      ti % C);
  const unsigned im = 4u * T * M;  // from a word of sre to sim's
  const unsigned kstep = 4u * (tpl / C) * T;
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    float2 y = v[i];
    if (rank > 0) y = cmul(y, __ldg(w + i * tpl));
    st_cluster(a0 + i * kstep, y.x);
    st_cluster(a0 + i * kstep + im, y.y);
  }
  // no CTA touches another's buffer after this, so each may exit
  cg::this_cluster().sync();
#pragma unroll
  for (int r = 0; r < C; ++r) {
    const int a = (r * tpl + ti) * T + c;
    v[r] = make_float2(sre[a], sim[a]);
  }
  kofft::radix::dft<C>(v);
  const float2 f =
      __ldg(wk + static_cast<long long>(rank + C * ti) * inner + col);
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    const float2 b = __ldg(ws + s * inner + col);
    const float2 y =
        cmul(v[s], make_float2(f.x * b.x - f.y * b.y, f.x * b.y + f.y * b.x));
    st(yr, g + s * step, y.x);
    st(yi, g + s * step, y.y);
  }
}

// f(s) for s = kFirst ... kE - 1, 0 ... kFirst - 1, unrolled, so that
// f may index a register array with s
template <int kFirst, typename F>
__device__ __forceinline__ void each_from(const F& f) {
#pragma unroll
  for (int j = 0; j < kE; ++j) f((j + kFirst) % kE);
}

// How stage2_kernel stores its lines: transposed into (b, n2, n1) (the
// 1-D spectrum), or only the one-sided bins into (b, n/2 + 1) (sgn is not
// read)
enum Store { kTransposed, kHalf };

// A tile of T consecutive lines k1 of C, Tc of them per CTA; kCluster: the
// tile spans a cluster of T / Tc CTAs (1-D, so blockIdx.x % (T / Tc) is
// the CTA's rank in it). T is a power of two; the last pass's swizzle in
// the plan is the transposed exchange's.
template <int kStore, bool kCluster, typename TIn, typename TOut>
__global__ void __launch_bounds__(kCluster ? kClusterThreads : kMaxThreads,
                                  kCluster ? 2 : 1)
stage2_kernel(const TIn* __restrict__ cr, const TIn* __restrict__ ci,
              TOut* __restrict__ yr, TOut* __restrict__ yi, int n1, int m,
              int T, int tc, RadixPlan plan, const float2* __restrict__ tab,
              float sgn) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + tc * m;
  const int csize = T / tc;
  const int rank = kCluster ? static_cast<int>(blockIdx.x % csize) : 0;
  const int tile = blockIdx.x / csize;
  const int tiles = n1 / T;
  const long long row = tile / tiles;
  const int k1_0 = (tile - static_cast<int>(row) * tiles) * T;
  const int tpl = m / kE;
  const int cl = threadIdx.x / tpl;
  const int ti = threadIdx.x - cl * tpl;
  const int c = rank * tc + cl;
  const long long base = row * n1 * static_cast<long long>(m);
  const long long g = base + static_cast<long long>(k1_0 + c) * m + ti;
  float2 v[kE];
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    v[s] = make_float2(ld(cr, g + s * tpl), ld(ci, g + s * tpl));
  }
  if constexpr (kCluster) {
    // every stage-2 line has >= 2 passes, so one exchange at least
    kofft::radix::line_fft<kE>(v, ti, tpl, plan, tab, sre, sim, cl * m, 1,
                               ArriveAfterLastExchange{2 * plan.npass - 2});
  } else {
    kofft::radix::line_fft<kE>(v, ti, tpl, plan, tab, sre, sim, cl * m, 1);
  }
  const int last = plan.npass - 1;
  const Swizzle sw{plan.sw[last][0], plan.sw[last][1], plan.sw[last][2],
                   plan.sw[last][3]};
  // the transposed exchange: point k2 of tile line c goes to word
  // c * slice + k2 mod slice of CTA k2 / slice (the block itself without a
  // cluster, slice = m), so that a warp writes one 128-byte row; the radix
  // passes left the buffer free (their last exchange ended with a barrier)
  const int slice = m / csize;
  if constexpr (kCluster) {
    // point s goes to CTA s * csize / kE (slice is a multiple of tpl); CTA
    // q starts at s = q * kE / csize, so at each step the CTAs of the
    // cluster write to csize different CTAs, not all to one
    cg::cluster_group cluster = cg::this_cluster();
    const auto push = [&](int s) {
      const int k2 = ti + s * tpl;
      const int r = k2 / slice;
      const int a = swizzle(c * slice + k2 - r * slice, sw);
      cluster.map_shared_rank(sre, r)[a] = v[s].x;
      cluster.map_shared_rank(sim, r)[a] = v[s].y;
    };
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    switch (rank * (kE / csize)) {
      case 0: each_from<0>(push); break;
      case 2: each_from<2>(push); break;
      case 4: each_from<4>(push); break;
      case 6: each_from<6>(push); break;
      case 8: each_from<8>(push); break;
      case 10: each_from<10>(push); break;
      case 12: each_from<12>(push); break;
      default: each_from<14>(push);
    }
    cluster.sync();
  } else {
#pragma unroll
    for (int s = 0; s < kE; ++s) {
      const int a = swizzle(c * m + ti + s * tpl, sw);
      sre[a] = v[s].x;
      sim[a] = v[s].y;
    }
    __syncthreads();
  }
  // read idx is output row k2 = rank * slice + idx / T, column k1_0 +
  // idx mod T (word (idx mod T) * slice + idx / T): a warp stores 32 / T
  // runs of T consecutive k1
  const int tsh = __ffs(T) - 1;
  const long long half = static_cast<long long>(n1) * (m / 2);
#pragma unroll
  for (int s = 0; s < kE; ++s) {
    const int idx = threadIdx.x + s * blockDim.x;
    const int a = swizzle((idx & (T - 1)) * slice + (idx >> tsh), sw);
    const long long k =
        static_cast<long long>(rank * slice + (idx >> tsh)) * n1 + k1_0 +
        (idx & (T - 1));
    if constexpr (kStore == kHalf) {
      if (k <= half) {
        st(yr, row * (half + 1) + k, sre[a]);
        st(yi, row * (half + 1) + k, sim[a]);
      }
    } else {
      st(yr, base + k, sre[a]);
      st(yi, base + k, sgn * sim[a]);
    }
  }
}

// Each launcher instance keeps its own record of the dynamic shared memory
// already allowed per device (the attribute is per kernel function).
template <bool kReal, typename TIn, typename TOut>
int launch_stage1(const void* ar, const void* ai, void* yr, void* yi,
                  int rows, int m, int inner, int T, const RadixPlan& p,
                  const void* tab, int conj, const void* wb, const void* wc,
                  int tw_t, int device, void* stream) {
  const long long threads = static_cast<long long>(T) * (m / kE);
  const long long grid =
      static_cast<long long>(rows) * (inner / (T > 0 ? T : 1));
  if (T < 1 || m % kE != 0 || inner % T != 0 || threads > kMaxThreads ||
      rows < 1 ||
      (wb != nullptr && (wc == nullptr || tw_t < 1 || inner % tw_t != 0)) ||
      grid > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(2 * sizeof(float) * m * T);
  static int allowed[kMaxDevices];
  const auto kernel = stage1_kernel<kReal, TIn, TOut>;
  const int r =
      prepare(reinterpret_cast<const void*>(kernel), allowed, device, smem);
  if (r != cudaSuccess) return r;
  kernel<<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(ar), static_cast<const TIn*>(ai),
      static_cast<TOut*>(yr), static_cast<TOut*>(yi), m, inner, T, p,
      static_cast<const float2*>(tab), conj ? -1.f : 1.f, nullptr, 1, 1,
      static_cast<const float2*>(wb), static_cast<const float2*>(wc),
      wb == nullptr ? 1 : tw_t);
  return cudaGetLastError();
}

template <bool kReal, typename TIn, typename TOut>
int launch_stage1_cluster(const void* ar, const void* ai, void* yr, void* yi,
                          int b, int m, int inner, const RadixPlan& p,
                          const void* tab, int conj, const void* ctw,
                          const void* wk, const void* ws, int device,
                          void* stream) {
  constexpr int C = kS1Cluster;
  constexpr int T = kS1Tile;
  const int mc = m / C;
  const int threads = T * (mc / kE);
  // every point of a thread goes to one CTA: tpl = mc / 16 is a multiple
  // of C
  if (b < 1 || m % C != 0 || mc % kE != 0 || (mc / kE) % C != 0 ||
      threads > kClusterThreads || inner < T || inner % T != 0 ||
      p.npass < 2 || ctw == nullptr || wk == nullptr || ws == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long grid = static_cast<long long>(b) * (inner / T) * C;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(2 * sizeof(float) * mc * T);
  static int allowed[kMaxDevices];
  // bit C: a cluster of C CTAs was checked to fit, per device
  static int fits[kMaxDevices];
  const auto kernel = stage1_cluster_kernel<kReal, TIn, TOut>;
  const int r =
      prepare(reinterpret_cast<const void*>(kernel), allowed, device, smem);
  if (r != cudaSuccess) return r;
  return kofft::launch_cluster(
      kernel, fits, device, grid, threads, smem, stream, C,
      static_cast<const TIn*>(ar), static_cast<const TIn*>(ai),
      static_cast<TOut*>(yr), static_cast<TOut*>(yi), m, inner, p,
      static_cast<const float2*>(tab), conj ? -1.f : 1.f,
      static_cast<const float2*>(ctw), static_cast<const float2*>(wk),
      static_cast<const float2*>(ws));
}

template <int kStore, bool kCluster, typename TIn, typename TOut>
int launch_stage2_kernel(const void* cr, const void* ci, void* yr, void* yi,
                         int b, int n1, int m, int T, int tc,
                         const RadixPlan& p, const void* tab, int conj,
                         int device, void* stream) {
  const int csize = T / tc;
  const int threads = tc * (m / kE);
  if (kCluster && threads > kClusterThreads) return cudaErrorInvalidValue;
  const long long grid = static_cast<long long>(b) * (n1 / T) * csize;
  const int smem = static_cast<int>(2 * sizeof(float) * m * tc);
  static int allowed[kMaxDevices];
  // bit c: a cluster of c CTAs was checked to fit, per device
  static int fits[kMaxDevices];
  const auto kernel = stage2_kernel<kStore, kCluster, TIn, TOut>;
  int r = prepare(reinterpret_cast<const void*>(kernel), allowed, device,
                  smem);
  if (r != cudaSuccess) return r;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const TIn* a_r = static_cast<const TIn*>(cr);
  const TIn* a_i = static_cast<const TIn*>(ci);
  TOut* o_r = static_cast<TOut*>(yr);
  TOut* o_i = static_cast<TOut*>(yi);
  const float2* t = static_cast<const float2*>(tab);
  const float sgn = conj ? -1.f : 1.f;
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (!kCluster) {
    kernel<<<static_cast<unsigned>(grid), threads, smem, s>>>(
        a_r, a_i, o_r, o_i, n1, m, T, tc, p, t, sgn);
    return cudaGetLastError();
  } else {
    return kofft::launch_cluster(kernel, fits, device, grid, threads, smem,
                                 stream, csize, a_r, a_i, o_r, o_i, n1, m, T,
                                 tc, p, t, sgn);
  }
}

template <int kStore, typename TIn, typename TOut>
int launch_stage2(const void* cr, const void* ci, void* yr, void* yi, int b,
                  int n1, int m, int T, int tc, const RadixPlan& p,
                  const void* tab, int conj, int device, void* stream) {
  if (T < 1 || (T & (T - 1)) != 0 || tc < 1 || T % tc != 0 ||
      T / tc > kMaxCluster || n1 % T != 0 || m % kE != 0 ||
      m % (T / tc) != 0 || tc * (m / kE) > kMaxThreads ||
      b < 1) {
    return cudaErrorInvalidValue;
  }
  if (T == tc) {
    return launch_stage2_kernel<kStore, false, TIn, TOut>(
        cr, ci, yr, yi, b, n1, m, T, tc, p, tab, conj, device, stream);
  }
  return launch_stage2_kernel<kStore, true, TIn, TOut>(
      cr, ci, yr, yi, b, n1, m, T, tc, p, tab, conj, device, stream);
}

// The instances by I/O form: in_bf16 / out_bf16 select bf16 loaded planes
// and bf16 stored planes; stage 1 has no f32 -> bf16 form (the `default`
// tier casts its input planes whenever it keeps C in bf16)
template <bool kReal, typename... Args>
int stage1_forms(int in_bf16, int out_bf16, Args... a) {
  if (!in_bf16 && !out_bf16) return launch_stage1<kReal, float, float>(a...);
  if (in_bf16 && !out_bf16) return launch_stage1<kReal, bf16, float>(a...);
  if (in_bf16 && out_bf16) return launch_stage1<kReal, bf16, bf16>(a...);
  return cudaErrorInvalidValue;
}

template <bool kReal, typename... Args>
int stage1_cluster_forms(int in_bf16, int out_bf16, Args... a) {
  if (!in_bf16 && !out_bf16) {
    return launch_stage1_cluster<kReal, float, float>(a...);
  }
  if (in_bf16 && !out_bf16) {
    return launch_stage1_cluster<kReal, bf16, float>(a...);
  }
  if (in_bf16 && out_bf16) {
    return launch_stage1_cluster<kReal, bf16, bf16>(a...);
  }
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

// One launch of stage1_kernel over the (rows, m, inner) view: line FFTs of
// length m along axis 1 (real = 1: one real plane ar, ai is not read; conj
// negates the imaginary part on load), stored times the four-step twiddle
// (wb, wc, tw_t; hopper_kernels._stage1_twiddle). T columns per block,
// steps / npass / tab from hopper_kernels._axis_plan. The I/O forms:
// f32 -> f32, bf16 -> f32 and bf16 -> bf16. A plan whose last radix is
// odd (m = o * q) launches stage1_odd.cu's kernel in ``groups`` sub-line
// groups (0 for a power-of-two plan).
extern "C" int kofft_stage1(const void* ar, const void* ai, void* yr,
                            void* yi, int rows, int m, int inner, int T,
                            int groups, const int* steps, int npass,
                            const void* tab, int conj, const void* wb,
                            const void* wc, int tw_t, int real, int in_bf16,
                            int out_bf16, int device, void* stream) {
  RadixPlan p;
  if (npass >= 2 && steps[7 * (npass - 1)] % 2 == 1) {
    const int* odd = steps + 7 * (npass - 1);
    const int o = odd[0];
    if (o < 3 || m % o != 0 || odd[1] != m / o) return cudaErrorInvalidValue;
    const int r = fill_plan(&p, steps, npass - 1, m / o, kE);
    if (r != cudaSuccess) return r;
    return kofft::launch_stage1_odd(o, real, in_bf16, out_bf16, ar, ai, yr,
                                    yi, rows, m / o, inner, T, groups, p,
                                    tab, odd[2], conj, wb, wc, tw_t, device,
                                    stream);
  }
  const int r = fill_plan(&p, steps, npass, m, kE);
  if (r != cudaSuccess || groups != 0) return cudaErrorInvalidValue;
  if (real) {
    return stage1_forms<true>(in_bf16, out_bf16, ar, ai, yr, yi, rows, m,
                              inner, T, p, tab, 0, wb, wc, tw_t, device,
                              stream);
  }
  return stage1_forms<false>(in_bf16, out_bf16, ar, ai, yr, yi, rows, m,
                             inner, T, p, tab, conj, wb, wc, tw_t, device,
                             stream);
}

// Stage 1 of (b, m, inner) planes at m = 4096 or 8192 in one launch of
// stage1_cluster_kernel (csize = 16 CTAs per cluster, T = 16 columns per
// tile, the one shape built): real and conj as kofft_stage1, the same
// I/O forms. steps / npass / tab: the plan of lines of m / 16, ctw the
// (16, m / 16) twiddle w_m^(r * k), and wk (m / 16, inner) and ws (16,
// inner) the factors of W (hopper_kernels._static_args("stage1_cluster")).
extern "C" int kofft_stage1_cluster(const void* ar, const void* ai,
                                    void* yr, void* yi, int b, int m,
                                    int inner, int T, int csize,
                                    const int* steps, int npass,
                                    const void* tab, int conj,
                                    const void* ctw, const void* wk,
                                    const void* ws, int real, int in_bf16,
                                    int out_bf16, int device, void* stream) {
  if (csize != kS1Cluster || T != kS1Tile || m % csize != 0) {
    return cudaErrorInvalidValue;
  }
  RadixPlan p;
  const int r = fill_plan(&p, steps, npass, m / csize, kE);
  if (r != cudaSuccess) return r;
  if (real) {
    return stage1_cluster_forms<true>(in_bf16, out_bf16, ar, ai, yr, yi, b,
                                      m, inner, p, tab, 0, ctw, wk, ws,
                                      device, stream);
  }
  return stage1_cluster_forms<false>(in_bf16, out_bf16, ar, ai, yr, yi, b, m,
                                     inner, p, tab, conj, ctw, wk, ws, device,
                                     stream);
}

// C (b, n1, n2) -> (b, n2, n1), or (half = 1) the one-sided (b, n/2 + 1)
// planes; conj negates the imaginary part on store (not with half). T
// lines per tile, tc per CTA (a cluster of T / tc CTAs when tc < T, each
// of at most 512 threads);
// steps / npass / tab from hopper_kernels._stage2_plan.
extern "C" int kofft_stage2(const void* cr, const void* ci, void* yr,
                            void* yi, int b, int n1, int n2, int T, int tc,
                            const int* steps, int npass, const void* tab,
                            int conj, int half, int in_bf16, int out_bf16,
                            int device, void* stream) {
  RadixPlan p;
  const int r = fill_plan(&p, steps, npass, n2, kE);
  if (r != cudaSuccess) return r;
  if (half) {
    return stage2_forms<kHalf>(in_bf16, out_bf16, cr, ci, yr, yi, b, n1, n2,
                               T, tc, p, tab, 0, device, stream);
  }
  return stage2_forms<kTransposed>(in_bf16, out_bf16, cr, ci, yr, yi, b, n1,
                                   n2, T, tc, p, tab, conj, device, stream);
}
