// The dense four-step pair on Hopper's tensor cores: each stage of
// X = F_n2 . ((F_n1 . A) o W) as one complex DFT-matrix product, with no
// line recursion. A plain C interface bound by ctypes
// (kofft_tpu_torch/ops/_cuda_build.py).
//
// dense_stage_a replaces _stage_a_kernel (kofft_tpu/ops/pallas_kernels.py:
// 185, pallas_call :235): per batch row, C[k1, j2] = (sum_j1 F1[j1, k1]
// A[j1, j2]) W[k1, j2], (b, n1, n2) -> (b, n1, n2), with the full twiddle
// plane W = tables.twiddle(n1, n2) in the epilogue (as _build reads it).
// dense_stage_b replaces _stage_b_kernel (:199, :261): X[k2, k1] =
// sum_j2 F2[j2, k2] C[k1, j2], (b, n1, n2) -> (b, n2, n1), whose row-major
// flattening is the natural-order spectrum.
//
// Both are one product Y[m, n] = sum_k F[k, m] D[k, n] over a square DFT
// matrix F (nf x nf) and nd data lines n: stage a's lines are A's columns
// j2 (D = A, k = j1), stage b's are C's rows k1 (D[k, n] = C[n, k]). The
// output Y (nf, nd) is stored row-major: C for stage a, X for stage b.
//
// Arithmetic, per precision tier as _build's `mode` (_cdot, :164-182):
// the Gauss three-product t1 = Fr Dr, t2 = Fi Di, t3 = (Fr + Fi)(Dr + Di),
// Y = (t1 - t2) + i (t3 - t1 - t2), three real products where the
// four-product form takes four (a third more tensor-core work). Each real
// product is a warpgroup wgmma with float32 accumulators in registers:
// - tf32x3 (`highest` and `high`): every operand x splits into
//   big = tf32(x) and small = tf32(x - big), rounded as cvt.rna rounds;
//   each product is big.big + big.small + small.big (m64n64k8, three
//   wgmmas per k step and product), the tensor-core counterpart of
//   float32 products.
// - bf16x1 (`default`): the operands and both Gauss sums, formed in
//   float32, round to bf16 (RN-even) once; one wgmma per product
//   (m64n64k16), as _cdot's single-pass `default` mode.
// The host splits or rounds the F planes once per length (hopper_kernels.
// _dense_tables: six tf32 planes Fr, Fi, Fr + Fi big and small, or three
// bf16 planes); the data are split or rounded in registers on their way
// in.
//
// Layout. The data are the wgmma A operand, from registers (a warpgroup's
// 64 lines, M = 64); F is the B operand from shared memory (N = 64 output
// rows m of the block): TF32 reads shared-memory operands K-major only,
// and F is symmetric bit for bit (tables.dft_matrix has exact integer
// phases), so row m of the table, F[m, k0 .. k0 + 31], is column m of
// the operand, K-major. Each K slice of an F plane is 64 rows of 128
// bytes, the 128-byte swizzle atom: chunk c of row r lands at chunk
// c ^ (r & 7). The raw data tile of a slice stays in its global layout
// ([k][n] rows of 128 lines for stage a, [n][k] rows for stage b), padded
// so that every fragment load is one wavefront. The accumulators come
// out as Y^T (lines n by rows, output rows m by columns), so the epilogue
// writes them into a padded (64, 132) shared tile, and each warp then
// stores whole output rows of 512 consecutive bytes (stage a multiplies
// by W on the way).
//
// Sums. The tensor cores truncate where they add into their float32
// accumulators, so a sum kept there over all of K drifts from the float32
// plain version as K grows. Each K slice of 32 (tf32) or 64 (bf16)
// terms of one Gauss product is therefore summed on the tensor cores into
// a fresh set (scale-d 0 on its first wgmma) and folded into the float32
// sums Re += t1 - t2, Im += t3 - t1 - t2 by rounding adds: two sets of
// sums and two fresh sets alternating, 128 accumulator registers.
//
// Pipeline: 256 threads (two warpgroups: 128 data lines x 64 output rows
// per block), two stages of cp.async traffic, the F planes and the raw
// data of slice s + 1 loading while slice s multiplies. Within a slice a
// warpgroup loads and splits the next product's A fragments (4 k steps)
// while the current product's wgmmas run (wgmma.wait_group 1), and the
// other warpgroup's wgmmas fill the tensor cores while it folds.
//
// Bound: the function is the same as stage1/stage2's, so its bound is
// theirs (a few microseconds of device memory at (1, 1024, 1024)). The
// algorithm is O(n^1.5): 6 nf real MACs per output point and stage, in
// tf32x3 three tensor-core passes each (19.3 GFLOP of TF32 work at
// (1, 1024, 1024), 39 us at 495 TFLOP/s), in bf16x1 one (6.4 GFLOP, 6.5
// us at 989 TFLOP/s). The tensor cores and the L2 traffic of the F
// tables bound it, not device memory.
//
// Shapes: nf and nd are multiples of 128 in [128, 8192] (_pow2_split:
// nf = n1 = 3 * 2^7 at 3 * 2^14); the launcher rejects any other shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

using kofft::kMaxDevices;
using kofft::prepare;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kTileD = 128;          // data lines per block, 64 per warpgroup
constexpr int kTileF = 64;           // output rows m per block (wgmma N)
constexpr int kRowBytes = 128;       // one F row of a K slice: a swizzle atom
constexpr int kFPlaneBytes = kTileF * kRowBytes;
constexpr int kOutLd = kTileD + 4;   // epilogue tile row, words
constexpr int kMaxLine = 8192;

template <bool kBf16>
struct Tier {
  static constexpr int kEsize = kBf16 ? 2 : 4;        // F element bytes
  static constexpr int kBK = kRowBytes / kEsize;      // K per slice
  static constexpr int kStep = kBf16 ? 16 : 8;        // K per wgmma
  static constexpr int kSteps = kBK / kStep;
  static constexpr int kPlanes = kBf16 ? 3 : 6;       // F planes
  static constexpr int kFBytes = kPlanes * kFPlaneBytes;
};

template <bool kBf16, bool kStageB>
struct Geo {
  using T = Tier<kBf16>;
  // raw data tile of one plane, words per row: stage a [k][n] (rows of
  // kTileD lines), stage b [n][k] (rows of kBK); the pad puts the eight
  // lines g and four k offsets t of a fragment load in 32 distinct banks
  // (bf16 stage b: 8-byte loads of k, k + 1, a half warp's in 32 banks)
  static constexpr int kLd =
      kStageB ? T::kBK + (kBf16 ? 8 : 4) : kTileD + (kBf16 ? 4 : 8);
  static constexpr int kRows = kStageB ? kTileD : T::kBK;
  static constexpr int kPlaneBytes = kRows * kLd * 4;
  static constexpr int kStageBytes =
      (T::kFBytes + 2 * kPlaneBytes + 1023) / 1024 * 1024;
  static constexpr int kSmem = 2 * kStageBytes + 1024;  // + alignment
  static_assert(2 * kTileF * kOutLd * 4 <= kStageBytes, "epilogue tile");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy; wgmma reads through the
// async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small), big + small = x to about 2^-22 relative
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// K-major B operand of 64 rows of 128 bytes, 128-byte swizzle: leading
// offset unused (1), 1024 bytes between 8-row groups, layout type 1
__device__ __forceinline__ uint64_t f_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define KOFFT_ACC32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define KOFFT_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, {%32, %33, %34, %35}, %36, p"

// d (64 x 64, float32) = a (64 x k, registers) . B (k x 64, shared),
// + d unless ``accumulate`` is 0
template <bool kBf16>
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t desc, int accumulate) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KOFFT_D32
        ", 1, 1, 0;\n}\n"
        : KOFFT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " KOFFT_D32
        ", 1, 1;\n}\n"
        : KOFFT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
}

// Y[b] (nf, nd) = sum_k F[k, m] D[b][k, n], complex by the Gauss product.
// f: the tier's F planes, each (nf, nf) row-major, plane after plane.
// kStageB = false: D = X[b] (nf, nd) row-major, and the epilogue
// multiplies by W (nf, nd). kStageB = true: D[k, n] = X[b][n, k], X[b]
// (nd, nf) row-major.
template <bool kBf16, bool kStageB>
__global__ void __launch_bounds__(kThreads, 1)
dense_tc_kernel(const void* __restrict__ f, const float* __restrict__ xr,
                const float* __restrict__ xi, const float* __restrict__ wr,
                const float* __restrict__ wi, float* __restrict__ yr,
                float* __restrict__ yi, int nf, int nd) {
  using T = Tier<kBf16>;
  using G = Geo<kBf16, kStageB>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of address bits 4-9: align to 1024 bytes
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kTileD;
  const int m0 = blockIdx.y * kTileF;
  const long long plane = static_cast<long long>(nf) * nd;
  xr += blockIdx.z * plane;
  xi += blockIdx.z * plane;

  // this thread's cp.async chunks: F chunk tid % 8 of rows tid / 8 and
  // + 32 of each plane (one swizzled chunk for both: 32 % 8 == 0); data
  // chunk tid % kc of rows tid / kc + kTR h of each plane
  const int fr0 = tid >> 3;
  const uint32_t f_dst = fr0 * kRowBytes + (((tid & 7) ^ (fr0 & 7)) << 4);
  const char* f_src = static_cast<const char*>(f) +
                      static_cast<long long>(m0 + fr0) * nf * T::kEsize +
                      (tid & 7) * 16;
  const long long f_plane = static_cast<long long>(nf) * nf * T::kEsize;
  const long long f_half = 32LL * nf * T::kEsize;
  constexpr int kc = kStageB ? T::kBK / 4 : kTileD / 4;  // chunks per row
  constexpr int kTR = kThreads / kc;                     // rows per pass
  const int dr0 = tid / kc;
  const int dc = 4 * (tid % kc);
  const uint32_t d_dst = T::kFBytes + (dr0 * G::kLd + dc) * 4;
  const long long d_off = kStageB
                              ? static_cast<long long>(n0 + dr0) * nf + dc
                              : static_cast<long long>(dr0) * nd + n0 + dc;
  const long long d_row = kStageB ? nf : nd;

  // slice s (K = s kBK ... + kBK) into stage q
  auto load = [&](int s, int q) {
    const uint32_t sb = base + q * G::kStageBytes;
#pragma unroll
    for (int p = 0; p < T::kPlanes; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cp_async16(sb + p * kFPlaneBytes + h * 32 * kRowBytes + f_dst,
                   f_src + p * f_plane + h * f_half + s * kRowBytes);
    }
    const long long d_s = kStageB ? static_cast<long long>(s) * T::kBK
                                  : static_cast<long long>(s) * T::kBK * nd;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* x = (p ? xi : xr) + d_off + d_s;
#pragma unroll
      for (int h = 0; h < G::kRows / kTR; ++h)
        cp_async16(sb + d_dst + p * G::kPlaneBytes + h * kTR * G::kLd * 4,
                   x + h * kTR * d_row);
    }
  };

  // re, im: the float32 sums of Y^T; per K slice each Gauss product is
  // summed on the tensor cores into a fresh set (ta or tb) and folded in
  // by rounding adds (the tensor cores' own sums truncate): re += t1 - t2,
  // im += t3 - t1 - t2
  float re[32], im[32], ta[32], tb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) re[i] = im[i] = ta[i] = tb[i] = 0.f;

  // this thread's fragment line: warpgroup tile row 16 w + g (and + 8)
  const int ln = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + g;
  const int slices = nf / T::kBK;
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const uint32_t fb = base + (s & 1) * G::kStageBytes;
    const float* dr =
        reinterpret_cast<const float*>(smem + (s & 1) * G::kStageBytes +
                                       T::kFBytes);
    const float* di = dr + G::kPlaneBytes / 4;
    // product p's data operand at (line n, k): Dr, Di or Dr + Di
    auto x = [&](int p, int n, int k) {
      const int o = kStageB ? n * G::kLd + k : k * G::kLd + n;
      return p == 0 ? dr[o] : p == 1 ? di[o] : dr[o] + di[o];
    };
    // the same at k and k + 1 (k even): one 8-byte load in stage b's rows
    auto x2 = [&](int p, int n, int k) {
      if constexpr (kStageB) {
        const int o = n * G::kLd + k;
        const float2 r = *reinterpret_cast<const float2*>(dr + o);
        const float2 i = *reinterpret_cast<const float2*>(di + o);
        return p == 0 ? r : p == 1 ? i : make_float2(r.x + i.x, r.y + i.y);
      } else {
        return make_float2(x(p, n, k), x(p, n, k + 1));
      }
    };
    // A fragments of product p for the slice's k steps j. tf32: register
    // v holds line ln + 8 (v & 1), k = 8 j + t + 4 (v >> 1), [0] big and
    // [1] small; bf16: k = 16 j + 2t + 8 (v >> 1) and k + 1, in [0]
    using Frags = uint32_t[T::kSteps][2][4];
    auto fill = [&](int p, Frags& a) {
#pragma unroll
      for (int j = 0; j < T::kSteps; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int n = ln + 8 * (v & 1);
          if constexpr (kBf16) {
            const int k = j * T::kStep + 2 * t + 8 * (v >> 1);
            const float2 u = x2(p, n, k);
            a[j][0][v] = bf16_pair(u.x, u.y);
          } else {
            const int k = j * T::kStep + t + 4 * (v >> 1);
            tf32_split(x(p, n, k), a[j][0][v], a[j][1][v]);
          }
        }
      }
    };
    // product p of the slice into d: F plane p (bf16), or planes 2p
    // (big) and 2p + 1 (small) of Fr, Fi, Fr + Fi (tf32)
    auto multiply = [&](int p, const Frags& a, float (&d)[32]) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::kSteps; ++j) {
        if constexpr (kBf16) {
          mma<true>(d, a[j][0], f_desc(fb + p * kFPlaneBytes + 32 * j), j);
        } else {
          const uint32_t fk = fb + 2 * p * kFPlaneBytes + 32 * j;
          mma<false>(d, a[j][0], f_desc(fk), j);
          mma<false>(d, a[j][0], f_desc(fk + kFPlaneBytes), 1);
          mma<false>(d, a[j][1], f_desc(fk), 1);
        }
      }
      wgmma_commit();
    };
    auto fold = [&](int p, float (&d)[32]) {
      pin(d);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (p != 2) re[i] += p == 0 ? d[i] : -d[i];
        im[i] += p == 2 ? d[i] : -d[i];
      }
    };
    // product 1's fragments load while product 0 multiplies, product 2's
    // while product 1 does
    Frags a0, a1;
    fill(0, a0);
    multiply(0, a0, ta);
    fill(1, a1);
    multiply(1, a1, tb);
    wgmma_wait<1>();
    fold(0, ta);
    fill(2, a0);
    multiply(2, a0, ta);
    wgmma_wait<1>();
    fold(1, tb);
    wgmma_wait<0>();
    fold(2, ta);
    __syncthreads();
  }

  // epilogue: Y^T accumulators -> (64, kOutLd) tiles of Re, Im -> rows
  float* sr = reinterpret_cast<float*>(smem);
  float* si = sr + kTileF * kOutLd;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    // accumulator q: line ln + 8 ((q >> 1) & 1), output row 8 (q >> 2) +
    // 2t + (q & 1)
    const int m = 8 * (q >> 2) + 2 * t + (q & 1);
    const int n = ln + 8 * ((q >> 1) & 1);
    sr[m * kOutLd + n] = re[q];
    si[m * kOutLd + n] = im[q];
  }
  __syncthreads();
  float* o_r = yr + blockIdx.z * plane;
  float* o_i = yi + blockIdx.z * plane;
  for (int m = tid >> 5; m < kTileF; m += kThreads / 32) {
    float4 yre = *reinterpret_cast<const float4*>(sr + m * kOutLd + 4 * lane);
    float4 yim = *reinterpret_cast<const float4*>(si + m * kOutLd + 4 * lane);
    const long long o = static_cast<long long>(m0 + m) * nd + n0 + 4 * lane;
    if constexpr (!kStageB) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(wr + o));
      const float4 c = __ldg(reinterpret_cast<const float4*>(wi + o));
      const float4 r = yre;
      const float4 i = yim;
      yre = make_float4(r.x * a.x - i.x * c.x, r.y * a.y - i.y * c.y,
                        r.z * a.z - i.z * c.z, r.w * a.w - i.w * c.w);
      yim = make_float4(r.x * c.x + i.x * a.x, r.y * c.y + i.y * a.y,
                        r.z * c.z + i.z * a.z, r.w * c.w + i.w * a.w);
    }
    *reinterpret_cast<float4*>(o_r + o) = yre;
    *reinterpret_cast<float4*>(o_i + o) = yim;
  }
}

template <bool kBf16, bool kStageB>
int launch_dense(const void* f, const float* xr, const float* xi,
                 const float* wr, const float* wi, float* yr, float* yi,
                 int b, int nf, int nd, int device, void* stream) {
  if (b < 1 || b > 65535 || nf < kTileD || nd < kTileD || nf > kMaxLine ||
      nd > kMaxLine || nf % kTileD != 0 || nd % kTileD != 0)
    return cudaErrorInvalidValue;
  using G = Geo<kBf16, kStageB>;
  const auto kernel = dense_tc_kernel<kBf16, kStageB>;
  static int allowed[kMaxDevices];
  const int r = prepare(reinterpret_cast<const void*>(kernel), allowed,
                        device, G::kSmem);
  if (r != cudaSuccess) return r;
  const dim3 grid(nd / kTileD, nf / kTileF, b);
  kernel<<<grid, kThreads, G::kSmem, static_cast<cudaStream_t>(stream)>>>(
      f, xr, xi, wr, wi, yr, yi, nf, nd);
  return cudaGetLastError();
}

}  // namespace

// A (b, n1, n2) planes -> C (b, n1, n2); f: the tier's F_n1 planes
// (hopper_kernels._dense_tables), w*: the (n1, n2) twiddle planes;
// bf16: 0 tf32x3, 1 bf16x1
extern "C" int kofft_dense_stage_a(const float* ar, const float* ai,
                                   const void* f, const float* wr,
                                   const float* wi, float* cr, float* ci,
                                   int b, int n1, int n2, int bf16,
                                   int device, void* stream) {
  return bf16 ? launch_dense<true, false>(f, ar, ai, wr, wi, cr, ci, b, n1,
                                          n2, device, stream)
              : launch_dense<false, false>(f, ar, ai, wr, wi, cr, ci, b, n1,
                                           n2, device, stream);
}

// C (b, n1, n2) -> (b, n2, n1); f: the tier's F_n2 planes
extern "C" int kofft_dense_stage_b(const float* cr, const float* ci,
                                   const void* f, float* yr, float* yi,
                                   int b, int n1, int n2, int bf16,
                                   int device, void* stream) {
  return bf16 ? launch_dense<true, true>(f, cr, ci, nullptr, nullptr, yr,
                                         yi, b, n2, n1, device, stream)
              : launch_dense<false, true>(f, cr, ci, nullptr, nullptr, yr,
                                          yi, b, n2, n1, device, stream);
}
