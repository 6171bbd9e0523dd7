// The dense four-step pair: each stage of X = F_n2 . ((F_n1 . A) o W) as
// one complex DFT-matrix product, with no line recursion. A plain C
// interface bound by ctypes (kofft_tpu_torch/ops/_cuda_build.py).
//
// dense_stage_a replaces _stage_a_kernel (kofft_tpu/ops/pallas_kernels.py:
// 185, pallas_call :235): per batch row, C[k1, j2] = (sum_j1 F1[j1, k1]
// A[j1, j2]) W[k1, j2], (b, n1, n2) -> (b, n1, n2), with the full twiddle
// plane W = tables.twiddle(n1, n2) in the epilogue (as _build reads it).
// dense_stage_b replaces _stage_b_kernel (:199, :261): X[k2, k1] =
// sum_j2 F2[j2, k2] C[k1, j2], (b, n1, n2) -> (b, n2, n1), whose row-major
// flattening is the natural-order spectrum.
//
// Both are instances of one tiled product Y[m, n] = sum_k F[k, m] B[k, n]:
// F is the (K, M) DFT matrix read along its rows; B is A itself for stage
// a (rows of length N = n2) and C read transposed for stage b (C's rows run
// along k = j2, so a block loads (BN, BK) runs of C and writes them into
// shared memory as (BK, BN)). The complex product is the Gauss
// three-product of _cdot's `highest` tier (:164-182): t1 = Fr Br, t2 = Fi Bi,
// t3 = (Fr + Fi)(Br + Bi), Y = (t1 - t2) + i (t3 - t1 - t2), every product
// a float32 FFMA. The host passes the Fr + Fi plane (one cached table per
// length); Br + Bi is formed once per element as the tile is loaded.
// tables.dft_matrix(n) is symmetric bit for bit (exact integer phases), so
// F[j, k] is also F[k, j]; the kernel reads it as (K, M) either way.
//
// Bound: the function is the same as stage1/stage2's, so its bound is
// theirs (a few microseconds of device memory at (1, 1024, 1024)). The
// algorithm is what limits it: 3 n1 FFMA (6 n1 flop) per output point per
// stage against an FFT's 5 log2 n1, 96 us at n1 = 1024 even at the 67
// TFLOP/s float32 peak. The kernel is compute-bound and makes no attempt
// at the bound: each thread keeps a 4 x 4 output tile in three accumulator
// sets (48 registers), the block a 64 x 64 tile, and each step of the
// K loop reads six 16-byte shared-memory vectors for 48 FFMAs. Tensor-core
// tiers (TF32, bf16 splits with wgmma) and TMA loads are later work.
//
// Shapes: M, N and K are multiples of 64 (n1 and n2 are multiples of 128,
// _pow2_split), not necessarily powers of two (n1 = 3 * 2^7 at 3 * 2^14);
// the launcher rejects any other shape. Sums run over K in order, one
// float32 FFMA chain per accumulator (about 112 dB against exact sums at
// K = 8192 for random input, by a float32 simulation of the same chain).
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;   // outputs m per block
constexpr int kBN = 64;   // outputs n per block
constexpr int kBK = 16;   // depth of one shared-memory stage
constexpr int kTM = 4;    // outputs m per thread
constexpr int kTN = 4;    // outputs n per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

static_assert(kBK * kBM == 4 * kThreads, "one float4 of F per thread");
static_assert(kBK * kBN == 4 * kThreads, "one float4 of B per thread");

// Y[b, m, n] = sum_k F[k, m] B[b, k, n], complex by the Gauss product.
// kTransB = false: B is (b, K, N) row-major (stage a, A itself).
// kTransB = true: B[b, k, n] = X[b, n, k], X (b, N, K) row-major (stage b).
// kTwiddle: the epilogue multiplies by W[m, n], (M, N) row-major (stage a).
template <bool kTransB, bool kTwiddle>
__global__ void __launch_bounds__(kThreads)
dense_dft_kernel(const float* __restrict__ fr, const float* __restrict__ fi,
                 const float* __restrict__ fs, const float* __restrict__ xr,
                 const float* __restrict__ xi, const float* __restrict__ wr,
                 const float* __restrict__ wi, float* __restrict__ yr,
                 float* __restrict__ yi, int M, int N, int K) {
  // [0] real, [1] imaginary, [2] real + imaginary
  __shared__ __align__(16) float sf[3][kBK][kBM];
  __shared__ __align__(16) float sb[3][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const long long plane = static_cast<long long>(K) * N;  // = M * N
  const float* b_r = xr + blockIdx.z * plane;
  const float* b_i = xi + blockIdx.z * plane;

  float t1[kTM][kTN], t2[kTM][kTN], t3[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) t1[i][j] = t2[i][j] = t3[i][j] = 0.f;
  }

  // this thread's loads: F row lk, columns lc..lc+3 of the tile
  const int lk = tid / (kBM / 4);
  const int lc = (tid % (kBM / 4)) * 4;
  // stage b: C row n0 + tn, columns k0 + tk..tk+3
  const int tn = tid / (kBK / 4);
  const int tk = (tid % (kBK / 4)) * 4;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const long long fo = static_cast<long long>(k0 + lk) * M + m0 + lc;
    const float4 a = __ldg(reinterpret_cast<const float4*>(fr + fo));
    const float4 c = __ldg(reinterpret_cast<const float4*>(fi + fo));
    const float4 s = __ldg(reinterpret_cast<const float4*>(fs + fo));
    *reinterpret_cast<float4*>(&sf[0][lk][lc]) = a;
    *reinterpret_cast<float4*>(&sf[1][lk][lc]) = c;
    *reinterpret_cast<float4*>(&sf[2][lk][lc]) = s;
    if constexpr (kTransB) {
      const long long bo = static_cast<long long>(n0 + tn) * K + k0 + tk;
      const float4 r = __ldg(reinterpret_cast<const float4*>(b_r + bo));
      const float4 q = __ldg(reinterpret_cast<const float4*>(b_i + bo));
      const float rv[4] = {r.x, r.y, r.z, r.w};
      const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sb[0][tk + u][tn] = rv[u];
        sb[1][tk + u][tn] = qv[u];
        sb[2][tk + u][tn] = rv[u] + qv[u];
      }
    } else {
      const long long bo = static_cast<long long>(k0 + lk) * N + n0 + lc;
      const float4 r = __ldg(reinterpret_cast<const float4*>(b_r + bo));
      const float4 q = __ldg(reinterpret_cast<const float4*>(b_i + bo));
      *reinterpret_cast<float4*>(&sb[0][lk][lc]) = r;
      *reinterpret_cast<float4*>(&sb[1][lk][lc]) = q;
      *reinterpret_cast<float4*>(&sb[2][lk][lc]) =
          make_float4(r.x + q.x, r.y + q.y, r.z + q.z, r.w + q.w);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 f0 = *reinterpret_cast<const float4*>(&sf[0][k][ty * kTM]);
      const float4 f1 = *reinterpret_cast<const float4*>(&sf[1][k][ty * kTM]);
      const float4 f2 = *reinterpret_cast<const float4*>(&sf[2][k][ty * kTM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[0][k][tx * kTN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[1][k][tx * kTN]);
      const float4 b2 = *reinterpret_cast<const float4*>(&sb[2][k][tx * kTN]);
      const float fa[kTM] = {f0.x, f0.y, f0.z, f0.w};
      const float fb[kTM] = {f1.x, f1.y, f1.z, f1.w};
      const float fc[kTM] = {f2.x, f2.y, f2.z, f2.w};
      const float ba[kTN] = {b0.x, b0.y, b0.z, b0.w};
      const float bb[kTN] = {b1.x, b1.y, b1.z, b1.w};
      const float bc[kTN] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          t1[i][j] = fmaf(fa[i], ba[j], t1[i][j]);
          t2[i][j] = fmaf(fb[i], bb[j], t2[i][j]);
          t3[i][j] = fmaf(fc[i], bc[j], t3[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* o_r = yr + blockIdx.z * plane;
  float* o_i = yi + blockIdx.z * plane;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    const long long g = static_cast<long long>(m) * N + n0 + tx * kTN;
    float re[kTN], im[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      re[j] = t1[i][j] - t2[i][j];
      im[j] = t3[i][j] - t1[i][j] - t2[i][j];
    }
    if constexpr (kTwiddle) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wr + g));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wi + g));
      const float wa[kTN] = {w0.x, w0.y, w0.z, w0.w};
      const float wb[kTN] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float r = re[j] * wa[j] - im[j] * wb[j];
        im[j] = re[j] * wb[j] + im[j] * wa[j];
        re[j] = r;
      }
    }
    *reinterpret_cast<float4*>(o_r + g) = make_float4(re[0], re[1], re[2],
                                                      re[3]);
    *reinterpret_cast<float4*>(o_i + g) = make_float4(im[0], im[1], im[2],
                                                      im[3]);
  }
}

// Selects the device, only if it is not current.
int use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

template <bool kTransB, bool kTwiddle>
int launch_dense(const float* fr, const float* fi, const float* fs,
                 const float* xr, const float* xi, const float* wr,
                 const float* wi, float* yr, float* yi, int b, int M, int N,
                 int K, int device, void* stream) {
  if (b < 1 || b > 65535 || M < kBM || N < kBN || K < kBK ||
      M % kBM != 0 || N % kBN != 0 || K % kBK != 0 || M / kBM > 65535)
    return cudaErrorInvalidValue;
  const int r = use_device(device);
  if (r != cudaSuccess) return r;
  const dim3 grid(N / kBN, M / kBM, b);
  dense_dft_kernel<kTransB, kTwiddle>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          fr, fi, fs, xr, xi, wr, wi, yr, yi, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// (b, n1, n2) planes -> C (b, n1, n2); f*: F_n1 (n1, n1) planes and their
// sum, w*: the (n1, n2) twiddle planes
extern "C" int kofft_dense_stage_a(const float* ar, const float* ai,
                                   const float* fr, const float* fi,
                                   const float* fs, const float* wr,
                                   const float* wi, float* cr, float* ci,
                                   int b, int n1, int n2, int device,
                                   void* stream) {
  return launch_dense<false, true>(fr, fi, fs, ar, ai, wr, wi, cr, ci, b, n1,
                                   n2, n1, device, stream);
}

// C (b, n1, n2) -> (b, n2, n1); f*: F_n2 (n2, n2) planes and their sum
extern "C" int kofft_dense_stage_b(const float* cr, const float* ci,
                                   const float* fr, const float* fi,
                                   const float* fs, float* yr, float* yi,
                                   int b, int n1, int n2, int device,
                                   void* stream) {
  return launch_dense<true, false>(fr, fi, fs, cr, ci, nullptr, nullptr, yr,
                                   yi, b, n2, n1, n2, device, stream);
}
