// The Goertzel recurrence over rows of samples: one thread per row.
//
// Replaces the lax.scan of kofft_tpu.ops.goertzel.goertzel_scan (not a
// Pallas kernel: the JAX package runs the scan on its device). Each row
// runs
//     s = x_i + coeff * s1 - s2;  s2 = s1;  s1 = s
// in float32, with the same operations in the same order and no FMA
// contraction (__fmul_rn / __fadd_rn / __fsub_rn), then
//     |X_k| = sqrt(max(s2*s2 + s1*s1 - coeff*s1*s2, 0)).
//
// What bounds it: each step depends on the one before through three
// float32 operations (multiply, add, subtract), so a row of n samples is a
// dependent chain of 3n operations at the FP32 pipe's latency; the bytes
// (one read of each sample) take far less at any row count that fits the
// card. The design keeps the chain fed. One warp takes 32 rows; thread r
// reads row r, but a load of one sample per thread would touch 32 cache
// lines per instruction. So the warp copies tiles of (32 rows, kTile
// samples) with cp.async, coalesced (one 128-byte row segment per copy
// instruction), into a ring of kStages padded shared-memory tiles, kStages
// - 1 tiles ahead of the one its steps run on; each thread reads its row
// of a landed tile into registers (16-byte reads, conflict-free) before
// its steps.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                   // rows (threads) per block: a warp
constexpr int kTile = 64;                   // samples per row and tile
constexpr int kCopies = kRows * kTile / 32;  // copy instructions per tile
constexpr int kPitch = kTile + 4;           // padded row, 16-byte aligned
constexpr int kStages = 4;                  // tiles in the shared ring

__device__ __forceinline__ void step(float x, float coeff, float& s1,
                                     float& s2) {
  const float s = __fsub_rn(__fadd_rn(x, __fmul_rn(coeff, s1)), s2);
  s2 = s1;
  s1 = s;
}

// the copies of tile t that lane makes into ``stage``: copy j takes row
// j / 2 of the block, columns (j % 2) * 32 + lane (rows past the end copy
// nothing)
__device__ __forceinline__ void copy_tile(float* stage,
                                          const float* __restrict__ base,
                                          long long n, int rows_left,
                                          long long t, int lane) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(stage));
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const int r = j / 2;
    const int c = (j % 2) * 32 + lane;
    if (r < rows_left)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       dst + 4u * (r * kPitch + c)),
                   "l"(base + r * n + t * kTile + c)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kRows)
goertzel_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int rows, long long n, float coeff) {
  __shared__ __align__(16) float tiles[kStages][kRows * kPitch];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int rows_left = rows - row0;
  const float* base = x + static_cast<long long>(row0) * n;
  const long long full = n / kTile;
  float s1 = 0.f, s2 = 0.f;
  // one commit group per tile, empty past the last: tile t has landed when
  // at most kStages - 1 groups are pending
  for (int t = 0; t < kStages - 1; ++t)
    copy_tile(tiles[t], base, n, t < full ? rows_left : 0, t, lane);
  for (long long t = 0; t < full; ++t) {
    const long long next = t + kStages - 1;
    copy_tile(tiles[next % kStages], base, n, next < full ? rows_left : 0,
              next, lane);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const float4* mine = reinterpret_cast<const float4*>(
        tiles[t % kStages] + lane * kPitch);
    float4 m[kTile / 4];
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) m[q] = mine[q];
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      step(m[q].x, coeff, s1, s2);
      step(m[q].y, coeff, s1, s2);
      step(m[q].z, coeff, s1, s2);
      step(m[q].w, coeff, s1, s2);
    }
    // every lane has read this stage before the next copies reuse it
    __syncwarp();
  }
  if (lane >= rows_left) return;
  const float* p = base + lane * n;
  for (long long i = full * kTile; i < n; ++i) step(__ldg(p + i), coeff, s1,
                                                    s2);
  const float power = __fsub_rn(__fadd_rn(__fmul_rn(s2, s2),
                                          __fmul_rn(s1, s1)),
                                __fmul_rn(__fmul_rn(coeff, s1), s2));
  out[row0 + lane] = __fsqrt_rn(fmaxf(power, 0.f));
}

}  // namespace

// x: (rows, n) float32, contiguous; out: (rows,) float32.
extern "C" int kofft_goertzel_scan(const float* x, float* out, int rows,
                                   long long n, float coeff, int device,
                                   void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  goertzel_scan_kernel<<<grid, kRows, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, rows,
                                                              n, coeff);
  return cudaGetLastError();
}
