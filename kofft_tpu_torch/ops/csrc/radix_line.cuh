// Block-wide line FFT in registers: radix passes of 16, 8, 4 or 2 points,
// exchanged through one shared-memory buffer in Stockham order, and the
// odd-radix butterfly (3 ... 23 points) that ends the line of a smooth
// m = o * 2^a. It is the line FFT of the axis kernels (axis_fft.cu) and
// of the stage kernels (fft_stages.cu, stage1_odd.cu); it computes
// _fft_axis0_traced's function (kofft_tpu/ops/pallas_kernels.py:378-412),
// the DFT of each line.
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
// (T*m floats for re, T*m for im) serves every exchange. The barrier is
// the caller's (Sync): the whole block by default, or a named barrier of
// the threads that share one buffer (stage1_odd.cu's sub-line groups).
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
// (w_8, w_16, and cos / sin(2 pi k / o) of the odd butterflies) are
// hard-coded float32 values rounded from float64, as in kofft's
// fixed-size fft2/fft4/fft8/fft16 kernels.
//
// Odd radix: a smooth line m = o * q (q = 2^a) runs the power-of-two
// passes first, so every Ns stays a power of two and the masks below
// hold; they leave the DFTs of length q of the o subsequences
// x[i + o*l], and one last pass of radix o (Ns = q) combines them:
//   X[k' + q*r] = sum_i (Y_i[k'] * w_m^(i*k')) * w_o^(i*r),
// its twiddle the (q, o-1) table of the same rule. dft_odd is that pass's
// butterfly; stage1_odd.cu runs it with its own thread map (see there).
//
// Cost per point and pass: a radix-16 butterfly is two radix-8 halves and
// 16 complex additions with 6 constant products, about 11 floating-point
// instructions per point, plus (R-1)/R twiddle products of 4 instructions
// and one 8-byte table load each; radix 8 about 8, radix 4 about 4; the
// odd butterfly in its pair form ~ 4 * ((o-1)/2)^2 / o FMAs per point (21
// at o = 23, 3 at o = 3). A line of 128 (16*8) takes ~30 instructions per
// point where the dense 128-point leaf took 512 FFMA; a line of 1024
// (16*8*8) ~40 against 256. Shared memory: per exchange one 4-byte store
// and one 4-byte load per plane and point (pass count - 1 exchanges: 1 at
// 128, 2 at 1024, 3 at 8192), and no shared memory at all for lines of 16
// or fewer.
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

// (cos, sin) of 2 pi k / o for odd o = 3 ... 23 and k = 1 ... (o-1)/2,
// rounded once from float64 (tests/test_torch_stage.py reads them back);
// k = 0 (j*k a multiple of o, for o = 9, 15, 21) is (1, 0)
__device__ __forceinline__ float2 odd_w(int o, int k) {
  switch (o * 32 + k) {
    case 3 * 32 + 1:
      return make_float2(-0.5f, 0.8660253882408142f);
    case 5 * 32 + 1:
      return make_float2(0.30901700258255005f, 0.9510565400123596f);
    case 5 * 32 + 2:
      return make_float2(-0.80901700258255f, 0.5877852439880371f);
    case 7 * 32 + 1:
      return make_float2(0.6234897971153259f, 0.7818315029144287f);
    case 7 * 32 + 2:
      return make_float2(-0.22252093255519867f, 0.9749279022216797f);
    case 7 * 32 + 3:
      return make_float2(-0.9009688496589661f, 0.4338837265968323f);
    case 9 * 32 + 1:
      return make_float2(0.7660444378852844f, 0.6427876353263855f);
    case 9 * 32 + 2:
      return make_float2(0.1736481785774231f, 0.9848077297210693f);
    case 9 * 32 + 3:
      return make_float2(-0.5f, 0.8660253882408142f);
    case 9 * 32 + 4:
      return make_float2(-0.9396926164627075f, 0.3420201539993286f);
    case 11 * 32 + 1:
      return make_float2(0.8412535190582275f, 0.5406408309936523f);
    case 11 * 32 + 2:
      return make_float2(0.4154150187969208f, 0.9096319675445557f);
    case 11 * 32 + 3:
      return make_float2(-0.1423148363828659f, 0.9898214340209961f);
    case 11 * 32 + 4:
      return make_float2(-0.6548607349395752f, 0.7557495832443237f);
    case 11 * 32 + 5:
      return make_float2(-0.9594929814338684f, 0.28173255920410156f);
    case 13 * 32 + 1:
      return make_float2(0.8854560256004333f, 0.4647231698036194f);
    case 13 * 32 + 2:
      return make_float2(0.5680647492408752f, 0.8229838609695435f);
    case 13 * 32 + 3:
      return make_float2(0.1205366775393486f, 0.9927088618278503f);
    case 13 * 32 + 4:
      return make_float2(-0.35460489988327026f, 0.9350162148475647f);
    case 13 * 32 + 5:
      return make_float2(-0.7485107779502869f, 0.6631226539611816f);
    case 13 * 32 + 6:
      return make_float2(-0.9709418416023254f, 0.23931565880775452f);
    case 15 * 32 + 1:
      return make_float2(0.9135454297065735f, 0.4067366421222687f);
    case 15 * 32 + 2:
      return make_float2(0.6691306233406067f, 0.7431448101997375f);
    case 15 * 32 + 3:
      return make_float2(0.30901700258255005f, 0.9510565400123596f);
    case 15 * 32 + 4:
      return make_float2(-0.10452846437692642f, 0.9945219159126282f);
    case 15 * 32 + 5:
      return make_float2(-0.5f, 0.8660253882408142f);
    case 15 * 32 + 6:
      return make_float2(-0.80901700258255f, 0.5877852439880371f);
    case 15 * 32 + 7:
      return make_float2(-0.9781476259231567f, 0.2079116851091385f);
    case 17 * 32 + 1:
      return make_float2(0.9324722290039062f, 0.3612416684627533f);
    case 17 * 32 + 2:
      return make_float2(0.739008903503418f, 0.6736956238746643f);
    case 17 * 32 + 3:
      return make_float2(0.4457383453845978f, 0.8951632976531982f);
    case 17 * 32 + 4:
      return make_float2(0.09226836264133453f, 0.9957341551780701f);
    case 17 * 32 + 5:
      return make_float2(-0.2736629843711853f, 0.9618256688117981f);
    case 17 * 32 + 6:
      return make_float2(-0.602634608745575f, 0.7980172038078308f);
    case 17 * 32 + 7:
      return make_float2(-0.8502171635627747f, 0.5264321565628052f);
    case 17 * 32 + 8:
      return make_float2(-0.9829730987548828f, 0.1837495118379593f);
    case 19 * 32 + 1:
      return make_float2(0.945817232131958f, 0.3246994614601135f);
    case 19 * 32 + 2:
      return make_float2(0.789140522480011f, 0.614212691783905f);
    case 19 * 32 + 3:
      return make_float2(0.5469481348991394f, 0.8371664881706238f);
    case 19 * 32 + 4:
      return make_float2(0.24548548460006714f, 0.9694002866744995f);
    case 19 * 32 + 5:
      return make_float2(-0.0825793445110321f, 0.9965844750404358f);
    case 19 * 32 + 6:
      return make_float2(-0.4016954302787781f, 0.915773332118988f);
    case 19 * 32 + 7:
      return make_float2(-0.6772815585136414f, 0.7357239127159119f);
    case 19 * 32 + 8:
      return make_float2(-0.8794737458229065f, 0.47594738006591797f);
    case 19 * 32 + 9:
      return make_float2(-0.9863613247871399f, 0.1645945906639099f);
    case 21 * 32 + 1:
      return make_float2(0.955572783946991f, 0.29475516080856323f);
    case 21 * 32 + 2:
      return make_float2(0.826238751411438f, 0.5633200407028198f);
    case 21 * 32 + 3:
      return make_float2(0.6234897971153259f, 0.7818315029144287f);
    case 21 * 32 + 4:
      return make_float2(0.36534103751182556f, 0.9308737516403198f);
    case 21 * 32 + 5:
      return make_float2(0.07473009079694748f, 0.9972038269042969f);
    case 21 * 32 + 6:
      return make_float2(-0.22252093255519867f, 0.9749279022216797f);
    case 21 * 32 + 7:
      return make_float2(-0.5f, 0.8660253882408142f);
    case 21 * 32 + 8:
      return make_float2(-0.7330518960952759f, 0.6801727414131165f);
    case 21 * 32 + 9:
      return make_float2(-0.9009688496589661f, 0.4338837265968323f);
    case 21 * 32 + 10:
      return make_float2(-0.9888308048248291f, 0.1490422636270523f);
    case 23 * 32 + 1:
      return make_float2(0.9629172682762146f, 0.269796758890152f);
    case 23 * 32 + 2:
      return make_float2(0.8544194102287292f, 0.5195839405059814f);
    case 23 * 32 + 3:
      return make_float2(0.6825531721115112f, 0.7308359742164612f);
    case 23 * 32 + 4:
      return make_float2(0.4600650370121002f, 0.8878852128982544f);
    case 23 * 32 + 5:
      return make_float2(0.20345601439476013f, 0.9790840744972229f);
    case 23 * 32 + 6:
      return make_float2(-0.06824241578578949f, 0.9976687431335449f);
    case 23 * 32 + 7:
      return make_float2(-0.334879606962204f, 0.9422609210014343f);
    case 23 * 32 + 8:
      return make_float2(-0.5766803026199341f, 0.8169698715209961f);
    case 23 * 32 + 9:
      return make_float2(-0.7757112979888916f, 0.6310879588127136f);
    case 23 * 32 + 10:
      return make_float2(-0.9172112941741943f, 0.39840108156204224f);
    case 23 * 32 + 11:
      return make_float2(-0.9906859397888184f, 0.13616664707660675f);
    default:
      return make_float2(1.f, 0.f);
  }
}

// The forward DFT of O points (odd O = 3 ... 23) in the symmetric pair
// form: a_j = u_j + u_(O-j), d_j = u_j - u_(O-j) for j = 1 ... H = O/2,
// and with theta = 2 pi j k / O, for k = 1 ... H,
//   X_k = u_0 + sum_j a_j cos(theta) - i sum_j d_j sin(theta),
//   X_(O-k) = the same with + i,
// 2 H^2 real-by-complex products where the plain sum takes (O-1)^2 complex
// ones. load(j) gives u_j (each once); emit(k, X_k) takes each output as
// soon as it is formed, so that only the a_j and d_j stay in registers.
template <int O, typename Load, typename Emit>
__device__ __forceinline__ void dft_odd(const Load& load, const Emit& emit) {
  constexpr int H = O / 2;
  float2 a[H], d[H];
  const float2 u0 = load(0);
  float2 x0 = u0;
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    const float2 p = load(j);
    const float2 q = load(O - j);
    a[j - 1] = cadd(p, q);
    d[j - 1] = csub(p, q);
    x0 = cadd(x0, a[j - 1]);
  }
  emit(0, x0);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 A = u0;
    float2 B = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int t = (j * k) % O;
      const float2 w = odd_w(O, t <= H ? t : O - t);
      const float s = t <= H ? w.y : -w.y;
      A = make_float2(fmaf(a[j - 1].x, w.x, A.x), fmaf(a[j - 1].y, w.x, A.y));
      B = make_float2(fmaf(d[j - 1].x, s, B.x), fmaf(d[j - 1].y, s, B.y));
    }
    emit(k, make_float2(A.x + B.y, A.y - B.x));      // A - i B
    emit(O - k, make_float2(A.x - B.y, A.y + B.x));  // A + i B
  }
}

struct Swizzle {
  int x1, y1, x2, y2;
};

// The barrier of an exchange: every thread of the block
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The barrier of the exchanges of a line FFT that a thread-block cluster
// exchanges again afterwards (fft_stages.cu's stage 2 and axis_fft.cu's
// col_cluster_kernel at long lines): the whole block, and after the last
// exchange (its buffer read back, so free) the CTA's arrival at the
// cluster barrier, which the kernel waits on before it writes into other
// CTAs' buffers
struct ArriveAfterLastExchange {
  mutable int left;  // block barriers until the arrival
  __device__ __forceinline__ void operator()() const {
    __syncthreads();
    if (--left == 0) {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    }
  }
};

// Address `addr` of this CTA's shared memory mapped into CTA `rank` of
// the cluster, and a 4-byte store there (32-bit shared::cluster
// addresses: a generic pointer per store took two registers more); the
// exchanges of the column clusters (axis_fft.cu's col_cluster_kernel,
// fft_stages.cu's stage1_cluster_kernel)
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(r)
      : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// Physical word of logical word a in the exchange buffer (see the note)
__device__ __forceinline__ int swizzle(int a, Swizzle sw) {
  const int h = a >> 5;
  return a ^ ((((h >> sw.x1) << sw.y1) ^ ((h >> sw.x2) << sw.y2)) & 31);
}

// One radix-R pass over the E points the thread holds (v[s] = point
// ti + s*tpl). Not the last pass: exchange through shared memory, where
// point k of the thread's line is logical word line0 + k*kstride.
template <int E, int R, typename Sync>
__device__ __forceinline__ void radix_pass(float2 (&v)[E], int ti, int tpl,
                                           int ns,
                                           const float2* __restrict__ tw,
                                           bool last, float* sre, float* sim,
                                           int line0, int kstride,
                                           Swizzle sw, const Sync& sync) {
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
  sync();
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int a = swizzle(line0 + (ti + s * tpl) * kstride, sw);
    v[s] = make_float2(sre[a], sim[a]);
  }
  sync();
}

// The whole line FFT: v holds points ti + s*tpl of the thread's line on
// entry and their DFT, in the same places, on exit. Every thread that
// sync waits for must call it (it synchronises between passes).
template <int E, typename Sync = BlockSync>
__device__ __forceinline__ void line_fft(float2 (&v)[E], int ti, int tpl,
                                         const RadixPlan& p,
                                         const float2* __restrict__ tab,
                                         float* sre, float* sim, int line0,
                                         int kstride,
                                         const Sync& sync = Sync()) {
  for (int s = 0; s < p.npass; ++s) {
    const bool last = s == p.npass - 1;
    const float2* tw = tab + p.tw_off[s];
    const int ns = p.ns[s];
    const Swizzle sw{p.sw[s][0], p.sw[s][1], p.sw[s][2], p.sw[s][3]};
    switch (p.radix[s]) {
      case 16:
        if constexpr (E >= 16)
          radix_pass<E, 16>(v, ti, tpl, ns, tw, last, sre, sim, line0,
                            kstride, sw, sync);
        break;
      case 8:
        if constexpr (E >= 8)
          radix_pass<E, 8>(v, ti, tpl, ns, tw, last, sre, sim, line0,
                           kstride, sw, sync);
        break;
      case 4:
        if constexpr (E >= 4)
          radix_pass<E, 4>(v, ti, tpl, ns, tw, last, sre, sim, line0,
                           kstride, sw, sync);
        break;
      default:
        radix_pass<E, 2>(v, ti, tpl, ns, tw, last, sre, sim, line0, kstride,
                         sw, sync);
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
