// Tiled products over ragged row groups for Hopper (sm_90a), shared by the
// grouped GEMM (float and int8 weights, csrc/grouped_gemm.cu) and the int8
// dequant matmul (csrc/dequant_matmul.cu, whose 16-bit x has a kernel of its
// own there; f32 x and the general instance come from here).
//
// One function covers all three: E groups of C rows each, x [E*C, K] row-major,
// weights w [E, K, N] and out y [E*C, N]. Group e owns rows [e*C, (e+1)*C), of
// which the first rows_e = clip(gs[e], 0, C) are real (gs == nullptr: all C).
//   y[e*C + i] = x[e*C + i] @ W[e]   for i < rows_e,   0 elsewhere,
// where W is w itself (float weights, read through strides) or the int8
// weights dequantized with per-block f32 scales [E, ceil(K/B), N]:
//   W[e][k][n] = q[e][k][n] * scales[e][k / B][n]
// (the last block is ragged where B does not divide K).
//
// Two instances, picked by one rule in paddle_tpu_torch/ops/_tile_gemm.py
// (`gemm_instance`):
//
//   tile     bf16 or f32 x, K % 8 == 0, N % 8 == 0; int8 blocks that are a
//            multiple of 32 and N % 16 == 0; w with a unit stride along K or
//            N. The kernels below: grid (N / 128, C / 32, E), one block of
//            128 threads per 32 x 128 out tile. A tile whose first row is at
//            or past rows_e writes zeros and reads nothing else, so the dead
//            rows of dropless routing (E*C rows, n*k real) cost only the zero
//            writes. Rows at or past rows_e inside a live tile read zeros and
//            are written as zeros. The K loop walks 32-deep tiles in order.
//            bf16 x (the serving path): a ring of cp.async copies keeps 3
//            (bf16 weights) or 7 (int8) tiles in flight per block while one
//            computes; each landed weight tile is converted once into the
//            MMA's layout. f32 x: double-buffered through registers.
//   general  everything else: f32, f16 or bf16 x, any K, N >= 1, any block
//            B >= 1, float weights through any strides (`gen_kernel`).
//
// Every out element is one sum over K in one fixed order, whatever M, C or
// the tile's other rows are: an out row depends on its own x row only, bit
// for bit, which the serving engine's exactness rests on.
//
// Numbers. bf16 x on the tile instance: bf16 tensor-core products (mma.sync
// m16n8k16) with f32 accumulators; a bf16 x bf16 product is exact in f32.
// f32 x, and the general instance: f32 FMAs on the CUDA cores, no TF32.
// int8 weights: int8 values are exact in bf16 and f32, so x multiplies the
// raw q; the partial sum of a scale block (B rows of K) is kept apart and
// added as acc += partial * scale[n] when the block ends. That is the
// reference's f32 sum of x * (q * scale) with the scale factored out of each
// block: f32-grade, not bitwise.
//
// Bound. At the serving shapes (rows per group <= 64) each live tile streams
// its 32 x 128 weight tiles from device memory once per row tile, so the
// weight bytes bound it; the design keeps one weight read per row tile,
// enough bytes in flight to cover the memory latency, and skips dead groups
// entirely. A narrow grid splits K over blocks (`split_count`). Left for
// later: TMA and wgmma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The including library names the namespace of its copy of these kernels
// (`grouped_gemm`, `dequant_matmul`), so that a profile tells them apart.
#ifndef TILE_GEMM_NS
#error "define TILE_GEMM_NS before including tile_gemm.cuh"
#endif

namespace TILE_GEMM_NS {
// internal linkage: each library that includes this header keeps its own
// kernels and its own launch state (an inline function's static would
// otherwise be one symbol shared by every loaded library)
namespace {

constexpr int kBM = 32;             // rows per block
constexpr int kBN = 128;            // columns per block
constexpr int kBK = 32;             // depth of one K tile
constexpr int kThreads = 128;       // 4 warps
constexpr int kLdH = kBK + 8;       // bf16 smem row stride: 80 B, 16-B aligned
constexpr int kLdF = kBK + 1;       // f32 smem row stride: conflict-free columns

enum WKind { kWeightFloat = 0, kWeightInt8 = 1 };

struct Args {
  const void* x;          // [E*C, K], the x type
  const void* w;          // float kinds: strided [E, K, N] in the x type;
                          // int8: contiguous [E, K, N]
  const float* scales;    // int8 only: [E, ceil(K/B), N]
  const int* gs;          // [E] real rows per group, nullptr = C
  void* y;                // [E*C, N], the x type
  int C, K, N, block;     // block: scale rows per block (int8 only)
  long long w_se, w_sk, w_sn;  // element strides of w
  int splits;             // K splits (bf16 x only; 1 = none)
  float* partial;         // splits > 1: [splits, E*C, N] f32 scratch
  int* tickets;           // splits > 1: [E, C tiles, N tiles], zeroed
};

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ int live_rows(const Args& a, int e) {
  const int r = a.gs ? a.gs[e] : a.C;
  return min(max(r, 0), a.C);
}

// zeros over out rows [r0, r1) of group e, columns [n0, n0 + kBN) clipped to N
template <typename XT>
__device__ void zero_rows(const Args& a, int e, int r0, int r1, int n0) {
  XT* y = reinterpret_cast<XT*>(a.y) + (size_t)e * a.C * a.N;
  const int nc = min(kBN, a.N - n0);
  for (int i = threadIdx.x; i < (r1 - r0) * nc; i += kThreads)
    y[(size_t)(r0 + i / nc) * a.N + n0 + i % nc] = from_f<XT>(0.f);
}

// ---------------------------------------------------------------------------
// f32 x: each K tile is staged into registers, then into shared memory as
// As[row][k] (x) and Bs[n][k] (weights, n-major so both operands are read
// along k)
// ---------------------------------------------------------------------------

// x tile: 32 rows x 32 k, 16-byte vectors of 4 (K % 8 == 0)
struct XLoadF32 {
  static constexpr int kN = kBM * kBK / 4 / kThreads;          // 2
  uint4 r[kN];
  __device__ void fetch(const Args& a, int e, int m0, int rows, int k0) {
    const float* x =
        reinterpret_cast<const float*>(a.x) + (size_t)e * a.C * a.K;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kBK / 4), kc = (idx % (kBK / 4)) * 4;
      const bool ok = m0 + row < rows && k0 + kc < a.K;
      r[i] = ok ? *reinterpret_cast<const uint4*>(
                      x + (size_t)(m0 + row) * a.K + k0 + kc)
                : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int LD>
  __device__ void stash(float (*As)[LD]) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kBK / 4), kc = (idx % (kBK / 4)) * 4;
      const float* v = reinterpret_cast<const float*>(&r[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) As[row][kc + j] = v[j];
    }
  }
};

// f32 weight tile: 32 k x 128 n, N-contiguous (w_sn == 1) or K-contiguous
// (w_sk == 1: the transposed weight of the backward)
struct WLoadF32 {
  static constexpr int kN = kBK * kBN / 4 / kThreads;          // 8
  uint4 r[kN];
  __device__ void fetch(const Args& a, int e, int n0, int k0) {
    const float* w = reinterpret_cast<const float*>(a.w) + (size_t)e * a.w_se;
    const bool n_major = a.w_sn == 1;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int k = n_major ? idx / (kBN / 4) : (idx % (kBK / 4)) * 4;
      const int n = n_major ? (idx % (kBN / 4)) * 4 : idx / (kBK / 4);
      const bool ok = k0 + k < a.K && n0 + n < a.N;
      r[i] = ok ? *reinterpret_cast<const uint4*>(
                      w + (size_t)(k0 + k) * a.w_sk + (size_t)(n0 + n) * a.w_sn)
                : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int LD>
  __device__ void stash(const Args& a, float (*Bs)[LD]) const {
    const bool n_major = a.w_sn == 1;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const float* v = reinterpret_cast<const float*>(&r[i]);
      const int k = n_major ? idx / (kBN / 4) : (idx % (kBK / 4)) * 4;
      const int n = n_major ? (idx % (kBN / 4)) * 4 : idx / (kBK / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n_major)
          Bs[n + j][k] = v[j];
        else
          Bs[n][k + j] = v[j];
      }
    }
  }
};

// int8 weight tile: 32 k x 128 n of a contiguous [K, N] int8 matrix, 16 values
// a vector (N % 16 == 0), converted exactly to f32
struct WLoadInt8F32 {
  static constexpr int kN = kBK * kBN / 16 / kThreads;         // 2
  uint4 r[kN];
  __device__ void fetch(const Args& a, int e, int n0, int k0) {
    const int8_t* w = reinterpret_cast<const int8_t*>(a.w) +
                      (size_t)e * a.K * a.N;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int k = idx / (kBN / 16), n = (idx % (kBN / 16)) * 16;
      const bool ok = k0 + k < a.K && n0 + n < a.N;
      r[i] = ok ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * a.N +
                                                  n0 + n)
                : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int LD>
  __device__ void stash(const Args&, float (*Bs)[LD]) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int k = idx / (kBN / 16), n = (idx % (kBN / 16)) * 16;
      const int8_t* v = reinterpret_cast<const int8_t*>(&r[i]);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[n + j][k] = (float)v[j];
    }
  }
};

template <int WK>
struct WLoadOf {
  using T = WLoadF32;
};
template <>
struct WLoadOf<kWeightInt8> {
  using T = WLoadInt8F32;
};

// does the scale block end with K tile t? (B % kBK == 0; the last block
// may be ragged, K % B != 0, and ends with the last tile `nk - 1`)
__device__ __forceinline__ bool block_ends(const Args& a, int t, int nk) {
  return ((t + 1) * kBK) % a.block == 0 || t + 1 == nk;
}

__device__ __forceinline__ float scale_at(const Args& a, int e, int t, int n) {
  const int kb = (t * kBK) / a.block, nb = (a.K + a.block - 1) / a.block;
  return a.scales[((size_t)e * nb + kb) * a.N + n];
}

// ---------------------------------------------------------------------------
// bf16 x: tensor-core tiles. Warp w owns columns [32 w, 32 w + 32) of the
// block's tile and both 16-row halves: 2 x 4 mma tiles of 16 x 8.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes global -> shared, bypassing L1; a false `valid` fills zeros
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The ring of K tiles in flight: deep for int8 (a tile is 4 KB), shallower
// for bf16 weights (8 KB a tile).
template <int WK>
struct Ring {
  static constexpr int kStages = 8;
  static constexpr int kRaw = kBK * kBN;          // int8 [32 k][128 n]
};
template <>
struct Ring<kWeightFloat> {
  static constexpr int kStages = 4;
  static constexpr int kRaw = kBK * kBN * 2;      // bf16 [32][128] or [128][32]
};

// dynamic shared memory of mma_kernel<WK>: the x ring, the raw weight ring,
// then one converted weight tile Bs[kBN][kLdH]
template <int WK>
constexpr int mma_smem_bytes() {
  return Ring<WK>::kStages * (kBM * kLdH * 2 + Ring<WK>::kRaw) +
         kBN * kLdH * 2;
}

template <int WK>
__global__ void __launch_bounds__(kThreads) mma_kernel(Args a) {
  using XT = __nv_bfloat16;
  constexpr int S = Ring<WK>::kStages, kRaw = Ring<WK>::kRaw;
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<XT(*)[kBM][kLdH]>(smem);
  unsigned char* raw = smem + S * kBM * kLdH * 2;
  auto Bs = reinterpret_cast<XT(*)[kLdH]>(raw + S * kRaw);
  __shared__ int last_split;
  const int ks = blockIdx.z % a.splits, e = blockIdx.z / a.splits;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = live_rows(a, e);
  if (m0 >= rows) {  // dead tile: zeros, no weight read
    if (ks == 0) zero_rows<XT>(a, e, m0, min(m0 + kBM, a.C), n0);
    return;
  }
  // this split's K tiles [t0, t1): whole scale blocks (int8) or K tiles
  const int unit = WK == kWeightInt8 ? a.block : kBK;
  const int n_units = (a.K + unit - 1) / unit;
  const int t0 = ks * n_units / a.splits * unit / kBK;
  const int t1 =
      (min((ks + 1) * n_units / a.splits * unit, a.K) + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bool n_major = a.w_sn == 1;
  const XT* x = reinterpret_cast<const XT*>(a.x) + (size_t)e * a.C * a.K;
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = part[mi][ni][q] = 0.f;

  // Raw weight tiles keep the global layout, 16-byte chunks XOR-swizzled
  // by (row & 7) so that the conversion pass reads them without bank
  // conflicts: int8 and N-contiguous bf16 rows are one k each; the
  // K-contiguous (transposed) bf16 tile is [128 n][32 k], read in order.
  auto fetch = [&](int t) {
    if (t < t1) {
      const int st = (t - t0) % S, k0 = t * kBK;
      {
        const int row = tid >> 2, kc = (tid & 3) * 8;
        const bool ok = m0 + row < rows && k0 + kc < a.K;
        cp_async16(&As[st][row][kc],
                   ok ? x + (size_t)(m0 + row) * a.K + k0 + kc : x, ok);
      }
      unsigned char* dst = raw + st * kRaw;
      if (WK == kWeightInt8) {
        const int8_t* w = reinterpret_cast<const int8_t*>(a.w) +
                          (size_t)e * a.K * a.N;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = tid + i * kThreads, k = idx >> 3, c = idx & 7;
          const bool ok = k0 + k < a.K && n0 + c * 16 < a.N;
          cp_async16(dst + k * kBN + ((c ^ (k & 7)) * 16),
                     ok ? w + (size_t)(k0 + k) * a.N + n0 + c * 16 : w, ok);
        }
      } else {
        const XT* w = reinterpret_cast<const XT*>(a.w) + (size_t)e * a.w_se;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = tid + i * kThreads;
          if (n_major) {
            const int k = idx >> 4, c = idx & 15;
            const bool ok = k0 + k < a.K && n0 + c * 8 < a.N;
            cp_async16(dst + (k * kBN + ((c ^ (k & 7)) * 8)) * 2,
                       ok ? w + (size_t)(k0 + k) * a.w_sk + n0 + c * 8 : w,
                       ok);
          } else {
            const int n = idx >> 2, kc = (idx & 3) * 8;
            const bool ok = k0 + kc < a.K && n0 + n < a.N;
            cp_async16(dst + (n * kBK + kc) * 2,
                       ok ? w + (size_t)(n0 + n) * a.w_sn + k0 + kc : w, ok);
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count even
  };

  // raw tile -> Bs[n][k] in bf16 (int8 converts exactly); lane = k for the
  // k-per-row layouts, so the 2-byte stores of a warp hit one row
  auto convert = [&](int st) {
    const unsigned char* src = raw + st * kRaw;
    if (WK == kWeightInt8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = lane, c = warp * 2 + i;
        const uint4 v = *reinterpret_cast<const uint4*>(
            src + k * kBN + ((c ^ (k & 7)) * 16));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          Bs[c * 16 + j][k] = __float2bfloat16((float)b[j]);
      }
    } else if (n_major) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = lane, c = warp * 4 + i;
        const uint4 v = *reinterpret_cast<const uint4*>(
            src + (k * kBN + ((c ^ (k & 7)) * 8)) * 2);
        const XT* b = reinterpret_cast<const XT*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[c * 8 + j][k] = b[j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kThreads, n = idx >> 2, kc = (idx & 3) * 8;
        *reinterpret_cast<uint4*>(&Bs[n][kc]) =
            *reinterpret_cast<const uint4*>(src + (n * kBK + kc) * 2);
      }
    }
  };

#pragma unroll 1
  for (int t = t0; t < t0 + S - 1; ++t) fetch(t);
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % S;
    cp_async_wait<S - 2>();  // this thread's copies of tile t have landed
    __syncthreads();         // everyone's have; tile t - 1 is consumed
    fetch(t + S - 1);        // into the stage tile t - 1 used
    convert(st);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = mi * 16 + g, c = kk + tig * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][c + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp * 32 + ni * 8 + g, c = kk + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(part[mi][ni], af[mi], b0, b1);
      }
    }
    if (WK == kWeightInt8 && block_ends(a, t, t1)) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + warp * 32 + ni * 8 + tig * 2;
        const float s0 = n < a.N ? scale_at(a, e, t, n) : 0.f;
        const float s1 = n + 1 < a.N ? scale_at(a, e, t, n + 1) : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][0] = fmaf(part[mi][ni][0], s0, acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(part[mi][ni][1], s1, acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(part[mi][ni][2], s0, acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(part[mi][ni][3], s1, acc[mi][ni][3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  float(&res)[2][4][4] = WK == kWeightInt8 ? acc : part;
  const int r_end = min(m0 + kBM, a.C);

  if (a.splits > 1) {
    // Each split leaves its f32 sums of the live rows in the scratch; the
    // block that finishes last adds them in split order (fixed, whatever
    // the rows) and writes the tile.
    const size_t rows_all = (size_t)(gridDim.z / a.splits) * a.C;
    auto slot = [&](int j, int r, int n) {
      return a.partial + ((size_t)j * rows_all + (size_t)e * a.C + r) * a.N + n;
    };
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mi * 16 + g + h * 8;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + warp * 32 + ni * 8 + tig * 2;
          if (r < rows && n < a.N)
            *reinterpret_cast<float2*>(slot(ks, r, n)) =
                make_float2(res[mi][ni][2 * h], res[mi][ni][2 * h + 1]);
        }
      }
    __threadfence();
    __syncthreads();
    const int tile = (e * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (tid == 0)
      last_split = atomicAdd(&a.tickets[tile], 1) == a.splits - 1;
    __syncthreads();
    if (!last_split) return;
    __threadfence();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mi * 16 + g + h * 8;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + warp * 32 + ni * 8 + tig * 2;
          float2 sum = make_float2(0.f, 0.f);
          if (r < rows && n < a.N) {
            sum = __ldcg(reinterpret_cast<const float2*>(slot(0, r, n)));
            for (int j = 1; j < a.splits; ++j) {
              const float2 v =
                  __ldcg(reinterpret_cast<const float2*>(slot(j, r, n)));
              sum.x += v.x;
              sum.y += v.y;
            }
          }
          res[mi][ni][2 * h] = sum.x;
          res[mi][ni][2 * h + 1] = sum.y;
        }
      }
    if (tid == 0) a.tickets[tile] = 0;  // ready for the next call
  }

  XT* y = reinterpret_cast<XT*>(a.y) + (size_t)e * a.C * a.N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mi * 16 + g + h * 8;
      if (r >= r_end) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + warp * 32 + ni * 8 + tig * 2;
        if (n >= a.N) continue;  // N % 8 == 0: the pair is whole
        const bool live = r < rows;
        __nv_bfloat162 v;
        v.x = __float2bfloat16(live ? res[mi][ni][2 * h] : 0.f);
        v.y = __float2bfloat16(live ? res[mi][ni][2 * h + 1] : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * a.N + n) = v;
      }
    }
}

// ---------------------------------------------------------------------------
// f32 x: CUDA-core FMAs. Thread (tx, ty) = (tid % 32, tid / 32) owns rows
// 8 ty .. 8 ty + 7 and columns tx + 32 j (j < 4).
// ---------------------------------------------------------------------------

template <int WK>
__global__ void __launch_bounds__(kThreads) fma_kernel(Args a) {
  using XT = float;
  __shared__ __align__(16) float As[2][kBM][kLdF];
  __shared__ __align__(16) float Bs[2][kBN][kLdF];
  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = live_rows(a, e);
  if (m0 >= rows) {
    zero_rows<XT>(a, e, m0, min(m0 + kBM, a.C), n0);
    return;
  }
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[8][4], part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  XLoadF32 xl;
  typename WLoadOf<WK>::T wl;
  const int nk = (a.K + kBK - 1) / kBK;
  xl.fetch(a, e, m0, rows, 0);
  wl.fetch(a, e, n0, 0);
  xl.stash(As[0]);
  wl.stash(a, Bs[0]);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) {
      xl.fetch(a, e, m0, rows, (t + 1) * kBK);
      wl.fetch(a, e, n0, (t + 1) * kBK);
    }
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[buf][ty * 8 + i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[buf][tx + 32 * j][k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    if (WK == kWeightInt8 && block_ends(a, t, nk)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 32 * j;
        const float s = n < a.N ? scale_at(a, e, t, n) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(part[i][j], s, acc[i][j]);
          part[i][j] = 0.f;
        }
      }
    }
    if (t + 1 < nk) {
      xl.stash(As[buf ^ 1]);
      wl.stash(a, Bs[buf ^ 1]);
    }
    __syncthreads();
  }

  float* y = reinterpret_cast<float*>(a.y) + (size_t)e * a.C * a.N;
  const int r_end = min(m0 + kBM, a.C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 8 + i;
    if (r >= r_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 32 * j;
      const float o = WK == kWeightInt8 ? acc[i][j] : part[i][j];
      if (n < a.N) y[(size_t)r * a.N + n] = r < rows ? o : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// The general instance: every x type (f32, f16, bf16), any K, N >= 1, any
// scale block B >= 1, float weights through any strides. Scalar loads into
// 32 x 16 (x) and 16 x 64 (weight) f32 tiles; thread (tx, ty) = (tid % 32,
// tid / 32) owns rows 4 ty .. 4 ty + 3 and columns tx, tx + 32 of the
// block's 32 x 64 out tile. Every product is an f32 FMA (never TF32), one
// fixed K order per out element; an int8 block's partial is scaled at the
// block's last row, wherever that falls in a tile.
// ---------------------------------------------------------------------------

constexpr int kGenM = 32, kGenN = 64, kGenK = 16, kGenThreads = 256;

template <typename XT, int WK>
__global__ void __launch_bounds__(kGenThreads) gen_kernel(Args a) {
  __shared__ float As[kGenM][kGenK + 1];
  __shared__ float Bs[kGenK][kGenN + 1];
  const int e = blockIdx.z, m0 = blockIdx.y * kGenM, n0 = blockIdx.x * kGenN;
  const int rows = live_rows(a, e);
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  XT* y = reinterpret_cast<XT*>(a.y) + (size_t)e * a.C * a.N;
  const int r_end = min(m0 + kGenM, a.C);
  if (m0 >= rows) {  // dead tile: zeros, no weight read
    const int nc = min(kGenN, a.N - n0);
    for (int i = tid; i < (r_end - m0) * nc; i += kGenThreads)
      y[(size_t)(m0 + i / nc) * a.N + n0 + i % nc] = from_f<XT>(0.f);
    return;
  }
  const XT* x = reinterpret_cast<const XT*>(a.x) + (size_t)e * a.C * a.K;
  const int nb = (a.K + a.block - 1) / max(a.block, 1);
  float acc[4][2], part[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = part[i][j] = 0.f;
  for (int k0 = 0; k0 < a.K; k0 += kGenK) {
    for (int i = tid; i < kGenM * kGenK; i += kGenThreads) {
      const int r = i / kGenK, kk = i % kGenK;
      As[r][kk] = m0 + r < rows && k0 + kk < a.K
                      ? to_f(x[(size_t)(m0 + r) * a.K + k0 + kk])
                      : 0.f;
    }
    for (int i = tid; i < kGenK * kGenN; i += kGenThreads) {
      const int kk = i / kGenN, n = i % kGenN;
      float v = 0.f;
      if (k0 + kk < a.K && n0 + n < a.N) {
        if (WK == kWeightInt8)
          v = (float)reinterpret_cast<const int8_t*>(
              a.w)[((size_t)e * a.K + k0 + kk) * a.N + n0 + n];
        else
          v = to_f(reinterpret_cast<const XT*>(a.w)[
              e * a.w_se + (k0 + kk) * a.w_sk + (long long)(n0 + n) * a.w_sn]);
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
    const int kn = min(kGenK, a.K - k0);
    for (int kk = 0; kk < kn; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          part[i][j] = fmaf(As[ty * 4 + i][kk], Bs[kk][tx + 32 * j], part[i][j]);
      const int k = k0 + kk;
      if (WK == kWeightInt8 && ((k + 1) % a.block == 0 || k + 1 == a.K)) {
        const float* srow = a.scales + ((size_t)e * nb + k / a.block) * a.N;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + tx + 32 * j;
          const float s = n < a.N ? srow[n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j] = fmaf(part[i][j], s, acc[i][j]);
            part[i][j] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= r_end) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx + 32 * j;
      const float o = WK == kWeightInt8 ? acc[i][j] : part[i][j];
      if (n < a.N) y[(size_t)r * a.N + n] = from_f<XT>(r < rows ? o : 0.f);
    }
  }
}

// dtype codes of the C entries
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// instance codes: the tile kernels above, or the general one
enum Instance { kTileInstance = 0, kGeneralInstance = 1 };

template <typename XT>
void launch_general(const Args& a, int E, int wk, cudaStream_t s) {
  const dim3 grid((a.N + kGenN - 1) / kGenN, (a.C + kGenM - 1) / kGenM, E);
  if (wk == kWeightInt8)
    gen_kernel<XT, kWeightInt8><<<grid, kGenThreads, 0, s>>>(a);
  else
    gen_kernel<XT, kWeightFloat><<<grid, kGenThreads, 0, s>>>(a);
}

// Launch the product for groups of x type `dtype` (the weight kind `wk`) on
// `stream` through `instance`; returns the cudaGetLastError() code of the
// launch, or cudaErrorInvalidValue for a geometry the instance does not take
// (the tile instance: bf16 or f32 x, K % 8 == 0, N % 8 == 0, int8 blocks
// that are multiples of 32 and N % 16 == 0, a unit stride of w along K or N;
// the general instance: any K, N >= 1 and block >= 1).
inline int launch(const Args& a, int E, int dtype, int wk, int instance,
                  void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (E <= 0 || a.C <= 0 || a.K <= 0 || a.N <= 0)
    return (int)cudaErrorInvalidValue;
  if (wk == kWeightInt8 && (a.block <= 0 || !a.scales))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (instance == kGeneralInstance) {
    if (dtype == kF32)
      launch_general<float>(a, E, wk, s);
    else if (dtype == kBF16)
      launch_general<__nv_bfloat16>(a, E, wk, s);
    else if (dtype == kF16)
      launch_general<__half>(a, E, wk, s);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (instance != kTileInstance || a.K % 8 || a.N % 8)
    return (int)cudaErrorInvalidValue;
  if (wk == kWeightInt8 && (a.block % kBK || a.N % 16))
    return (int)cudaErrorInvalidValue;
  if (wk == kWeightFloat && a.w_sn != 1 && a.w_sk != 1)
    return (int)cudaErrorInvalidValue;
  if (a.splits < 1 || (a.splits > 1 && (dtype != kBF16 || !a.partial ||
                                        !a.tickets)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.C + kBM - 1) / kBM,
                  E * a.splits);
  if (dtype == kBF16) {
    // above 48 KB of shared memory a kernel must ask for it once
    static bool sized[2] = {false, false};
    constexpr int kI8 = mma_smem_bytes<kWeightInt8>();
    constexpr int kF = mma_smem_bytes<kWeightFloat>();
    if (!sized[wk]) {
      cudaError_t rc =
          wk == kWeightInt8
              ? cudaFuncSetAttribute(mma_kernel<kWeightInt8>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kI8)
              : cudaFuncSetAttribute(mma_kernel<kWeightFloat>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kF);
      if (rc != cudaSuccess) return (int)rc;
      sized[wk] = true;
    }
    if (wk == kWeightInt8)
      mma_kernel<kWeightInt8><<<grid, kThreads, kI8, s>>>(a);
    else
      mma_kernel<kWeightFloat><<<grid, kThreads, kF, s>>>(a);
  } else if (dtype == kF32) {
    if (wk == kWeightInt8)
      fma_kernel<kWeightInt8><<<grid, kThreads, 0, s>>>(a);
    else
      fma_kernel<kWeightFloat><<<grid, kThreads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace TILE_GEMM_NS
