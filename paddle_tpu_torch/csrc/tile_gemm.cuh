// Tiled products over ragged row groups for Hopper (sm_90a), shared by the
// grouped GEMM (float and int8 weights, csrc/grouped_gemm.cu) and the int8
// dequant matmul (csrc/dequant_matmul.cu): their f32 x and general instances
// (16-bit x has cluster instances of its own in each library).
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
// Two instances here, picked by one rule in paddle_tpu_torch/ops/_tile_gemm.py
// (`gemm_instance`):
//
//   tile     f32 x, K % 8 == 0, N % 8 == 0, with f32 weights read with a
//            unit stride along K or N, or int8 weights in blocks that are a
//            multiple of 32 and N % 16 == 0 (`fma_kernel`): grid (N / 128,
//            C / 32, E), one block of 128 threads per 32 x 128 out tile. A
//            tile whose first row is at or past rows_e writes zeros and reads
//            nothing else, so the dead rows of dropless routing (E*C rows,
//            n*k real) cost only the zero writes. Rows at or past rows_e
//            inside a live tile read zeros and are written as zeros. The K
//            loop walks 32-deep tiles in order, double-buffered through
//            registers. (16-bit x has kernels of its own: the cluster
//            instances of csrc/grouped_gemm.cu, float and int8 weights, and
//            of csrc/dequant_matmul.cu.)
//   general  everything else: f32, f16 or bf16 x, any K, N >= 1, any block
//            B >= 1, float weights through any strides (`gen_kernel`).
//
// Every out element is one sum over K in one fixed order, whatever M, C or
// the tile's other rows are: an out row depends on its own x row only, bit
// for bit, which the serving engine's exactness rests on.
//
// Numbers. f32 FMAs on the CUDA cores, no TF32. int8 weights: int8 values
// are exact in f32, so x multiplies the raw q; the partial sum of a scale
// block (B rows of K) is kept apart and added as acc += partial * scale[n]
// when the block ends. That is the reference's f32 sum of x * (q * scale)
// with the scale factored out of each block: f32-grade, not bitwise.
//
// Bound. At the serving shapes (rows per group <= 64) each live tile streams
// its 32 x 128 weight tiles from device memory once per row tile, so the
// weight bytes bound it; f32 x is off the serving and training paths (which
// run 16-bit x), so these instances stay simple.

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
// (the tile instance: f32 x, K % 8 == 0, N % 8 == 0, int8 blocks that are
// multiples of 32 and N % 16 == 0, a unit stride of w along K or N; the
// general instance: any K, N >= 1 and block >= 1).
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
  if (instance != kTileInstance || dtype != kF32 || a.K % 8 || a.N % 8)
    return (int)cudaErrorInvalidValue;
  if (wk == kWeightInt8 && (a.block % kBK || a.N % 16))
    return (int)cudaErrorInvalidValue;
  if (wk == kWeightFloat && a.w_sn != 1 && a.w_sk != 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.C + kBM - 1) / kBM, E);
  if (wk == kWeightInt8)
    fma_kernel<kWeightInt8><<<grid, kThreads, 0, s>>>(a);
  else
    fma_kernel<kWeightFloat><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace TILE_GEMM_NS
