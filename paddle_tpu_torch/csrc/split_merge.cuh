// The merge of a row's splits over the sequence, shared by the kernels that
// split the keys of a row over blocks and let the last split to finish merge
// the others' partial (acc, max, sum) rows in split order
// (csrc/paged_attention.cu, csrc/ragged_paged_attention.cu). The including
// file defines kNegInf and from_f32<T> first. Internal linkage: each library
// keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// x / l, 0 where l is 0 (a row that saw no key), or x as it is (partials:
// l < 0)
__device__ __forceinline__ float over(float x, float l) {
  return l < 0.f ? x : (l > 0.f ? x / l : 0.f);
}

// four f32 values to consecutive elements of T (16-byte aligned for f32)
template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c,
                                       float d) {
  dst[0] = from_f32<T>(a);
  dst[1] = from_f32<T>(b);
  dst[2] = from_f32<T>(c);
  dst[3] = from_f32<T>(d);
}
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// One warp merges the n splits of a row of D <= 256 values (partial rows
// prow, prow + stride, ...) into dst, in split order: lane j holds the (max,
// sum) of splits j, j + 32, ...; the columns walk the splits with the
// weights broadcast from their lanes. The partials come from other blocks:
// read past L1.
template <typename T>
__device__ __forceinline__ void merge_row(const float* part_o,
                                          const float* part_ml, T* dst,
                                          size_t prow, int stride, int n,
                                          int D, int lane) {
  auto row = [&](int s) { return prow + (size_t)s * stride; };
  float mmax = kNegInf;
  for (int s = lane; s < n; s += 32)
    mmax = fmaxf(mmax, __ldcg(part_ml + 2 * row(s)));
  for (int o = 16; o > 0; o >>= 1)
    mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, o));
  float lsum = 0.f;
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int s0 = 0; s0 < n; s0 += 32) {
    float w = 0.f, wl = 0.f;
    if (s0 + lane < n) {
      w = expf(__ldcg(part_ml + 2 * row(s0 + lane)) - mmax);
      wl = w * __ldcg(part_ml + 2 * row(s0 + lane) + 1);
    }
    for (int o = 16; o > 0; o >>= 1)
      wl += __shfl_xor_sync(0xffffffffu, wl, o);
    lsum += wl;
    const int m = n - s0 < 32 ? n - s0 : 32;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* src = part_o + row(s0 + j) * D;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d0 = 4 * lane + 128 * c;
        if (d0 < D) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(src + d0));
          acc[c].x += wj * x.x;
          acc[c].y += wj * x.y;
          acc[c].z += wj * x.z;
          acc[c].w += wj * x.w;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d0 = 4 * lane + 128 * c;
    if (d0 < D)
      store4(dst + d0, over(acc[c].x, lsum), over(acc[c].y, lsum),
             over(acc[c].z, lsum), over(acc[c].w, lsum));
  }
}

}  // namespace
