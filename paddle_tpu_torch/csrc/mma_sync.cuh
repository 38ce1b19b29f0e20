// Warp-level tensor-core helpers shared by the kernels that multiply 16-bit
// tiles with mma.sync (csrc/dequant_matmul.cu, csrc/grouped_gemm.cu,
// csrc/paged_attention.cu, csrc/ragged_paged_attention.cu):
// ldmatrix loads, the m16n8k16 product with f32 accumulation, and the exact
// conversion of int8 byte pairs to 16-bit pairs. Internal linkage: each
// library keeps its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

// two or four 8x8 16-bit matrices from shared memory, lane i giving the
// address of row i % 8 of matrix i / 8 (and .trans: each matrix transposed)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&a)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(a[0]), "=r"(a[1])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c += a b, m16n8k16, 16-bit operands of type XT, f32 accumulation
template <typename XT>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes 0 and 2 of `p` (int8 values, the other bytes ignored) as a pair of
// 16-bit values, exactly: for bf16, (0x4300 | (b & 0x7f)) - (0x4300 | (b &
// 0x80)) = 128 + (b & 127) minus 128 or 256; for f16, (0x6400 | (b ^
// 0x80)) - 0x6480
template <typename XT>
__device__ __forceinline__ uint32_t int8_pair(uint32_t p);
template <>
__device__ __forceinline__ uint32_t int8_pair<__nv_bfloat16>(uint32_t p) {
  const uint32_t hi = (p & 0x007F007Fu) | 0x43004300u;   // 128 + (b & 127)
  const uint32_t lo = (p & 0x00800080u) | 0x43004300u;   // 128 or 256
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
              *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&d);
}
template <>
__device__ __forceinline__ uint32_t int8_pair<__half>(uint32_t p) {
  const uint32_t v = ((p & 0x00FF00FFu) ^ 0x00800080u) | 0x64006400u;
  const uint32_t c = 0x64806480u;                        // 1152
  const __half2 d = __hsub2(*reinterpret_cast<const __half2*>(&v),
                            *reinterpret_cast<const __half2*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

}  // namespace
