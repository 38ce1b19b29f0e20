// Hopper copy and barrier helpers shared by the kernels that stream tiles
// with TMA (csrc/flash_attention.cu, csrc/dequant_matmul.cu,
// csrc/fused_linear_cross_entropy.cu, csrc/grouped_gemm.cu,
// csrc/paged_attention.cu): shared-memory
// addresses, mbarriers, named barriers, 2-D and 3-D tensor maps and their
// loads, and
// cuTensorMapEncodeTiled found in libcuda at run time. Internal linkage: each
// library keeps its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// error codes of the tensor maps, past the CUDA runtime's own
constexpr int kErrNoEncoder = 10001;
constexpr int kErrTensorMap = 10002;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// cuTensorMapEncodeTiled from libcuda, found at run time (PyTorch has
// loaded it already), so the library links against nothing but cudart
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// one box of a 2-D tensor map at (column, row), completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// one box of a 3-D tensor map at (c0, c1, c2), innermost first, completing
// on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled needs a current context. A thread that has
// made no CUDA runtime call yet has none (autograd's device threads, where a
// backward's first launch encodes its maps before anything else), so the
// runtime binds the device's primary context once per thread first.
inline void bind_context() {
  static thread_local bool bound = false;
  if (!bound) {
    (void)cudaFree(nullptr);
    bound = true;
  }
}

// a 2-D map of a row-major [rows, cols] matrix (row stride `stride` bytes),
// [box_rows][box_cols] boxes with the given swizzle (128 bytes a box row for
// the 128-byte swizzle); out-of-range elements read as zeros
inline int map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                  int rows, int cols, long long stride, int box_rows,
                  int box_cols,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  bind_context();
  const EncodeTiled encode = encoder();
  if (!encode) return kErrNoEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// a 3-D map of a strided [d2, d1, d0] tensor (d0 contiguous; strides of
// dimensions 1 and 2 in bytes, multiples of 16), [1][box1][box0] boxes with
// the 128-byte swizzle; out-of-range elements read as zeros
inline int map_3d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                  long long d0, long long d1, long long d2, long long stride1,
                  long long stride2, int box0, int box1) {
  bind_context();
  const EncodeTiled encode = encoder();
  if (!encode) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)stride1, (cuuint64_t)stride2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

inline const char* tma_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (strides or "
           "alignment)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace
