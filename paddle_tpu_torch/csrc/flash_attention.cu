// Flash attention forward and backward (dQ, dK/dV) with GQA, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py: the forward
// `_fwd_kernel` (pallas_call at :155), the dQ kernel `_bwd_dq_kernel` (:279)
// and the dK/dV kernel `_bwd_dkv_kernel` (:299).
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, Hk, D], read through their (batch,
// seq, head) strides with unit stride along D (no transposes on the host);
// query head h reads kv head h / (H / Hk). Outputs are contiguous: out and
// dq [B, Sq, H, D], dk/dv [B, Sk, Hk, D] in the inputs' dtype, lse [B, H, Sq]
// f32. Causal alignment is bottom-right: query i sees keys j <= i + (Sk - Sq).
// Both sequence lengths are multiples of 128.
//
// Two instances of each kernel; ops/flash_attention.py picks one by dtype
// and head_dim (one rule, `kernel_instance`), and the C entries refuse any
// other pairing:
//
//   tensor-core  bf16 at D 64 or 128.
//     forward  wgmma + TMA: one block per (128 q rows, head, batch), longest
//              causal rows first; two consumer warpgroups of 64 q rows and
//              a producer warpgroup, one lane of which issues the copies
//              (setmaxnreg moves registers by warpgroups: the producer
//              drops to 24, the consumers rise to 240). The producer loads
//              Q once and keeps rings of 2 stages of 128-key K tiles and of
//              V tiles full through TMA (4-D tensor maps over the strided
//              tensors, 128-byte swizzle, mbarriers). S = Q K^T is wgmma m64n128k16
//              with both operands K-major in shared memory and the f32
//              accumulator in registers; the online softmax runs on those
//              registers (row max by quad shuffles, exp2 with
//              scale * log2(e) folded in, the reference's finite -1e30 mask
//              on the diagonal tile only); P is split in registers into bf16
//              hi + lo and fed as the register A operand of two wgmma
//              m64nDk16 per 16 keys against V read transposed (MN-major)
//              from shared memory; O stays in registers for the whole key
//              loop. Each warpgroup issues tile j's S before tile j-1's
//              P V and runs tile j's softmax while P V is in flight. The epilogue stages O / l as bf16 in shared memory and
//              stores 16-byte rows; lse = m + log l.
//     dK/dV    wgmma + TMA: one block per (128 keys, kv head, batch), key
//              tile 0 first; a producer warpgroup loads K and V once and
//              keeps a ring of Q / dO tiles of 64 query rows (with their lse
//              and delta) full, over the group's query heads and the q tiles
//              from the causal start; two consumer warpgroups of 64 keys
//              each compute S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16,
//              f32 in registers), the elementwise backward in registers,
//              and dV += P^T dO, dK += dS^T Q with P^T and dS^T split into
//              bf16 hi + lo as the register A operand and dO, Q read
//              transposed; dK and dV stay in registers across the group (no
//              atomics). See the note above flash_dkv_wgmma.
//     dQ       wgmma + TMA, the forward's structure with one product more:
//              one block per (128 q rows, head, batch), longest causal rows
//              first; the producer warpgroup loads Q and dO once (with lse
//              and delta) and keeps rings of 64-key K and V tiles full; two
//              consumer warpgroups of 64 q rows compute S = Q K^T and dP =
//              dO V^T (wgmma m64n64k16, f32 in registers), the elementwise
//              backward in registers, and dQ += dS K with dS split into
//              bf16 hi + lo as the register A operand and K read transposed
//              from the box S read K-major; tile j's S and dP are issued
//              with tile j-1's dQ product. See the note above
//              flash_dq_wgmma.
//   general      every other (dtype, D) of the reference's domain: f32, f16
//              and bf16 (read as 16-bit, computed in f32), any D % 8 == 0 up
//              to 256, padded with zeros to a multiple of 16 in shared
//              memory. The same three kernels on 32-row tiles with 256
//              threads; each thread owns 2 x 2 scores and 2 rows x D/16
//              output columns in registers; every product is an f32 FMA
//              (never TF32).
//
// P and dS are f32 values the bf16 products need in bf16: each is split into
// hi = bf16(x) and lo = bf16(x - hi) and multiplied twice, so the products
// see ~16 bits of mantissa and the kernels agree with the f32 plain version
// to f32 summation order (the bf16 inputs are exact operands).
//
// Bound. At training shapes (S = 2048, D = 128) the kernels are bound by
// operations: 4 D flops per unmasked (query, key) pair forward, 6 D for dQ,
// 8 D for dK/dV, against 989 TFLOP/s of dense bf16 (67 TFLOP/s of f32 for
// the general instance); the bytes (q, k, v, dO and the outputs, once each)
// are far below that line.
//
// What is left on the table: the split doubles the forward's P V product,
// the masked half of each diagonal tile is computed, and the two consumer
// warpgroups are not ordered against each other (no ping-pong of one's
// softmax against the other's products). dK/dV waits for each product
// before the next (a warpgroup's S^T / dP^T and its dV / dK products do not
// overlap; the two warpgroups overlap each other). dQ computes its diagonal
// 64 x 64 tiles whole and masks them; it splits dS as the others split P.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;      // the reference's finite mask value

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head
};

template <typename K>
int prepare(K kernel, size_t smem) {
  // above 48 KB only after an explicit opt-in; a refused launch never runs
  // and is reported only by cudaGetLastError
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// Forward, bf16 at D 64 / 128: wgmma + TMA (replaces _fwd, pallas_call :155)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRows = 128;       // q rows of a block, keys of a K/V tile
constexpr int kConsumers = 2;    // warpgroups of 64 q rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kStages = 2;       // K/V tiles in flight
constexpr int kBox = 64;         // bf16 columns of one 128-byte swizzled box
constexpr int kBoxBytes = kRows * kBox * 2;      // one [128][64] box: 16 KB
constexpr float kLn2 = 0.69314718055994531f;
// registers a thread after the split: the launch gives 168 to each of the
// 384 threads (65536 / 384); 2 x 128 x 240 + 128 x 24 is the same file
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// shared memory: Q [D/64 boxes of 128 x 64], then a ring of kStages K tiles
// and a ring of kStages V tiles in the same box layout, then the mbarriers;
// the base is aligned to 1024 bytes (the 128-byte swizzle repeats every 8
// rows)
template <int D>
struct Smem {
  static constexpr int kTile = kRows * D * 2;
  static constexpr int kK = kTile;                       // K stage s at +s
  static constexpr int kV = kK + kStages * kTile;        // V stage s at +s
  // k_full, k_empty, v_full, v_empty (kStages each), q
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (4 * kStages + 1) + 1024;
  static constexpr int kLdStage = D + 8;                 // epilogue rows
  static_assert(kConsumers * 64 * kLdStage * 2 <= kStages * kTile,
                "the epilogue stages in the K ring");
};

// one [128 rows][64 columns] box of a [B, S, heads, D] tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a shared-memory matrix descriptor with the 128-byte swizzle; `lbo` and
// `sbo` in bytes (K-major: sbo = 8 rows; MN-major: lbo = the next 64
// columns, sbo = the next 8 rows of K)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64] (+)= A[64 x 16] B[16 x 128], both operands K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] (+)= A[64 x 16] B[16 x 64], both operands K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A[64 x 16] B[16 x 64]: A from registers (bf16x2 a[4]), B
// MN-major in shared memory (read transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A[64 x 16] B[16 x 128]: A from registers (bf16x2 a[4]), B
// MN-major in shared memory (read transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, b);
  } else {
    wgmma_rs_n64(o, a, b);
  }
}

// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup owns rows
// 16w + lane/4 (+8); register i holds row +8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * (lane & 3) + (i & 1). Registers 8kk..8kk+7 of S are
// the A fragment of keys 16kk..16kk+15 for P V, two values a register.
//
// The key loop is software-pipelined inside each warpgroup: tile j's
// S = Q K_j is issued, then tile j-1's O += P V_{j-1}; the softmax of S_j
// runs while that product is on the tensor cores, and O is rescaled by
// tile j's alpha once it has landed. K and V have rings (and barriers) of
// their own, so K_j's slot frees when S_j is done and V_j's when P V_j is.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ out, float* __restrict__ lse, int H,
                    int Hk, int Sq, int Sk, int causal, float scale_log2) {
  using SM = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_full = base + SM::kBar, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;
  const uint32_t q_bar = v_empty + 8 * kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * kRows, offset = Sk - Sq;
  // keys past the block's last query are all masked; the last tile is the
  // diagonal one (S and the offset are multiples of 128)
  const int n_kt = causal ? (q0 + offset) / kRows + 1 : Sk / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128 * kConsumers);
      mbar_init(v_empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer warpgroup: one lane keeps the K and V rings full through
    // TMA; the warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(q_bar, SM::kTile);
      for (int c = 0; c < D / kBox; ++c)
        tma_load(q_s + c * kBoxBytes, &tq, q_bar, c * kBox, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t parity = ((kt / kStages) & 1) ^ 1;
        const uint32_t k_s = base + SM::kK + s * SM::kTile;
        const uint32_t v_s = base + SM::kV + s * SM::kTile;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, SM::kTile);
        for (int c = 0; c < D / kBox; ++c)
          tma_load(k_s + c * kBoxBytes, &tk, k_full + 8 * s, c * kBox, hk,
                   kt * kRows, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, SM::kTile);
        for (int c = 0; c < D / kBox; ++c)
          tma_load(v_s + c * kBoxBytes, &tv, v_full + 8 * s, c * kBox, hk,
                   kt * kRows, b);
      }
    }
    return;
  }

  // consumers: warpgroup `grp` owns q rows 64 grp .. 64 grp + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int grp = warp >> 2;
  const int row = grp * 64 + (warp & 3) * 16 + (lane >> 2);  // and row + 8
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float sc[64];
  uint32_t p_hi[8][4], p_lo[8][4];

  // S = Q K^T of tile kt: K-major operands, 16 columns of D (32 bytes) a
  // step; committed as one group
  auto issue_s = [&](int kt) {
    const int s = kt % kStages;
    mbar_wait(k_full + 8 * s, (kt / kStages) & 1);
    const uint32_t k_s = base + SM::kK + s * SM::kTile;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n128(sc, smem_desc(q_s + step + grp * 64 * 128, 16, 1024),
                    smem_desc(k_s + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P_hi V + P_lo V of tile kt: V MN-major (transposed), 16 keys a
  // step; committed as one group
  auto issue_pv = [&](int kt) {
    const int s = kt % kStages;
    mbar_wait(v_full + 8 * s, (kt / kStages) & 1);
    const uint32_t v_s = base + SM::kV + s * SM::kTile;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv<D>(o, p_hi[kk],
                  smem_desc(v_s + kk * 16 * 128, kBoxBytes, 1024));
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_pv<D>(o, p_lo[kk],
                  smem_desc(v_s + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit();
  };
  // the online softmax of tile kt on S in registers, in base 2 with the
  // scale folded in; the reference's finite -1e30 mask on the diagonal
  // tile only. Leaves P (f32) in sc and returns each row's rescale.
  auto softmax = [&](int kt, float (&alpha)[2]) {
    const bool diag = causal && kt == n_kt - 1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale_log2;
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (diag && col > row + 8 * ((i >> 1) & 1)) x = kNegInf;
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = exp2f(m[j] - mx[j]);
      m[j] = mx[j];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      ps[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + ps[j];
  };
  // P = hi + lo, both bf16, as the register A operand
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
        p_hi[kk][r] = pack_bf16(x0, x1);
        const __nv_bfloat162 hv =
            *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
        p_lo[kk][r] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
      }
    }
  };

  mbar_wait(q_bar, 0);
  float alpha[2];
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(k_empty);
  softmax(0, alpha);  // O is still zero: nothing to rescale
  split_p();
  for (int kt = 1; kt < n_kt; ++kt) {
    issue_s(kt);
    issue_pv(kt - 1);
    wgmma_wait<1>();  // S of tile kt has landed; P V of kt - 1 runs on
    fence_regs(sc);
    mbar_arrive(k_empty + 8 * (kt % kStages));
    softmax(kt, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_empty + 8 * ((kt - 1) % kStages));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    split_p();
  }
  issue_pv(n_kt - 1);
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(v_empty + 8 * ((n_kt - 1) % kStages));

  // epilogue: O / l to bf16, staged in the K ring once both warpgroups are
  // done with every tile, then stored as 16-byte rows
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  named_sync(1, 128 * kConsumers);
  bf16* stage = reinterpret_cast<bf16*>(smem + SM::kK) +
                grp * 64 * SM::kLdStage;
  const int r0 = row - grp * 64;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hr = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(stage + (r0 + 8 * hr) * SM::kLdStage + col) =
        pack_bf16(o[i] / l[hr], o[i + 1] / l[hr]);
  }
  named_sync(2 + grp, 128);
  const int t = threadIdx.x - grp * 128;
  bf16* dst = out + (((long long)b * Sq + q0 + grp * 64) * H + h) * D;
  for (int v = t; v < 64 * D / 8; v += 128) {
    const int r = v / (D / 8), c = (v - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (long long)r * H * D + c) =
        *reinterpret_cast<const uint4*>(stage + r * SM::kLdStage + c);
  }
  if ((lane & 3) == 0) {
    float* lrow = lse + ((long long)b * H + h) * Sq + q0;
    lrow[row] = m[0] * kLn2 + logf(l[0]);
    lrow[row + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

// a 4-D map (D, heads, S, B) of a bf16 [B, S, heads, D] tensor read through
// its strides, [rows][64 columns] boxes with the 128-byte swizzle
int tensor_map(CUtensorMap* map, const void* ptr, Strides st, int D,
               int heads, int S, int B, int rows = kRows) {
  const EncodeTiled encode = encoder();
  if (!encode) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1},
                   elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int D>
int forward(const void* q, const void* k, const void* v, void* out, void* lse,
            Strides qs, Strides ks, Strides vs, int B, int H, int Hk, int Sq,
            int Sk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (int e = tensor_map(&tq, q, qs, D, H, Sq, B)) return e;
  if (int e = tensor_map(&tk, k, ks, D, Hk, Sk, B)) return e;
  if (int e = tensor_map(&tv, v, vs, D, Hk, Sk, B)) return e;
  const size_t smem = Smem<D>::kBytes;
  if (int e = prepare(flash_fwd_wgmma<D>, smem)) return e;
  const float log2e = 1.4426950408889634f;
  flash_fwd_wgmma<D><<<dim3(Sq / kRows, H, B), kThreads, smem, stream>>>(
      tq, tk, tv, (bf16*)out, (float*)lse, H, Hk, Sq, Sk, causal,
      scale * log2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dK/dV, bf16 at D 64 / 128: wgmma + TMA (replaces _bwd's dK/dV kernel,
// pallas_call :299)
//
// One block per (128 keys, kv head, batch), key tile 0 (the most causal work)
// scheduled first. The producer warpgroup loads the block's K and V tiles
// once and keeps a ring of kBwdStages stages full, each the Q and dO rows of
// one 64-query tile of one query head with their 64 lse and delta values;
// the stages run over the group's query heads and, for each, the q tiles
// from the causal start, in one fixed order. Consumer warpgroup `grp` owns
// keys 64 grp .. 64 grp + 63 and, per stage:
//   S^T = K Q^T and dP^T = V dO^T   wgmma m64n64k16, both operands K-major
//                                   from the swizzled boxes, f32 in registers
//   P^T = exp2(S^T scale log2e - lse log2e), the causal mask on tiles that
//   cross the diagonal; dS^T = P^T (dP^T - delta) scale, in registers (lse
//   and delta read from the stage by the accumulator's column)
//   dV += P^T dO, dK += dS^T Q       P^T and dS^T split into bf16 hi + lo as
//                                   the register A operand of wgmma m64nDk16,
//                                   dO and Q read MN-major (transposed) from
//                                   the same boxes
// dK and dV stay in registers for the whole group (no atomics: the output
// is the same bit for bit from run to run) and leave through shared memory
// as 16-byte rows.
// ---------------------------------------------------------------------------
constexpr int kQRows = 64;                      // query rows of a stage
constexpr int kBwdStages = 2;                   // Q/dO stages in flight
constexpr int kQBoxBytes = kQRows * kBox * 2;   // one [64][64] box: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: K and V [D/64 boxes of 128 x 64], the ring of stages (Q then
// dO, D/64 boxes of 64 x 64 each), the stages' lse and delta rows, then the
// mbarriers; the base is aligned to 1024 bytes
template <int D>
struct BwdSmem {
  static constexpr int kKV = kRows * D * 2;       // K (V at +kKV)
  static constexpr int kQ = kQRows * D * 2;       // a Q (or dO) tile
  static constexpr int kRing = 2 * kKV;           // stage s at +2 kQ s
  static constexpr int kRowsAt = kRing + kBwdStages * 2 * kQ;  // [s][2][64]
  static constexpr int kBar = kRowsAt + kBwdStages * 2 * kQRows * 4;
  // full, empty (kBwdStages each), then K/V
  static constexpr int kBytes = kBar + 8 * (2 * kBwdStages + 1) + 1024;
  static constexpr int kLdStage = D + 8;          // epilogue rows
  static_assert(4 * 64 * kLdStage * 2 <= kRowsAt,
                "dK and dV stage in the tiles and the ring");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Hk, int Sq, int Sk,
                    int causal, float scale) {
  using SM = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + SM::kKV;
  const uint32_t full = base + SM::kBar, empty = full + 8 * kBwdStages;
  const uint32_t kv_bar = empty + 8 * kBwdStages;
  const float* rows_s = reinterpret_cast<const float*>(smem + SM::kRowsAt);

  const int kt = blockIdx.y;
  const int hk = blockIdx.x % Hk, b = blockIdx.x / Hk;
  const int G = H / Hk, k0 = kt * kRows, offset = Sk - Sq;
  // q tiles whose last query precedes this key tile never see it
  const int qt0 = causal ? max(0, (k0 - offset) / kQRows) : 0;
  const int n_qt = Sq / kQRows - qt0, n_it = G * n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer warpgroup: one lane loads K and V, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * SM::kKV);
      for (int c = 0; c < D / kBox; ++c) {
        tma_load(k_s + c * kBoxBytes, &tk, kv_bar, c * kBox, hk, k0, b);
        tma_load(v_s + c * kBoxBytes, &tv, kv_bar, c * kBox, hk, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kBwdStages;
        const int h = hk * G + it / n_qt, q0 = (qt0 + it % n_qt) * kQRows;
        const uint32_t q_st = base + SM::kRing + s * 2 * SM::kQ;
        const uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(bar, 2 * SM::kQ + 2 * kQRows * 4);
        for (int c = 0; c < D / kBox; ++c) {
          tma_load(q_st + c * kQBoxBytes, &tq, bar, c * kBox, h, q0, b);
          tma_load(q_st + SM::kQ + c * kQBoxBytes, &tdo, bar, c * kBox, h, q0,
                   b);
        }
        const long long row = ((long long)b * H + h) * Sq + q0;
        const uint32_t r_s = base + SM::kRowsAt + s * 2 * kQRows * 4;
        bulk_load(r_s, lse + row, kQRows * 4, bar);
        bulk_load(r_s + kQRows * 4, delta + row, kQRows * 4, bar);
      }
    }
    return;
  }

  // consumers: warpgroup `grp` owns keys 64 grp .. 64 grp + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int grp = warp >> 2;
  const int key = grp * 64 + (warp & 3) * 16 + (lane >> 2);  // and key + 8
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[32], dpt[32];
  uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kBwdStages;
    const int q0 = (qt0 + it % n_qt) * kQRows;
    const uint32_t q_st = base + SM::kRing + s * 2 * SM::kQ;
    const uint32_t do_st = q_st + SM::kQ;
    mbar_wait(full + 8 * s, (it / kBwdStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 16 columns of D (32 bytes) a step
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * kBoxBytes + (kk & 3) * 32 + grp * 64 * 128;
      const uint32_t bq = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(st, smem_desc(k_s + a, 16, 1024),
                   smem_desc(q_st + bq, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * kBoxBytes + (kk & 3) * 32 + grp * 64 * 128;
      const uint32_t bq = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(dpt, smem_desc(v_s + a, 16, 1024),
                   smem_desc(do_st + bq, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // the elementwise backward: rows are keys, columns queries
    const float* lse_s = rows_s + s * 2 * kQRows;
    const float* dl_s = lse_s + kQRows;
    const bool diag = causal && k0 + grp * 64 + 63 > q0 + offset;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float p = exp2f(fmaf(st[i], scale_log2, -lse_s[col] * kLog2e));
      if (diag && k0 + key + 8 * ((i >> 1) & 1) > q0 + col + offset) p = 0.f;
      dpt[i] = p * (dpt[i] - dl_s[col]) * scale;
      st[i] = p;
    }
    // P^T and dS^T = hi + lo, both bf16, as register A operands: registers
    // 8kk .. 8kk+7 hold queries 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        p_hi[kk][r] = pack_bf16(st[i], st[i + 1]);
        d_hi[kk][r] = pack_bf16(dpt[i], dpt[i + 1]);
        const __nv_bfloat162 ph =
            *reinterpret_cast<const __nv_bfloat162*>(&p_hi[kk][r]);
        const __nv_bfloat162 dh =
            *reinterpret_cast<const __nv_bfloat162*>(&d_hi[kk][r]);
        p_lo[kk][r] = pack_bf16(st[i] - __low2float(ph),
                                st[i + 1] - __high2float(ph));
        d_lo[kk][r] = pack_bf16(dpt[i] - __low2float(dh),
                                dpt[i + 1] - __high2float(dh));
      }
    }

    // dV += P^T dO, dK += dS^T Q: dO and Q MN-major, 16 queries a step
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = smem_desc(do_st + kk * 16 * 128, kQBoxBytes, 1024);
      wgmma_pv<D>(dv_acc, p_hi[kk], bd);
      wgmma_pv<D>(dv_acc, p_lo[kk], bd);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = smem_desc(q_st + kk * 16 * 128, kQBoxBytes, 1024);
      wgmma_pv<D>(dk_acc, d_hi[kk], bq);
      wgmma_pv<D>(dk_acc, d_lo[kk], bq);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(empty + 8 * s);
  }

  // epilogue: dK and dV to bf16, staged over the tiles once both
  // warpgroups are past their last stage, then stored as 16-byte rows
  named_sync(1, 128 * kConsumers);
  bf16* stage = reinterpret_cast<bf16*>(smem);   // dK [128][ld], dV after
  constexpr int ld = SM::kLdStage;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = key + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(stage + r * ld + col) =
        pack_bf16(dk_acc[i], dk_acc[i + 1]);
    *reinterpret_cast<uint32_t*>(stage + (kRows + r) * ld + col) =
        pack_bf16(dv_acc[i], dv_acc[i + 1]);
  }
  named_sync(2 + grp, 128);
  const int t = threadIdx.x - grp * 128;
  const long long off = (((long long)b * Sk + k0 + grp * 64) * Hk + hk) * D;
  for (int v = t; v < 64 * D / 8; v += 128) {
    const int r = v / (D / 8), c = (v - r * (D / 8)) * 8;
    const long long o = off + (long long)r * Hk * D + c;
    *reinterpret_cast<uint4*>(dk + o) =
        *reinterpret_cast<const uint4*>(stage + (grp * 64 + r) * ld + c);
    *reinterpret_cast<uint4*>(dv + o) = *reinterpret_cast<const uint4*>(
        stage + (kRows + grp * 64 + r) * ld + c);
  }
}

template <int D>
int backward_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, Strides qs, Strides ks, Strides vs,
                 Strides dos, int B, int H, int Hk, int Sq, int Sk,
                 int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (int e = tensor_map(&tq, q, qs, D, H, Sq, B, kQRows)) return e;
  if (int e = tensor_map(&tdo, dout, dos, D, H, Sq, B, kQRows)) return e;
  if (int e = tensor_map(&tk, k, ks, D, Hk, Sk, B)) return e;
  if (int e = tensor_map(&tv, v, vs, D, Hk, Sk, B)) return e;
  const size_t smem = BwdSmem<D>::kBytes;
  if (int e = prepare(flash_dkv_wgmma<D>, smem)) return e;
  flash_dkv_wgmma<D><<<dim3(Hk * B, Sk / kRows), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ, bf16 at D 64 / 128: wgmma + TMA (replaces _bwd's dQ kernel,
// pallas_call :279)
//
// One block per (128 q rows, head, batch), the longest causal rows first.
// The producer warpgroup loads the block's Q and dO once (128-row boxes)
// with their 128 lse and delta values, and keeps rings of kDqStages 64-key
// K tiles and V tiles full. Consumer warpgroup `grp` owns q rows 64 grp ..
// 64 grp + 63 and walks the keys its rows see, 64 a tile:
//   S = Q K^T and dP = dO V^T      wgmma m64n64k16, both operands K-major
//                                  from the swizzled boxes, f32 in registers
//   P = exp2(S scale log2e - lse log2e), the causal mask on the diagonal
//   tile (the last); dS = P (dP - delta), in registers
//   dQ += dS K                     dS split into bf16 hi + lo as the register
//                                  A operand of wgmma m64nDk16, K read
//                                  MN-major (transposed) from the same boxes
// Tile kt's S and dP are issued with tile kt-1's dQ product, and kt's
// elementwise backward runs while that product is in flight (K and V have
// rings and barriers of their own: V_kt frees when dP_kt is done, K_kt when
// dQ's product of kt is). dQ stays in registers (no atomics: two launches
// are equal bit for bit), is multiplied by the scale once, and leaves
// through shared memory as 16-byte rows.
// ---------------------------------------------------------------------------
constexpr int kDqStages = 3;                    // K (and V) tiles in flight

// shared memory: Q and dO [D/64 boxes of 128 x 64], the rings of K tiles and
// of V tiles [D/64 boxes of 64 x 64], lse and delta [128] each, then the
// mbarriers; the base is aligned to 1024 bytes
template <int D>
struct DqSmem {
  static constexpr int kQ = kRows * D * 2;       // Q, dO at +kQ
  static constexpr int kKV = kQRows * D * 2;     // one K or V tile
  static constexpr int kK = 2 * kQ;              // K stage s at +s kKV
  static constexpr int kV = kK + kDqStages * kKV;
  static constexpr int kRowsAt = kV + kDqStages * kKV;   // lse, delta
  static constexpr int kBar = kRowsAt + 2 * kRows * 4;
  // k_full, k_empty, v_full, v_empty (kDqStages each), q
  static constexpr int kBytes = kBar + 8 * (4 * kDqStages + 1) + 1024;
  static constexpr int kLdStage = D + 8;         // epilogue rows
  static_assert(kRows * kLdStage * 2 <= 2 * kQ, "dQ stages in Q and dO");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int H, int Hk, int Sq, int Sk, int causal, float scale) {
  using SM = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + SM::kQ;
  const uint32_t k_full = base + SM::kBar, k_empty = k_full + 8 * kDqStages;
  const uint32_t v_full = k_empty + 8 * kDqStages;
  const uint32_t v_empty = v_full + 8 * kDqStages;
  const uint32_t q_bar = v_empty + 8 * kDqStages;
  const float* rows_s = reinterpret_cast<const float*>(smem + SM::kRowsAt);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * kRows, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128 * kConsumers);
      mbar_init(v_empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer warpgroup: one lane loads Q, dO, lse and delta, then keeps
    // the K and V rings full through TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      // the keys of the block's last query: S and the offset are
      // multiples of 128
      const int n_kt = causal ? (q0 + offset) / kQRows + 2 : Sk / kQRows;
      mbar_expect_tx(q_bar, 2 * SM::kQ + 2 * kRows * 4);
      for (int c = 0; c < D / kBox; ++c) {
        tma_load(q_s + c * kBoxBytes, &tq, q_bar, c * kBox, h, q0, b);
        tma_load(do_s + c * kBoxBytes, &tdo, q_bar, c * kBox, h, q0, b);
      }
      const long long row = ((long long)b * H + h) * Sq + q0;
      bulk_load(base + SM::kRowsAt, lse + row, kRows * 4, q_bar);
      bulk_load(base + SM::kRowsAt + kRows * 4, delta + row, kRows * 4,
                q_bar);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        const uint32_t parity = ((kt / kDqStages) & 1) ^ 1;
        const uint32_t k_st = base + SM::kK + s * SM::kKV;
        const uint32_t v_st = base + SM::kV + s * SM::kKV;
        mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, SM::kKV);
        for (int c = 0; c < D / kBox; ++c)
          tma_load(k_st + c * kQBoxBytes, &tk, k_full + 8 * s, c * kBox, hk,
                   kt * kQRows, b);
        mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, SM::kKV);
        for (int c = 0; c < D / kBox; ++c)
          tma_load(v_st + c * kQBoxBytes, &tv, v_full + 8 * s, c * kBox, hk,
                   kt * kQRows, b);
      }
    }
    return;
  }

  // consumers: warpgroup `grp` owns q rows 64 grp .. 64 grp + 63; a
  // thread's rows are `row` and row + 8 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int grp = warp >> 2;
  const int row = (warp & 3) * 16 + (lane >> 2);
  // the group's last tile is its diagonal one; the producer's extra tile
  // (the other group's diagonal) is never waited on here
  const int n_kt =
      causal ? (q0 + grp * 64 + offset) / kQRows + 1 : Sk / kQRows;
  const float scale_log2 = scale * kLog2e;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float st[32], dpt[32];
  uint32_t d_hi[4][4], d_lo[4][4];

  mbar_wait(q_bar, 0);
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse_r[hr] = rows_s[grp * 64 + row + 8 * hr] * kLog2e;
    dl_r[hr] = rows_s[kRows + grp * 64 + row + 8 * hr];
  }

  // S = Q K^T and dP = dO V^T of tile kt, 16 columns of D (32 bytes) a
  // step; committed as one group
  auto issue_sdp = [&](int kt) {
    const int s = kt % kDqStages;
    const uint32_t parity = (kt / kDqStages) & 1;
    const uint32_t k_st = base + SM::kK + s * SM::kKV;
    const uint32_t v_st = base + SM::kV + s * SM::kKV;
    mbar_wait(k_full + 8 * s, parity);
    mbar_wait(v_full + 8 * s, parity);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * kBoxBytes + (kk & 3) * 32 + grp * 64 * 128;
      const uint32_t bk = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(st, smem_desc(q_s + a, 16, 1024),
                   smem_desc(k_st + bk, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * kBoxBytes + (kk & 3) * 32 + grp * 64 * 128;
      const uint32_t bk = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(dpt, smem_desc(do_s + a, 16, 1024),
                   smem_desc(v_st + bk, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += (dS_hi + dS_lo) K of tile kt: K MN-major, 16 keys a step
  auto issue_dq = [&](int kt) {
    const uint32_t k_st = base + SM::kK + (kt % kDqStages) * SM::kKV;
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = smem_desc(k_st + kk * 16 * 128, kQBoxBytes, 1024);
      wgmma_pv<D>(dq_acc, d_hi[kk], bk);
      wgmma_pv<D>(dq_acc, d_lo[kk], bk);
    }
    wgmma_commit();
  };
  // the elementwise backward of tile kt on the registers: rows are
  // queries, columns keys; leaves dS (f32) in dpt
  auto elementwise = [&](int kt) {
    const bool diag = causal && kt == n_kt - 1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float p = exp2f(fmaf(st[i], scale_log2, -lse_r[hr]));
      if (diag && col > row + 8 * hr) p = 0.f;
      dpt[i] = p * (dpt[i] - dl_r[hr]);
    }
  };
  // dS = hi + lo, both bf16, as the register A operand: registers 8kk ..
  // 8kk+7 hold keys 16kk .. 16kk+15
  auto split_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        d_hi[kk][r] = pack_bf16(dpt[i], dpt[i + 1]);
        const __nv_bfloat162 dh =
            *reinterpret_cast<const __nv_bfloat162*>(&d_hi[kk][r]);
        d_lo[kk][r] = pack_bf16(dpt[i] - __low2float(dh),
                                dpt[i + 1] - __high2float(dh));
      }
    }
  };

  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  mbar_arrive(v_empty);
  elementwise(0);
  split_ds();
  for (int kt = 1; kt < n_kt; ++kt) {
    issue_sdp(kt);
    issue_dq(kt - 1);
    wgmma_wait<1>();  // S and dP of tile kt have landed; dQ of kt - 1 runs
    fence_regs(st);
    fence_regs(dpt);
    mbar_arrive(v_empty + 8 * (kt % kDqStages));
    elementwise(kt);
    wgmma_wait<0>();
    fence_regs(dq_acc);
    mbar_arrive(k_empty + 8 * ((kt - 1) % kDqStages));
    split_ds();
  }
  issue_dq(n_kt - 1);
  wgmma_wait<0>();
  fence_regs(dq_acc);
  mbar_arrive(k_empty + 8 * ((n_kt - 1) % kDqStages));

  // epilogue: dQ scale to bf16, staged over Q and dO once both warpgroups
  // are done with every tile, then stored as 16-byte rows
  named_sync(1, 128 * kConsumers);
  constexpr int ld = SM::kLdStage;
  bf16* stage = reinterpret_cast<bf16*>(smem) + grp * 64 * ld;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = row + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(stage + r * ld + col) =
        pack_bf16(dq_acc[i] * scale, dq_acc[i + 1] * scale);
  }
  named_sync(2 + grp, 128);
  const int t = threadIdx.x - grp * 128;
  bf16* dst = dq + (((long long)b * Sq + q0 + grp * 64) * H + h) * D;
  for (int v = t; v < 64 * D / 8; v += 128) {
    const int r = v / (D / 8), c = (v - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (long long)r * H * D + c) =
        *reinterpret_cast<const uint4*>(stage + r * ld + c);
  }
}

template <int D>
int backward_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, Strides qs, Strides ks, Strides vs, Strides dos,
                int B, int H, int Hk, int Sq, int Sk, int causal, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (int e = tensor_map(&tq, q, qs, D, H, Sq, B)) return e;
  if (int e = tensor_map(&tdo, dout, dos, D, H, Sq, B)) return e;
  if (int e = tensor_map(&tk, k, ks, D, Hk, Sk, B, kQRows)) return e;
  if (int e = tensor_map(&tv, v, vs, D, Hk, Sk, B, kQRows)) return e;
  const size_t smem = DqSmem<D>::kBytes;
  if (int e = prepare(flash_dq_wgmma<D>, smem)) return e;
  flash_dq_wgmma<D><<<dim3(Sq / kRows, H, B), kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, H,
      Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}


}  // namespace wg

// ---------------------------------------------------------------------------
// The general instance: every other (dtype, D) of the domain (f32, f16, bf16;
// D % 8 == 0, D <= 256), forward, dQ and dK/dV, products in f32 FMAs
// ---------------------------------------------------------------------------
namespace gen {

constexpr int kTile = 32;     // q rows and keys of a tile
constexpr int kThreads = 256;
constexpr int kMaxCols = 16;  // output columns a thread owns: DP / 16
constexpr int kLdP = kTile + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [row0, row0 + 32) of head `head` of a strided [B, S, heads, D] tensor
// as f32 into a shared [32][DP + 1] tile, columns D..DP-1 zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st,
                                          int b, int row0, int head, int D,
                                          int DP) {
  const T* base = src + b * st.b + row0 * st.s + head * st.h;
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    dst[r * (DP + 1) + c] = c < D ? to_f32(base[r * st.s + c]) : 0.f;
  }
}

// 32 x 32 products of the thread's 2 rows (2ty, 2ty+1) of `a` and its 2
// rows (tx, tx + 16) of `b`, over DP (a multiple of 16) columns
__device__ __forceinline__ void dots(float (&acc)[2][2], const float* a,
                                     const float* b, int DP, int ty, int tx) {
  const float* a0 = a + 2 * ty * (DP + 1);
  const float* a1 = a0 + DP + 1;
  const float* b0 = b + tx * (DP + 1);
  const float* b1 = b0 + 16 * (DP + 1);
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
}

// acc[r][j] += sum_k p[2ty + r][k] x[k][tx + 16j], k over the 32 keys
__device__ __forceinline__ void accumulate(float (&acc)[2][kMaxCols],
                                           const float* p, const float* x,
                                           int DP, int ty, int tx) {
  for (int k = 0; k < kTile; ++k) {
    const float p0 = p[2 * ty * kLdP + k], p1 = p[(2 * ty + 1) * kLdP + k];
    const float* xr = x + k * (DP + 1) + tx;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (16 * j < DP) {
        acc[0][j] = fmaf(p0, xr[16 * j], acc[0][j]);
        acc[1][j] = fmaf(p1, xr[16 * j], acc[1][j]);
      }
    }
  }
}

// max / sum over the 16 lanes (tx) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           const float (&acc)[2][kMaxCols],
                                           const float (&div)[2], int D,
                                           int DP, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tx + 16 * j;
      if (16 * j < DP && c < D)
        out[(2 * ty + r) * row_stride + c] = from_f32<T>(acc[r][j] / div[r]);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
              int D, int DP, int H, int Hk, int Sq, int Sk, int causal,
              float scale) {
  extern __shared__ float fsm[];
  float* q_s = fsm;                       // [32][DP+1]
  float* k_s = q_s + kTile * (DP + 1);    // [32][DP+1]
  float* v_s = k_s + kTile * (DP + 1);    // [32][DP+1]
  float* p_s = v_s + kTile * (DP + 1);    // [32][33]
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * kTile, offset = Sk - Sq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_tile(q_s, q, qs, b, q0, h, D, DP);
  float acc[2][kMaxCols] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int n_kt = causal ? (q0 + kTile - 1 + offset) / kTile + 1
                          : Sk / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    load_tile(k_s, k, ks, b, k0, hk, D, DP);
    load_tile(v_s, v, vs, b, k0, hk, D, DP);
    __syncthreads();
    float s[2][2] = {};
    dots(s, q_s, k_s, DP, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + 2 * ty + r + offset;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x[c] = s[r][c] * scale;
        if (causal && k0 + tx + 16 * c > qpos) x[c] = kNegInf;
      }
      const float m_new = fmaxf(m[r], row_max(fmaxf(x[0], x[1])));
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      l[r] = l[r] * alpha + row_sum(p0 + p1);
      m[r] = m_new;
      p_s[(2 * ty + r) * kLdP + tx] = p0;
      p_s[(2 * ty + r) * kLdP + tx + 16] = p1;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();
    accumulate(acc, p_s, v_s, DP, ty, tx);
    __syncthreads();
  }
  store_rows(out + (((long long)b * Sq + q0) * H + h) * D, (long long)H * D,
             acc, l, D, DP, ty, tx);
  if (tx == 0) {
    float* lrow = lse + ((long long)b * H + h) * Sq + q0 + 2 * ty;
    lrow[0] = m[0] + logf(l[0]);
    lrow[1] = m[1] + logf(l[1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
             Strides dos, int D, int DP, int H, int Hk, int Sq, int Sk,
             int causal, float scale) {
  extern __shared__ float fsm[];
  float* q_s = fsm;
  float* do_s = q_s + kTile * (DP + 1);
  float* k_s = do_s + kTile * (DP + 1);
  float* v_s = k_s + kTile * (DP + 1);
  float* ds_s = v_s + kTile * (DP + 1);  // [32][33]
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * kTile, offset = Sk - Sq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_tile(q_s, q, qs, b, q0, h, D, DP);
  load_tile(do_s, dout, dos, b, q0, h, D, DP);
  const long long rb = ((long long)b * H + h) * Sq + q0 + 2 * ty;
  const float lse_r[2] = {lse[rb], lse[rb + 1]};
  const float dl_r[2] = {delta[rb], delta[rb + 1]};
  float acc[2][kMaxCols] = {};
  const int n_kt = causal ? (q0 + kTile - 1 + offset) / kTile + 1
                          : Sk / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    load_tile(k_s, k, ks, b, k0, hk, D, DP);
    load_tile(v_s, v, vs, b, k0, hk, D, DP);
    __syncthreads();
    float s[2][2] = {}, dp[2][2] = {};
    dots(s, q_s, k_s, DP, ty, tx);
    dots(dp, do_s, v_s, DP, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = tx + 16 * c;
        float p = 0.f;
        if (!causal || k0 + key <= q0 + 2 * ty + r + offset)
          p = expf(s[r][c] * scale - lse_r[r]);
        ds_s[(2 * ty + r) * kLdP + key] = p * (dp[r][c] - dl_r[r]) * scale;
      }
    __syncthreads();
    accumulate(acc, ds_s, k_s, DP, ty, tx);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dq + (((long long)b * Sq + q0) * H + h) * D, (long long)H * D,
             acc, one, D, DP, ty, tx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks,
              Strides vs, Strides dos, int D, int DP, int H, int Hk, int Sq,
              int Sk, int causal, float scale) {
  extern __shared__ float fsm[];
  float* k_s = fsm;
  float* v_s = k_s + kTile * (DP + 1);
  float* q_s = v_s + kTile * (DP + 1);
  float* do_s = q_s + kTile * (DP + 1);
  float* pt_s = do_s + kTile * (DP + 1);   // [32 keys][33]
  float* dst_s = pt_s + kTile * kLdP;      // [32 keys][33]
  float* lse_s = dst_s + kTile * kLdP;     // [32]
  float* dl_s = lse_s + kTile;             // [32]
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hk, k0 = kt * kTile, offset = Sk - Sq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_tile(k_s, k, ks, b, k0, hk, D, DP);
  load_tile(v_s, v, vs, b, k0, hk, D, DP);
  float dk_acc[2][kMaxCols] = {}, dv_acc[2][kMaxCols] = {};
  // q tiles whose last query precedes this k tile never see it
  const int qt0 = causal ? max(0, (k0 - offset) / kTile) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < Sq / kTile; ++qt) {
      const int q0 = qt * kTile;
      load_tile(q_s, q, qs, b, q0, h, D, DP);
      load_tile(do_s, dout, dos, b, q0, h, D, DP);
      const long long rb = ((long long)b * H + h) * Sq + q0;
      if (threadIdx.x < kTile) {
        lse_s[threadIdx.x] = lse[rb + threadIdx.x];
        dl_s[threadIdx.x] = delta[rb + threadIdx.x];
      }
      __syncthreads();
      // rows are keys (2ty, 2ty+1), columns queries (tx, tx+16)
      float st[2][2] = {}, dpt[2][2] = {};
      dots(st, k_s, q_s, DP, ty, tx);
      dots(dpt, v_s, do_s, DP, ty, tx);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = tx + 16 * c;
          float p = 0.f;
          if (!causal || k0 + 2 * ty + r <= q0 + qi + offset)
            p = expf(st[r][c] * scale - lse_s[qi]);
          pt_s[(2 * ty + r) * kLdP + qi] = p;
          dst_s[(2 * ty + r) * kLdP + qi] =
              p * (dpt[r][c] - dl_s[qi]) * scale;
        }
      __syncthreads();
      accumulate(dv_acc, pt_s, do_s, DP, ty, tx);
      accumulate(dk_acc, dst_s, q_s, DP, ty, tx);
      __syncthreads();
    }
  }
  const long long base = (((long long)b * Sk + k0) * Hk + hk) * D;
  const float one[2] = {1.f, 1.f};
  store_rows(dk + base, (long long)Hk * D, dk_acc, one, D, DP, ty, tx);
  store_rows(dv + base, (long long)Hk * D, dv_acc, one, D, DP, ty, tx);
}

inline int padded(int D) { return (D + 15) / 16 * 16; }
inline size_t tile_floats(int DP) { return (size_t)kTile * (DP + 1); }

template <typename T>
int forward(const void* q, const void* k, const void* v, void* out, void* lse,
            Strides qs, Strides ks, Strides vs, int D, int B, int H, int Hk,
            int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  const int DP = padded(D);
  const size_t smem = 4 * (3 * tile_floats(DP) + kTile * kLdP);
  if (int e = prepare(flash_fwd<T>, smem)) return e;
  flash_fwd<T><<<dim3(Sq / kTile, H, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, qs, ks, vs,
      D, DP, H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, Strides qs,
                Strides ks, Strides vs, Strides dos, int D, int B, int H,
                int Hk, int Sq, int Sk, int causal, float scale,
                cudaStream_t stream) {
  const int DP = padded(D);
  const size_t smem = 4 * (4 * tile_floats(DP) + kTile * kLdP);
  if (int e = prepare(flash_dq<T>, smem)) return e;
  flash_dq<T><<<dim3(Sq / kTile, H, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, qs, ks, vs, dos, D, DP,
      H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, Strides qs, Strides ks, Strides vs,
                 Strides dos, int D, int B, int H, int Hk, int Sq, int Sk,
                 int causal, float scale, cudaStream_t stream) {
  const int DP = padded(D);
  const size_t smem = 4 * (4 * tile_floats(DP) + 2 * kTile * kLdP + 2 * kTile);
  if (int e = prepare(flash_dkv<T>, smem)) return e;
  flash_dkv<T><<<dim3(Sk / kTile, Hk, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, qs, ks, vs, dos,
      D, DP, H, Hk, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace gen

}  // namespace
// C interface, loaded with ctypes. `instance` is 0 for the tensor-core
// kernels (bf16, head_dim 64 or 128) and 1 for the general ones; `dtype` is
// 0 bf16, 1 f16, 2 f32 (q/k/v/dout and the outputs alike); lse and delta are
// f32 [B, H, Sq]. Strides are (batch, seq, head) element strides of each
// input. Each entry launches on `stream`, does not synchronise, and returns
// the cudaGetLastError() code of its launch (0 on success), or
// cudaErrorInvalidValue for an (instance, dtype, head_dim) that no kernel
// takes.
extern "C" {

const char* fa_error_string(int code) { return tma_error_string(code); }

int fa_forward(int instance, int dtype, const void* q, const void* k,
               const void* v, void* out, void* lse, long long qsb,
               long long qss, long long qsh, long long ksb, long long kss,
               long long ksh, long long vsb, long long vss, long long vsh,
               int D, int B, int H, int Hk, int Sq, int Sk, int causal,
               float scale, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == 0 && dtype == 0 && D == 64)
    return wg::forward<64>(q, k, v, out, lse, qs, ks, vs, B, H, Hk, Sq, Sk,
                           causal, scale, st);
  if (instance == 0 && dtype == 0 && D == 128)
    return wg::forward<128>(q, k, v, out, lse, qs, ks, vs, B, H, Hk, Sq, Sk,
                            causal, scale, st);
  if (instance != 1 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gen::forward<bf16>(q, k, v, out, lse, qs, ks, vs, D, B, H, Hk, Sq,
                              Sk, causal, scale, st);
  if (dtype == 1)
    return gen::forward<__half>(q, k, v, out, lse, qs, ks, vs, D, B, H, Hk,
                                Sq, Sk, causal, scale, st);
  if (dtype == 2)
    return gen::forward<float>(q, k, v, out, lse, qs, ks, vs, D, B, H, Hk, Sq,
                               Sk, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int fa_backward_dq(int instance, int dtype, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, long long qsb, long long qss,
                   long long qsh, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, long long dsb,
                   long long dss, long long dsh, int D, int B, int H, int Hk,
                   int Sq, int Sk, int causal, float scale, void* stream) {
  (void)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == 0 && dtype == 0 && D == 64)
    return wg::backward_dq<64>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                               dos, B, H, Hk, Sq, Sk, causal, scale, st);
  if (instance == 0 && dtype == 0 && D == 128)
    return wg::backward_dq<128>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                dos, B, H, Hk, Sq, Sk, causal, scale, st);
  if (instance != 1 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gen::backward_dq<bf16>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                  dos, D, B, H, Hk, Sq, Sk, causal, scale, st);
  if (dtype == 1)
    return gen::backward_dq<__half>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                    dos, D, B, H, Hk, Sq, Sk, causal, scale,
                                    st);
  if (dtype == 2)
    return gen::backward_dq<float>(q, k, v, dout, lse, delta, dq, qs, ks, vs,
                                   dos, D, B, H, Hk, Sq, Sk, causal, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}

int fa_backward_dkv(int instance, int dtype, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, long long qsb,
                    long long qss, long long qsh, long long ksb,
                    long long kss, long long ksh, long long vsb,
                    long long vss, long long vsh, long long dsb,
                    long long dss, long long dsh, int D, int B, int H, int Hk,
                    int Sq, int Sk, int causal, float scale, void* stream) {
  (void)cudaGetLastError();
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == 0 && dtype == 0 && D == 64)
    return wg::backward_dkv<64>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos,
                            B, H, Hk, Sq, Sk, causal, scale, st);
  if (instance == 0 && dtype == 0 && D == 128)
    return wg::backward_dkv<128>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs,
                             dos, B, H, Hk, Sq, Sk, causal, scale, st);
  if (instance != 1 || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gen::backward_dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, qs, ks,
                                   vs, dos, D, B, H, Hk, Sq, Sk, causal,
                                   scale, st);
  if (dtype == 1)
    return gen::backward_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, qs,
                                     ks, vs, dos, D, B, H, Hk, Sq, Sk, causal,
                                     scale, st);
  if (dtype == 2)
    return gen::backward_dkv<float>(q, k, v, dout, lse, delta, dk, dv, qs, ks,
                                    vs, dos, D, B, H, Hk, Sq, Sk, causal,
                                    scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
