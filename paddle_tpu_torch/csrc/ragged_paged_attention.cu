// The ragged paged attention family for Hopper (sm_90a): a write kernel and
// two attention instances, each templated on rope, on int8 pools and on the
// model's dtype T (bf16, f16 or f32: q, the fresh K/V, the output and float
// pools), which replace six TPU kernels of
// paddle_tpu/ops/ragged_paged_attention.py:
//
//   TPU kernel (pallas_call at)           | write launch       | attention launch
//   #12 _fused_rope_kernel    (:1060)     | kv_write<1, 0, T>  | attention<1, 0, T>
//   #13 _fused_rope_kernel_q8 (:1133)     | kv_write<1, 1, T>  | attention<1, 1, T>
//   #11a _fused_kernel        (:921)      | kv_write<0, 0, T>  | attention<0, 0, T>
//   #11b _fused_kernel_q8     (:990)      | kv_write<0, 1, T>  | attention<0, 1, T>
//   #10 _ragged_kernel        (:368)      | -                  | attention<0, 0, T>
//   #9  _ragged_kernel_q8     (:328)      | -                  | attention<0, 1, T>
//
// The domain is the reference's: any page % 8 == 0, head_dim % 8 == 0 up to
// 256 (int8 pools too), GQA. ops/ragged_paged_attention.py picks the
// attention instance by one rule (`attention_instance`), and the C entry
// refuses a tensor-core launch outside it:
//   tensor-core  bf16 and f16 models at head_dim % 16 == 0 (namespace tc):
//                mma.sync on the tensor cores, the keys split over the
//                sequence, the last split of each tile merging them;
//   general      f32 models and other head_dims (ragged_attention_kernel):
//                f32 FMAs on CUDA cores, one block walks a row's keys.
//
// The TPU kernels compute rope on the packed pre-rope q/k from per-dispatch
// sin/cos tables (#12, #13; the others take q and K post-rope), the write of
// the dispatch's fresh K/V into their pages (#9 and #10 only read), and ragged
// causal GQA attention with an f32 online softmax over the page table, all in
// one body (`_softmax_accumulate`). The int8 instances store pages as int8
// with one f32 scale per (page, head, slot) in `[P, Hk, page, 1]` sidecars.
//
// Design. The TPU kernels replay a dispatch's fresh K/V on every read, because
// a Pallas grid cannot order a page write before another grid step's read.
// Here the work is launches on one stream, which gives that order for free:
//   (a) kv_write_kernel, one warp per (fresh token, kv head, K or V)
//       vector, on a grid of the packed tokens (not the rows): the warp
//       finds its token's row by a ballot over the rows (row r writes
//       positions [q_start, q_start + q_len) of its sequence from packed
//       index w_flat + p - w_start), a lane moves 16-byte vectors. With
//       rope, K is roped in f32 and cast to the model dtype; the float
//       instances store K and V as they are then, the int8 ones quantize
//       each vector of D values (absmax by shuffles, scale max(amax, 1e-8)
//       * f32(1/127), rint(x / scale) clipped to +-127) and store the int8
//       slot and its scale. Each fresh position belongs to exactly one row,
//       so no slot is written twice; the dump page is never touched.
//   (b) the attention, over the flattened (query token, group head) rows of
//       a row and kv head: mask kpos <= qpos & kpos < kv_len & qrow < q_len,
//       the reference's finite -1e30 running max, masked keys contribute 0,
//       rows with l == 0 (padding, inactive rows with kv_len 0) emit zeros;
//       table entries are clamped into [0, P). q is roped in f32 and cast
//       through the model dtype, as PyTorch does on the engine's fallback
//       paths.
// Rope products and sums are rounded separately (__fmul_rn/__fadd_rn), the
// quantizer divides with __fdiv_rn: the same operations PyTorch performs
// elementwise, so written slots and scales agree with the plain version bit
// for bit, and the engine's three paths (rope-fused, fused-KV, two-op with a
// PyTorch rope and scatter) feed one attention body the same values.
//
// Bound. At serving shapes the attention is memory-bound: the least time is
// the bytes of the live K/V pages (+ scales) + q + out + the fresh K/V
// written, over 3.35 TB/s (H100 SXM). The arithmetic (2 * 2 * D flops per
// unmasked (query, key) pair) is far below the tensor cores' rate.
//
// The tensor-core instance (attention_tc):
// - Splits over the sequence. A block takes one (row, kv head, tile of 64
//   flattened rows, split of the keys); a split holds 256 keys per 16 valid
//   rows (512 where the tile's rows see more than 1024 keys), a function of
//   the row alone (`plan`, mirrored by `split_plan` in Python), so a long row
//   no longer sets the launch time and a row's output does not depend on the
//   rest of the dispatch. A row with one split is written by its block; the
//   others leave (acc, max, sum) partials in device memory, and the tile's
//   last split to finish (a ticket counter per tile, the only atomic; it is
//   left at zero) adds them in split order, one warp a row: no atomics on
//   values, and two calls agree bit for bit. Split 0 writes the zeros of the
//   tile's padded and inactive rows, so a decode row's empty tiles cost that
//   write and no more.
// - Tensor cores. A busy warp owns 16 flattened rows; its q fragments stay
//   in registers at head_dim <= 128 (re-read from shared memory at 256,
//   where registers would spill). S = Q K^T and O += P V are mma.sync
//   m16n8k16 with f32 accumulation, K read by ldmatrix, V by ldmatrix.trans;
//   the softmax scale multiplies the f32 scores, not q, and the online
//   softmax runs in registers by quad shuffles with expf, as the plain
//   version computes it; P is split into parts of T that sum to it to about
//   f32's precision (three for bf16, two for f16) and each part is
//   multiplied, since the served tokens are held against an f32 plain
//   forward over 32 layers, where one bf16 rounding of an attention output
//   more or less than the plain version's carries on. Where only one or two
//   16-row groups are busy (decode), each step's keys are shared out among
//   the block's 4 warps and their states meet in shared memory at the end,
//   in warp order.
// - int8 pools without a per-value multiply. int8 values (|v| <= 127) are
//   exact in bf16 and f16: ldmatrix brings 4 bytes of a key row (K) or of two
//   key rows (V, as 16-bit pairs) to a thread, and the bit tricks of
//   csrc/dequant_matmul.cu turn byte pairs into T (q is staged in the k order
//   that pairing gives, perm16). The per-slot scales come out of the
//   products: s_j = (q . k8_j) kscale_j scale, and P' = p_j vscale_j feeds
//   P V while l sums p_j. The result is f32-grade, not bitwise the general
//   instance's.
// - Steps of 64 keys. Each key's K and V rows are fetched with 16-byte
//   cp.async through the page table (staged in shared memory) into a ring of
//   3 steps (4 for int8 pages; 2 and 3 at head_dim 256), keys past the split
//   zero-filled; one barrier a step. q is staged in the ring's idle last
//   slot before its fragments go to registers, so two blocks share a SM.
//
// The general instance: one block per (row, kv-head, tile of 16 flattened
// rows) walks the row's live pages up to the tile's causal horizon in chunks
// of `chunk` slots (the page itself up to 32 slots; else 32, 16 or 8, a
// divisor of the page), with the softmax update carried from chunk to chunk;
// int8 pages are dequantized as __fmul_rn(float(q8), scale) into shared
// memory before any product. Each chunk of K and V is fetched as 16-byte
// vectors (8 bf16/f16, 4 f32 or 16 int8 values, with their slots' scales: an
// int8 vector straddles two slots where D % 16 != 0, and takes each value's
// own scale) into registers one chunk ahead of its use; a chunk holds at most
// 8 KB of K a thread's output column (4 vectors a thread), which sets the
// chunk for f32 pools; q . k runs one thread per (query row, key slot) pair
// over padded shared-memory rows; P.V keeps each thread's output columns of
// the tile's rows in registers (one column up to head_dim 128, two up to
// 256).
//
// What is left on the table: on an H100 SXM the tensor-core instance moves
// its bytes at about 44% of the card's memory rate at long context over
// bf16 pages (22% over int8 pages, whose conversions cost as much as the
// bytes they save) and less at short contexts, where each block's fixed
// cost (metadata, page ids and q before the first copy; the merge in the
// last split) weighs most; the splits' partials go through device memory;
// every busy warp converts the int8 K it reads (a prefill tile's warps
// convert the same step). The general instance keeps the simple design:
// CUDA cores, no split, one page in flight.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kQTile = 16;         // flattened (token, group head) rows/block
constexpr int kThreads = 128;
constexpr int kMaxChunk = 32;      // key slots a softmax step holds: a warp
// 16-byte vectors of one chunk's K (and of its V) per thread and output
// column: a chunk holds at most kThreads * kVecPerCol * 16 = 8 KB per head
// for each column a thread owns
constexpr int kVecPerCol = 4;
// the quantizer's constants as the reference rounds them: doubles cast to f32
constexpr float kMinAmax = static_cast<float>(1e-8);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

using bf16 = __nv_bfloat16;

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

// Element d of x * cos + rotate_half(x) * sin for one head row of length D
// (neox duplicated-half layout), in f32 with no FMA contraction.
template <typename T>
__device__ __forceinline__ float rope_elem(const T* row, int d, int D,
                                           const float* sin_row,
                                           const float* cos_row) {
  const int half = D / 2;
  const float x = to_f32(row[d]);
  const float partner =
      d < half ? -to_f32(row[d + half]) : to_f32(row[d - half]);
  return __fadd_rn(__fmul_rn(x, cos_row[d]), __fmul_rn(partner, sin_row[d]));
}

}  // namespace

#include "split_merge.cuh"

namespace {

__device__ __forceinline__ int clamp_page(int p, int num_pages) {
  return p < 0 ? 0 : (p >= num_pages ? num_pages - 1 : p);
}

// ---------------------------------------------------------------------------
// The write launch: one warp per (fresh token, kv head, K or V) vector.
// ---------------------------------------------------------------------------

constexpr int kWriteWarps = 2;  // vectors a block of the write launch
// blocks an SM the launch bounds ask for: 32 warps, so that ptxas may take
// up to 64 registers a thread
constexpr int kWriteMinBlocks = 32 / kWriteWarps;
constexpr int kWriteVals = 8;   // values a lane holds: D <= 32 * 8

// 16-bit words <-> f32 by register operations only (no local arrays of
// another type): a word's low and high halves widened exactly, and two f32
// values rounded to nearest even into one word, as torch casts
__device__ __forceinline__ float2 widen2(uint32_t w, bf16*) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 widen2(uint32_t w, __half*) {
  __half2 h;
  memcpy(&h, &w, sizeof(w));
  return __half22float2(h);
}
__device__ __forceinline__ uint32_t narrow2(float lo, float hi, bf16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t w;
  memcpy(&w, &h, sizeof(w));
  return w;
}
__device__ __forceinline__ uint32_t narrow2(float lo, float hi, __half*) {
  const __half2 h = __floats2half2_rn(lo, hi);
  uint32_t w;
  memcpy(&w, &h, sizeof(w));
  return w;
}

// A lane's 8 values of a head vector: their 16 (16-bit T) or 32 (f32) bytes
// as loaded, and widened to f32. Loads from 16-byte aligned `src`.
template <typename T>
struct Vals8 {
  static constexpr int kWords = sizeof(T) == 4 ? 8 : 4;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const T* src) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  }
  __device__ __forceinline__ void widen(float* v) const {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __uint_as_float(w[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = widen2(w[k], (T*)nullptr);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    }
  }
  // f32 values rounded to T into the words
  __device__ __forceinline__ void narrow(const float* v) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = __float_as_uint(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = narrow2(v[2 * k], v[2 * k + 1], (T*)nullptr);
    }
  }
  __device__ __forceinline__ void store(T* dst) const {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
};

// 4 values of T from 8-byte (16-bit T) or 16-byte (f32) aligned `src`,
// widened to f32
__device__ __forceinline__ void load4(const bf16* src, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
  const float2 a = widen2(u.x, (bf16*)nullptr), b = widen2(u.y, (bf16*)nullptr);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* src, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
  const float2 a = widen2(u.x, (__half*)nullptr),
               b = widen2(u.y, (__half*)nullptr);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// The write launch of the fused calls: the dispatch's fresh K/V (K roped in
// f32 and cast to T when ROPE) into their page slots, cast to the pools'
// dtype PT (float pools; PT != T with rope only) or quantized (int8 pools
// with f32 scales). Work item i = blockIdx.x *
// kWriteWarps + warp is one (fresh token f, kv head hk, K or V) vector: f = i
// / (2 Hk), hk = (i / 2) % Hk, V for odd i. A grid of ceil(2 n_tok Hk /
// kWriteWarps) blocks, a function of n_tok and Hk only, so a long prefill
// chunk spreads over as many blocks as it has tokens and no row sets the
// launch time.
//
// Lane l holds values [8 l, 8 l + 8) of the vector (16-byte loads and
// stores; lanes past D / 8 hold none). Its loads are issued first, since
// they depend on f alone: the vector's own values, with rope the partner
// half (two runs of 4: a run never straddles D / 2, which is a multiple of
// 4) and sin/cos as float4, and, beside them, one row's metadata a lane.
// The warp then finds f's row: each lane tests its row (an active row r
// holds packed tokens [w_flats + q_starts - w_starts, + q_lens), kv_lens >
// 0) and a ballot gives the rows that hold f, 32 rows a round; padding
// tokens are in no row and write nothing. The row's page-table entry is
// loaded before the rope and the quantizer run and used only at the store,
// so the dependent loads are two round trips (the metadata beside the
// vector, then the entry) with the arithmetic under the second; the slot is
// computed once per (vector, row). Each fresh position belongs to one row,
// so no slot is written twice; slots past the table (pi >= W) are skipped
// and the dump page is never touched. (The launch bounds ask for 32 warps
// an SM, not the full 64 that ptxas aims for by itself, which held the rope
// instances to 32 registers and spilled. Two warps a block measured 0.1 us
// under eight at the decode-only shape, NVIDIA H100 80GB HBM3, 700 W.)
//
// The arithmetic is the plain version's, bit for bit: rope as __fmul_rn /
// __fadd_rn in f32 (no contraction), cast through T; the int8 scale
// __fmul_rn(max(amax, 1e-8), f32(1/127)) with the absmax reduced over the
// lanes by shuffles (the max of finite values is order-free), each value
// rintf(__fdiv_rn(x, scale)) clipped to +-127.
template <bool ROPE, bool Q8, typename T, typename PT>
__global__ void __launch_bounds__(32 * kWriteWarps, kWriteMinBlocks)
    kv_write_kernel(const T* __restrict__ new_k, const T* __restrict__ new_v,
                    void* __restrict__ k_out, void* __restrict__ v_out,
                    float* __restrict__ k_scale, float* __restrict__ v_scale,
                    const float* __restrict__ sin_tab,
                    const float* __restrict__ cos_tab,
                    const int* __restrict__ tables,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ q_starts,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ w_starts,
                    const int* __restrict__ w_flats, int R, int n_tok,
                    int Hk, int D, int P, int page, int W) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWriteWarps + (threadIdx.x >> 5);
  if (item >= 2 * n_tok * Hk) return;  // the whole warp
  const bool is_v = item & 1;
  const int hk = (item >> 1) % Hk, f = (item >> 1) / Hk;
  const int d0 = lane * kWriteVals;
  const bool has = d0 < D;
  const size_t vec = ((size_t)f * Hk + hk) * D;
  // lane l holds row r0 + l's metadata, 32 rows a round; the first round's
  // loads go out with the vector's own, unconditionally, so that finding
  // the row costs one round trip beside them
  int ql = 0, kv = 0, qs = 0, wf = 0, ws = 0;
  auto fetch_row = [&](int r) {
    ql = 0;
    if (r < R) {
      ql = q_lens[r];
      kv = kv_lens[r];
      qs = q_starts[r];
      wf = w_flats[r];
      ws = w_starts[r];
    }
  };
  fetch_row(lane);
  // the vector's values and, for K with rope, its partners (two runs of 4:
  // [d + half, ...) below D / 2, [d - half, ...) from there) and sin/cos
  Vals8<T> vals;
  float part[kWriteVals], sv[kWriteVals], cv[kWriteVals];
  const int half = D / 2;
  if (has) vals.load((is_v ? new_v : new_k) + vec + d0);
  if constexpr (ROPE) {
    if (!is_v && has) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + 4 * h;
        load4(new_k + vec + (d < half ? d + half : d - half), part + 4 * h);
        load4(sin_tab + (size_t)f * D + d, sv + 4 * h);
        load4(cos_tab + (size_t)f * D + d, cv + 4 * h);
      }
    }
  }
  // the rows that hold f, 32 rows a round by a ballot, and the next one's
  // table entry and slot in its page; the entry is used only at the store,
  // so its load is in flight while the vector is roped and quantized
  int r0 = 0, pos = 0;
  unsigned hits = 0;
  auto scan = [&]() {
    const int t = f - (wf + qs - ws);
    hits = __ballot_sync(0xffffffffu,
                         ql > 0 && kv > 0 && t >= 0 && t < ql);
    pos = qs + t;
  };
  auto next_row = [&](int& entry, int& off) {
    for (;;) {
      while (hits) {  // uniform across the warp
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const int p = __shfl_sync(0xffffffffu, pos, src);
        const int pi = p / page;
        if (p < 0 || pi >= W) continue;
        entry = tables[(size_t)(r0 + src) * W + pi];
        off = p - pi * page;
        return true;
      }
      r0 += 32;
      if (r0 >= R) return false;
      fetch_row(r0 + lane);
      scan();
    }
  };
  scan();
  int entry = 0, off = 0;
  bool more = next_row(entry, off);
  float x[kWriteVals] = {};
  if (has) vals.widen(x);
  if constexpr (ROPE) {
    if (!is_v && has) {
#pragma unroll
      for (int j = 0; j < kWriteVals; ++j) {
        const float p = d0 + j < half ? -part[j] : part[j];
        x[j] = __fadd_rn(__fmul_rn(x[j], cv[j]), __fmul_rn(p, sv[j]));
      }
      // the roped K cast to the model dtype: the float pools' values, and
      // the int8 quantizer's input widened back
      vals.narrow(x);
      vals.widen(x);
    }
  }
  // the int8 slot's 8 bytes and scale, the same for every row that takes f
  uint2 q8v = make_uint2(0u, 0u);
  float sc = 0.f;
  if constexpr (Q8) {
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kWriteVals; ++j) amax = fmaxf(amax, fabsf(x[j]));
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    sc = __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
#pragma unroll
    for (int j = 0; j < kWriteVals; ++j) {
      const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(x[j], sc)), -127.f),
                               127.f);
      const uint32_t b = (uint32_t)(q & 0xff) << (8 * (j & 3));
      if (j < 4)
        q8v.x |= b;
      else
        q8v.y |= b;
    }
  }
  for (; more; more = next_row(entry, off)) {
    const size_t slot =
        ((size_t)clamp_page(entry, P) * Hk + hk) * page + off;
    if constexpr (Q8) {
      int8_t* pool = static_cast<int8_t*>(is_v ? v_out : k_out);
      if (has) *reinterpret_cast<uint2*>(pool + slot * D + d0) = q8v;
      if (lane == 0) (is_v ? v_scale : k_scale)[slot] = sc;
    } else if (has) {
      PT* dst = static_cast<PT*>(is_v ? v_out : k_out) + slot * D + d0;
      if constexpr (std::is_same<T, PT>::value) {
        vals.store(dst);
      } else {
        // V, and K roped and cast through T, cast to the pools' dtype
        Vals8<PT> cast;
        cast.narrow(x);
        cast.store(dst);
      }
    }
  }
}

// the pools' element as stored: the model dtype, or int8
// the pools' element as stored: their float dtype PT, or int8
template <typename PT, bool Q8>
using Stored = typename std::conditional<Q8, int8_t, PT>::type;

// 16 bytes of pool values widened to f32 (int8 values times their slot's
// scale, one rounding each: `s0` up to element `split`, `s1` from there, as
// a vector may straddle two slots when D % 16 != 0)
__device__ __forceinline__ void unpack(const uint4& raw, float* dst, bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float* dst,
                                       __half*) {
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float* dst, float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k] = f[k];
}
__device__ __forceinline__ void unpack_q8(const uint4& raw, float s0, float s1,
                                          int split, float* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int k = 0; k < 16; ++k)
    dst[k] = __fmul_rn((float)b[k], k < split ? s0 : s1);
}

template <bool ROPE, bool Q8, typename T, typename PT, int COLS>
__global__ void __launch_bounds__(kThreads) ragged_attention_kernel(
    const T* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ w_starts,
    const int* __restrict__ w_flats, T* __restrict__ out, int n_tok, int H,
    int Hk, int D, int P, int page, int W, int QB, int chunk, float scale) {
  using S = Stored<PT, Q8>;
  constexpr int E = 16 / (int)sizeof(S);   // elements per 16-byte vector
  constexpr int kVec = kVecPerCol * COLS;  // vectors a thread fetches
  const int KS = D + 1;            // padded row stride of q_s and k_s
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kQTile, KS] (roped) scaled q
  float* k_s = q_s + kQTile * KS;     // [chunk, KS]
  float* v_s = k_s + chunk * KS;      // [chunk, D]
  float* p_s = v_s + chunk * D;       // [kQTile, chunk] scores, then probs
  float* m_s = p_s + kQTile * chunk;  // [kQTile] running max
  float* l_s = m_s + kQTile;          // [kQTile] running sum
  float* a_s = l_s + kQTile;          // [kQTile] this chunk's rescale

  const int r = blockIdx.x, hk = blockIdx.y, row0 = blockIdx.z * kQTile;
  const int G = H / Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads >> 5;
  const int ctx = kv_lens[r], qlen = q_lens[r], qstart = q_starts[r];
  const int tile_rows = min(kQTile, QB * G - row0);
  const int n_valid =
      (ctx > 0 && qlen > 0) ? max(0, min(tile_rows, qlen * G - row0)) : 0;

#pragma unroll 4
  for (int idx = tid; idx < n_valid * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
    float v = 0.f;
    if constexpr (ROPE) {
      // packed pre-rope q: the row's tokens sit at w_flat + q_start - w_start
      const int f = w_flats[r] + qstart - w_starts[r] + qi;
      if (f >= 0 && f < n_tok) {
        const float rot =
            rope_elem(q + ((size_t)f * H + h) * D, d, D,
                      sin_tab + (size_t)f * D, cos_tab + (size_t)f * D);
        v = to_f32(from_f32<T>(rot)) * scale;
      }
    } else {
      // row-blocked post-rope q [R, QB, H, D]
      v = to_f32(q[(((size_t)r * QB + qi) * H + h) * D + d]) * scale;
    }
    q_s[i * KS + d] = v;
  }
  for (int i = tid; i < n_valid; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  // thread d < D owns output columns d (and d + kThreads) of every row of
  // the tile: the unnormalised accumulator lives in registers
  float acc[COLS][kQTile];
#pragma unroll
  for (int c = 0; c < COLS; ++c)
#pragma unroll
    for (int i = 0; i < kQTile; ++i) acc[c][i] = 0.f;
  // keys past the causal horizon of the tile's last query are all masked
  const int kv_end =
      n_valid > 0 ? min(ctx, qstart + (row0 + n_valid - 1) / G + 1) : 0;
  // the keys are walked in chunks of `chunk` slots (a divisor of the page,
  // at most 32: one slot per lane in the softmax step)
  const int n_chunks = (kv_end + chunk - 1) / chunk;

  // a chunk's K and V as 16-byte vectors (and, for int8, the scales of each
  // vector's slots), fetched into registers one chunk ahead so the loads of
  // chunk c+1 are in flight while chunk c computes
  const int nvec = chunk * D / E;
  uint4 kreg[kVec], vreg[kVec];
  float ksr[Q8 ? kVec : 1][2], vsr[Q8 ? kVec : 1][2];
  auto fetch = [&](int c) {
    const int pos0 = c * chunk, pg = pos0 / page;
    const int pid = clamp_page(tables[(size_t)r * W + pg], P);
    const size_t slot0 = ((size_t)pid * Hk + hk) * page + (pos0 - pg * page);
    const uint4* kb = reinterpret_cast<const uint4*>(
        static_cast<const S*>(k_pages) + slot0 * D);
    const uint4* vb = reinterpret_cast<const uint4*>(
        static_cast<const S*>(v_pages) + slot0 * D);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int v = tid + u * kThreads;
      if (v < nvec) {
        kreg[u] = kb[v];
        vreg[u] = vb[v];
        if constexpr (Q8) {
          const int j0 = v * E / D, j1 = (v * E + E - 1) / D;
          ksr[u][0] = k_scale[slot0 + j0];
          vsr[u][0] = v_scale[slot0 + j0];
          // a second slot only where the vector straddles two
          ksr[u][1] = j1 == j0 ? ksr[u][0] : k_scale[slot0 + j1];
          vsr[u][1] = j1 == j0 ? vsr[u][0] : v_scale[slot0 + j1];
        }
      }
    }
  };
  if (n_chunks > 0) fetch(0);
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int v = tid + u * kThreads;
      if (v < nvec) {
        const int e0 = v * E, j = e0 / D, d0 = e0 - j * D;
        // V rows are unpadded, so a vector lands at e0 whatever its slots;
        // K rows are padded to KS
        float kt[E];
        if constexpr (Q8) {
          const int split = D - d0;   // >= E unless the vector straddles
          unpack_q8(kreg[u], ksr[u][0], ksr[u][1], split, kt);
          unpack_q8(vreg[u], vsr[u][0], vsr[u][1], split, v_s + e0);
          if (split >= E) {
#pragma unroll
            for (int e = 0; e < E; ++e) k_s[j * KS + d0 + e] = kt[e];
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e)
              k_s[e < split ? j * KS + d0 + e : (j + 1) * KS + e - split] =
                  kt[e];
          }
        } else {
          unpack(kreg[u], kt, (S*)nullptr);
          unpack(vreg[u], v_s + e0, (S*)nullptr);
#pragma unroll
          for (int e = 0; e < E; ++e) k_s[j * KS + d0 + e] = kt[e];
        }
      }
    }
    __syncthreads();
    if (c + 1 < n_chunks) fetch(c + 1);
    // scores: one thread per (query row, key slot) pair
    for (int pair = tid; pair < n_valid * chunk; pair += kThreads) {
      const int i = pair / chunk, j = pair - i * chunk;
      const float* qr = q_s + i * KS;
      const float* kr = k_s + j * KS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d = 0; d < D; d += 4) {
        s0 += qr[d] * kr[d];
        s1 += qr[d + 1] * kr[d + 1];
        s2 += qr[d + 2] * kr[d + 2];
        s3 += qr[d + 3] * kr[d + 3];
      }
      const float s = (s0 + s1) + (s2 + s3);
      const int kpos = c * chunk + j;
      const int qpos = qstart + (row0 + i) / G;
      p_s[pair] = (kpos <= qpos && kpos < ctx) ? s : -INFINITY;
    }
    __syncthreads();
    // online softmax: one warp per query row, lane j = key slot j
    for (int i = warp; i < n_valid; i += nwarps) {
      const float s = lane < chunk ? p_s[i * chunk + lane] : -INFINITY;
      const bool valid = s > -INFINITY;
      float m_cur = valid ? s : kNegInf;
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, m_cur);
      const float pe = valid ? expf(s - m_new) : 0.f;
      float sum = pe;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < chunk) p_s[i * chunk + lane] = pe;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();
    // P.V; rows past n_valid hold stale values and are never emitted
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc) {
      const int col = tid + cc * kThreads;
      if (col < D) {
#pragma unroll
        for (int i = 0; i < kQTile; ++i) acc[cc][i] *= a_s[i];
        for (int j = 0; j < chunk; ++j) {
          const float vj = v_s[j * D + col];
#pragma unroll
          for (int i = 0; i < kQTile; ++i)
            acc[cc][i] += p_s[i * chunk + j] * vj;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int col = tid + cc * kThreads;
    if (col < D) {
#pragma unroll
      for (int i = 0; i < kQTile; ++i) {
        if (i < tile_rows) {
          const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
          const float v =
              (i < n_valid && l_s[i] > 0.f) ? acc[cc][i] / l_s[i] : 0.f;
          out[(((size_t)r * QB + qi) * H + h) * D + col] = from_f32<T>(v);
        }
      }
    }
  }
}

struct Meta {
  const float* sin_tab;
  const float* cos_tab;
  const int* tables;
  const int* kv_lens;
  const int* q_starts;
  const int* q_lens;
  const int* w_starts;
  const int* w_flats;
};

// the chunk of key slots the attention walks: the largest of (page if it
// is at most 32), 32, 16, 8 that divides the page and keeps a chunk's K
// within the threads' vector budget (kVecPerCol 16-byte vectors a thread
// and output column); page % 8 == 0 makes 8 always fit
int chunk_slots(int page, int D, int elem_bytes, int cols) {
  const int cands[4] = {page < kMaxChunk ? page : kMaxChunk, 32, 16, 8};
  for (int c : cands)
    if (c <= kMaxChunk && page % c == 0 &&
        c * D * elem_bytes <= kThreads * kVecPerCol * cols * 16)
      return c;
  return 8;
}

size_t attention_smem(int D, int chunk) {
  return sizeof(float) * ((kQTile + chunk) * (D + 1) + chunk * D +
                          kQTile * chunk + 3 * kQTile);
}

template <bool ROPE, bool Q8, typename T, typename PT = T>
int launch_write(const void* new_k, const void* new_v, void* k_pages,
                 void* v_pages, void* k_scale, void* v_scale, const Meta& m,
                 int R, int n_tok, int Hk, int D, int P, int page, int W,
                 cudaStream_t stream) {
  const long long items = 2LL * n_tok * Hk;
  if (items == 0) return 0;
  const unsigned blocks =
      (unsigned)((items + kWriteWarps - 1) / kWriteWarps);
  kv_write_kernel<ROPE, Q8, T, PT><<<blocks, 32 * kWriteWarps, 0, stream>>>(
      (const T*)new_k, (const T*)new_v, k_pages, v_pages, (float*)k_scale,
      (float*)v_scale, m.sin_tab, m.cos_tab, m.tables, m.kv_lens, m.q_starts,
      m.q_lens, m.w_starts, m.w_flats, R, n_tok, Hk, D, P, page, W);
  return (int)cudaGetLastError();
}

template <bool ROPE, bool Q8, typename T, typename PT, int COLS>
int launch_attention_cols(const void* q, const void* k_pages,
                          const void* v_pages, const void* k_scale,
                          const void* v_scale, const Meta& m, void* out,
                          int R, int n_tok, int H, int Hk, int D, int P,
                          int page, int W, int QB, float scale,
                          cudaStream_t stream) {
  const int chunk =
      chunk_slots(page, D, (int)sizeof(Stored<PT, Q8>), COLS);
  const size_t smem = attention_smem(D, chunk);
  if (smem > 48 * 1024) {
    // above 48 KB only after an explicit opt-in; a refused launch never
    // runs and is reported only by cudaGetLastError
    const cudaError_t e = cudaFuncSetAttribute(
        ragged_attention_kernel<ROPE, Q8, T, PT, COLS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (QB * (H / Hk) + kQTile - 1) / kQTile;
  ragged_attention_kernel<ROPE, Q8, T, PT, COLS>
      <<<dim3(R, Hk, tiles), kThreads, smem, stream>>>(
          (const T*)q, k_pages, v_pages, (const float*)k_scale,
          (const float*)v_scale, m.sin_tab, m.cos_tab, m.tables, m.kv_lens,
          m.q_starts, m.q_lens, m.w_starts, m.w_flats, (T*)out, n_tok, H, Hk,
          D, P, page, W, QB, chunk, scale);
  return (int)cudaGetLastError();
}

template <bool ROPE, bool Q8, typename T, typename PT = T>
int launch_attention(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scale, const void* v_scale, const Meta& m,
                     void* out, int R, int n_tok, int H, int Hk, int D, int P,
                     int page, int W, int QB, float scale,
                     cudaStream_t stream) {
  // one output column a thread up to D = 128, two up to 256
  if (D <= kThreads)
    return launch_attention_cols<ROPE, Q8, T, PT, 1>(
        q, k_pages, v_pages, k_scale, v_scale, m, out, R, n_tok, H, Hk, D, P,
        page, W, QB, scale, stream);
  return launch_attention_cols<ROPE, Q8, T, PT, 2>(
      q, k_pages, v_pages, k_scale, v_scale, m, out, R, n_tok, H, Hk, D, P,
      page, W, QB, scale, stream);
}

// the C code of a float dtype: 0 bf16, 1 f16, 2 f32
template <typename T>
constexpr int kCode = std::is_same<T, bf16>::value
                          ? 0
                          : (std::is_same<T, __half>::value ? 1 : 2);

// the rope write over float pools of another dtype (code `pool`) than the
// fresh K/V's T: K roped and cast through T, then both cast to the pools'
// dtype
template <typename T>
int write_rope_mixed(int pool, const void* new_k, const void* new_v,
                     void* k_pages, void* v_pages, const Meta& m, int R,
                     int n_tok, int Hk, int D, int P, int page, int W,
                     cudaStream_t s) {
  if (pool == 0)
    return launch_write<true, false, T, bf16>(new_k, new_v, k_pages, v_pages,
                                              nullptr, nullptr, m, R, n_tok,
                                              Hk, D, P, page, W, s);
  if (pool == 1)
    return launch_write<true, false, T, __half>(new_k, new_v, k_pages,
                                                v_pages, nullptr, nullptr, m,
                                                R, n_tok, Hk, D, P, page, W,
                                                s);
  return launch_write<true, false, T, float>(new_k, new_v, k_pages, v_pages,
                                             nullptr, nullptr, m, R, n_tok,
                                             Hk, D, P, page, W, s);
}

template <typename T>
int write_for(int rope, int q8, int pool, const void* new_k,
              const void* new_v, void* k_pages, void* v_pages, void* k_scale,
              void* v_scale, const Meta& m, int R, int n_tok, int Hk, int D,
              int P, int page, int W, cudaStream_t s) {
  if (!q8 && pool != kCode<T>) {
    if (!rope) return (int)cudaErrorInvalidValue;
    return write_rope_mixed<T>(pool, new_k, new_v, k_pages, v_pages, m, R,
                               n_tok, Hk, D, P, page, W, s);
  }
  if (rope && q8)
    return launch_write<true, true, T>(new_k, new_v, k_pages, v_pages,
                                       k_scale, v_scale, m, R, n_tok, Hk, D,
                                       P, page, W, s);
  if (rope)
    return launch_write<true, false, T>(new_k, new_v, k_pages, v_pages,
                                        k_scale, v_scale, m, R, n_tok, Hk, D,
                                        P, page, W, s);
  if (q8)
    return launch_write<false, true, T>(new_k, new_v, k_pages, v_pages,
                                        k_scale, v_scale, m, R, n_tok, Hk, D,
                                        P, page, W, s);
  return launch_write<false, false, T>(new_k, new_v, k_pages, v_pages,
                                       k_scale, v_scale, m, R, n_tok, Hk, D,
                                       P, page, W, s);
}

// the general attention over float pools of another dtype (code `pool`,
// type PT) than the model's T
template <typename T, typename PT>
int attention_mixed(int rope, const void* q, const void* k_pages,
                    const void* v_pages, const Meta& m, void* out, int R,
                    int n_tok, int H, int Hk, int D, int P, int page, int W,
                    int QB, float scale, cudaStream_t s) {
  if (rope)
    return launch_attention<true, false, T, PT>(q, k_pages, v_pages, nullptr,
                                                nullptr, m, out, R, n_tok, H,
                                                Hk, D, P, page, W, QB, scale,
                                                s);
  return launch_attention<false, false, T, PT>(q, k_pages, v_pages, nullptr,
                                               nullptr, m, out, R, n_tok, H,
                                               Hk, D, P, page, W, QB, scale,
                                               s);
}

template <typename T>
int attention_for(int rope, int q8, int pool, const void* q,
                  const void* k_pages, const void* v_pages,
                  const void* k_scale, const void* v_scale, const Meta& m,
                  void* out, int R, int n_tok, int H, int Hk, int D, int P,
                  int page, int W, int QB, float scale, cudaStream_t s) {
  if (!q8 && pool != kCode<T>) {
    if (pool == 0)
      return attention_mixed<T, bf16>(rope, q, k_pages, v_pages, m, out, R,
                                      n_tok, H, Hk, D, P, page, W, QB, scale,
                                      s);
    if (pool == 1)
      return attention_mixed<T, __half>(rope, q, k_pages, v_pages, m, out, R,
                                        n_tok, H, Hk, D, P, page, W, QB,
                                        scale, s);
    return attention_mixed<T, float>(rope, q, k_pages, v_pages, m, out, R,
                                     n_tok, H, Hk, D, P, page, W, QB, scale,
                                     s);
  }
  if (rope && q8)
    return launch_attention<true, true, T>(q, k_pages, v_pages, k_scale,
                                           v_scale, m, out, R, n_tok, H, Hk,
                                           D, P, page, W, QB, scale, s);
  if (rope)
    return launch_attention<true, false, T>(q, k_pages, v_pages, k_scale,
                                            v_scale, m, out, R, n_tok, H, Hk,
                                            D, P, page, W, QB, scale, s);
  if (q8)
    return launch_attention<false, true, T>(q, k_pages, v_pages, k_scale,
                                            v_scale, m, out, R, n_tok, H, Hk,
                                            D, P, page, W, QB, scale, s);
  return launch_attention<false, false, T>(q, k_pages, v_pages, k_scale,
                                           v_scale, m, out, R, n_tok, H, Hk,
                                           D, P, page, W, QB, scale, s);
}

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16 and f16 models (q, fresh K/V and out in T;
// pools in T or int8) at head_dim % 16 == 0 up to 256, any page % 8 == 0.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;                // a warp owns 16 flattened rows
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;   // flattened rows of a block
constexpr int kStep = 64;                // keys a step holds
constexpr int kSplitUnit = 256;          // keys of a split per busy warp
constexpr int kLongKeys = 1024;          // past it, splits of twice that
constexpr int kMaxTab = 2 * kSplitUnit * kWarps / 8 + 2;  // pages a split

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// The work of one (row, tile of kTileRows flattened rows): its valid rows,
// the keys they see, and the split of those keys. A function of the row's
// own metadata and the geometry (group, qblock, table capacity) alone,
// never of the other rows or the card; the attention and merge kernels
// and ops/ragged_paged_attention.py (`split_plan`) apply the same rule.
struct Plan {
  int n_valid;   // valid flattened rows of the tile
  int n_keys;    // keys [0, n_keys) some valid row of the tile sees
  int split;     // keys of a split: kSplitUnit per busy warp, twice that
                 // past kLongKeys
  int n_splits;
};

__host__ __device__ __forceinline__ Plan plan(int ctx, int qlen, int qstart,
                                              int G, int QB, int tile,
                                              int cap) {
  Plan p{0, 0, 0, 0};
  const int rows = (ctx > 0 && qlen > 0) ? imin(qlen, QB) * G : 0;
  p.n_valid = imax(0, imin(kTileRows, rows - tile * kTileRows));
  if (p.n_valid == 0) return p;
  const int last_q = (tile * kTileRows + p.n_valid - 1) / G;
  p.n_keys = imax(0, imin(imin(ctx, qstart + last_q + 1), cap));
  p.split = kSplitUnit * ((p.n_valid + 15) / 16) *
            (p.n_keys > kLongKeys ? 2 : 1);
  p.n_splits = (p.n_keys + p.split - 1) / p.split;
  return p;
}

// a K/V (or q) row of `bytes` in shared memory, padded by 16 bytes where
// its 16-byte units are even: 8 rows of an ldmatrix then hit 32 banks
__host__ __device__ __forceinline__ int padded_stride(int bytes) {
  const int units = bytes / 16;
  return 16 * (units % 2 ? units : units + 1);
}

// K/V tiles in flight: two steps ahead at head_dim <= 128 (three for int8
// pages, half the bytes), one at 256
__host__ __device__ constexpr int stages(bool q8, int DB) {
  return DB <= 128 ? (q8 ? 4 : 3) : (q8 ? 3 : 2);
}
__host__ __device__ __forceinline__ int stage_size(bool q8, int kv_stride) {
  return 2 * kStep * kv_stride + (q8 ? 2 * kStep * 4 : 0);
}

// the key groups' exchange after the key walk (in the ring): every warp's
// accumulator fragments and its rows' (max, sum)
__host__ __device__ __forceinline__ int red_bytes(int DB) {
  return kWarps * (DB / 2 + 4) * 32 * 4;
}

// logical column of the mma's k order at shared-memory column p of a
// 16-column group, for int8 K: a thread's ldmatrix word holds bytes
// 4t .. 4t+3, paired as (4t, 4t+2) for k = 2t, 2t+1 and (4t+1, 4t+3) for
// k = 2t+8, 2t+9, so q is staged in that order
__host__ __device__ constexpr int perm16(int p) {
  return (p & ~15) + 4 * ((p & 7) >> 1) + 2 * (p & 1) + ((p >> 3) & 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the first `bytes` of them read (0: zero fill)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// (x0, x1) as pairs of T whose sum is x to about f32's precision: hi =
// T(x), then the rest rounded again, three parts for bf16 (8 + 8 + 8 bits)
// and two for f16 (11 + 11), each multiplied in the products
template <typename T>
constexpr int kParts = std::is_same<T, bf16>::value ? 3 : 2;

__device__ __forceinline__ uint32_t pack2(float a, float b, bf16*) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u, bf16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 unpack2(uint32_t u, __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

template <typename T>
__device__ __forceinline__ void split_parts(float x0, float x1,
                                            uint32_t (&parts)[3]) {
#pragma unroll
  for (int k = 0; k < kParts<T>; ++k) {
    const uint32_t u = pack2(x0, x1, (T*)nullptr);
    parts[k] = u;
    const float2 f = unpack2(u, (T*)nullptr);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// n values of T from f32, to consecutive addresses
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  dst[0] = from_f32<T>(a);
  dst[1] = from_f32<T>(b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
// Accumulator layout of m16n8k16 (f32): c0, c1 are row g = lane / 4,
// columns 2t, 2t + 1 (t = lane % 4) of the n-tile; c2, c3 row g + 8. S's
// n-tiles 2kk and 2kk + 1 are the A fragment of P V for keys 16kk .. 16kk+15.
// O's n-tiles are 8 columns of D for 16-bit pools (n-tile n: columns 8n +
// 2t, +1) and, for int8 V read by ldmatrix.trans as 16-bit pairs, the even
// and odd columns of each 16-column group b (n-tiles 2b, 2b + 1): a thread
// holds columns 16b + 4t .. 16b + 4t + 3 of its rows.
// the thread's values of row hr divided by `l` (0 where l is 0: a row that
// saw no key), or as they are (partials: l < 0), by `over`
template <bool Q8, int NT, typename OT>
__device__ __forceinline__ void store_rows(OT* dst, const float (&o)[NT][4],
                                           int hr, float l, int D, int t) {
  if constexpr (!Q8) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (8 * n < D)
        store2(dst + 8 * n + 2 * t, over(o[n][2 * hr], l),
               over(o[n][2 * hr + 1], l));
  } else {
#pragma unroll
    for (int b = 0; b < NT / 2; ++b)
      if (16 * b < D)
        store4(dst + 16 * b + 4 * t, over(o[2 * b][2 * hr], l),
               over(o[2 * b + 1][2 * hr], l), over(o[2 * b][2 * hr + 1], l),
               over(o[2 * b + 1][2 * hr + 1], l));
  }
}

// Grid (tiles x splits, Hk, R): block (tile + tiles * s, hk, r) takes the
// tile's valid flattened (query token, group head) rows in 16-row groups
// over the keys of split s of the row, in steps of kStep keys through a
// kStages ring filled by cp.async (one barrier a step); where one or two
// groups are busy, each step's keys are shared out among the 4 warps and the
// warps' states meet in shared memory at the end. A row with one split
// writes its output here; otherwise each row leaves its unnormalised
// accumulator, running max and sum in the partial buffers, and the
// tile's last split to finish merges them (merge_row). Split 0 also writes
// the zeros of the tile's rows that no split holds.
template <bool ROPE, bool Q8, typename T, int DB>
__global__ void __launch_bounds__(kThreads) attention_tc(
    const T* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ w_starts,
    const int* __restrict__ w_flats, T* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml,
    int* __restrict__ tickets, int n_tok, int H, int Hk, int D, int P,
    int page, int W, int QB, int tiles, int slab_rows, int kv_stride,
    int q_stride, float scale) {
  using S = Stored<T, Q8>;
  constexpr int kStages = stages(Q8, DB);
  constexpr bool kQRegs = DB <= 128;  // q fragments live in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = stage_size(Q8, kv_stride);
  const int ring_bytes = imax(kStages * stage_bytes, red_bytes(DB));
  // q stages in the ring's last slot, free until the first step's barrier,
  // where its fragments go to registers and a slot holds it
  const bool q_in_ring = kQRegs && stage_bytes >= kTileRows * q_stride;
  T* q_s = reinterpret_cast<T*>(
      smem + (q_in_ring ? (kStages - 1) * stage_bytes : ring_bytes));
  int* tab_s = reinterpret_cast<int*>(
      smem + ring_bytes + (q_in_ring ? 0 : kTileRows * q_stride));

  const int r = blockIdx.z, hk = blockIdx.y;
  const int tile = blockIdx.x % tiles, split_idx = blockIdx.x / tiles;
  const int G = H / Hk;
  const int ctx = kv_lens[r], qlen = q_lens[r], qstart = q_starts[r];
  const Plan pl = plan(ctx, qlen, qstart, G, QB, tile, W * page);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (split_idx == 0) {
    // the tile's rows no split writes (padded query rows, inactive rows,
    // rows that see no key) are zeros, 16 bytes a thread
    const int rows = imin(kTileRows, QB * G - tile * kTileRows);
    const int z0 = pl.n_splits > 0 ? pl.n_valid : 0;
    const int vecs = D / 8;
    for (int idx = tid; idx < (rows - z0) * vecs; idx += kThreads) {
      const int i = z0 + idx / vecs, v = idx % vecs;
      const int flat = tile * kTileRows + i, qi = flat / G;
      T* dst = out + (((size_t)r * QB + qi) * H + hk * G + flat % G) * D;
      reinterpret_cast<uint4*>(dst)[v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (split_idx >= pl.n_splits) return;
  const int g = lane >> 2, t = lane & 3;
  const int k_lo = split_idx * pl.split;
  const int k_hi = imin(k_lo + pl.split, pl.n_keys);
  // the tile's partial rows: split s, row i at slab0 + s n_valid + i
  const size_t slab0 =
      (((size_t)r * Hk + hk) * tiles + tile) * slab_rows;
  const int n_steps = (k_hi - k_lo + kStep - 1) / kStep;
  const int pg_lo = k_lo / page;
  const int n_pg = (k_hi - 1) / page - pg_lo + 1;
  for (int i = tid; i < n_pg; i += kThreads)
    tab_s[i] = clamp_page(tables[(size_t)r * W + pg_lo + i], P);

  // one step's K and V rows (int8: and the steps' scales, 4 slots of one
  // page a 16-byte copy) into ring slot st % kStages; keys past the split
  // are zero-filled. A thread copies 16-byte column c of keys j0, j0 +
  // stride, ... (one column a thread where the row's units divide the
  // block)
  const int chunks = D * (int)sizeof(S) / 16;  // 16-byte units of a row
  const bool even = kThreads % chunks == 0;
  const int c_own = even ? tid % chunks : 0, j_own = even ? tid / chunks : 0;
  const int j_stride = even ? kThreads / chunks : 0;
  const S* kp = static_cast<const S*>(k_pages);
  const S* vp = static_cast<const S*>(v_pages);
  const uint32_t ring = smem_u32(smem);
  auto copy_row = [&](uint32_t kb, uint32_t vb, int k0, int j, int c) {
    const int kpos = k0 + j;
    size_t off = 0;
    int bytes = 0;
    if (kpos < k_hi) {
      const int pg = kpos / page;
      off = (((size_t)tab_s[pg - pg_lo] * Hk + hk) * page + kpos -
             pg * page) * D + c * (16 / (int)sizeof(S));
      bytes = 16;
    }
    cp_async16(kb + j * kv_stride + c * 16, kp + off, bytes);
    cp_async16(vb + j * kv_stride + c * 16, vp + off, bytes);
  };
  auto issue = [&](int st) {
    const uint32_t kb = ring + (st % kStages) * stage_bytes;
    const uint32_t vb = kb + kStep * kv_stride;
    const int k0 = k_lo + st * kStep;
    if (even) {
      for (int j = j_own; j < kStep; j += j_stride)
        copy_row(kb, vb, k0, j, c_own);
    } else {
      for (int id = tid; id < kStep * chunks; id += kThreads) {
        const int j = id / chunks;
        copy_row(kb, vb, k0, j, id - j * chunks);
      }
    }
    if constexpr (Q8) {
      const uint32_t sb = vb + kStep * kv_stride;
      for (int id = tid; id < kStep / 4; id += kThreads) {
        const int kpos = k0 + 4 * id;
        size_t off = 0;
        int bytes = 0;
        if (kpos < k_hi) {
          const int pg = kpos / page;
          off = ((size_t)tab_s[pg - pg_lo] * Hk + hk) * page + kpos -
                pg * page;
          bytes = 16;
        }
        cp_async16(sb + 16 * id, k_scale + off, bytes);
        cp_async16(sb + kStep * 4 + 16 * id, v_scale + off, bytes);
      }
    }
  };
  // the tile's q rows (roped in f32 and cast through T, as the general
  // instance does), 16 columns a thread, staged in the mma's k order
  // (int8 K: even columns of the group, then odd ones, see perm16)
  const int n_valid = pl.n_valid, row0 = tile * kTileRows;
  const int busy_warps = (n_valid + 15) / 16;
  const int q_ld = q_stride / 2, groups = D / 16;
  for (int idx = tid; idx < busy_warps * 16 * groups; idx += kThreads) {
    const int i = idx / groups, d0 = 16 * (idx - i * groups);
    float x[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = 0.f;
    if (i < n_valid) {
      const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
      if constexpr (ROPE) {
        const int f = w_flats[r] + qstart - w_starts[r] + qi;
        if (f >= 0 && f < n_tok) {
          const T* row = q + ((size_t)f * H + h) * D;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            x[e] = to_f32(from_f32<T>(rope_elem(row, d0 + e, D,
                                                sin_tab + (size_t)f * D,
                                                cos_tab + (size_t)f * D)));
        }
      } else {
        const uint4* row = reinterpret_cast<const uint4*>(
            q + (((size_t)r * QB + qi) * H + h) * D + d0);
        const uint4 v0 = row[0], v1 = row[1];
        const T* e0 = reinterpret_cast<const T*>(&v0);
        const T* e1 = reinterpret_cast<const T*>(&v1);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          x[e] = to_f32(e0[e]);
          x[8 + e] = to_f32(e1[e]);
        }
      }
    }
    T* dst = q_s + i * q_ld + d0;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      dst[p] = from_f32<T>(x[Q8 ? perm16(p) : p]);
  }
  __syncthreads();   // the page ids and q are in shared memory
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) issue(st);
    cp_commit();
  }

  // warps: rg 16-row groups x kg key groups (kg = kWarps / busy_warps
  // where that divides, else 1): warp (rg, kq) takes rows 16 rg .. 16 rg +
  // 15 and keys kq nk .. kq nk + nk - 1 of each step
  const int kg = busy_warps == 1 ? 4 : (busy_warps == 2 ? 2 : 1);
  const int rg = warp % busy_warps, kq = warp / busy_warps;
  const int nk = kStep / kg, key0 = kq * nk;
  const bool busy = kq < kg;
  // A fragments of the warp's 16 rows: ldmatrix row lane & 15, columns
  // 8 (lane >> 4) of each 16-column group
  const uint32_t qa = smem_u32(q_s) + (rg * 16 + (lane & 15)) * q_stride +
                      (lane >> 4) * 16;
  uint32_t qf[kQRegs ? DB / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int c = 0; c < DB / 16; ++c)
      if (busy && 16 * c < D) ldmatrix_x4(qf[c], qa + c * 32);
  }
  // keys [0, lim) are visible to the thread's rows g and g + 8
  int lim[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = rg * 16 + g + 8 * hr;
    lim[hr] = i < n_valid ? imin(qstart + (row0 + i) / G + 1, pl.n_keys) : 0;
  }
  float o[DB / 8][4];
#pragma unroll
  for (int n = 0; n < DB / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int st = 0; st < n_steps; ++st) {
    cp_wait<kStages - 2>();
    __syncthreads();   // step st has landed; every warp is past step st - 1
    if (st + kStages - 1 < n_steps) issue(st + kStages - 1);
    cp_commit();
    if (!busy) continue;
    const int slot = st % kStages;
    const uint32_t kb = ring + slot * stage_bytes + key0 * kv_stride;
    const uint32_t vb = kb + kStep * kv_stride;
    const float* scl = reinterpret_cast<const float*>(
        smem + slot * stage_bytes + 2 * kStep * kv_stride) + key0;
    const int k0 = k_lo + st * kStep + key0;

    // S = Q K^T: nk / 8 n-tiles of 8 keys; K rows by ldmatrix (16-bit: two
    // k-steps an x4; int8: four, paired into T by int8_pair)
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    constexpr int kCs = Q8 ? 4 : 2;   // k-steps an ldmatrix.x4 covers
#pragma unroll
    for (int c = 0; c < DB / 16; c += kCs) {
      if (16 * c >= D) break;
      uint32_t af[kCs][4];
#pragma unroll
      for (int u = 0; u < kCs; ++u) {
        if (16 * (c + u) < D) {
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[u][e] = qf[c + u][e];
          } else {
            ldmatrix_x4(af[u], qa + (c + u) * 32);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= nk) break;
        uint32_t b[4];
        const uint32_t row = kb + (8 * j + (lane & 7)) * kv_stride;
        if constexpr (!Q8) {
          ldmatrix_x4(b, row + (c * 16 + 8 * (lane >> 3)) * 2);
          mma16816<T>(sc[j], af[0], b[0], b[1]);
          if (16 * (c + 1) < D) mma16816<T>(sc[j], af[1], b[2], b[3]);
        } else {
          ldmatrix_x4(b, row + (c + (lane >> 3)) * 16);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (16 * (c + u) < D)
              mma16816<T>(sc[j], af[u], int8_pair<T>(b[u]),
                     int8_pair<T>(b[u] >> 8));
        }
      }
    }

    // the online softmax on the registers, as the plain version computes
    // it (expf of the f32 score less the running max; the reference's
    // mask, finite -1e30 max, masked keys contribute 0); int8 K's slot
    // scale multiplies the f32 score, V's goes into P (l sums p alone)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= nk) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1), hr = e >> 1;
        float x = sc[j][e] * (Q8 ? scl[kj] * scale : scale);
        x = k0 + kj < lim[hr] ? x : kNegInf;
        sc[j][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      alpha[hr] = expf(m[hr] - mx[hr]);
      m[hr] = mx[hr];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= nk) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = 8 * j + 2 * t + (e & 1), hr = e >> 1;
        const bool vis = k0 + kj < lim[hr];
        const float p = vis ? expf(sc[j][e] - m[hr]) : 0.f;
        ps[hr] += p;
        sc[j][e] = Q8 ? (vis ? p * scl[kStep + kj] : 0.f) : p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ps[hr];
#pragma unroll
    for (int n = 0; n < DB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += (P_1 + P_2 [+ P_3]) V, 16 keys a k-step; V rows by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      if (16 * kk >= nk) break;
      uint32_t pa[3][4];   // A fragments of the parts of P
      {
        uint32_t p4[4][3];
        split_parts<T>(sc[2 * kk][0], sc[2 * kk][1], p4[0]);
        split_parts<T>(sc[2 * kk][2], sc[2 * kk][3], p4[1]);
        split_parts<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1], p4[2]);
        split_parts<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3], p4[3]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int a = 0; a < 4; ++a) pa[k][a] = p4[a][k];
      }
      const uint32_t vrow = vb + (16 * kk + (lane & 15)) * kv_stride;
      if constexpr (!Q8) {
#pragma unroll
        for (int n = 0; n < DB / 8; n += 2) {
          if (8 * n >= D) break;
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + (8 * n + 8 * (lane >> 4)) * 2);
#pragma unroll
          for (int k = 0; k < kParts<T>; ++k) {
            mma16816<T>(o[n], pa[k], b[0], b[1]);
            mma16816<T>(o[n + 1], pa[k], b[2], b[3]);
          }
        }
      } else {
#pragma unroll
        for (int bb = 0; bb < DB / 16; bb += 2) {
          if (16 * bb >= D) break;
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + (bb + (lane >> 4)) * 16);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (16 * (bb + u) < D) {
              const uint32_t k07 = b[2 * u], k815 = b[2 * u + 1];
              const uint32_t e0 = int8_pair<T>(k07), e1 = int8_pair<T>(k815);
              const uint32_t d0 = int8_pair<T>(k07 >> 8);
              const uint32_t d1 = int8_pair<T>(k815 >> 8);
#pragma unroll
              for (int k = 0; k < kParts<T>; ++k) {
                mma16816<T>(o[2 * (bb + u)], pa[k], e0, e1);
                mma16816<T>(o[2 * (bb + u) + 1], pa[k], d0, d1);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  if (kg > 1) {
    // the key groups meet in shared memory (the ring, drained): each warp
    // leaves its state in its own fragment layout, and key group 0 adds
    // the others' in key-group order
    cp_wait<0>();
    __syncthreads();
    constexpr int kRegs = DB / 2;   // o values a thread
    float* red = reinterpret_cast<float*>(smem);   // [warp][reg][lane]
    float* red_ml = red + kWarps * kRegs * 32;     // [warp][m, m, l, l][lane]
    if (kq > 0) {
#pragma unroll
      for (int n = 0; n < DB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * kRegs + 4 * n + e) * 32 + lane] = o[n][e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        red_ml[(warp * 4 + hr) * 32 + lane] = m[hr];
        red_ml[(warp * 4 + 2 + hr) * 32 + lane] = l[hr];
      }
    }
    __syncthreads();
  }
  // key group 0 of each 16-row group holds the rows' state from here
  const bool writer = busy && kq == 0;
  if (kg > 1 && writer) {
    constexpr int kRegs = DB / 2;
    const float* red = reinterpret_cast<const float*>(smem);
    const float* red_ml = red + kWarps * kRegs * 32;
    float mo[4][2], wq[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        mo[q][hr] = q == 0 ? m[hr]
                           : (q < kg ? red_ml[((rg + q * busy_warps) * 4 + hr)
                                              * 32 + lane]
                                     : kNegInf);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = mo[0][hr];
#pragma unroll
      for (int q = 1; q < 4; ++q) mt = fmaxf(mt, mo[q][hr]);
      float lt = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wq[q][hr] = q < kg ? expf(mo[q][hr] - mt) : 0.f;
        const float lq =
            q == 0 ? l[hr]
                   : (q < kg ? red_ml[((rg + q * busy_warps) * 4 + 2 + hr) *
                                          32 + lane]
                             : 0.f);
        lt += wq[q][hr] * lq;
      }
      m[hr] = mt;
      l[hr] = lt;
    }
#pragma unroll
    for (int n = 0; n < DB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = o[n][e] * wq[0][e >> 1];
#pragma unroll
        for (int q = 1; q < 4; ++q)
          if (q < kg)
            x += wq[q][e >> 1] *
                 red[((rg + q * busy_warps) * kRegs + 4 * n + e) * 32 + lane];
        o[n][e] = x;
      }
  }
  if (writer) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = rg * 16 + g + 8 * hr;
      if (i >= n_valid) continue;
      if (pl.n_splits == 1) {
        const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
        store_rows<Q8>(out + (((size_t)r * QB + qi) * H + h) * D, o, hr,
                       l[hr], D, t);
      } else {
        const size_t prow = slab0 + (size_t)split_idx * n_valid + i;
        store_rows<Q8>(part_o + prow * D, o, hr, -1.f, D, t);
        if (t == 0) {
          part_ml[2 * prow] = m[hr];
          part_ml[2 * prow + 1] = l[hr];
        }
      }
    }
  }
  if (pl.n_splits < 2) return;

  // the tile's last split to finish merges them all, in split order: its
  // ticket (a counter, never a value) is left at zero for the next launch
  __threadfence();
  __syncthreads();
  int* last = tab_s;   // the page ids are spent
  int* ticket = tickets + ((size_t)r * Hk + hk) * tiles + tile;
  if (tid == 0) last[0] = atomicAdd(ticket, 1) == pl.n_splits - 1;
  __syncthreads();
  if (!last[0]) return;
  __threadfence();
  for (int i = warp; i < n_valid; i += kWarps) {
    const int flat = row0 + i, qi = flat / G, h = hk * G + flat % G;
    merge_row(part_o, part_ml, out + (((size_t)r * QB + qi) * H + h) * D,
              slab0 + i, n_valid, pl.n_splits, D, lane);
  }
  if (tid == 0) *ticket = 0;
}

// the tensor-core instance's scratch: the splits' partial rows and the
// tiles' tickets (zero before a launch, left zero by it)
struct Scratch {
  float* part_o;
  float* part_ml;
  int* tickets;
  int slab_rows;
};

template <bool ROPE, bool Q8, typename T, int DB>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const Meta& m, void* out,
           const Scratch& sc, int R, int n_tok, int H, int Hk, int D, int P,
           int page, int W, int QB, float scale, cudaStream_t stream) {
  constexpr int kStages = stages(Q8, DB);
  const int kv_stride = padded_stride(D * (Q8 ? 1 : 2));
  const int q_stride = padded_stride(D * 2);
  const int stage = stage_size(Q8, kv_stride);
  const bool q_in_ring = DB <= 128 && stage >= kTileRows * q_stride;
  // + 256 bytes: an ldmatrix.x4 past a row whose 16-column groups are odd
  // in number reads (and drops) up to 32 bytes beyond the last row
  const size_t smem = imax(kStages * stage, red_bytes(DB)) +
                      (q_in_ring ? 0 : kTileRows * q_stride) + kMaxTab * 4 +
                      256;
  auto kernel = attention_tc<ROPE, Q8, T, DB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // the largest shared-memory carveout, so two blocks share a SM
  if (const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared))
    return (int)e;
  const int tiles = (QB * (H / Hk) + kTileRows - 1) / kTileRows;
  const int splits = imax(1, (W * page + kSplitUnit - 1) / kSplitUnit);
  kernel<<<dim3(tiles * splits, Hk, R), kThreads, smem, stream>>>(
      (const T*)q, k_pages, v_pages, (const float*)k_scale,
      (const float*)v_scale, m.sin_tab, m.cos_tab, m.tables, m.kv_lens,
      m.q_starts, m.q_lens, m.w_starts, m.w_flats, (T*)out, sc.part_o,
      sc.part_ml, sc.tickets, n_tok, H, Hk, D, P, page, W, QB, tiles,
      sc.slab_rows, kv_stride, q_stride, scale);
  return (int)cudaGetLastError();
}

template <bool ROPE, bool Q8, typename T>
int launch_d(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scale, const void* v_scale, const Meta& m,
             void* out, const Scratch& sc, int R, int n_tok, int H, int Hk,
             int D, int P, int page, int W, int QB, float scale,
             cudaStream_t s) {
  if (D <= 128)
    return launch<ROPE, Q8, T, 128>(q, k_pages, v_pages, k_scale, v_scale, m,
                                    out, sc, R, n_tok, H, Hk, D, P, page, W,
                                    QB, scale, s);
  return launch<ROPE, Q8, T, 256>(q, k_pages, v_pages, k_scale, v_scale, m,
                                  out, sc, R, n_tok, H, Hk, D, P, page, W, QB,
                                  scale, s);
}

template <typename T>
int attention_for(int rope, int q8, const void* q, const void* k_pages,
                  const void* v_pages, const void* k_scale,
                  const void* v_scale, const Meta& m, void* out,
                  const Scratch& sc, int R, int n_tok, int H, int Hk, int D,
                  int P, int page, int W, int QB, float scale,
                  cudaStream_t s) {
  if (rope && q8)
    return launch_d<true, true, T>(q, k_pages, v_pages, k_scale, v_scale, m,
                                   out, sc, R, n_tok, H, Hk, D, P, page, W,
                                   QB, scale, s);
  if (rope)
    return launch_d<true, false, T>(q, k_pages, v_pages, k_scale, v_scale, m,
                                    out, sc, R, n_tok, H, Hk, D, P, page, W,
                                    QB, scale, s);
  if (q8)
    return launch_d<false, true, T>(q, k_pages, v_pages, k_scale, v_scale, m,
                                    out, sc, R, n_tok, H, Hk, D, P, page, W,
                                    QB, scale, s);
  return launch_d<false, false, T>(q, k_pages, v_pages, k_scale, v_scale, m,
                                   out, sc, R, n_tok, H, Hk, D, P, page, W,
                                   QB, scale, s);
}

}  // namespace tc


}  // namespace

// C interface, loaded with ctypes. `dtype` is the model's: 0 bf16, 1 f16,
// 2 f32, the type of q and out (for the write: of the fresh K/V); the pools
// are float of code `pool` (q8 = 0) or int8 with f32 [P, Hk, page, 1] scale
// sidecars (q8 = 1; null otherwise, and `pool` is ignored); the rope tables
// f32 [T, D] (rope = 1; null otherwise); the metadata int32. Over float
// pools of another dtype than the model's, the write takes the rope launch
// only (without rope the caller casts the fresh K/V to the pools' dtype and
// passes it as the model's), and the attention the general instance only. With rope = 0 the attention takes q
// row-blocked [R, QB, H, D] and needs no w_starts/w_flats. The write reads
// new_k, new_v and the rope tables as 16-byte vectors (16-byte aligned). The
// attention's
// `instance` is 0 for the tensor-core kernels (bf16 or f16, head_dim % 16
// == 0), whose scratch is `part_o` (f32 [R, Hk, tiles, slab_rows, D]),
// `part_ml` (f32 [R, Hk, tiles, slab_rows, 2]) and `tickets` (int32 [R, Hk,
// tiles], zero before the launch and left zero by it), tiles = ceil(QB * H /
// Hk / 64) and slab_rows >= ceil(W * page / 16) + 64; 1 for the general
// kernel (no scratch). Each entry launches on `stream`, does not synchronise, and
// returns the cudaGetLastError() code of its launches (0 on success), or
// cudaErrorInvalidValue for an (instance, dtype) code or geometry no kernel
// takes.
extern "C" {

const char* rpa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int rpa_kv_write(int dtype, int pool, int rope, int q8, const void* new_k,
                 const void* new_v, void* k_pages, void* v_pages,
                 void* k_scale, void* v_scale, const void* sin_tab,
                 const void* cos_tab, const void* tables, const void* kv_lens,
                 const void* q_starts, const void* q_lens,
                 const void* w_starts, const void* w_flats, int R, int n_tok,
                 int Hk, int D, int P, int page, int W, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (D % 8 || D > 256 || page % 8 || pool < 0 || pool > 2)
    return (int)cudaErrorInvalidValue;
  const Meta m{(const float*)sin_tab, (const float*)cos_tab,
               (const int*)tables,    (const int*)kv_lens,
               (const int*)q_starts,  (const int*)q_lens,
               (const int*)w_starts,  (const int*)w_flats};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return write_for<bf16>(rope, q8, pool, new_k, new_v, k_pages, v_pages,
                           k_scale, v_scale, m, R, n_tok, Hk, D, P, page, W,
                           s);
  if (dtype == 1)
    return write_for<__half>(rope, q8, pool, new_k, new_v, k_pages, v_pages,
                             k_scale, v_scale, m, R, n_tok, Hk, D, P, page, W,
                             s);
  if (dtype == 2)
    return write_for<float>(rope, q8, pool, new_k, new_v, k_pages, v_pages,
                            k_scale, v_scale, m, R, n_tok, Hk, D, P, page, W,
                            s);
  return (int)cudaErrorInvalidValue;
}

int rpa_attention(int instance, int dtype, int pool, int rope, int q8,
                  const void* q,
                  const void* k_pages, const void* v_pages,
                  const void* k_scale, const void* v_scale,
                  const void* sin_tab, const void* cos_tab, const void* tables,
                  const void* kv_lens, const void* q_starts,
                  const void* q_lens, const void* w_starts,
                  const void* w_flats, void* out, void* part_o, void* part_ml,
                  void* tickets, int R, int n_tok, int H, int Hk, int D,
                  int P, int page, int W, int QB, int slab_rows, float scale,
                  void* stream) {
  (void)cudaGetLastError();
  if (D % 8 || D > 256 || page % 8 || pool < 0 || pool > 2)
    return (int)cudaErrorInvalidValue;
  const Meta m{(const float*)sin_tab, (const float*)cos_tab,
               (const int*)tables,    (const int*)kv_lens,
               (const int*)q_starts,  (const int*)q_lens,
               (const int*)w_starts,  (const int*)w_flats};
  const cudaStream_t s = (cudaStream_t)stream;
  if (instance == 0) {
    if (D % 16 || (!q8 && pool != dtype)) return (int)cudaErrorInvalidValue;
    const tc::Scratch sc{(float*)part_o, (float*)part_ml, (int*)tickets,
                         slab_rows};
    if (dtype == 0)
      return tc::attention_for<bf16>(rope, q8, q, k_pages, v_pages, k_scale,
                                     v_scale, m, out, sc, R, n_tok, H, Hk, D,
                                     P, page, W, QB, scale, s);
    if (dtype == 1)
      return tc::attention_for<__half>(rope, q8, q, k_pages, v_pages,
                                       k_scale, v_scale, m, out, sc, R, n_tok,
                                       H, Hk, D, P, page, W, QB, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (instance != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return attention_for<bf16>(rope, q8, pool, q, k_pages, v_pages, k_scale,
                               v_scale, m, out, R, n_tok, H, Hk, D, P, page,
                               W, QB, scale, s);
  if (dtype == 1)
    return attention_for<__half>(rope, q8, pool, q, k_pages, v_pages,
                                 k_scale, v_scale, m, out, R, n_tok, H, Hk, D,
                                 P, page, W, QB, scale, s);
  if (dtype == 2)
    return attention_for<float>(rope, q8, pool, q, k_pages, v_pages, k_scale,
                                v_scale, m, out, R, n_tok, H, Hk, D, P, page,
                                W, QB, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
