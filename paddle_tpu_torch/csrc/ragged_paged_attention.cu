// The ragged paged attention family for Hopper (sm_90a): two kernels, each
// templated on rope, on int8 pools and on the model's dtype T (bf16, f16 or
// f32: q, the fresh K/V, the output and float pools), whose instances replace
// six TPU kernels of paddle_tpu/ops/ragged_paged_attention.py:
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
// 256 (int8 pools too), GQA. Shared memory forces no bound on it: the
// attention walks a row's keys in chunks of at most 32 slots (a divisor of
// the page), so a block holds 16 q rows and one chunk of K and V, at most
// 84 KB at head_dim 256.
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
// Here the work is two launches on one stream, which gives that order for
// free:
//   (a) kv_write_kernel, one block per (row, kv-head): positions
//       [q_start, q_start + q_len) of each active row, packed index
//       w_flat + p - w_start. With rope, K is roped in f32 and cast to the
//       model dtype; the float instances store K and V as they are then, the
//       int8 ones quantize each (token, kv-head) vector of D values (one warp
//       each: absmax by shuffles, scale max(amax, 1e-8) * f32(1/127),
//       rint(x / scale) clipped to +-127) and store the int8 slot and its
//       scale. Each fresh position belongs to exactly one row, so no slot is
//       written twice; the dump page is never touched.
//   (b) ragged_attention_kernel, one block per (row, kv-head, tile of 16
//       flattened (query token, group head) rows): loads its q rows (packed
//       pre-rope and roped here in f32, cast through the model dtype, or
//       row-blocked [R, QB, H, D] post-rope), times scale, then walks the
//       row's live pages up to the tile's causal horizon, in chunks of
//       `chunk` slots (the page itself up to 32 slots; else 32, 16 or 8, a
//       divisor of the page), with the reference softmax update carried
//       from chunk to chunk: mask kpos <= qpos & kpos < kv_len & qrow < q_len,
//       finite -1e30 running max, masked lanes contribute 0, rows with l == 0
//       (padding, inactive rows with kv_len 0) emit zeros. Table entries are
//       clamped into [0, P). int8 pages are dequantized as
//       __fmul_rn(float(q8), scale) into shared memory before any product.
// Rope products and sums are rounded separately (__fmul_rn/__fadd_rn), the
// quantizer divides with __fdiv_rn: the same operations PyTorch performs
// elementwise, so written slots and scales agree with the plain version bit
// for bit, and the engine's three paths (rope-fused, fused-KV, two-op with a
// PyTorch rope and scatter) feed the one attention body the same values.
//
// Bound. At decode the kernels are memory-bound: the least time is the bytes
// of the live K/V pages (+ scales) + q + out + the fresh K/V written, over
// 3.35 TB/s (H100 SXM). The arithmetic (2 * 2 * D flops per unmasked
// (query, key) pair) is far below the tensor cores' rate at these shapes.
//
// Each chunk of K and V is fetched as 16-byte vectors (8 bf16/f16, 4 f32 or
// 16 int8 values, with their slots' scales: an int8 vector straddles two
// slots where D % 16 != 0, and takes each value's own scale) into registers
// one chunk ahead of its use, so one chunk's loads are in flight while the
// previous chunk computes; a chunk holds at most 8 KB of K a thread's output
// column (4 vectors a thread), which sets the chunk for f32 pools; q . k
// runs one thread per (query row, key slot) pair over padded shared-memory
// rows (no bank conflicts); P.V keeps each thread's output columns of the
// tile's rows in registers (one column up to head_dim 128, two up to 256).
//
// What the simple design leaves on the table: the dot products and the P.V
// update run on CUDA cores in f32 (no mma.sync / wgmma); the prefetch is one
// page deep through registers (no cp.async/TMA ring); a decode row's pages
// are walked by one block (no split over the sequence, so long contexts leave
// most SMs idle at small batch); tiles of a prefill row each re-read the
// row's pages; and q-tiles past a decode row's single token are launched only
// to write zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kQTile = 16;         // flattened (token, group head) rows/block
constexpr int kThreads = 128;
constexpr int kMaxChunk = 32;      // key slots a softmax step holds: a warp
// 16-byte vectors of one chunk's K (and of its V) per thread and output
// column: a chunk holds at most kThreads * kVecPerCol * 16 = 8 KB per head
// for each column a thread owns
constexpr int kVecPerCol = 4;
constexpr int kMaxLaneVals = 8;  // head_dim <= 32 * 8 for the quantizer
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

__device__ __forceinline__ int clamp_page(int p, int num_pages) {
  return p < 0 ? 0 : (p >= num_pages ? num_pages - 1 : p);
}

// One warp quantizes one (token, kv-head) vector of D <= 256 values: the f32
// widening of `src` (roped and cast through the model dtype first when ROPE),
// absmax over D, scale, rint(x / scale) clipped to +-127. Every lane ends with
// the same absmax whatever the order of the shuffles (max of finite values).
template <bool ROPE, typename T>
__device__ __forceinline__ void quantize_row(const T* src, int D,
                                             const float* sin_row,
                                             const float* cos_row,
                                             int8_t* dst, float* scale_dst,
                                             int lane) {
  float x[kMaxLaneVals];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxLaneVals; ++j) {
    const int d = lane + 32 * j;
    float v = 0.f;
    if (d < D) {
      if constexpr (ROPE) {
        v = to_f32(from_f32<T>(rope_elem(src, d, D, sin_row, cos_row)));
      } else {
        v = to_f32(src[d]);
      }
    }
    x[j] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
#pragma unroll
  for (int j = 0; j < kMaxLaneVals; ++j) {
    const int d = lane + 32 * j;
    if (d < D) {
      const float r = rintf(__fdiv_rn(x[j], sc));
      dst[d] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
    }
  }
  if (lane == 0) *scale_dst = sc;
}

template <bool ROPE, bool Q8, typename T>
__global__ void __launch_bounds__(kThreads)
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
                    const int* __restrict__ w_flats, int n_tok, int Hk, int D,
                    int P, int page, int W) {
  const int r = blockIdx.x, hk = blockIdx.y;
  const int qlen = q_lens[r];
  if (qlen <= 0 || kv_lens[r] <= 0) return;
  const int qstart = q_starts[r];
  const int f_base = w_flats[r] + qstart - w_starts[r];
  if constexpr (!Q8) {
    T* k_pages = static_cast<T*>(k_out);
    T* v_pages = static_cast<T*>(v_out);
    for (int idx = threadIdx.x; idx < qlen * D; idx += blockDim.x) {
      const int t = idx / D, d = idx - t * D;
      const int pos = qstart + t, f = f_base + t, pi = pos / page;
      if (f < 0 || f >= n_tok || pi >= W) continue;
      const int pid = clamp_page(tables[(size_t)r * W + pi], P);
      const size_t src = ((size_t)f * Hk + hk) * D;
      const size_t dst =
          (((size_t)pid * Hk + hk) * page + (pos - pi * page)) * D + d;
      if constexpr (ROPE) {
        k_pages[dst] = from_f32<T>(rope_elem(new_k + src, d, D,
                                             sin_tab + (size_t)f * D,
                                             cos_tab + (size_t)f * D));
      } else {
        k_pages[dst] = new_k[src + d];
      }
      v_pages[dst] = new_v[src + d];
    }
  } else {
    int8_t* k_pages = static_cast<int8_t*>(k_out);
    int8_t* v_pages = static_cast<int8_t*>(v_out);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    // one warp per fresh token; the skip below is uniform across a warp
    for (int t = warp; t < qlen; t += nwarps) {
      const int pos = qstart + t, f = f_base + t, pi = pos / page;
      if (f < 0 || f >= n_tok || pi >= W) continue;
      const int pid = clamp_page(tables[(size_t)r * W + pi], P);
      const size_t src = ((size_t)f * Hk + hk) * D;
      const size_t slot = ((size_t)pid * Hk + hk) * page + (pos - pi * page);
      const float* sin_row = ROPE ? sin_tab + (size_t)f * D : nullptr;
      const float* cos_row = ROPE ? cos_tab + (size_t)f * D : nullptr;
      quantize_row<ROPE, T>(new_k + src, D, sin_row, cos_row,
                            k_pages + slot * D, k_scale + slot, lane);
      quantize_row<false, T>(new_v + src, D, nullptr, nullptr,
                             v_pages + slot * D, v_scale + slot, lane);
    }
  }
}

// the pools' element as stored: the model dtype, or int8
template <typename T, bool Q8>
using Stored = typename std::conditional<Q8, int8_t, T>::type;

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

template <bool ROPE, bool Q8, typename T, int COLS>
__global__ void __launch_bounds__(kThreads) ragged_attention_kernel(
    const T* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ q_starts,
    const int* __restrict__ q_lens, const int* __restrict__ w_starts,
    const int* __restrict__ w_flats, T* __restrict__ out, int n_tok, int H,
    int Hk, int D, int P, int page, int W, int QB, int chunk, float scale) {
  using S = Stored<T, Q8>;
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

template <bool ROPE, bool Q8, typename T>
int launch_write(const void* new_k, const void* new_v, void* k_pages,
                 void* v_pages, void* k_scale, void* v_scale, const Meta& m,
                 int R, int n_tok, int Hk, int D, int P, int page, int W,
                 cudaStream_t stream) {
  kv_write_kernel<ROPE, Q8, T><<<dim3(R, Hk), kThreads, 0, stream>>>(
      (const T*)new_k, (const T*)new_v, k_pages, v_pages, (float*)k_scale,
      (float*)v_scale, m.sin_tab, m.cos_tab, m.tables, m.kv_lens, m.q_starts,
      m.q_lens, m.w_starts, m.w_flats, n_tok, Hk, D, P, page, W);
  return (int)cudaGetLastError();
}

template <bool ROPE, bool Q8, typename T, int COLS>
int launch_attention_cols(const void* q, const void* k_pages,
                          const void* v_pages, const void* k_scale,
                          const void* v_scale, const Meta& m, void* out,
                          int R, int n_tok, int H, int Hk, int D, int P,
                          int page, int W, int QB, float scale,
                          cudaStream_t stream) {
  const int chunk =
      chunk_slots(page, D, (int)sizeof(Stored<T, Q8>), COLS);
  const size_t smem = attention_smem(D, chunk);
  if (smem > 48 * 1024) {
    // above 48 KB only after an explicit opt-in; a refused launch never
    // runs and is reported only by cudaGetLastError
    const cudaError_t e = cudaFuncSetAttribute(
        ragged_attention_kernel<ROPE, Q8, T, COLS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (QB * (H / Hk) + kQTile - 1) / kQTile;
  ragged_attention_kernel<ROPE, Q8, T, COLS>
      <<<dim3(R, Hk, tiles), kThreads, smem, stream>>>(
          (const T*)q, k_pages, v_pages, (const float*)k_scale,
          (const float*)v_scale, m.sin_tab, m.cos_tab, m.tables, m.kv_lens,
          m.q_starts, m.q_lens, m.w_starts, m.w_flats, (T*)out, n_tok, H, Hk,
          D, P, page, W, QB, chunk, scale);
  return (int)cudaGetLastError();
}

template <bool ROPE, bool Q8, typename T>
int launch_attention(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scale, const void* v_scale, const Meta& m,
                     void* out, int R, int n_tok, int H, int Hk, int D, int P,
                     int page, int W, int QB, float scale,
                     cudaStream_t stream) {
  // one output column a thread up to D = 128, two up to 256
  if (D <= kThreads)
    return launch_attention_cols<ROPE, Q8, T, 1>(
        q, k_pages, v_pages, k_scale, v_scale, m, out, R, n_tok, H, Hk, D, P,
        page, W, QB, scale, stream);
  return launch_attention_cols<ROPE, Q8, T, 2>(
      q, k_pages, v_pages, k_scale, v_scale, m, out, R, n_tok, H, Hk, D, P,
      page, W, QB, scale, stream);
}

template <typename T>
int write_for(int rope, int q8, const void* new_k, const void* new_v,
              void* k_pages, void* v_pages, void* k_scale, void* v_scale,
              const Meta& m, int R, int n_tok, int Hk, int D, int P, int page,
              int W, cudaStream_t s) {
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

template <typename T>
int attention_for(int rope, int q8, const void* q, const void* k_pages,
                  const void* v_pages, const void* k_scale,
                  const void* v_scale, const Meta& m, void* out, int R,
                  int n_tok, int H, int Hk, int D, int P, int page, int W,
                  int QB, float scale, cudaStream_t s) {
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

}  // namespace

// C interface, loaded with ctypes. `dtype` is the model's: 0 bf16, 1 f16,
// 2 f32, the type of q, new_k, new_v, out and of float pools; the pools are
// that type (q8 = 0) or int8 with f32 [P, Hk, page, 1] scale sidecars
// (q8 = 1; null otherwise); the rope tables f32 [T, D] (rope = 1; null
// otherwise); the metadata int32. With rope = 0 the attention takes q
// row-blocked [R, QB, H, D] and needs no w_starts/w_flats. Each entry
// launches on `stream`, does not synchronise, and returns the
// cudaGetLastError() code of its launch (0 on success), or
// cudaErrorInvalidValue for a dtype code or geometry no kernel takes.
extern "C" {

const char* rpa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int rpa_kv_write(int dtype, int rope, int q8, const void* new_k,
                 const void* new_v, void* k_pages, void* v_pages,
                 void* k_scale, void* v_scale, const void* sin_tab,
                 const void* cos_tab, const void* tables, const void* kv_lens,
                 const void* q_starts, const void* q_lens,
                 const void* w_starts, const void* w_flats, int R, int n_tok,
                 int Hk, int D, int P, int page, int W, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  if (D % 8 || D > 256 || page % 8) return (int)cudaErrorInvalidValue;
  const Meta m{(const float*)sin_tab, (const float*)cos_tab,
               (const int*)tables,    (const int*)kv_lens,
               (const int*)q_starts,  (const int*)q_lens,
               (const int*)w_starts,  (const int*)w_flats};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return write_for<bf16>(rope, q8, new_k, new_v, k_pages, v_pages, k_scale,
                           v_scale, m, R, n_tok, Hk, D, P, page, W, s);
  if (dtype == 1)
    return write_for<__half>(rope, q8, new_k, new_v, k_pages, v_pages,
                             k_scale, v_scale, m, R, n_tok, Hk, D, P, page, W,
                             s);
  if (dtype == 2)
    return write_for<float>(rope, q8, new_k, new_v, k_pages, v_pages, k_scale,
                            v_scale, m, R, n_tok, Hk, D, P, page, W, s);
  return (int)cudaErrorInvalidValue;
}

int rpa_attention(int dtype, int rope, int q8, const void* q,
                  const void* k_pages, const void* v_pages,
                  const void* k_scale, const void* v_scale,
                  const void* sin_tab, const void* cos_tab, const void* tables,
                  const void* kv_lens, const void* q_starts,
                  const void* q_lens, const void* w_starts,
                  const void* w_flats, void* out, int R, int n_tok, int H,
                  int Hk, int D, int P, int page, int W, int QB, float scale,
                  void* stream) {
  (void)cudaGetLastError();
  if (D % 8 || D > 256 || page % 8) return (int)cudaErrorInvalidValue;
  const Meta m{(const float*)sin_tab, (const float*)cos_tab,
               (const int*)tables,    (const int*)kv_lens,
               (const int*)q_starts,  (const int*)q_lens,
               (const int*)w_starts,  (const int*)w_flats};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return attention_for<bf16>(rope, q8, q, k_pages, v_pages, k_scale,
                               v_scale, m, out, R, n_tok, H, Hk, D, P, page,
                               W, QB, scale, s);
  if (dtype == 1)
    return attention_for<__half>(rope, q8, q, k_pages, v_pages, k_scale,
                                 v_scale, m, out, R, n_tok, H, Hk, D, P, page,
                                 W, QB, scale, s);
  if (dtype == 2)
    return attention_for<float>(rope, q8, q, k_pages, v_pages, k_scale,
                                v_scale, m, out, R, n_tok, H, Hk, D, P, page,
                                W, QB, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
