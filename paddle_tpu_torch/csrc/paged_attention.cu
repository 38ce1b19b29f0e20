// Decode-step paged attention for Hopper (sm_90a), replacing the TPU kernel
// paddle_tpu/ops/paged_attention.py `_make_paged` (pallas_call at :153, body
// `_decode_kernel` at :84): one query token per sequence, GQA, over a
// head-major paged pool [P, Hk, page, D] read through per-sequence block
// tables, with an f32 online softmax.
//
// The TPU kernel runs grid (B, Hk, max_pages) and carries (m, l, acc) in VMEM
// scratch from one page's grid step to the next. Blocks here run in parallel
// in no order, so the page loop lives inside the block:
//
//   one block per (sequence, kv head), holding that head's G query heads
//   (scaled by `scale` in f32, in shared memory). Its NW warps split the
//   row's keys in 8-key tiles (page % 8 == 0, so a tile never straddles a
//   page) in a fixed interleave: warp w takes tiles w, w + NW, ... Each warp
//   streams its tiles' K and V rows with cp.async (16 bytes a lane) into its
//   own ring of kStages tiles in shared memory, so kStages - 1 tiles are in
//   flight while one computes, and keeps its own f32 (m, l, acc[G, D]) in
//   shared memory: scores one lane per (head, key) pair, the softmax update
//   by shuffles within each head's 8 lanes, P.V one lane per output column.
//   After the loop the block merges the warps' states in warp order and
//   writes acc / l in q's dtype.
//
// Rows are independent and runs repeat bit for bit: no atomics, and every
// sum's order depends only on the row's own context length and the shapes
// (NW depends on G, D and the pool dtype alone). Only the first
// ceil(n / page) table entries are read (n = min(context_len, W * page), the
// keys both reference paths attend), so the table's tail is never read;
// live entries are clamped into [0, P) as the reference clamps them. A row
// with context_len 0 writes zeros (the reference's Pallas kernel divides
// 0 / 0 there). Key slots of a tile past the context are copied but never
// enter a sum.
//
// Bound. Decode is memory-bound: the least time is the live K/V pages + q +
// out + tables over 3.35 TB/s (H100 SXM); 4 * D flops per (query head, key)
// pair are far below the card's rates. What this simple design leaves on the
// table: products on CUDA cores in f32 (no mma), one block per (sequence, kv
// head) walks the whole row (no split over the sequence: at long context and
// small batch most SMs idle while a few blocks stream whole rows).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kTile = 8;           // keys per tile
constexpr int kStages = 3;         // tiles of a warp's ring
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// four consecutive elements (8-byte aligned for 2-byte types, 16 for f32)
__device__ __forceinline__ float4 load4(const bf16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const __half2* h = reinterpret_cast<const __half2*>(p);
  const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Padded strides: q rows (f32) at QS = 8 (mod 32) words and K/V tile rows at
// 16 (mod 128) bytes, so the lanes of one score step, 4 heads x 8 keys, hit
// distinct banks.
__host__ __device__ inline int q_stride(int D) {
  return D + (40 - D % 32) % 32;
}
__host__ __device__ inline int row_bytes(int D, int esize) {
  const int b = D * esize;
  return b + (144 - b % 128) % 128;
}

// Shared memory of one block: [q: G x QS f32][rings: NW x kStages x (K, V) x
// kTile rows][acc: NW x G x D f32][p: NW x G x kTile][m, l, alpha: NW x G]
__host__ __device__ inline size_t smem_bytes(int G, int D, int esize,
                                             int nw) {
  return sizeof(float) * (size_t)G * q_stride(D) +
         (size_t)nw * kStages * 2 * kTile * row_bytes(D, esize) +
         sizeof(float) * (size_t)nw * G * (D + kTile + 3);
}

// The most warps (8, 4, 2 or 1) whose block fits the card's shared memory; 0
// when not even one warp's does.
inline int pick_warps(int G, int D, int esize) {
  for (int nw = kMaxWarps; nw >= 1; nw /= 2)
    if (smem_bytes(G, D, esize, nw) <= (size_t)kMaxSmem) return nw;
  return 0;
}

template <typename TKV, typename TQ>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pages,
                           const TKV* __restrict__ v_pages,
                           const int* __restrict__ tables,
                           const int* __restrict__ lens, TQ* __restrict__ out,
                           int H, int Hk, int D, int P, int page, int W,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / Hk;
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int QS = q_stride(D);
  const int RB = row_bytes(D, (int)sizeof(TKV));
  const int tile_bytes = kTile * RB;

  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* rings = smem + sizeof(float) * (size_t)G * QS;
  float* acc_all = reinterpret_cast<float*>(
      rings + (size_t)nw * kStages * 2 * tile_bytes);
  float* p_all = acc_all + (size_t)nw * G * D;
  float* m_all = p_all + (size_t)nw * G * kTile;
  float* l_all = m_all + (size_t)nw * G;
  float* a_all = l_all + (size_t)nw * G;
  unsigned char* ring = rings + (size_t)w * kStages * 2 * tile_bytes;
  float* acc = acc_all + (size_t)w * G * D;
  float* p_s = p_all + (size_t)w * G * kTile;
  float* m_s = m_all + (size_t)w * G;
  float* l_s = l_all + (size_t)w * G;
  float* a_s = a_all + (size_t)w * G;

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    q_s[g * QS + d] = to_f32(q[((size_t)b * H + hk * G + g) * D + d]) * scale;
  }
  for (int i = lane; i < G * D; i += 32) acc[i] = 0.f;
  for (int i = lane; i < G; i += 32) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // keys this row attends: its context, at most the table's W pages
  const int ctx = lens[b];
  const long long cap = (long long)W * page;
  const int n_keys = ctx <= 0 ? 0 : (int)(ctx < cap ? ctx : cap);
  const int n_tiles = (n_keys + kTile - 1) / kTile;
  const int my_tiles = w < n_tiles ? (n_tiles - w + nw - 1) / nw : 0;
  const int row_vecs = D * (int)sizeof(TKV) / 16;  // 16-byte vectors a row
  const int vecs = kTile * row_vecs;

  // the i-th tile of this warp into ring slot i % kStages
  auto issue = [&](int i) {
    const int key0 = (w + i * nw) * kTile;
    const int pi = key0 / page;
    int pid = tables[(size_t)b * W + pi];
    pid = pid < 0 ? 0 : (pid >= P ? P - 1 : pid);
    const size_t slot0 = ((size_t)pid * Hk + hk) * page + (key0 - pi * page);
    const unsigned char* kg =
        reinterpret_cast<const unsigned char*>(k_pages + slot0 * D);
    const unsigned char* vg =
        reinterpret_cast<const unsigned char*>(v_pages + slot0 * D);
    unsigned char* ks = ring + (size_t)(i % kStages) * 2 * tile_bytes;
    unsigned char* vs = ks + tile_bytes;
    for (int v = lane; v < vecs; v += 32) {
      const int j = v / row_vecs, c = v - j * row_vecs;
      cp_async16(ks + j * RB + c * 16, kg + (size_t)v * 16);
      cp_async16(vs + j * RB + c * 16, vg + (size_t)v * 16);
    }
  };

  // one group per step, empty or not, so wait_group counts stay aligned
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_tiles) issue(i);
    cp_async_commit();
  }
  const int slices = (G * kTile + 31) / 32;  // 4 heads x 8 keys a slice
  for (int i = 0; i < my_tiles; ++i) {
    if (i + kStages - 1 < my_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* ks = ring + (size_t)(i % kStages) * 2 * tile_bytes;
    const unsigned char* vs = ks + tile_bytes;
    const int key0 = (w + i * nw) * kTile;
    const int n_valid = min(kTile, n_keys - key0);

    // scores and the softmax update: lane = (head within slice, key)
    for (int sl = 0; sl < slices; ++sl) {
      const int g = sl * 4 + (lane >> 3), j = lane & 7;
      const bool live = g < G;
      float s = kNegInf;
      if (live && j < n_valid) {
        const float* qr = q_s + g * QS;
        const TKV* kr = reinterpret_cast<const TKV*>(ks + j * RB);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 k4 = load4(kr + d);
          s0 += a.x * k4.x;
          s1 += a.y * k4.y;
          s2 += a.z * k4.z;
          s3 += a.w * k4.w;
        }
        s = (s0 + s1) + (s2 + s3);
      }
      float m_cur = s;
      for (int o = 4; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = live ? m_s[g] : kNegInf;
      const float m_new = fmaxf(m_prev, m_cur);
      const float pe = (live && j < n_valid) ? expf(s - m_new) : 0.f;
      float sum = pe;
      for (int o = 4; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (live) {
        p_s[g * kTile + j] = pe;
        if (j == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
          a_s[g] = alpha;
        }
      }
    }
    __syncwarp();
    // P.V: lane owns columns d = lane + 32c of every head
    for (int d = lane; d < D; d += 32) {
      float vr[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        vr[j] = j < n_valid
                    ? to_f32(reinterpret_cast<const TKV*>(vs + j * RB)[d])
                    : 0.f;
      for (int g = 0; g < G; ++g) {
        const float4 p0 = *reinterpret_cast<const float4*>(p_s + g * kTile);
        const float4 p1 =
            *reinterpret_cast<const float4*>(p_s + g * kTile + 4);
        float a = acc[g * D + d] * a_s[g];
        a += p0.x * vr[0];
        a += p0.y * vr[1];
        a += p0.z * vr[2];
        a += p0.w * vr[3];
        a += p1.x * vr[4];
        a += p1.y * vr[5];
        a += p1.z * vr[6];
        a += p1.w * vr[7];
        acc[g * D + d] = a;
      }
    }
    // every lane is done with this ring slot before it is refilled
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps' states in warp order; l == 0 (no key) writes zeros
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float m = kNegInf;
    for (int u = 0; u < nw; ++u) m = fmaxf(m, m_all[u * G + g]);
    float l = 0.f, a = 0.f;
    for (int u = 0; u < nw; ++u) {
      const float f = expf(m_all[u * G + g] - m);
      l += l_all[u * G + g] * f;
      a += acc_all[((size_t)u * G) * D + i] * f;
    }
    out[((size_t)b * H + hk * G) * D + i] = from_f32<TQ>(l > 0.f ? a / l : 0.f);
  }
}

template <typename TKV, typename TQ>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lens, void* out, int B, int H,
           int Hk, int D, int P, int page, int W, float scale,
           cudaStream_t stream) {
  const int G = H / Hk;
  const int nw = pick_warps(G, D, (int)sizeof(TKV));
  if (nw == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(G, D, (int)sizeof(TKV), nw);
  if (smem > 48 * 1024) {
    // above 48 KB only after an explicit opt-in; a refused launch never
    // runs and is reported only by cudaGetLastError
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TKV, TQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<TKV, TQ><<<dim3(B, Hk), nw * 32, smem, stream>>>(
      (const TQ*)q, (const TKV*)k_pages, (const TKV*)v_pages,
      (const int*)tables, (const int*)lens, (TQ*)out, H, Hk, D, P, page, W,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. kv_dtype: 0 bf16, 1 f16, 2 f32 pools;
// q and out are in the pools' dtype, or f32 when q_f32 = 1 (always for f32
// pools); tables [B, W] and lens [B] are int32. pa_attention launches on
// `stream`, does not synchronise, and returns the cudaGetLastError() code of
// its launch (0 on success). pa_smem_bytes gives a block's shared memory for
// a group of G query heads at head_dim D over pools of `esize`-byte elements,
// 0 when it does not fit.
extern "C" {

const char* pa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pa_smem_bytes(int G, int D, int esize) {
  const int nw = pick_warps(G, D, esize);
  return nw ? (int)smem_bytes(G, D, esize, nw) : 0;
}

int pa_attention(int kv_dtype, int q_f32, const void* q, const void* k_pages,
                 const void* v_pages, const void* tables, const void* lens,
                 void* out, int B, int H, int Hk, int D, int P, int page,
                 int W, float scale, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not a stale one
  const cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 2)
    return launch<float, float>(q, k_pages, v_pages, tables, lens, out, B, H,
                                Hk, D, P, page, W, scale, s);
  if (kv_dtype == 1)
    return q_f32 ? launch<__half, float>(q, k_pages, v_pages, tables, lens,
                                         out, B, H, Hk, D, P, page, W, scale,
                                         s)
                 : launch<__half, __half>(q, k_pages, v_pages, tables, lens,
                                          out, B, H, Hk, D, P, page, W, scale,
                                          s);
  if (kv_dtype == 0)
    return q_f32 ? launch<bf16, float>(q, k_pages, v_pages, tables, lens, out,
                                       B, H, Hk, D, P, page, W, scale, s)
                 : launch<bf16, bf16>(q, k_pages, v_pages, tables, lens, out,
                                      B, H, Hk, D, P, page, W, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
