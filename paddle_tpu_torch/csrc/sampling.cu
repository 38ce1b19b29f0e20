// The sampler's random pass for Hopper (sm_90a): threefry2x32 counter bits,
// the uniform in [tiny, 1), Gumbel noise g = -log(-log(u)), and per row the
// argmax of where(s >= thr, s + g, -inf) with ties to the lowest index.
//
// There is no Pallas kernel to replace: the reference leaves this pass to XLA
// (inference/sampling.py `sampled_next_tokens`, the gumbel draw and argmax at
// its end; models/llama.py `_pick_token`, `categorical`). The draw is the
// reference's bit for bit up to the two logf calls: row i's key is
// threefry(k = (0, seed_i), x = (0, fold_i)), as fold_in(key(seed), fold)
// computes it; element j's bits are y0 ^ y1 of threefry(key, (hi, lo)) over
// the 64-bit counter base_i + j; the uniform takes the top 23 bits as the
// mantissa of a float in [1, 2), subtracts 1 and lifts 0 to FLT_MIN.
//
// Bound. Each element costs about 85 32-bit integer operations (20 rounds of
// add, funnel-shift rotate and xor, 5 key injections, the counter and the
// uniform) and two logf calls, against 4 bytes of scores read: the integer
// pipe (64 lanes an SM, a quarter of the f32 FMA rate) bounds the kernel, not
// memory. The design keeps all of it in registers: a block takes kTile
// consecutive elements of one row (each thread kPerThread of them, the
// rounds of independent elements interleaved by the unrolled loop), the row's
// key is derived once per block, and nothing of the [N, V] noise reaches
// memory. The argmax packs (value, index) into one 64-bit key that orders by
// value and then by lowest index (NaN as the largest, -0 as +0, as argmax
// compares them), reduced in the warp by shuffles, across warps in shared
// memory, and across the row's blocks by one atomicMax each; the row's last
// block (one ticket counter a row) writes the token and leaves the key and
// the ticket at zero for the next launch.
//
// gumbel_noise writes the bits, uniforms and g of the same draw (tests and
// the card check only), from the same device code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435e-38f;   // FLT_MIN

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, R1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, R2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, R3); x1 ^= x0;
}

// Threefry-2x32, 20 rounds, in place on (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

struct RowKey {
  uint32_t k0, k1;
};

// fold_in(key(seed), fold): threefry((0, seed), (0, fold)).
__device__ __forceinline__ RowKey row_key(int seed, int fold) {
  uint32_t x0 = 0u, x1 = (uint32_t)fold;
  threefry(0u, (uint32_t)seed, x0, x1);
  return {x0, x1};
}

__device__ __forceinline__ uint32_t bits_at(RowKey key, uint64_t counter) {
  uint32_t x0 = (uint32_t)(counter >> 32), x1 = (uint32_t)counter;
  threefry(key.k0, key.k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f + kTiny, kTiny);
}

__device__ __forceinline__ float gumbel(float u) {
  return -logf(-logf(u));
}

// (value, index) as one key: larger value first, then lower index.
__device__ __forceinline__ unsigned long long argmax_key(float z, int j) {
  uint32_t b = __float_as_uint(z);
  if ((b << 1) == 0u) b = 0u;             // -0 ties with +0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (z != z) b = 0xFFFFFFFFu;            // NaN is the largest
  return ((unsigned long long)b << 32) | (0xFFFFFFFFu - (uint32_t)j);
}

__global__ void __launch_bounds__(kThreads)
gumbel_argmax_kernel(const float* __restrict__ scores,
                     const int* __restrict__ seeds,
                     const int* __restrict__ folds,
                     const long long* __restrict__ bases,
                     const float* __restrict__ thr,
                     long long* __restrict__ out,
                     unsigned long long* keys, unsigned int* tickets, int v) {
  __shared__ RowKey s_key;
  __shared__ unsigned long long s_best[kThreads / 32];
  const int row = blockIdx.y;
  if (threadIdx.x == 0) s_key = row_key(seeds[row], folds[row]);
  __syncthreads();
  const RowKey key = s_key;
  const uint64_t base = (uint64_t)bases[row];
  const float t = thr[row];
  const float* s = scores + (size_t)row * v;
  const int j0 = blockIdx.x * kTile + threadIdx.x;
  unsigned long long best = 0ull;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = j0 + i * kThreads;
    if (j < v) {
      const float x = s[j];
      const float g = gumbel(uniform(bits_at(key, base + (uint64_t)j)));
      const float z = x >= t ? x + g : -INFINITY;
      const unsigned long long k = argmax_key(z, j);
      best = k > best ? k : best;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    best = o > best ? o : best;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      best = s_best[w] > best ? s_best[w] : best;
    atomicMax(keys + row, best);
    __threadfence();
    if (atomicAdd(tickets + row, 1u) == gridDim.x - 1) {
      const unsigned long long k = atomicExch(keys + row, 0ull);
      out[row] = (long long)(0xFFFFFFFFu - (uint32_t)(k & 0xFFFFFFFFull));
      tickets[row] = 0u;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gumbel_noise_kernel(const int* __restrict__ seeds,
                    const int* __restrict__ folds,
                    const long long* __restrict__ bases,
                    int* __restrict__ bits_out, float* __restrict__ u_out,
                    float* __restrict__ g_out, int v) {
  __shared__ RowKey s_key;
  const int row = blockIdx.y;
  if (threadIdx.x == 0) s_key = row_key(seeds[row], folds[row]);
  __syncthreads();
  const RowKey key = s_key;
  const uint64_t base = (uint64_t)bases[row];
  const size_t off = (size_t)row * v;
  const int j0 = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int j = j0 + i * kThreads;
    if (j < v) {
      const uint32_t b = bits_at(key, base + (uint64_t)j);
      const float u = uniform(b);
      bits_out[off + j] = (int)b;
      u_out[off + j] = u;
      g_out[off + j] = gumbel(u);
    }
  }
}

dim3 grid_of(int n, int v) { return dim3((v + kTile - 1) / kTile, n); }

}  // namespace

extern "C" {

const char* sm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int sm_gumbel_argmax(const void* scores, const void* seeds, const void* folds,
                     const void* bases, const void* thr, void* out,
                     void* keys, void* tickets, int n, int v, void* stream) {
  gumbel_argmax_kernel<<<grid_of(n, v), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)scores, (const int*)seeds, (const int*)folds,
      (const long long*)bases, (const float*)thr, (long long*)out,
      (unsigned long long*)keys, (unsigned int*)tickets, v);
  return (int)cudaGetLastError();
}

int sm_gumbel_noise(const void* seeds, const void* folds, const void* bases,
                    void* bits, void* u, void* g, int n, int v,
                    void* stream) {
  gumbel_noise_kernel<<<grid_of(n, v), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)seeds, (const int*)folds, (const long long*)bases,
      (int*)bits, (float*)u, (float*)g, v);
  return (int)cudaGetLastError();
}

}  // extern "C"
