// Shared device code of the fused decode steps (v7_decode.cu, v6_decode.cu):
// the activation types and their rounding, and the LayerNorm / token-shift
// kernel both stacks launch.
//
// ln_mix_kernel (launched as v7_ln_mix by both stacks): LayerNorm of the f32
// residual, token shift against the f32 shift state, n_mix mixed outputs
// xa + round_T(dx * mix[i]) with xa = round_T(ln) and dx = round_T(shift -
// ln), and the new shift state (the f32 LayerNorm) for active rows.  With
// base = 2 the first two outputs are xa and dx themselves (RWKV-6 mixes its
// token shift with data-dependent offsets later in the layer).  Bounded by
// latency: B x C elements, one block of 1024 threads per row, so that at
// C = 1024 each pass is one round of independent loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr float LN_EPS = 1e-5f;
constexpr float GN_EPS = 64e-5f;
constexpr int HEAD = 64;  // head size of the WKV stages

// ---------------------------------------------------------------------------
// Element types
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round through T and come back (the ".astype(cd).astype(f32)" points).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// ln_mix_kernel
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 1024;  // one element a thread at C = 1024

// Sum over the block, in a fixed order; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // the previous total has been read by every thread
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < LN_THREADS / 32; ++i) t += red[i];
  return t;
}

// out: (base + n_mix, B, C); base is 0 or 2 (xa and dx first).
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_mix_kernel(const float* __restrict__ x, const T* __restrict__ ln,
              float* __restrict__ shift, const T* __restrict__ mix,
              const uint8_t* __restrict__ active, T* __restrict__ out, int B,
              int C, int n_mix, int base) {
  __shared__ float red[LN_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xr = x + (size_t)b * C;
  float* sh = shift + (size_t)b * C;

  float s = 0.f;
  for (int c = tid; c < C; c += LN_THREADS) s += xr[c];
  const float mean = block_sum(s, red) / C;
  float q = 0.f;
  for (int c = tid; c < C; c += LN_THREADS) {
    const float d = xr[c] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / C + LN_EPS);
  const bool act = active[b] != 0;

  for (int c = tid; c < C; c += LN_THREADS) {
    const float lnv = (xr[c] - mean) * rstd * to_f(ln[c]) + to_f(ln[C + c]);
    const float prev = sh[c];
    const float xa = rnd<T>(lnv);
    const float dx = rnd<T>(prev - lnv);
    if (base) {
      out[(size_t)b * C + c] = from_f<T>(xa);
      out[((size_t)B + b) * C + c] = from_f<T>(dx);
    }
    for (int i = 0; i < n_mix; ++i) {
      const float m = rnd<T>(dx * to_f(mix[(size_t)i * C + c]));
      out[((size_t)(base + i) * B + b) * C + c] = from_f<T>(xa + m);
    }
    if (act) sh[c] = lnv;  // the f32 LayerNorm, not rounded through T
  }
}

// Sum over a head's HEAD = 64 values held by threads 0..63 (the others pass
// 0), in a fixed order; every thread gets the total.
__device__ __forceinline__ float head_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int tid = threadIdx.x;
  if (tid < HEAD && (tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  const float t = red[0] + red[1];
  __syncthreads();
  return t;
}

}  // namespace decode
