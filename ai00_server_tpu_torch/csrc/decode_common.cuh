// Shared device code of the fused decode steps (v7_decode.cu, v6_decode.cu):
// the activation types and their rounding, programmatic dependent launch,
// the GroupNorm's sums over a head, and the LayerNorm / token-shift kernel
// every stack launches.
//
// ln_mix_kernel (launched as v7_ln_mix by every stack): LayerNorm of the
// f32 residual, token shift against the f32 shift state, n_mix mixed
// outputs xa + round_T(dx * mix[i]) with xa = round_T(ln) and dx =
// round_T(shift - ln), and the new shift state (the f32 LayerNorm) for
// active rows.  With base = 2 the first two outputs are xa and dx
// themselves (RWKV-6 mixes its token shift with data-dependent offsets
// later in the layer).  Replaces the LayerNorm and token-shift lines of the
// Pallas decode kernels (ai00_server_tpu/ops/v7_decode_pallas.py:174-185).
// Bounded by latency (B x C elements: 32 KB at the 0.4B shape), so the
// design keeps the chain short: a row is cut into chunks of columns, one
// block each (B x chunks blocks: 64 at B = 8, C = 1024, not 8), every block
// reads its whole row once with 16-byte loads into registers, takes the
// mean and then the variance from the registers (two passes over
// registers, one barrier each: warp shuffles and one shared-memory
// exchange), and writes its chunk.  It fetches its LayerNorm and mix
// parameters before it waits for the kernel before it (programmatic
// dependent launch), reads x, the shift state and active with coherent
// loads after it, and lets the next kernel start at once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

constexpr float LN_EPS = 1e-5f;
constexpr float GN_EPS = 64e-5f;

#ifdef HEAD_N
// The head size of the WKV stages, HEAD = HEAD_N (ops/_build.py compiles
// each WKV source once per head size: N % 8 == 0, 8 <= N <= 128), and the
// size of their tiles, HEAD_P: the next power of two, at least 32.  A
// kernel lays a head out at HEAD_P and masks the rest: rows and columns
// at HEAD or above hold zeros, are never read from or written to device
// memory, and add zero to every sum.  At HEAD = 32, 64 and 128 nothing is
// masked.
__host__ __device__ constexpr int pad_head(int n) {
  int p = 32;
  while (p < n) p <<= 1;
  return p;
}
constexpr int HEAD = HEAD_N;
constexpr int HEAD_P = pad_head(HEAD_N);
static_assert(HEAD % 8 == 0 && HEAD >= 8 && HEAD <= 128,
              "head size: N % 8 == 0, 8 <= N <= 128");
// Whether row or column i (< HEAD_P) of a head's tile lies in the head:
// constant true where nothing is masked (HEAD == HEAD_P).
__device__ __forceinline__ bool in_head(int i) {
  return HEAD == HEAD_P || i < HEAD;
}
#endif

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
// Programmatic dependent launch
// ---------------------------------------------------------------------------

// Lets the next kernel of the stream start its blocks (launched with the
// programmatic-serialization attribute, it reads nothing this kernel writes
// before its grid_wait).
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Waits until the kernel before this one in the stream has finished and
// its writes are visible; a no-op in a kernel launched without the
// attribute.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Sums over a head (the WKV stages' GroupNorm)
// ---------------------------------------------------------------------------

// Sum over the 32 lanes of a warp, lanes 16 apart first, then 8, ... 1:
// every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

#ifdef HEAD_N
// The two-pass mean and variance of a head's HEAD values, lane l of a warp
// holding y[o] = value l + 32 o (HEAD_P / 32 of them; 0 at HEAD and
// above).  Halving order (ops/v7_decode.py:halving_sum over the HEAD_P
// values: value l + value l + HEAD_P / 2 first, down to a lane's one sum,
// then warp_sum) with no product fused into a sum, so every warp gets the
// same bits, and so does the PyTorch mirror.  At HEAD = 64: (y0 + y1),
// then warp_sum.
struct Moments {
  float mean, var;
};
constexpr int HEAD_LANE = HEAD_P / 32;  // values of a head a lane holds
__device__ __forceinline__ Moments head_moments(
    const float (&y)[HEAD_LANE]) {
  const int lane = threadIdx.x & 31;
  float t[HEAD_LANE];
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o) t[o] = y[o];
#pragma unroll
  for (int h = HEAD_LANE / 2; h > 0; h >>= 1)
#pragma unroll
    for (int o = 0; o < h; ++o) t[o] = t[o] + t[o + h];
  const float mean = warp_sum(t[0]) / HEAD;
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o) {
    const float d = in_head(lane + 32 * o) ? y[o] - mean : 0.f;
    t[o] = __fmul_rn(d, d);
  }
#pragma unroll
  for (int h = HEAD_LANE / 2; h > 0; h >>= 1)
#pragma unroll
    for (int o = 0; o < h; ++o) t[o] = __fadd_rn(t[o], t[o + h]);
  const float var = warp_sum(t[0]) / HEAD;
  return {mean, var};
}
#endif

// ---------------------------------------------------------------------------
// ln_mix_kernel
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 256;
constexpr int LN_MAXC = 4096;  // the row a block stages: 16 KB of f32

// Four f32 at p, 16-byte aligned.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// Four f32 from L2 (ld.global.cg).  A programmatic dependent runs while
// the kernel before it still does, so it must not read what an earlier
// kernel of the stream writes with ld.global.nc (SASS LDG.E.CONSTANT:
// __ldg, and nvcc's choice for a load through a const __restrict__
// pointer): the non-coherent path may return lines from before the
// writes.  The first PDL versions of the WKV stages read r, k, v and g so,
// and a CUDA graph's replay of every stack went wrong from its first step.
// The WKV stages read every kernel-written operand, and their state,
// with this; ln_mix_kernel with __ldca, the products' epilogues with plain
// loads (all coherent; tools/torch_sass_loads.py lists each kernel's
// loads by kind).
__device__ __forceinline__ float4 ld4_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Four elements of a vector from L2 (.cg) as floats: 16 bytes of f32 or
// 8 of bf16 (widened exactly).  i counts elements.  The one-step WKV
// kernels (wkv7.cu, wkv56.cu) read their vectors in the dtype the caller
// holds them in with this.
__device__ __forceinline__ float4 vec4_l2(const void* p, size_t i,
                                          bool bf16) {
  if (!bf16) return ld4_l2(static_cast<const float*>(p) + i);
  const uint2 t = __ldcg(reinterpret_cast<const uint2*>(
      static_cast<const uint16_t*>(p) + i));
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}

// Four T of p (8-byte aligned for bf16, 16 for f32) as floats, and back.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// Sum over the block's LN_THREADS threads, in a fixed order (lanes by
// shuffles, then the warps in order through red); every thread gets the
// total.  One barrier: red is not reused.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < LN_THREADS / 32; ++i) t += red[i];
  return t;
}

// Block (s, b): row b's statistics from the whole row (every block of the
// row reads it: 4-16 KB from L2), then the outputs of its `chunk` groups of
// four columns from 4 s chunk, one group a thread.  out: (base + n_mix, B,
// C); base is 0 or 2 (xa and dx first).  C a multiple of 4, at most
// LN_MAXC; chunk at most LN_THREADS.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_mix_kernel(const float* __restrict__ x, const T* __restrict__ ln,
              float* __restrict__ shift, const T* __restrict__ mix,
              const uint8_t* __restrict__ active, T* __restrict__ out, int B,
              int C, int n_mix, int base, int chunk) {
  constexpr int U = LN_MAXC / 4 / LN_THREADS;  // float4s of the row a thread
  __shared__ __align__(16) float4 xs[LN_MAXC / 4];
  __shared__ float red[2][LN_THREADS / 32];
  grid_launch_dependents();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int C4 = C / 4;
  const int j = blockIdx.x * chunk + tid;  // this thread's group of 4
  const bool mine = tid < chunk && j < C4;
  // The parameters first: nothing earlier in the stream writes them.
  float w[4], bias[4], m[6][4];
  if (mine) {
    load4(ln + 4 * j, w);
    load4(ln + C + 4 * j, bias);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (i < n_mix) load4(mix + (size_t)i * C + 4 * j, m[i]);
  }
  grid_wait();
  // x and active with coherent loads (__ldca: x is a const __restrict__
  // pointer, which nvcc would read with ld.global.nc; see ld4_l2).
  const float* xr = x + (size_t)b * C;
  float* sh = shift + (size_t)b * C;
  float prev[4];
  if (mine) load4(sh + 4 * j, prev);
  const bool act = __ldca(active + b) != 0;
  float4 v[U];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = tid + LN_THREADS * u;
    v[u] = q < C4 ? __ldca(reinterpret_cast<const float4*>(xr) + q)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < C4) xs[q] = v[u];
    s += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  const float mean = block_sum(s, red[0]) / C;
  float d2 = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tid + LN_THREADS * u < C4) {
      const float a = v[u].x - mean, c = v[u].y - mean;
      const float e = v[u].z - mean, f = v[u].w - mean;
      d2 += (a * a + c * c) + (e * e + f * f);
    }
  const float rstd = rsqrtf(block_sum(d2, red[1]) / C + LN_EPS);
  if (!mine) return;
  const float4 xv = xs[j];
  const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
  float lnv[4], xa[4], dx[4], o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lnv[e] = (xe[e] - mean) * rstd * w[e] + bias[e];
    xa[e] = rnd<T>(lnv[e]);
    dx[e] = rnd<T>(prev[e] - lnv[e]);
  }
  const size_t row = (size_t)b * C + 4 * j;
  if (base) {
    store4(out + row, xa);
    store4(out + (size_t)B * C + row, dx);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (i < n_mix) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = xa[e] + rnd<T>(dx[e] * m[i][e]);
      store4(out + (size_t)(base + i) * B * C + row, o);
    }
  if (act) store4(sh + 4 * j, lnv);  // the f32 LayerNorm, not rounded
}

}  // namespace decode
