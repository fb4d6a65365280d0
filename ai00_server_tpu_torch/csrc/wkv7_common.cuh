// Shared device code of the RWKV-7 WKV kernels: the register layout of one
// head's state and the delta-rule update / readout on it.  Included by
// wkv7.cu (one WKV step, a T-token chunk); v7_decode.cu's WKV stage takes
// its constants and dot4.
//
// Thread layout: 256 threads per (b, h) block, tid = row * 4 + q; thread q
// of a row owns columns 16*j + 4*q + e (j, e in 0..3) of its state row, so
// for each j the four threads of a row read 64 contiguous bytes (coalesced
// global loads, no shared-memory bank conflicts).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv7 {

constexpr int N = 64;             // head size (RWKV-7 uses 64 throughout)
constexpr int TPR = 4;            // threads per state row
constexpr int THREADS = N * TPR;  // 256
constexpr int J = N / (4 * TPR);  // float4 groups per thread (4)

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// One delta-rule update of a thread's 16 state elements; w_, k_, kk_, a_
// are this step's vectors in shared memory (N floats each).
__device__ __forceinline__ void update(float4 (&s)[J], const float* w_,
                                       const float* k_, const float* kk_,
                                       const float* a_, float v, int q) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float4 kk = reinterpret_cast<const float4*>(kk_)[4 * j + q];
    part += dot4(s[j], kk);
  }
  const float skk = row_sum(part);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float4 w = reinterpret_cast<const float4*>(w_)[4 * j + q];
    const float4 k = reinterpret_cast<const float4*>(k_)[4 * j + q];
    const float4 kk = reinterpret_cast<const float4*>(kk_)[4 * j + q];
    const float4 a = reinterpret_cast<const float4*>(a_)[4 * j + q];
    s[j].x = s[j].x * w.x - skk * (kk.x * a.x) + v * k.x;
    s[j].y = s[j].y * w.y - skk * (kk.y * a.y) + v * k.y;
    s[j].z = s[j].z * w.z - skk * (kk.z * a.z) + v * k.z;
    s[j].w = s[j].w * w.w - skk * (kk.w * a.w) + v * k.w;
  }
}

__device__ __forceinline__ float readout(const float4 (&s)[J],
                                         const float* r_, int q) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    part += dot4(s[j], reinterpret_cast<const float4*>(r_)[4 * j + q]);
  return row_sum(part);
}

}  // namespace wkv7
