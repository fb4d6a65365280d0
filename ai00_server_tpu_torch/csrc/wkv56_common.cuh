// Shared device code of the RWKV-5/6 WKV kernels: the register layout of one
// head's k-major state and the step on it.  Included by wkv56.cu (one WKV
// step, a T-token chunk).
//
// Thread layout: N = 64 threads per (b, h) block; thread v owns column v of
// the head's state S (N_k x N_v, f32, v contiguous) and holds it in 64
// registers, s[k] = S[k][v].  For each k the block's loads of S[k][.] are 256
// contiguous bytes (coalesced), and both the readout and the update reduce
// over k inside one thread: no shuffles, no shared-memory reduction.  The
// step's vectors r, k, w, u are read by every thread at the same address
// (shared-memory broadcasts).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv56 {

constexpr int N = 64;  // head size (RWKV-5/6 use 64 throughout)

__device__ __forceinline__ void load_col(float (&s)[N], const float* S,
                                         int v) {
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = S[(size_t)k * N + v];
}

__device__ __forceinline__ void store_col(const float (&s)[N], float* S,
                                          int v) {
#pragma unroll
  for (int k = 0; k < N; ++k) S[(size_t)k * N + v] = s[k];
}

// One v5/v6 step on column v:  y_v = sum_k r_k (S[k][v] + u_k k_k v_v) from
// the state before the step; then, if update, S[k][v] = w_k S[k][v] + k_k v_v.
// r_, k_, w_, u_ are the step's vectors in shared memory (N floats each,
// 16-byte aligned).  The readout keeps four partial sums (k mod 4), so its
// chain of dependent multiply-adds is N / 4 long, not N.
__device__ __forceinline__ float step(float (&s)[N], const float* r_,
                                      const float* k_, const float* w_,
                                      const float* u_, float v, bool update) {
  float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 r = reinterpret_cast<const float4*>(r_)[j];
    const float4 k = reinterpret_cast<const float4*>(k_)[j];
    const float4 w = reinterpret_cast<const float4*>(w_)[j];
    const float4 u = reinterpret_cast<const float4*>(u_)[j];
    const float a[4] = {k.x * v, k.y * v, k.z * v, k.w * v};
    const float rr[4] = {r.x, r.y, r.z, r.w};
    const float uu[4] = {u.x, u.y, u.z, u.w};
    const float ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& se = s[4 * j + e];
      y[e] = fmaf(fmaf(uu[e], a[e], se), rr[e], y[e]);
      if (update) se = fmaf(ww[e], se, a[e]);
    }
  }
  return (y[0] + y[1]) + (y[2] + y[3]);
}

}  // namespace wkv56
