// Shared device code of the RWKV-5/6 WKV kernels of wkv56.cu: the two
// register layouts of one head's k-major state S (N_k x N_v, f32, v
// contiguous) and the v5/v6 step on each.
//
// The tile (wkv56_t1_kernel, one decode step; v6_decode.cu's v6_wkv_gn
// keeps the same layout): a thread holds a 4 x 4 tile, four k rows (row
// group rg, rows 4 rg .. 4 rg + 3) by four value columns, in four float4
// registers: 16-byte loads and stores, the step's r, k, w, u at its rows
// and v at its columns in registers.  The readout sums over k: a thread
// over its four rows (step_tile), then the row groups by shuffles and
// through shared memory in the kernel.
//
// The column (wkv56_seq_kernel, the step-by-step chunk): HN threads per
// (b, h) block; thread v owns column v of S and holds it in HN registers,
// s[k] = S[k][v].  For each k the block's loads of S[k][.] are 4 HN
// contiguous bytes (coalesced), and both the readout and the update reduce
// over k inside one thread: no shuffles, no shared-memory reduction.  The
// step's vectors r, k, w, u are read by every thread at the same address
// (shared-memory broadcasts).
//
// Head size: HN = HEAD_N in device memory; the tile kernels lay a head out
// at N = HEAD_P (decode_common.cuh), the column kernel at HN.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace wkv56 {

constexpr int HN = decode::HEAD;   // head size in device memory
constexpr int N = decode::HEAD_P;  // head size of the tiles

__device__ __forceinline__ void load_col(float (&s)[HN], const float* S,
                                         int v) {
#pragma unroll
  for (int k = 0; k < HN; ++k) s[k] = S[(size_t)k * HN + v];
}

__device__ __forceinline__ void store_col(const float (&s)[HN], float* S,
                                          int v) {
#pragma unroll
  for (int k = 0; k < HN; ++k) S[(size_t)k * HN + v] = s[k];
}

// One v5/v6 step on column v:  y_v = sum_k r_k (S[k][v] + u_k k_k v_v) from
// the state before the step; then, if update, S[k][v] = w_k S[k][v] + k_k v_v.
// r_, k_, w_, u_ are the step's vectors in shared memory (HN floats each,
// 16-byte aligned).  The readout keeps four partial sums (k mod 4), so its
// chain of dependent multiply-adds is HN / 4 long, not HN.
__device__ __forceinline__ float step(float (&s)[HN], const float* r_,
                                      const float* k_, const float* w_,
                                      const float* u_, float v, bool update) {
  float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < HN / 4; ++j) {
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

// One v5/v6 step on a thread's 4 x 4 tile: s[i] is row k0 + i of S at the
// tile's four columns; r, k, w, u hold the step's vectors at rows k0 ..
// k0 + 3, v at the four columns.  y[e] += the tile's part of column e's
// readout from the state before the step, its rows in order:
// y_e = sum_i r_i (s[i]_e + u_i k_i v_e); then, if update,
// s[i]_e = w_i s[i]_e + k_i v_e (else s stays as it is, bit for bit).
__device__ __forceinline__ void step_tile(float4 (&s)[4], const float4& r,
                                          const float4& k, const float4& v,
                                          const float4& w, const float4& u,
                                          bool update, float (&y)[4]) {
  const float rr[4] = {r.x, r.y, r.z, r.w}, kk[4] = {k.x, k.y, k.z, k.w};
  const float ww[4] = {w.x, w.y, w.z, w.w}, uu[4] = {u.x, u.y, u.z, u.w};
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float se[4] = {s[i].x, s[i].y, s[i].z, s[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = kk[i] * vv[e];
      y[e] = fmaf(fmaf(uu[i], a, se[e]), rr[i], y[e]);
      se[e] = fmaf(ww[i], se[e], a);
    }
    if (update) s[i] = make_float4(se[0], se[1], se[2], se[3]);
  }
}

}  // namespace wkv56
