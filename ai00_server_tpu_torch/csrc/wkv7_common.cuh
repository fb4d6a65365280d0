// Shared device code of the RWKV-7 WKV decode kernels (wkv7.cu's one-step
// wkv7_t1_kernel, v7_decode.cu's wkv_gn_kernel): the thread layout of one
// head's state and the sums over it.
//
// Thread layout: one head's 64 x 64 f32 state over 256 threads; a thread
// holds a 4 x 4 tile, four value rows (row group tid / CQ) by the four
// columns 4 cq .. 4 cq + 3 (cq = tid % CQ); the CQ = 16 threads of a row
// group cover its rows' 64 columns, 256 contiguous bytes a row, and sit in
// one half-warp, so a row's sums over the head are shuffles (group_sum)
// and no block barrier is needed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv7 {

constexpr int N = 64;         // head size (RWKV-7 uses 64 throughout)
constexpr int THREADS = 256;  // a head's 16 row groups of 16 threads
constexpr int CQ = 16;        // threads across a row group's 64 columns

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Sum over the 16 threads of a row group (lanes xor 1, 2, 4, 8): every
// thread gets the same bits (ops/v7_decode.py:pair_sum).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < CQ; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace wkv7
