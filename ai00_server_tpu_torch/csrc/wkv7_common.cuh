// Shared device code of the RWKV-7 WKV decode kernels (wkv7.cu's one-step
// wkv7_t1_kernel, v7_wkv_gn.cu's wkv_gn_kernel): the thread layout of one
// head's state and the sums over it.
//
// Thread layout: one head's N x N f32 state (HN = HEAD_N real rows and
// columns, laid out at N = HEAD_P, decode_common.cuh) over N / 4 row groups
// of CQ = N / 4 threads; a thread holds a 4 x 4 tile, four value rows (row
// group tid / CQ) by the four columns 4 cq .. 4 cq + 3 (cq = tid % CQ); the
// CQ threads of a row group cover its rows' columns, 4 N contiguous bytes a
// row, and sit in one warp (or half of one), so a row's sums over the head
// are shuffles (group_sum) and no block barrier is needed.  At HN = 64: 256
// threads, 16 row groups of 16.  Rows and columns at HN and above are
// masked: their threads read and write nothing and add zero to the sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace wkv7 {

constexpr int HN = decode::HEAD;     // head size: rows and columns in memory
constexpr int N = decode::HEAD_P;    // the tile's rows and columns
constexpr int CQ = N / 4;            // threads across a row group's columns
constexpr int THREADS = N * N / 16;  // a head's N / 4 row groups of CQ

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Sum over the CQ threads of a row group (lanes xor 1, 2, ... CQ / 2):
// every thread gets the same bits (ops/v7_decode.py:pair_sum).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < CQ; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace wkv7
