// Shared device code of the chunked-form prefill WKV kernels (wkv7.cu's
// wkv7_chunk, wkv56.cu's wkv56_chunk): the sub-chunk length, the padded row
// stride of the per-sub-chunk factor arrays, cp.async staging of a
// sub-chunk's inputs, and f32 matrix products on the tensor cores (3xTF32
// mma.sync) with their fragment layouts.
//
// Head size: the kernels lay a head out at N = HEAD_P (decode_common.cuh:
// the next power of two of HN = HEAD_N, at least 32), in shared memory and
// in the scratch; staging reads the HN real columns from device memory and
// fills the rest with zeros, which every product carries as exact zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace wkvc {

constexpr int HN = decode::HEAD;    // head size in device memory
constexpr int N = decode::HEAD_P;   // head size of the tiles
constexpr int R = 16;        // steps per sub-chunk
constexpr int NT = 256;      // threads per block
constexpr int LD = N + 4;    // padded row stride of the factor arrays
constexpr int NQ = R * (N / 4);  // float4s of a sub-chunk's input rows

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}

// 16 bytes global -> shared without registers; valid == false fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Calls f(q) for q = threadIdx.x, threadIdx.x + NT, ... below COUNT (a
// block of NT threads): once a thread where COUNT == NT, as at N = 64.
template <int COUNT, class F>
__device__ __forceinline__ void strided(F f) {
  if constexpr (COUNT == NT) {
    f((int)threadIdx.x);
  } else if constexpr (COUNT < NT) {
    if (threadIdx.x < COUNT) f((int)threadIdx.x);
  } else {
    static_assert(COUNT % NT == 0, "whole passes of the block");
#pragma unroll
    for (int i = 0; i < COUNT / NT; ++i) f((int)threadIdx.x + i * NT);
  }
}

// Stage steps t0 .. t0 + R - 1 of NIN (B, T, H, HN) inputs into
// dst[i][t][n] (zeros past T and at columns HN and above); float4 q of the
// sub-chunk is row q / (N / 4), columns 4 (q % (N / 4)) .. + 3, thread tid
// copying q = tid, tid + NT, ...
template <int NIN>
__device__ __forceinline__ void stage(float (*dst)[R][N],
                                      const float* const (&src)[NIN], int b,
                                      int h, int H, int T, int t0, int nin) {
  strided<NQ>([&](int q) {
    const int t = q / (N / 4), c = 4 * (q % (N / 4));
    const bool ok = t0 + t < T && decode::in_head(c);
    const size_t off = ok ? (((size_t)b * T + t0 + t) * H + h) * HN + c : 0;
#pragma unroll
    for (int i = 0; i < NIN; ++i)
      if (i < nin) cp_async16(&dst[i][t][c], src[i] + off, ok);
  });
  cp_async_commit();
}

// ---- f32 products on the tensor cores: 3xTF32 ----
//
// mma.sync m16n8k8 with tf32 operands and f32 sums.  An f32 operand x is
// split into x_hi, x rounded to tf32's 10 mantissa bits (half an ulp added,
// the low 13 bits cleared), and x_lo = x - x_hi, exact in f32, which the
// tensor cores read truncated to tf32; a product takes a_lo b_hi + a_hi b_lo
// + a_hi b_hi: ~21 of f32's 24 bits of each operand, against ~11 of plain
// TF32.  Fragments (g = lane / 4, q = lane % 4):
//   A 16 x 8:  a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B 8 x 8:   b0 (q, g), b1 (q + 4, g)
//   C 16 x 8:  c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo (x finite), hi a tf32 value, lo exact in f32.
template <int M>
__device__ __forceinline__ void split(const float (&x)[M], uint32_t (&hi)[M],
                                      uint32_t (&lo)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    hi[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

// One 16 x 8 x 8 step of a 3xTF32 product on split fragments: the large
// term into hi, the two small ones into lo (two accumulators, so that the
// three mma of a step do not wait on one another).
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(lo, al, bh);
  mma_tf32(lo, ah, bl);
  mma_tf32(hi, ah, bh);
}

// The A fragment of the 16 x 8 tile at (m0, k0) of A[m][k] = at(m, k).
template <class F>
__device__ __forceinline__ void frag_a(float (&a)[4], F at, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  a[0] = at(m0 + g, k0 + q);
  a[1] = at(m0 + g + 8, k0 + q);
  a[2] = at(m0 + g, k0 + q + 4);
  a[3] = at(m0 + g + 8, k0 + q + 4);
}

// The B fragment of the 8 x 8 tile at (k0, n0) of B[k][n] = at(k, n).
template <class F>
__device__ __forceinline__ void frag_b(float (&b)[2], F at, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  b[0] = at(k0 + q, n0 + g);
  b[1] = at(k0 + q + 4, n0 + g);
}

// Fills a C fragment of the 16 x 8 tile at (m0, n0) with at(m, n).
template <class F>
__device__ __forceinline__ void frag_c_set(float (&c)[4], F at, int m0,
                                           int n0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  c[0] = at(m0 + g, n0 + 2 * q);
  c[1] = at(m0 + g, n0 + 2 * q + 1);
  c[2] = at(m0 + g + 8, n0 + 2 * q);
  c[3] = at(m0 + g + 8, n0 + 2 * q + 1);
}

// Calls f(m, n, c) for the four elements of a C fragment of the 16 x 8 tile
// at (m0, n0).
template <class F>
__device__ __forceinline__ void frag_c(const float (&c)[4], F f, int m0,
                                       int n0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  f(m0 + g, n0 + 2 * q, c[0]);
  f(m0 + g, n0 + 2 * q + 1, c[1]);
  f(m0 + g + 8, n0 + 2 * q, c[2]);
  f(m0 + g + 8, n0 + 2 * q + 1, c[3]);
}

// c[i] += A_i B for MT 16-row tiles that share the 8-column tile at n0 of
// B: A_i[m][k] = at_a(i, m, k), B[k][n] = at_b(k, n), k < 8 KSTEPS.  Even
// and odd steps sum into separate accumulators (independent chains of mma),
// and the loops unroll fully, so the fragment loads of later steps are
// issued ahead.
template <int KSTEPS, int MT, class FA, class FB>
__device__ __forceinline__ void rows_product(float (&c)[MT][4], FA at_a,
                                             FB at_b, int n0) {
  float hi[2][MT][4] = {}, lo[2][MT][4] = {};
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    float fb[2];
    uint32_t bh[2], bl[2];
    frag_b(fb, at_b, 8 * ks, n0);
    split(fb, bh, bl);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float fa[4];
      uint32_t ah[4], al[4];
      frag_a(fa, [&](int m, int k) { return at_a(i, m, k); }, 0, 8 * ks);
      split(fa, ah, al);
      mma3(hi[ks & 1][i], lo[ks & 1][i], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[i][e] += (hi[0][i][e] + hi[1][i][e]) + (lo[0][i][e] + lo[1][i][e]);
}

// c += A B for the 16 x 8 tile at (0, n0): rows_product with one tile.
template <int KSTEPS, class FA, class FB>
__device__ __forceinline__ void tile_product(float (&c)[4], FA at_a, FB at_b,
                                             int n0) {
  float cc[1][4] = {{c[0], c[1], c[2], c[3]}};
  rows_product<KSTEPS, 1>(cc, [&](int, int m, int k) { return at_a(m, k); },
                          at_b, n0);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = cc[0][e];
}

// s[j] += A B_j for the 16 x 8 tiles at (m0, n0 + 8 j), j < NT8, that share
// the 16-row tile of A: A[m][k] = at_a(m, k), B[k][n] = at_b(k, n), k < 8
// KSTEPS; s holds the large terms, the small ones sum apart and are added
// at the end.
template <int KSTEPS, int NT8, class FA, class FB>
__device__ __forceinline__ void cols_product(float (&s)[NT8][4], FA at_a,
                                             FB at_b, int m0, int n0) {
  float lo[NT8][4] = {};
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    float fa[4];
    uint32_t ah[4], al[4];
    frag_a(fa, at_a, m0, 8 * ks);
    split(fa, ah, al);
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      float fb[2];
      uint32_t bh[2], bl[2];
      frag_b(fb, at_b, 8 * ks, n0 + 8 * j);
      split(fb, bh, bl);
      mma3(s[j], lo[j], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += lo[j][e];
}

}  // namespace wkvc
