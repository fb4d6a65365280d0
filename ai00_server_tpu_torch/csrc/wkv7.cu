// RWKV-7 WKV kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Both kernels compute the v7 delta-rule recurrence on one head's state
// S (N_v x N_k, f32, k contiguous):
//
//     S' = S diag(w) - (S kk)(kk * a)^T + v k^T,     y = S' r
//
// wkv7_t1_launch replaces ai00_server_tpu/ops/wkv_t1.py:wkv7_t1 (the
// Pallas _v7_kernel): one decode step, row-masked — an inactive row keeps
// S bit for bit and y reads the kept S.  What bounds it: the state's bytes
// (16 KB a head read, 16 KB written: 4.2 MB at B=8, H=16, 1.25 us at 3.35
// TB/s) under a chain of latencies - the launch, the state's DRAM round
// trip, two sums over a row, the store.  The design shortens the chain:
//  * one launch for the whole call: the six vectors are read in the dtype
//    the caller holds them in, each f32 or bf16 by a bit of vec_bf16 (the
//    layer path's r, k, v, kk, a are bf16 and w f32; bf16 -> f32 is exact),
//    so no cast kernels run before it;
//  * a programmatic dependent launch (launch_ex, pdl): it lets the next
//    kernel start at once and fetches this head's state rows (ld4_l2)
//    before griddepcontrol.wait, so the state's DRAM round trip overlaps
//    the kernel before it; the vectors and the mask, which that kernel may
//    have written, after it, from L2 (.cg: never ld.global.nc on a
//    kernel-written operand, see decode_common.cuh:ld4_l2);
//  * a thread holds a 4 x 4 state tile in registers (wkv7_common.cuh, the
//    layout of v7_decode.cu's wkv_gn_kernel): 16-byte loads and stores, the
//    vectors of its four columns and four rows in registers, each row's
//    S kk and S' r over its 16 threads by shuffles, no block barrier;
//  * v7's rows are independent, so a head is split over 2 or 4 blocks of
//    128 or 64 threads (the kernel takes 1, 2 or 4; ops/wkv_t1.py:plan
//    picks 4 while B x H heads leave SMs idle).
// The early state fetch is safe only while the kernel launched just
// before this one did not write S: on the layer path (models/v7.py) that
// launch is a PyTorch op, which starts after everything before it has
// finished, and S is this layer's state from an earlier step.
//
// wkv7_chunk_launch replaces ai00_server_tpu/ops/wkv_pallas.py:wkv7_chunk
// (the Pallas _wkv7_kernel): the same recurrence over a T-token chunk.  A
// masked step is the identity (w = 1, k = kk = 0, as the JAX wrapper folds
// it): it leaves S unchanged and its y reads the kept S.  It computes the
// chunked WY form of ai00_server_tpu/ops/wkv_chunked.py:wkv7_chunk_mm over
// sub-chunks of R = 16 steps.  With A_t the cumulative decay inside a
// sub-chunk (A_0 = 1) and
//
//     kbar = A_{t-1} kk,  bbar = (kk a) / A_t,  kdec = k / A_t,  rbar = r A_t
//     Cb[t][j] = kbar_t . bbar_j (j < t),   Ck[t][j] = kbar_t . kdec_j (j < t)
//     Mb[t][j] = rbar_t . bbar_j (j <= t),  Mk[t][j] = rbar_t . kdec_j (j <= t)
//     P = (I + Cb)^-1 kbar,  Q = (I + Cb)^-1 Ck,  Rq = rbar - Mb P,
//     G = Mk - Mb Q
//
// a sub-chunk starting from state S gives
//
//     D  = -(P S^T + Q V)                      (the WY vectors, R x N_v)
//     Y  = Rq S^T + G V                        (the R outputs)
//     S' = S diag(A_R) + D^T (bbar A_R) + V^T (kdec A_R)
//
// PRECONDITION: the division by A is safe only because v7's decay has a
// floor, w = exp(-exp(-0.5) sigmoid(.)) >= 0.5452 (models/v7.py W_SCALE),
// so 1 / A <= 1.6e4 over 16 steps; every product above pairs a 1 / A_j
// with an A_t, t >= j, so the R x R matrices and the scaled factors are
// bounded by the inputs.  A decay far below the floor overflows 1 / A.
//
// What bounds it on an H100 at the serving shape (B=8, H=16, N=64, T=256):
// bytes and latency.  The step-by-step kernel it replaced ran one block
// per (b, h) along a 256-step chain of dependent reductions (16 blocks at
// B=1, 0.16 ms whatever B).  Here the only chain is over the 16 sub-chunks,
// and only the state's part of a sub-chunk lies on it.  Two launches:
//  * pass 1, wkv7_factors_kernel: one block of 256 threads per (b, h,
//    sub-chunk), all in parallel: the cumulative decay, the factors, the
//    four R x R products and Rq, G on the tensor cores, the forward
//    substitution on the CUDA cores; the factors go to a scratch buffer the
//    wrapper allocates (18.7 KB per sub-chunk).  A masked sub-chunk writes
//    Rq = r only.
//  * pass 2, wkv7_state_kernel: one block of 256 threads per (b, h, slice
//    of 64 / S state rows), S = 1, 2 or 4 (ops/wkv_chunk.py:plan); the
//    state rows stay in registers as mma accumulator fragments for the
//    whole chunk; per sub-chunk the block stages the next sub-chunk's
//    factors and V with cp.async while it forms O = [P; Rq] S^T + [Q; G] V
//    (D and Y) and the update, all on the tensor cores.
// Every product is f32 in 3xTF32 (wkv_chunk_common.cuh): ~21 bits of each
// operand, f32 sums.  The scratch costs bytes: at B=8 pass 1 reads the
// five inputs and writes 38 MB that pass 2 reads again.
//
// The t1 kernel's thread layout and row sums are in wkv7_common.cuh
// (shared with v7_decode.cu); the chunk kernels' staging and tensor-core
// products in wkv_chunk_common.cuh (shared with wkv56.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"
#include "wkv7_common.cuh"
#include "wkv_chunk_common.cuh"

using namespace wkv7;

namespace {

// Four elements of a vector from L2 (.cg) as floats: 16 bytes of f32 or
// 8 of bf16 (widened exactly).  i counts elements.
__device__ __forceinline__ float4 vec4_l2(const void* p, size_t i,
                                          bool bf16) {
  if (!bf16) return decode::ld4_l2(static_cast<const float*>(p) + i);
  const uint2 t = __ldcg(reinterpret_cast<const uint2*>(
      static_cast<const uint16_t*>(p) + i));
  return make_float4(__uint_as_float(t.x << 16),
                     __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16),
                     __uint_as_float(t.y & 0xffff0000u));
}

// Block (bh, slice) of ns = THREADS / blockDim.x blocks a head: its
// blockDim.x / CQ row groups, four rows each (see the note at the top).
// vec_bf16 bit i: vector i of (r, w, k, v, kk, a) is bf16, else f32.
__global__ void __launch_bounds__(THREADS)
wkv7_t1_kernel(const float* S, const void* r, const void* w, const void* k,
               const void* v, const void* kk, const void* a,
               const uint8_t* mask, float* S_out, float* y, int H,
               int vec_bf16) {
  decode::grid_launch_dependents();
  const int ns = THREADS / blockDim.x;
  const int bh = blockIdx.x / ns, b = bh / H;
  const int tid = threadIdx.x, col = 4 * (tid % CQ);
  const int row0 = 4 * ((blockIdx.x % ns) * (blockDim.x / CQ) + tid / CQ);
  const size_t vo = (size_t)bh * N;
  const float* src = S + (vo + row0) * N + col;

  // Before the wait: this head's state rows, which the kernel before this
  // one does not write (see the note at the top).
  float4 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = decode::ld4_l2(src + (size_t)i * N);
  decode::grid_wait();

  // After it, what the kernels before may have written, from L2; all of
  // it at once (no load waits on the mask's).
  const bool act = __ldcg(mask + b) != 0;
  const float4 rv = vec4_l2(r, vo + col, vec_bf16 & 1);
  const float4 wv = vec4_l2(w, vo + col, vec_bf16 >> 1 & 1);
  const float4 kv = vec4_l2(k, vo + col, vec_bf16 >> 2 & 1);
  const float4 vv = vec4_l2(v, vo + row0, vec_bf16 >> 3 & 1);
  const float4 kkv = vec4_l2(kk, vo + col, vec_bf16 >> 4 & 1);
  const float4 av = vec4_l2(a, vo + col, vec_bf16 >> 5 & 1);
  if (act) {
    const float4 kka = make_float4(kkv.x * av.x, kkv.y * av.y, kkv.z * av.z,
                                   kkv.w * av.w);
    const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
    float skk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) skk[i] = group_sum(dot4(s[i], kkv));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i].x = s[i].x * wv.x - skk[i] * kka.x + vr[i] * kv.x;
      s[i].y = s[i].y * wv.y - skk[i] * kka.y + vr[i] * kv.y;
      s[i].z = s[i].z * wv.z - skk[i] * kka.z + vr[i] * kv.z;
      s[i].w = s[i].w * wv.w - skk[i] * kka.w + vr[i] * kv.w;
    }
  }
  // An inactive row writes its state back as it was read, bit for bit.
  float* dst = S_out + (vo + row0) * N + col;
  float yr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(dst + (size_t)i * N) = s[i];
    yr[i] = group_sum(dot4(s[i], rv));
  }
  if (tid % CQ == 0)
    *reinterpret_cast<float4*>(y + vo + row0) =
        make_float4(yr[0], yr[1], yr[2], yr[3]);
}

namespace chunk {

using wkvc::LD;
using wkvc::NT;
using wkvc::R;
constexpr int LDR = R + 4;   // R x R matrices: conflict-free A fragments
constexpr int LDD = 72;      // [D; V] columns: conflict-free A fragments

// A sub-chunk's factors in the scratch, unpadded: L = [P; Rq], BK = [bbar
// A_R; kdec A_R], QG = [Q; G], A_R.  A masked sub-chunk has Rq = r only.
constexpr int F_L = 0, F_BK = 2 * R * N, F_QG = 4 * R * N;
constexpr int F_AR = F_QG + 2 * R * R, F_SIZE = F_AR + N;

// ---- pass 1: the factors of every (b, h, sub-chunk), in parallel ----

struct FactorSmem {
  float in[5][R][N];     // r, w, k, kk, a of the sub-chunk
  float L[2 * R][LD];    // kbar then P (rows 0..R-1), rbar then Rq (R..2R-1)
  float BK[2 * R][LD];   // bbar then bbar A_R, kdec then kdec A_R
  float A[R][LD];        // the cumulative decay A_t
  float Cb[R][LDR];
  float Mb[R][LDR];
  float QG[2 * R][LDR];  // Ck then Q (rows 0..R-1), Mk then G (R..2R-1)
  float AR[N];           // A_R, the sub-chunk's whole decay
  int msk[R];
};

__global__ void __launch_bounds__(NT)
wkv7_factors_kernel(const float* __restrict__ r, const float* __restrict__ w,
                    const float* __restrict__ k, const float* __restrict__ kk,
                    const float* __restrict__ a,
                    const uint8_t* __restrict__ mask, float* __restrict__ F,
                    int T, int H, int nsub) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FactorSmem& sm = *reinterpret_cast<FactorSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.x / nsub, t0 = (blockIdx.x % nsub) * R;
  const int b = bh / H, h = bh % H;
  const float* const ins[5] = {r, w, k, kk, a};
  const int t4 = tid / (N / 4), n4 = 4 * (tid % (N / 4));  // a float4 of a row

  // One sub-chunk's factors from its staged inputs into out.
  auto factors = [&](const float(*in)[R][N], const int* msk, float* out) {
    bool live = false;
#pragma unroll
    for (int t = 0; t < R; ++t) live |= msk[t] != 0;
    if (!live) {  // every step masked: the state pass reads y = S r only
      wkvc::st4(out + F_L + (R + t4) * N + n4, wkvc::ld4(&in[0][t4][n4]));
      return;
    }

    // 1a. The cumulative decay, a column a thread (masked steps decay by 1).
    if (tid < N) {
      float wv[R];
#pragma unroll
      for (int t = 0; t < R; ++t) wv[t] = msk[t] ? in[1][t][tid] : 1.f;
      float Ap = 1.f;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        Ap *= wv[t];
        sm.A[t][tid] = Ap;
      }
      sm.AR[tid] = Ap;
    }
    __syncthreads();

    // 1b. The normalised factors, four columns of a step a thread.
    {
      const bool on = msk[t4] != 0;
      const float4 At = wkvc::ld4(&sm.A[t4][n4]);
      const float4 Ap = t4 ? wkvc::ld4(&sm.A[t4 - 1][n4])
                           : make_float4(1.f, 1.f, 1.f, 1.f);
      const float4 rr = wkvc::ld4(&in[0][t4][n4]);
      const float4 av = wkvc::ld4(&in[4][t4][n4]);
      float4 kv = wkvc::ld4(&in[2][t4][n4]), kkv = wkvc::ld4(&in[3][t4][n4]);
      if (!on) kv = kkv = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 ia = make_float4(__frcp_rn(At.x), __frcp_rn(At.y),
                                    __frcp_rn(At.z), __frcp_rn(At.w));
      wkvc::st4(&sm.L[t4][n4], make_float4(Ap.x * kkv.x, Ap.y * kkv.y,
                                           Ap.z * kkv.z, Ap.w * kkv.w));
      wkvc::st4(&sm.L[R + t4][n4], make_float4(rr.x * At.x, rr.y * At.y,
                                               rr.z * At.z, rr.w * At.w));
      wkvc::st4(&sm.BK[t4][n4], make_float4(
          kkv.x * av.x * ia.x, kkv.y * av.y * ia.y, kkv.z * av.z * ia.z,
          kkv.w * av.w * ia.w));
      wkvc::st4(&sm.BK[R + t4][n4], make_float4(kv.x * ia.x, kv.y * ia.y,
                                                kv.z * ia.z, kv.w * ia.w));
    }
    __syncthreads();

    // 2. The four R x R products, [kbar; rbar] [bbar; kdec]^T, a 16 x 8 tile
    // a warp: Cb, Ck (j < t) from the kbar rows, Mb, Mk (j <= t) from the
    // rbar rows.
    {
      const int mt = warp / 4, nt = warp % 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      wkvc::tile_product<N / 8>(
          acc, [&](int t, int n) { return sm.L[R * mt + t][n]; },
          [&](int n, int j) { return sm.BK[j][n]; }, 8 * nt);
      wkvc::frag_c(acc, [&](int t, int j, float x) {
        x = (mt ? j % R <= t : j % R < t) ? x : 0.f;
        if (j < R)
          (mt ? sm.Mb : sm.Cb)[t][j] = x;
        else
          sm.QG[R * mt + t][j - R] = x;
      }, 0, 8 * nt);
    }
    __syncthreads();

    // 3. Forward substitution through the unit triangle I + Cb, a column of
    // [kbar | Ck] a thread (two partial sums halve the dependent chain):
    // P = (I + Cb)^-1 kbar, Q = (I + Cb)^-1 Ck.  Warps 3-7 meanwhile scale
    // bbar and kdec by A_R.
    if (tid < N + R) {
      float* col = tid < N ? &sm.L[0][tid] : &sm.QG[0][tid - N];
      const int ld = tid < N ? LD : LDR;
      float x[R];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        float e = col[t * ld], o = 0.f;
#pragma unroll
        for (int j = 0; j < t; ++j) {
          if (j & 1)
            o = fmaf(-sm.Cb[t][j], x[j], o);
          else
            e = fmaf(-sm.Cb[t][j], x[j], e);
        }
        x[t] = e + o;
      }
#pragma unroll
      for (int t = 0; t < R; ++t) col[t * ld] = x[t];
    } else if (tid >= 96) {
      for (int i = tid - 96; i < 2 * R * N; i += NT - 96)
        sm.BK[i / N][i % N] *= sm.AR[i % N];
    }
    __syncthreads();

    // 4. [Rq | G] = [rbar | Mk] - Mb [P | Q]: an 8-column tile of Rq a warp,
    // the two of G on warps 0 and 1.
    {
      float acc[4];
      wkvc::frag_c_set(acc, [&](int t, int n) { return sm.L[R + t][n]; }, 0,
                       8 * warp);
      wkvc::tile_product<R / 8>(
          acc, [&](int t, int j) { return -sm.Mb[t][j]; },
          [&](int j, int n) { return sm.L[j][n]; }, 8 * warp);
      wkvc::frag_c(acc, [&](int t, int n, float x) { sm.L[R + t][n] = x; }, 0,
                   8 * warp);
    }
    if (warp < 2) {
      float acc[4];
      wkvc::frag_c_set(acc, [&](int t, int j) { return sm.QG[R + t][j]; }, 0,
                       8 * warp);
      wkvc::tile_product<R / 8>(
          acc, [&](int t, int j) { return -sm.Mb[t][j]; },
          [&](int i, int j) { return sm.QG[i][j]; }, 8 * warp);
      wkvc::frag_c(acc, [&](int t, int j, float x) { sm.QG[R + t][j] = x; }, 0,
                   8 * warp);
    }
    __syncthreads();

    // The factors out, a float4 at a time.
    for (int i = tid; i < 2 * R * (N / 4); i += NT) {
      const int t = i / (N / 4), n = 4 * (i % (N / 4));
      wkvc::st4(out + F_L + t * N + n, wkvc::ld4(&sm.L[t][n]));
      wkvc::st4(out + F_BK + t * N + n, wkvc::ld4(&sm.BK[t][n]));
    }
    if (tid < 2 * R * (R / 4)) {
      const int t = tid / (R / 4), j = 4 * (tid % (R / 4));
      wkvc::st4(out + F_QG + t * R + j, wkvc::ld4(&sm.QG[t][j]));
    }
    if (tid < N / 4)
      wkvc::st4(out + F_AR + 4 * tid, wkvc::ld4(&sm.AR[4 * tid]));
  };

  wkvc::stage<5>(sm.in, ins, b, h, H, T, t0, 5);
  if (tid < R) sm.msk[tid] = t0 + tid < T ? mask[(size_t)b * T + t0 + tid] : 0;
  wkvc::cp_async_wait<0>();
  __syncthreads();
  factors(sm.in, sm.msk, F + (size_t)blockIdx.x * F_SIZE);
}

// ---- pass 2: the state, in order over the sub-chunks ----

template <int VB>
struct StateSmem {
  float L[2][2 * R][LD];   // the factors of a sub-chunk, double-buffered
  float BK[2][2 * R][LD];
  float QG[2][2 * R][LDR];
  float AR[2][N];
  float DV[2][2 * R][LDD];  // D (rows 0..R-1) and V (R..2R-1), block's columns
  float S[VB][LD];          // the block's state rows (v, k), for S^T products
  int msk[2][R];
};

// Stage sub-chunk c's factors and V into buffer buf (cp.async).
template <int VB>
__device__ __forceinline__ void stage_state(StateSmem<VB>& sm, int buf,
                                            const float* Fc, const float* v,
                                            int b, int h, int H, int T, int t0,
                                            int v0) {
  for (int i = threadIdx.x; i < 2 * R * (N / 4); i += NT) {
    const int t = i / (N / 4), n = 4 * (i % (N / 4));
    wkvc::cp_async16(&sm.L[buf][t][n], Fc + F_L + t * N + n, true);
    wkvc::cp_async16(&sm.BK[buf][t][n], Fc + F_BK + t * N + n, true);
  }
  if (threadIdx.x < 2 * R * (R / 4)) {
    const int t = threadIdx.x / (R / 4), j = 4 * (threadIdx.x % (R / 4));
    wkvc::cp_async16(&sm.QG[buf][t][j], Fc + F_QG + t * R + j, true);
  }
  if (threadIdx.x < N / 4)
    wkvc::cp_async16(&sm.AR[buf][4 * threadIdx.x], Fc + F_AR + 4 * threadIdx.x,
                     true);
  if (threadIdx.x < R * (VB / 4)) {
    const int t = threadIdx.x / (VB / 4), n = 4 * (threadIdx.x % (VB / 4));
    const bool ok = t0 + t < T;
    wkvc::cp_async16(&sm.DV[buf][R + t][n],
                     v + (ok ? (((size_t)b * T + t0 + t) * H + h) * N + v0 + n
                             : 0),
                     ok);
  }
  wkvc::cp_async_commit();
}

template <int NS>
__global__ void __launch_bounds__(NT, 2)
wkv7_state_kernel(const float* __restrict__ S0, const float* __restrict__ v,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ F, float* __restrict__ S_out,
                  float* __restrict__ y, int T, int H, int nsub) {
  constexpr int VB = N / NS;      // state rows of a block
  constexpr int NPW = VB / 16;    // 8-column tiles of S per warp
  constexpr int WPM = 8 / NPW;    // warps per 16-row tile of S
  constexpr int NTV = VB / 8;     // 8-column tiles of O (the block's rows)
  constexpr int MPW = NTV == 8 ? 2 : 1;  // 16-row halves of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem<VB>& sm = *reinterpret_cast<StateSmem<VB>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.x / NS, v0 = (blockIdx.x % NS) * VB;
  const int b = bh / H, h = bh % H;
  const float* Fbh = F + (size_t)bh * nsub * F_SIZE;

  // This warp's part of the state, S[m0 .. m0 + 15][n0 .. n0 + 8 NPW - 1]
  // of the block's rows, as mma accumulator fragments for the whole chunk.
  const int m0 = (warp / WPM) * 16, n0 = (warp % WPM) * NPW * 8;
  float s[NPW][4];
  {
    const float* src = S0 + ((size_t)bh * N + v0) * N;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      wkvc::frag_c_set(s[i], [&](int m, int n) { return src[m * N + n]; },
                       m0, n0 + 8 * i);
      wkvc::frag_c(s[i], [&](int m, int n, float x) { sm.S[m][n] = x; }, m0,
                   n0 + 8 * i);
    }
  }
  stage_state(sm, 0, Fbh, v, b, h, H, T, 0, v0);
  if (tid < R) sm.msk[0][tid] = tid < T ? mask[(size_t)b * T + tid] : 0;

  for (int c = 0; c < nsub; ++c) {
    const int buf = c & 1, t0 = c * R;
    int mnext = 0;
    if (c + 1 < nsub) {
      stage_state(sm, buf ^ 1, Fbh + (size_t)(c + 1) * F_SIZE, v, b, h, H, T,
                  t0 + R, v0);
      if (tid < R && t0 + R + tid < T)
        mnext = mask[(size_t)b * T + t0 + R + tid];
      wkvc::cp_async_wait<1>();
    } else {
      wkvc::cp_async_wait<0>();
    }
    __syncthreads();
    // A sub-chunk whose steps are all masked leaves S as it is and reads
    // y = S r (an idle row of a batch, or the tail of a short prompt).
    bool live = false;
#pragma unroll
    for (int t = 0; t < R; ++t) live |= sm.msk[buf][t] != 0;
    const float(*L)[LD] = sm.L[buf];
    const float(*QG)[LDR] = sm.QG[buf];
    float(*DV)[LDD] = sm.DV[buf];

    // O = [P; Rq] S^T + [Q; G] V over the block's rows: D = -O[0 .. R) into
    // DV, Y = O[R .. 2R) to y; a warp takes an 8-column tile and one or both
    // 16-row halves, sharing the S^T fragments.
    {
      const int nv = 8 * (warp % NTV), mt0 = MPW == 2 ? 0 : warp / NTV;
      auto store = [&](const float (&o)[4], int mt) {
        if (mt == 0)
          wkvc::frag_c(o, [&](int t, int vv, float x) { DV[t][vv] = -x; }, 0,
                       nv);
        else
          wkvc::frag_c(o, [&](int t, int vv, float x) {
            if (t0 + t < T)
              y[(((size_t)b * T + t0 + t) * H + h) * N + v0 + vv] = x;
          }, 0, nv);
      };
      if (live && mt0 < 2) {
        float acc[MPW][4] = {};
        wkvc::rows_product<N / 8, MPW>(
            acc, [&](int i, int t, int n) { return L[R * (mt0 + i) + t][n]; },
            [&](int n, int vv) { return sm.S[vv][n]; }, nv);
        wkvc::rows_product<R / 8, MPW>(
            acc, [&](int i, int t, int j) { return QG[R * (mt0 + i) + t][j]; },
            [&](int j, int vv) { return DV[R + j][vv]; }, nv);
#pragma unroll
        for (int i = 0; i < MPW; ++i) store(acc[i], mt0 + i);
      } else if (!live && mt0 + MPW - 1 == 1) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        wkvc::tile_product<N / 8>(
            acc, [&](int t, int n) { return L[R + t][n]; },
            [&](int n, int vv) { return sm.S[vv][n]; }, nv);
        store(acc, 1);
      }
    }

    if (live) {
      __syncthreads();  // D complete; every warp is done reading S
      // The update S = S diag(A_R) + D^T (bbar A_R) + V^T (kdec A_R) on this
      // warp's accumulator fragments, then S back to shared memory.
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int n = n0 + 8 * i + 2 * (tid & 3);
        s[i][0] *= sm.AR[buf][n];
        s[i][1] *= sm.AR[buf][n + 1];
        s[i][2] *= sm.AR[buf][n];
        s[i][3] *= sm.AR[buf][n + 1];
      }
      wkvc::cols_product<2 * R / 8, NPW>(
          s, [&](int vv, int t) { return DV[t][vv]; },
          [&](int t, int n) { return sm.BK[buf][t][n]; }, m0, n0);
#pragma unroll
      for (int i = 0; i < NPW; ++i)
        wkvc::frag_c(s[i], [&](int m, int n, float x) { sm.S[m][n] = x; },
                     m0, n0 + 8 * i);
    }
    if (c + 1 < nsub && tid < R) sm.msk[buf ^ 1][tid] = mnext;
    __syncthreads();  // this buffer and S are ready again
  }
  float* dst = S_out + ((size_t)bh * N + v0) * N;
#pragma unroll
  for (int i = 0; i < NPW; ++i)
    wkvc::frag_c(s[i], [&](int m, int n, float x) { dst[m * N + n] = x; }, m0,
                 n0 + 8 * i);
}

template <int NS>
int launch_state(const float* S, const float* v, const uint8_t* mask,
                 const float* F, float* S_out, float* y, int B, int T, int H,
                 int nsub, cudaStream_t st) {
  const int bytes = (int)sizeof(StateSmem<N / NS>);
  const cudaError_t e = cudaFuncSetAttribute(
      wkv7_state_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  wkv7_state_kernel<NS><<<B * H * NS, NT, bytes, st>>>(S, v, mask, F, S_out,
                                                       y, T, H, nsub);
  return (int)cudaGetLastError();
}

}  // namespace chunk

}  // namespace

extern "C" {

// vec_bf16: bit i set where vector i of (r, w, k, v, kk, a) is bf16 (else
// f32); f32 operands 16-byte aligned, bf16 ones 8-byte (the wrapper
// checks).  slices: 1, 2 or 4 blocks a head.  A programmatic dependent
// launch that reads S before it waits for the kernel before it: whatever
// writes S must have finished before this kernel starts (a
// synchronisation, or a launch without PDL between them).
int wkv7_t1_launch(const float* S, const void* r, const void* w,
                   const void* k, const void* v, const void* kk,
                   const void* a, const uint8_t* mask, float* S_out,
                   float* y, int B, int H, int n, int vec_bf16, int slices,
                   void* stream) {
  if (n != N || B <= 0 || H <= 0 || vec_bf16 < 0 || vec_bf16 > 63 ||
      (slices != 1 && slices != 2 && slices != 4))
    return (int)cudaErrorInvalidValue;
  int h = H, bf = vec_bf16;
  void* params[] = {(void*)&S,  (void*)&r,    (void*)&w,    (void*)&k,
                    (void*)&v,  (void*)&kk,   (void*)&a,    (void*)&mask,
                    (void*)&S_out, (void*)&y, &h,           &bf};
  const cudaError_t e = decode::launch_ex(
      (const void*)wkv7_t1_kernel, dim3(B * H * slices), THREADS / slices, 0,
      0, true, (cudaStream_t)stream, params);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The chunk: pass 1 (the factors of every sub-chunk into F, nsub * B * H
// blocks of wkv7_chunk_scratch_floats each) and pass 2 (the state, slices =
// 1, 2 or 4 blocks per (b, h): 64, 32 or 16 state rows a block).
int wkv7_chunk_launch(const float* S, const float* r, const float* w,
                      const float* k, const float* v, const float* kk,
                      const float* a, const uint8_t* mask, float* F,
                      float* S_out, float* y, int B, int T, int H, int n,
                      int slices, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nsub = (T + chunk::R - 1) / chunk::R;
  const int fbytes = (int)sizeof(chunk::FactorSmem);
  cudaError_t e = cudaFuncSetAttribute(
      chunk::wkv7_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fbytes);
  if (e != cudaSuccess) return (int)e;
  chunk::wkv7_factors_kernel<<<B * H * nsub, chunk::NT, fbytes, st>>>(
      r, w, k, kk, a, mask, F, T, H, nsub);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (slices) {
    case 1:
      return chunk::launch_state<1>(S, v, mask, F, S_out, y, B, T, H, nsub,
                                    st);
    case 2:
      return chunk::launch_state<2>(S, v, mask, F, S_out, y, B, T, H, nsub,
                                    st);
    case 4:
      return chunk::launch_state<4>(S, v, mask, F, S_out, y, B, T, H, nsub,
                                    st);
  }
  return (int)cudaErrorInvalidValue;
}

// Floats of pass 1's scratch per (b, h, sub-chunk).
int wkv7_chunk_scratch_floats(void) { return chunk::F_SIZE; }

}  // extern "C"
