// RWKV-5/6 WKV kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Both kernels compute the v5/v6 recurrence on one head's state S (N_k x N_v,
// f32, v contiguous) with the bonus u:
//
//     y = r^T (S + diag(u) k v^T),     S' = diag(w) S + k v^T
//
// wkv56_t1_launch replaces ai00_server_tpu/ops/wkv_t1.py:wkv56_t1 (the
// Pallas _v56_kernel): one decode step, row-masked - every row gets its y
// from the state before the step; an inactive row keeps S bit for bit.
//
// Both take the decay w dense, one vector per (b, [t,] h) as RWKV-6 makes it,
// or, with w_static, as one (H, N) array for every row and step: RWKV-5's
// static exp(-exp(time_decay)), read from there with a batch (and time)
// stride of 0, so the layer path never writes the broadcast out.
//
// wkv56_chunk_launch replaces ai00_server_tpu/ops/wkv_pallas.py:wkv56_chunk
// (the Pallas _wkv56_kernel): the same recurrence over a T-token chunk.  A
// masked step leaves S unchanged; its y is that of models/v5.wkv_scan,
// r_t (S + diag(u) k_t v_t^T) with the real k_t (the JAX Pallas wrapper
// folds the mask into w=1, k=0 and gives another y there).  It computes the
// suffix-sum form of ai00_server_tpu/ops/wkv_chunked.py:wkv56_chunk_mm over
// sub-chunks of R = 16 steps: with g_t = log max(w_t, 1e-30) (0 at a masked
// step, where k is 0 too) and c_t its running sum inside the sub-chunk,
//
//     y_t = (r_t exp(c_{t-1})) S                                  [inter]
//         + sum_{s<t} (sum_n r_tn k_sn exp(c_{t-1,n} - c_sn)) v_s [intra]
//         + (r_t . u . k_t) v_t                                   [bonus]
//     S'  = diag(exp(c_R)) S + (k exp(c_R - c))^T V               [carry]
//
// Every exponent is a sum of log-decays over a run of steps, so <= 0: no
// overflow for any decay, v6's data-dependent one at any strength included.
//
// What bounds it on an H100 at the serving shape (v6 1B6: B=8, H=32, N=64,
// T=256): bytes and latency.  The step-by-step kernel it replaced ran one
// block of 2 warps per (b, h) along a 256-step chain (0.09 ms at B=1).  Two
// launches, as wkv7.cu's chunk:
//  * pass 1, wkv56_factors_kernel: one block of 256 threads per (b, h,
//    sub-chunk), all in parallel: the log-decays, their running sums, the
//    decayed r and k, the bonus and the intra term's (R, R, N) reduce (its
//    exponentials on the CUDA cores); the factors go to a scratch buffer
//    the wrapper allocates (9.5 KB per sub-chunk).  A masked sub-chunk
//    writes r and the bonus only.
//  * pass 2, wkv56_state_kernel: one block of 256 threads per (b, h, slice
//    of 64 / S state columns), S = 1, 2 or 4 (ops/wkv_chunk.py:plan); the
//    state columns stay in registers as mma accumulator fragments for the
//    whole chunk; per sub-chunk the block stages the next sub-chunk's
//    factors and V with cp.async while it forms Y and the carry on the
//    tensor cores (3xTF32, wkv_chunk_common.cuh).
// At B=8, H=32 the two passes move ~180 MB (the old kernel ~100 MB): the
// scratch round trip is the cost of taking the chain off the state.  A
// chunk of one sub-chunk (T <= 16) runs wkv56_seq_kernel, the step-by-step
// kernel, instead: there the second launch and the scratch cost more than
// the chunked form saves.
//
// The t1 kernel's column layout and step are in wkv56_common.cuh (shared
// with v6_decode.cu); the chunk kernels' staging and tensor-core products in
// wkv_chunk_common.cuh (shared with wkv7.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv56_common.cuh"
#include "wkv_chunk_common.cuh"

using namespace wkv56;

namespace {

__global__ void __launch_bounds__(N)
wkv56_t1_kernel(const float* __restrict__ S, const float* __restrict__ r,
                const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const uint8_t* __restrict__ mask, float* __restrict__ S_out,
                float* __restrict__ y, int H, int w_static) {
  __shared__ __align__(16) float sv[4][N];  // r, k, w, u
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t vo = (size_t)bh * N;
  float s[N];
  load_col(s, S + vo * N, tid);
  sv[0][tid] = r[vo + tid];
  sv[1][tid] = k[vo + tid];
  sv[2][tid] = w[(w_static ? (size_t)(bh % H) * N : vo) + tid];
  sv[3][tid] = u[(size_t)(bh % H) * N + tid];
  const float vv = v[vo + tid];
  const bool active = mask[bh / H] != 0;
  __syncthreads();
  y[vo + tid] = step(s, sv[0], sv[1], sv[2], sv[3], vv, active);
  store_col(s, S_out + vo * N, tid);
}

// The step-by-step chunk for T <= 16 (ops/wkv_chunk.py:sequential), where a
// single sub-chunk leaves the chunked form's two passes nothing to win back
// their second launch and scratch with: the state lives in registers, one
// block of N threads per (b, h), thread v holding column v; TT steps of r,
// k, v, w are staged at a time into shared memory.
constexpr int TT = 16;  // time steps staged per tile (sequential chunk)

__global__ void __launch_bounds__(N)
wkv56_seq_kernel(const float* __restrict__ S0, const float* __restrict__ r,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const uint8_t* __restrict__ mask, float* __restrict__ S_out,
                   float* __restrict__ y, int T, int H, int w_static) {
  __shared__ __align__(16) float stage[4][TT][N];  // r, k, v, w
  __shared__ __align__(16) float su[N], sw[N];     // u, the static w
  __shared__ uint8_t sm[TT];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  float s[N];
  load_col(s, S0 + (size_t)bh * N * N, tid);
  su[tid] = u[(size_t)h * N + tid];
  if (w_static) sw[tid] = w[(size_t)h * N + tid];

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0);
    __syncthreads();  // every thread is done with the previous tile
    // Stage nt steps of the four inputs: each (b, t, h) slice is N
    // contiguous floats of the (B, T, H, N) layout, N / 4 float4 loads.
    for (int i = tid; i < nt * (N / 4); i += N) {
      const int tt = i / (N / 4), c = i % (N / 4);
      const size_t off = (((size_t)b * T + t0 + tt) * H + h) * N;
      reinterpret_cast<float4*>(stage[0][tt])[c] =
          reinterpret_cast<const float4*>(r + off)[c];
      reinterpret_cast<float4*>(stage[1][tt])[c] =
          reinterpret_cast<const float4*>(k + off)[c];
      reinterpret_cast<float4*>(stage[2][tt])[c] =
          reinterpret_cast<const float4*>(v + off)[c];
      if (!w_static)
        reinterpret_cast<float4*>(stage[3][tt])[c] =
            reinterpret_cast<const float4*>(w + off)[c];
    }
    if (tid < nt) sm[tid] = mask[(size_t)b * T + t0 + tid];
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float yv = step(s, stage[0][tt], stage[1][tt],
                            w_static ? sw : stage[3][tt], su,
                            stage[2][tt][tid], sm[tt] != 0);
      y[(((size_t)b * T + t0 + tt) * H + h) * N + tid] = yv;
    }
  }
  store_col(s, S_out + (size_t)bh * N * N, tid);
}

namespace chunk {

using wkvc::LD;
using wkvc::NT;
using wkvc::R;
constexpr int LDR = R + 4;  // the intra matrix: conflict-free A fragments
constexpr int LDT = 72;     // khat, S and V: conflict-free fragments

// A sub-chunk's factors in the scratch, unpadded: r exp(c_{t-1}), k exp(c_R
// - c_t), the intra matrix, the bonus, exp(c_R).  A masked sub-chunk has
// the first = r and the bonus only.
constexpr int F_RD = 0, F_KH = R * N, F_AM = 2 * R * N;
constexpr int F_BO = F_AM + R * R, F_ER = F_BO + R, F_SIZE = F_ER + N;

// ---- pass 1: the factors of every (b, h, sub-chunk), in parallel ----

struct FactorSmem {
  float in[3][R][N];       // r, k, w (dense) of the sub-chunk
  float rP[R][LD];         // r
  float kP[R][LD];         // k, 0 at a masked step
  float cP[R][LD];         // c_{t-1}
  float cI[R][LD];         // g_t, then c_t
  float rdec[R][LD];       // r_t exp(c_{t-1})
  float khat[R][LD];       // k_t exp(c_R - c_t)
  float Am[R][R];          // the intra matrix (s < t; 0 elsewhere)
  float bonus[R];          // r_t . u . k_t with the real k_t
  float cR[N], eR[N];      // c_R, exp(c_R)
  float sw[N], su[N];      // the static decay, u
  int msk[R];
};

__global__ void __launch_bounds__(NT)
wkv56_factors_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ w, const float* __restrict__ u,
                     const uint8_t* __restrict__ mask, float* __restrict__ F,
                     int T, int H, int nsub, int w_static) {
  constexpr int PAIRS = R * (R - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FactorSmem& sm = *reinterpret_cast<FactorSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / nsub, t0 = (blockIdx.x % nsub) * R;
  const int b = bh / H, h = bh % H;
  const float* const ins[3] = {r, k, w};
  const int nin = w_static ? 2 : 3;
  const int t4 = tid / (N / 4), n4 = 4 * (tid % (N / 4));  // a float4 of a row
  if (tid < N) {
    sm.su[tid] = u[(size_t)h * N + tid];
    sm.sw[tid] = w_static ? w[(size_t)h * N + tid] : 1.f;
  }
  for (int i = tid; i < R * R; i += NT) (&sm.Am[0][0])[i] = 0.f;

  // One sub-chunk's factors from its staged inputs into out.
  auto factors = [&](const float(*in)[R][N], const int* msk, float* out) {
    bool live = false;
#pragma unroll
    for (int t = 0; t < R; ++t) live |= msk[t] != 0;

    // 1. The log-decays (0 at a masked step), r and the masked k into padded
    // rows, and the bonus (the real k).
    {
      const bool on = msk[t4] != 0;
      const float4 rr = wkvc::ld4(&in[0][t4][n4]);
      const float4 kv = wkvc::ld4(&in[1][t4][n4]);
      const float4 ww = wkvc::ld4(w_static ? &sm.sw[n4] : &in[2][t4][n4]);
      const float4 uu = wkvc::ld4(&sm.su[n4]);
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f), kf = g;
      if (on) {
        g = make_float4(logf(fmaxf(ww.x, 1e-30f)), logf(fmaxf(ww.y, 1e-30f)),
                        logf(fmaxf(ww.z, 1e-30f)), logf(fmaxf(ww.w, 1e-30f)));
        kf = kv;
      }
      wkvc::st4(&sm.cI[t4][n4], g);
      wkvc::st4(&sm.rP[t4][n4], rr);
      wkvc::st4(&sm.kP[t4][n4], kf);
      float bo = rr.x * uu.x * kv.x;
      bo = fmaf(rr.y * uu.y, kv.y, bo);
      bo = fmaf(rr.z * uu.z, kv.z, bo);
      bo = fmaf(rr.w * uu.w, kv.w, bo);
#pragma unroll
      for (int m = 1; m < N / 4; m <<= 1)
        bo += __shfl_xor_sync(0xffffffffu, bo, m);
      if (n4 == 0) out[F_BO + t4] = bo;
      if (!live) {  // every step masked: the state pass reads y = S r + bonus
        wkvc::st4(out + F_RD + t4 * N + n4, rr);
        return;
      }
    }
    __syncthreads();

    // 2. The running sums c_t, a column a thread.
    if (tid < N) {
      float cc = 0.f;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        sm.cP[t][tid] = cc;
        cc += sm.cI[t][tid];
        sm.cI[t][tid] = cc;
      }
      sm.cR[tid] = cc;
      sm.eR[tid] = expf(cc);
    }
    __syncthreads();

    // 3. The decayed r and k, a float4 of a row a thread; the intra matrix,
    // half of a (t, s) pair's sum over n a thread.
    {
      const float4 cp = wkvc::ld4(&sm.cP[t4][n4]);
      const float4 ci = wkvc::ld4(&sm.cI[t4][n4]);
      const float4 cr = wkvc::ld4(&sm.cR[n4]);
      const float4 rr = wkvc::ld4(&sm.rP[t4][n4]);
      const float4 kf = wkvc::ld4(&sm.kP[t4][n4]);
      wkvc::st4(&sm.rdec[t4][n4],
                make_float4(rr.x * expf(cp.x), rr.y * expf(cp.y),
                            rr.z * expf(cp.z), rr.w * expf(cp.w)));
      wkvc::st4(&sm.khat[t4][n4], make_float4(kf.x * expf(cr.x - ci.x),
                                              kf.y * expf(cr.y - ci.y),
                                              kf.z * expf(cr.z - ci.z),
                                              kf.w * expf(cr.w - ci.w)));
    }
    {
      const int p = tid >> 1, half = tid & 1;
      int t = 1, sj = p;  // the p-th pair (t, sj), sj < t, row by row
      while (sj >= t) {
        sj -= t;
        ++t;
      }
      float acc = 0.f;
      if (p < PAIRS) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          const int n = 4 * (2 * i + half);
          const float4 rr = wkvc::ld4(&sm.rP[t][n]);
          const float4 kf = wkvc::ld4(&sm.kP[sj][n]);
          const float4 cp = wkvc::ld4(&sm.cP[t][n]);
          const float4 ci = wkvc::ld4(&sm.cI[sj][n]);
          acc = fmaf(rr.x * kf.x, __expf(cp.x - ci.x), acc);
          acc = fmaf(rr.y * kf.y, __expf(cp.y - ci.y), acc);
          acc = fmaf(rr.z * kf.z, __expf(cp.z - ci.z), acc);
          acc = fmaf(rr.w * kf.w, __expf(cp.w - ci.w), acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (p < PAIRS && half == 0) sm.Am[t][sj] = acc;
    }
    __syncthreads();

    // The factors out, a float4 at a time.
    wkvc::st4(out + F_RD + t4 * N + n4, wkvc::ld4(&sm.rdec[t4][n4]));
    wkvc::st4(out + F_KH + t4 * N + n4, wkvc::ld4(&sm.khat[t4][n4]));
    if (tid < R * R / 4)
      wkvc::st4(out + F_AM + 4 * tid, wkvc::ld4(&sm.Am[0][0] + 4 * tid));
    if (tid < N / 4)
      wkvc::st4(out + F_ER + 4 * tid, wkvc::ld4(&sm.eR[4 * tid]));
  };

  wkvc::stage<3>(sm.in, ins, b, h, H, T, t0, nin);
  if (tid < R) sm.msk[tid] = t0 + tid < T ? mask[(size_t)b * T + t0 + tid] : 0;
  wkvc::cp_async_wait<0>();
  __syncthreads();
  factors(sm.in, sm.msk, F + (size_t)blockIdx.x * F_SIZE);
}

// ---- pass 2: the state, in order over the sub-chunks ----

template <int VB>
struct StateSmem {
  float RD[2][R][LD];     // the factors of a sub-chunk, double-buffered
  float KH[2][R][LDT];
  float Am[2][R][LDR];
  float bonus[2][R];
  float eR[2][N];
  float V[2][R][LDT];     // V of the block's columns
  float S[N][LDT];        // the block's state columns (k, v)
  int msk[2][R];
};

// Stage sub-chunk c's factors and V into buffer buf (cp.async).
template <int VB>
__device__ __forceinline__ void stage_state(StateSmem<VB>& sm, int buf,
                                            const float* Fc, const float* v,
                                            int b, int h, int H, int T, int t0,
                                            int v0) {
  const int t = threadIdx.x / (N / 4), n = 4 * (threadIdx.x % (N / 4));
  wkvc::cp_async16(&sm.RD[buf][t][n], Fc + F_RD + t * N + n, true);
  wkvc::cp_async16(&sm.KH[buf][t][n], Fc + F_KH + t * N + n, true);
  if (threadIdx.x < R * (R / 4)) {
    const int i = threadIdx.x / (R / 4), j = 4 * (threadIdx.x % (R / 4));
    wkvc::cp_async16(&sm.Am[buf][i][j], Fc + F_AM + i * R + j, true);
  }
  if (threadIdx.x < R / 4)
    wkvc::cp_async16(&sm.bonus[buf][4 * threadIdx.x],
                     Fc + F_BO + 4 * threadIdx.x, true);
  if (threadIdx.x < N / 4)
    wkvc::cp_async16(&sm.eR[buf][4 * threadIdx.x], Fc + F_ER + 4 * threadIdx.x,
                     true);
  if (threadIdx.x < R * (VB / 4)) {
    const int tv = threadIdx.x / (VB / 4), nv = 4 * (threadIdx.x % (VB / 4));
    const bool ok = t0 + tv < T;
    wkvc::cp_async16(&sm.V[buf][tv][nv],
                     v + (ok ? (((size_t)b * T + t0 + tv) * H + h) * N + v0 +
                                   nv
                             : 0),
                     ok);
  }
  wkvc::cp_async_commit();
}

template <int NS>
__global__ void __launch_bounds__(NT, 2)
wkv56_state_kernel(const float* __restrict__ S0, const float* __restrict__ v,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ F, float* __restrict__ S_out,
                   float* __restrict__ y, int T, int H, int nsub) {
  constexpr int VB = N / NS;      // state columns of a block
  constexpr int NPW = VB / 16;    // 8-column tiles of S per warp
  constexpr int NTV = VB / 8;     // 8-column tiles of Y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem<VB>& sm = *reinterpret_cast<StateSmem<VB>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.x / NS, v0 = (blockIdx.x % NS) * VB;
  const int b = bh / H, h = bh % H;
  const float* Fbh = F + (size_t)bh * nsub * F_SIZE;

  // This warp's part of the state, S[m0 .. m0 + 15][n0 .. n0 + 8 NPW - 1]
  // of the block's columns, as mma accumulator fragments for the whole
  // chunk.
  const int m0 = (warp / 2) * 16, n0 = (warp % 2) * NPW * 8;
  float s[NPW][4];
  {
    const float* src = S0 + (size_t)bh * N * N + v0;
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
    // y = S r plus the bonus (an idle row of a batch, or the tail of a
    // short prompt).
    bool live = false;
#pragma unroll
    for (int t = 0; t < R; ++t) live |= sm.msk[buf][t] != 0;
    const float(*V)[LDT] = sm.V[buf];

    // Y = rdec S + Am V + bonus V over the block's columns, a 16 x 8 tile a
    // warp (rdec = r in a masked sub-chunk).
    if (warp < NTV) {
      const int nv = 8 * warp;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      wkvc::tile_product<N / 8>(
          acc, [&](int t, int n) { return sm.RD[buf][t][n]; },
          [&](int n, int vv) { return sm.S[n][vv]; }, nv);
      if (live)
        wkvc::tile_product<R / 8>(
            acc, [&](int t, int j) { return sm.Am[buf][t][j]; },
            [&](int j, int vv) { return V[j][vv]; }, nv);
      wkvc::frag_c(acc, [&](int t, int vv, float x) {
        x = fmaf(sm.bonus[buf][t], V[t][vv], x);
        if (t0 + t < T) y[(((size_t)b * T + t0 + t) * H + h) * N + v0 + vv] = x;
      }, 0, nv);
    }

    if (live) {
      // The carry S = diag(exp(c_R)) S + khat^T V on this warp's
      // accumulator fragments, then S back to shared memory once every
      // warp is done reading it.
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int m = m0 + ((tid & 31) >> 2);
        s[i][0] *= sm.eR[buf][m];
        s[i][1] *= sm.eR[buf][m];
        s[i][2] *= sm.eR[buf][m + 8];
        s[i][3] *= sm.eR[buf][m + 8];
      }
      wkvc::cols_product<R / 8, NPW>(
          s, [&](int n, int t) { return sm.KH[buf][t][n]; },
          [&](int t, int vv) { return V[t][vv]; }, m0, n0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NPW; ++i)
        wkvc::frag_c(s[i], [&](int m, int n, float x) { sm.S[m][n] = x; },
                     m0, n0 + 8 * i);
    }
    if (c + 1 < nsub && tid < R) sm.msk[buf ^ 1][tid] = mnext;
    __syncthreads();  // this buffer and S are ready again
  }
  float* dst = S_out + (size_t)bh * N * N + v0;
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
      wkv56_state_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  wkv56_state_kernel<NS><<<B * H * NS, NT, bytes, st>>>(S, v, mask, F, S_out,
                                                        y, T, H, nsub);
  return (int)cudaGetLastError();
}

}  // namespace chunk

}  // namespace

extern "C" {

int wkv56_t1_launch(const float* S, const float* r, const float* k,
                    const float* v, const float* w, const float* u,
                    const uint8_t* mask, float* S_out, float* y, int B, int H,
                    int n, int w_static, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  wkv56_t1_kernel<<<B * H, N, 0, (cudaStream_t)stream>>>(
      S, r, k, v, w, u, mask, S_out, y, H, w_static);
  return (int)cudaGetLastError();
}

// The step-by-step chunk (T <= 16 in ops/wkv_chunk.py).
int wkv56_chunk_seq_launch(const float* S, const float* r, const float* k,
                       const float* v, const float* w, const float* u,
                       const uint8_t* mask, float* S_out, float* y, int B,
                       int T, int H, int n, int w_static, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  wkv56_seq_kernel<<<B * H, N, 0, (cudaStream_t)stream>>>(
      S, r, k, v, w, u, mask, S_out, y, T, H, w_static);
  return (int)cudaGetLastError();
}

// The chunk: pass 1 (the factors of every sub-chunk into F, nsub * B * H
// blocks of wkv56_chunk_scratch_floats each) and pass 2 (the state, slices =
// 1, 2 or 4 blocks per (b, h): 64, 32 or 16 state columns a block).
int wkv56_chunk_launch(const float* S, const float* r, const float* k,
                       const float* v, const float* w, const float* u,
                       const uint8_t* mask, float* F, float* S_out, float* y,
                       int B, int T, int H, int n, int w_static, int slices,
                       void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nsub = (T + chunk::R - 1) / chunk::R;
  const int fbytes = (int)sizeof(chunk::FactorSmem);
  cudaError_t e = cudaFuncSetAttribute(
      chunk::wkv56_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fbytes);
  if (e != cudaSuccess) return (int)e;
  chunk::wkv56_factors_kernel<<<B * H * nsub, chunk::NT, fbytes, st>>>(
      r, k, w, u, mask, F, T, H, nsub, w_static);
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
int wkv56_chunk_scratch_floats(void) { return chunk::F_SIZE; }

}  // extern "C"
