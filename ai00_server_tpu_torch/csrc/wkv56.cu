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
// What bounds it: the state's bytes (16 KB a head read, 16 KB written: 8.4
// MB at B=8, H=32, 2.5 us at 3.35 TB/s; 1-4 MB at a tp place's H / tp
// heads) under a chain of latencies - the launch, the state's DRAM round
// trip, the readout's sum over k, the store.  The design, as wkv7.cu's
// wkv7_t1, shortens the chain:
//  * one launch for the whole call: r, k, v, w and u are read in the dtype
//    the caller holds them in, each f32 or bf16 by a bit of vec_bf16 (the
//    layer path's r, k, v are bf16, w f32, u the parameter's dtype; bf16
//    -> f32 is exact), so no cast kernels run before it;
//  * a programmatic dependent launch (launch_ex, pdl): it lets the next
//    kernel start at once and fetches this block's state tile (ld4_l2)
//    before griddepcontrol.wait, so the state's DRAM round trip overlaps
//    the kernel before it; everything else after it, from L2 (.cg: never
//    ld.global.nc on a kernel-written operand, decode_common.cuh:ld4_l2):
//    r, k, v, the mask, the dense decay, RWKV-5's static decay (models/v5.py
//    computes it with torch.exp on every call) and u (a tp place's slice of
//    it is a view today, but a copy or cast on the stream could make it);
//  * a thread holds a 4 x 4 state tile in registers (wkv56_common.cuh, the
//    layout of v6_decode.cu's v6_wkv_gn): 16-byte loads and stores, the
//    readout's sum over k by the thread's four rows in order, then the 16
//    row groups in a fixed tree, lanes by shuffles, then warps;
//  * a head's value columns are independent (y_v and S'[:, v] need column
//    v alone), so a head is split over 1, 2 or 4 blocks of 64, 32 or 16
//    columns (256, 128 or 64 threads) with no sum across blocks;
//    ops/wkv_t1.py:plan56 picks the split from B x H and the card's SMs.
//    The tree is the same in every split, so the split moves no bit.
// The early state fetch is safe only while the kernel launched just
// before this one did not write S: on the layer path (models/v6.py,
// models/v5.py, models/common.forward_tp) that launch is a PyTorch op,
// which starts after everything before it has finished, and S is this
// layer's state from an earlier step.
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
// Head size: compiled once per HN = HEAD_N (ops/_build.py; N % 8 == 0,
// 8 <= N <= 128).  The tile kernels lay a head out at N = HEAD_P, the next
// power of two, at least 32 (decode_common.cuh), the rows and columns past
// HN masked (they read and write nothing and add zero; at 64 the masks
// fold away): the one-step kernel's head is N^2 / 16 threads (1 or 2
// blocks at N <= 32), the chunk passes work at N and a state-pass block
// holds N / slices >= 16 columns (2 or 4 at 128: ops/wkv_chunk.py:plan).
// The step-by-step kernel keeps a column in HN registers, 128 at HN = 128.
//
// The t1 kernel's tile step and the step-by-step chunk's column step are
// in wkv56_common.cuh; the chunk kernels' staging and tensor-core products
// in wkv_chunk_common.cuh (shared with wkv7.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"
#include "wkv56_common.cuh"
#include "wkv_chunk_common.cuh"

using namespace wkv56;

namespace {

constexpr int T1_THREADS = N * N / 16;  // a whole head's 4 x 4 tiles

// Block (bh, slice) of NS blocks a head: the head's N / 4 row groups by the
// slice's VB = N / NS value columns, CG = VB / 4 column groups, a 4 x 4
// state tile a thread (tid = row group * CG + column group; see the note at
// the top); rows and columns past the head (HN) are masked: they read and
// write nothing and add zero.  vec_bf16 bit i: vector i of (r, k, v, w, u)
// is bf16, else f32.
template <int NS>
__global__ void __launch_bounds__(T1_THREADS / NS)
wkv56_t1_kernel(const float* S, const void* r, const void* k, const void* v,
                const void* w, const void* u, const uint8_t* mask,
                float* S_out, float* y, int H, int w_static, int vec_bf16) {
  constexpr int VB = N / NS, CG = VB / 4, WARPS = T1_THREADS / NS / 32;
  static_assert(WARPS >= 1, "a block of at least a warp");
  __shared__ __align__(16) float part[WARPS][VB];
  decode::grid_launch_dependents();
  const int bh = blockIdx.x / NS, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = tid % CG, k0 = 4 * (tid / CG);
  const int v0 = (blockIdx.x % NS) * VB, col = v0 + 4 * cg;
  const bool rows = decode::in_head(k0), live = rows && decode::in_head(col);
  const size_t vo = (size_t)bh * HN, ho = (size_t)h * HN;

  // Before the wait: this block's state tile, which the kernel before this
  // one does not write (see the note at the top).
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = S + (vo + k0) * HN + col;
  float4 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[i] = live ? decode::ld4_l2(src + (size_t)i * HN) : z;
  decode::grid_wait();

  // After it, every other operand, from L2; all of it at once (no load
  // waits on the mask's).
  const bool act = __ldcg(mask + b) != 0;
  const float4 rv = rows ? decode::vec4_l2(r, vo + k0, vec_bf16 & 1) : z;
  const float4 kv = rows ? decode::vec4_l2(k, vo + k0, vec_bf16 >> 1 & 1) : z;
  const float4 vv = live ? decode::vec4_l2(v, vo + col, vec_bf16 >> 2 & 1)
                         : z;
  const float4 wv = rows ? decode::vec4_l2(w, (w_static ? ho : vo) + k0,
                                           vec_bf16 >> 3 & 1)
                         : z;
  const float4 uv = rows ? decode::vec4_l2(u, ho + k0, vec_bf16 >> 4 & 1)
                         : z;
  float yp[4] = {0.f, 0.f, 0.f, 0.f};
  step_tile(s, rv, kv, vv, wv, uv, act, yp);

  // An inactive row writes its state back as it was read, bit for bit.
  float* dst = S_out + (vo + k0) * HN + col;
  if (live) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + (size_t)i * HN) = s[i];
  }

  // The N / 4 row groups' partial readouts in a fixed tree, the same in
  // every split: a warp's row groups by shuffles (lanes CG apart hold
  // neighbouring groups), then the warps in pairs.
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      yp[e] += __shfl_xor_sync(0xffffffffu, yp[e], off);
  if (lane < CG)
    *reinterpret_cast<float4*>(&part[warp][4 * cg]) =
        make_float4(yp[0], yp[1], yp[2], yp[3]);
  __syncthreads();
  if (tid < VB && decode::in_head(v0 + tid)) {
    float t[WARPS];
#pragma unroll
    for (int i = 0; i < WARPS; ++i) t[i] = part[i][tid];
#pragma unroll
    for (int n = WARPS; n > 1; n >>= 1)
#pragma unroll
      for (int i = 0; i < n / 2; ++i) t[i] = t[2 * i] + t[2 * i + 1];
    y[vo + v0 + tid] = t[0];
  }
}

// wkv56_t1_kernel<NS> where its blocks hold a warp or more, else null.
template <int NS>
const void* t1_kernel() {
  if constexpr (T1_THREADS / NS >= 32)
    return (const void*)wkv56_t1_kernel<NS>;
  else
    return nullptr;
}

// The step-by-step chunk for T <= 16 (ops/wkv_chunk.py:sequential), where a
// single sub-chunk leaves the chunked form's two passes nothing to win back
// their second launch and scratch with: the state lives in registers, one
// block of HN threads per (b, h), thread v holding column v (HN registers:
// 128 at HN = 128, under the 255 a thread may hold); TT steps of r, k, v,
// w are staged at a time into shared memory.
constexpr int TT = 16;  // time steps staged per tile (sequential chunk)

__global__ void __launch_bounds__(HN)
wkv56_seq_kernel(const float* __restrict__ S0, const float* __restrict__ r,
                   const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u,
                   const uint8_t* __restrict__ mask, float* __restrict__ S_out,
                   float* __restrict__ y, int T, int H, int w_static) {
  __shared__ __align__(16) float stage[4][TT][HN];  // r, k, v, w
  __shared__ __align__(16) float su[HN], sw[HN];     // u, the static w
  __shared__ uint8_t sm[TT];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  float s[HN];
  load_col(s, S0 + (size_t)bh * HN * HN, tid);
  su[tid] = u[(size_t)h * HN + tid];
  if (w_static) sw[tid] = w[(size_t)h * HN + tid];

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0);
    __syncthreads();  // every thread is done with the previous tile
    // Stage nt steps of the four inputs: each (b, t, h) slice is HN
    // contiguous floats of the (B, T, H, HN) layout, HN / 4 float4 loads.
    for (int i = tid; i < nt * (HN / 4); i += HN) {
      const int tt = i / (HN / 4), c = i % (HN / 4);
      const size_t off = (((size_t)b * T + t0 + tt) * H + h) * HN;
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
    if constexpr (HN >= TT) {
      if (tid < nt) sm[tid] = mask[(size_t)b * T + t0 + tid];
    } else {
      for (int i = tid; i < nt; i += HN) sm[i] = mask[(size_t)b * T + t0 + i];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float yv = step(s, stage[0][tt], stage[1][tt],
                            w_static ? sw : stage[3][tt], su,
                            stage[2][tt][tid], sm[tt] != 0);
      y[(((size_t)b * T + t0 + tt) * H + h) * HN + tid] = yv;
    }
  }
  store_col(s, S_out + (size_t)bh * HN * HN, tid);
}

namespace chunk {

using wkvc::LD;
using wkvc::NT;
using wkvc::R;
constexpr int LDR = R + 4;  // the intra matrix: conflict-free A fragments
constexpr int LDK = N + 8;  // khat: conflict-free fragments (72 at N = 64)
// S and V of VB block columns: conflict-free fragments (72 up to VB = 64).
__host__ __device__ constexpr int ldv(int vb) {
  return vb + 8 > 72 ? vb + 8 : 72;
}

// A sub-chunk's factors in the scratch, at the tile size N, unpadded
// rows: r exp(c_{t-1}), k exp(c_R
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
  if (tid < N) {  // columns past the head: u 0, decay 1
    sm.su[tid] = decode::in_head(tid) ? u[(size_t)h * HN + tid] : 0.f;
    sm.sw[tid] =
        w_static && decode::in_head(tid) ? w[(size_t)h * HN + tid] : 1.f;
  }
  for (int i = tid; i < R * R; i += NT) (&sm.Am[0][0])[i] = 0.f;

  // One sub-chunk's factors from its staged inputs into out.  Float4 q of a
  // sub-chunk's rows is row q / (N / 4), columns 4 (q % (N / 4)) .. + 3: a
  // row's N / 4 float4s on neighbouring lanes of one warp.
  auto factors = [&](const float(*in)[R][N], const int* msk, float* out) {
    bool live = false;
#pragma unroll
    for (int t = 0; t < R; ++t) live |= msk[t] != 0;

    // 1. The log-decays (0 at a masked step and past the head), r and the
    // masked k into padded rows, and the bonus (the real k).
    wkvc::strided<wkvc::NQ>([&](int q) {
      const int t4 = q / (N / 4), n4 = 4 * (q % (N / 4));
      const bool on = msk[t4] != 0 && decode::in_head(n4);
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
      if (!live)  // every step masked: the state pass reads y = S r + bonus
        wkvc::st4(out + F_RD + t4 * N + n4, rr);
    });
    if (!live) return;
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
    wkvc::strided<wkvc::NQ>([&](int q) {
      const int t4 = q / (N / 4), n4 = 4 * (q % (N / 4));
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
    });
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
    wkvc::strided<wkvc::NQ>([&](int q) {
      const int t4 = q / (N / 4), n4 = 4 * (q % (N / 4));
      wkvc::st4(out + F_RD + t4 * N + n4, wkvc::ld4(&sm.rdec[t4][n4]));
      wkvc::st4(out + F_KH + t4 * N + n4, wkvc::ld4(&sm.khat[t4][n4]));
    });
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
  float KH[2][R][LDK];
  float Am[2][R][LDR];
  float bonus[2][R];
  float eR[2][N];
  float V[2][R][ldv(VB)];  // V of the block's columns
  float S[N][ldv(VB)];     // the block's state columns (k, v)
  int msk[2][R];
};

// Stage sub-chunk c's factors and V into buffer buf (cp.async); V's
// columns past the head are zeros.
template <int VB>
__device__ __forceinline__ void stage_state(StateSmem<VB>& sm, int buf,
                                            const float* Fc, const float* v,
                                            int b, int h, int H, int T, int t0,
                                            int v0) {
  wkvc::strided<wkvc::NQ>([&](int q) {
    const int t = q / (N / 4), n = 4 * (q % (N / 4));
    wkvc::cp_async16(&sm.RD[buf][t][n], Fc + F_RD + t * N + n, true);
    wkvc::cp_async16(&sm.KH[buf][t][n], Fc + F_KH + t * N + n, true);
  });
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
  auto stage_v = [&](int q) {
    const int tv = q / (VB / 4), nv = 4 * (q % (VB / 4));
    const bool ok = t0 + tv < T && decode::in_head(v0 + nv);
    wkvc::cp_async16(&sm.V[buf][tv][nv],
                     v + (ok ? (((size_t)b * T + t0 + tv) * H + h) * HN + v0 +
                                   nv
                             : 0),
                     ok);
  };
  if constexpr (R * (VB / 4) <= NT) {
    if (threadIdx.x < R * (VB / 4)) stage_v(threadIdx.x);
  } else {
    wkvc::strided<R * (VB / 4)>(stage_v);
  }
  wkvc::cp_async_commit();
}

// Block (bh, slice) of NS: state columns v0 .. v0 + VB - 1 of head bh (rows
// and columns past the head are zeros, never read or written in device
// memory).
template <int NS>
__global__ void __launch_bounds__(NT, 2)
wkv56_state_kernel(const float* __restrict__ S0, const float* __restrict__ v,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ F, float* __restrict__ S_out,
                   float* __restrict__ y, int T, int H, int nsub) {
  constexpr int VB = N / NS;      // state columns of a block
  static_assert(VB >= 16, "a block holds whole 16-column tiles");
  constexpr int MT = N / 16;      // 16-row tiles of the state (k rows)
  constexpr int NTV = VB / 8;     // 8-column tiles of the block's columns
  constexpr int TILES = MT * NTV;                  // 16 x 8 tiles of S
  constexpr int NPW = TILES >= 8 ? TILES / 8 : 1;  // of them per warp
  constexpr int WPM = NTV / NPW;  // warps per 16-row tile of S
  constexpr int LDV = ldv(VB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem<VB>& sm = *reinterpret_cast<StateSmem<VB>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.x / NS, v0 = (blockIdx.x % NS) * VB;
  const int b = bh / H, h = bh % H;
  const float* Fbh = F + (size_t)bh * nsub * F_SIZE;

  // This warp's part of the state, S[m0 .. m0 + 15][n0 .. n0 + 8 NPW - 1]
  // of the block's columns, as mma accumulator fragments for the whole
  // chunk (every warp has a part where the block has 8 tiles or more).
  const bool owns = MT * WPM == NT / 32 || warp < MT * WPM;
  const int m0 = (warp / WPM) * 16, n0 = (warp % WPM) * NPW * 8;
  float s[NPW][4] = {};
  if (owns) {
    const float* src = S0 + (size_t)bh * HN * HN + v0;
    auto at = [&](int m, int n) {
      return decode::in_head(m) && decode::in_head(v0 + n) ? src[m * HN + n]
                                                           : 0.f;
    };
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      wkvc::frag_c_set(s[i], at, m0, n0 + 8 * i);
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
    const float(*V)[LDV] = sm.V[buf];

    // Y = rdec S + Am V + bonus V over the block's columns, a 16 x 8 tile a
    // warp (rdec = r in a masked sub-chunk).
#pragma unroll
    for (int i = 0; i < (NTV + NT / 32 - 1) / (NT / 32); ++i) {
      const int tile = warp + i * (NT / 32);
      if (tile >= NTV) break;
      const int nv = 8 * tile;
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
        if (t0 + t < T && decode::in_head(v0 + vv))
          y[(((size_t)b * T + t0 + t) * H + h) * HN + v0 + vv] = x;
      }, 0, nv);
    }

    if (live) {
      // The carry S = diag(exp(c_R)) S + khat^T V on this warp's
      // accumulator fragments, then S back to shared memory once every
      // warp is done reading it.
      if (owns) {
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
      }
      __syncthreads();
      if (owns) {
#pragma unroll
        for (int i = 0; i < NPW; ++i)
          wkvc::frag_c(s[i], [&](int m, int n, float x) { sm.S[m][n] = x; },
                       m0, n0 + 8 * i);
      }
    }
    if (c + 1 < nsub && tid < R) sm.msk[buf ^ 1][tid] = mnext;
    __syncthreads();  // this buffer and S are ready again
  }
  if (!owns) return;
  float* dst = S_out + (size_t)bh * HN * HN + v0;
#pragma unroll
  for (int i = 0; i < NPW; ++i)
    wkvc::frag_c(s[i], [&](int m, int n, float x) {
      if (decode::in_head(m) && decode::in_head(v0 + n)) dst[m * HN + n] = x;
    }, m0, n0 + 8 * i);
}

// NS blocks a head, each of N / NS >= 16 state columns (else refused).
template <int NS>
int launch_state(const float* S, const float* v, const uint8_t* mask,
                 const float* F, float* S_out, float* y, int B, int T, int H,
                 int nsub, cudaStream_t st) {
  if constexpr (N / NS < 16) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int bytes = (int)sizeof(StateSmem<N / NS>);
    const cudaError_t e = cudaFuncSetAttribute(
        wkv56_state_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    wkv56_state_kernel<NS><<<B * H * NS, NT, bytes, st>>>(
        S, v, mask, F, S_out, y, T, H, nsub);
    return (int)cudaGetLastError();
  }
}

}  // namespace chunk

}  // namespace

extern "C" {

// One step: n the head size the library was built for (HEAD_N); slices =
// 1, 2 or 4 blocks per (b, h) (N / slices value columns, N^2 / 16 / slices
// threads a block, at least a warp: at N = 32 one or two; N = HEAD_P); vec_bf16 bit i: vector i of (r,
// k, v, w, u) is bf16, else f32; w_static: w is one (H, N) array for every
// row.  Vectors 16-byte aligned (bf16: 8-byte), S and S_out 16-byte.  A
// programmatic dependent launch that reads S before it waits for the
// kernel before it: whatever writes S must have finished when it starts (a
// synchronisation, or a launch without PDL between them).
int wkv56_t1_launch(const float* S, const void* r, const void* k,
                    const void* v, const void* w, const void* u,
                    const uint8_t* mask, float* S_out, float* y, int B, int H,
                    int n, int w_static, int vec_bf16, int slices,
                    void* stream) {
  if (n != HN || B <= 0 || H <= 0 || (w_static != 0 && w_static != 1) ||
      vec_bf16 < 0 || vec_bf16 > 31)
    return (int)cudaErrorInvalidValue;
  const void* kern = slices == 1 ? t1_kernel<1>()
                     : slices == 2 ? t1_kernel<2>()
                     : slices == 4 ? t1_kernel<4>()
                                   : nullptr;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  int h = H, ws = w_static, bf = vec_bf16;
  void* params[] = {(void*)&S, (void*)&r,     (void*)&k, (void*)&v,
                    (void*)&w, (void*)&u,     (void*)&mask,
                    (void*)&S_out, (void*)&y, &h,        &ws,
                    &bf};
  const cudaError_t e = decode::launch_ex(
      kern, dim3(B * H * slices), T1_THREADS / slices, 0, 0, true,
      (cudaStream_t)stream, params);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The step-by-step chunk (T <= 16 in ops/wkv_chunk.py).
int wkv56_chunk_seq_launch(const float* S, const float* r, const float* k,
                       const float* v, const float* w, const float* u,
                       const uint8_t* mask, float* S_out, float* y, int B,
                       int T, int H, int n, int w_static, void* stream) {
  if (n != HN || B <= 0 || H <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  wkv56_seq_kernel<<<B * H, HN, 0, (cudaStream_t)stream>>>(
      S, r, k, v, w, u, mask, S_out, y, T, H, w_static);
  return (int)cudaGetLastError();
}

// The chunk: pass 1 (the factors of every sub-chunk into F, nsub * B * H
// blocks of wkv56_chunk_scratch_floats each) and pass 2 (the state, slices =
// 1, 2 or 4 blocks per (b, h): N / slices state columns a block, at least
// 16).
int wkv56_chunk_launch(const float* S, const float* r, const float* k,
                       const float* v, const float* w, const float* u,
                       const uint8_t* mask, float* F, float* S_out, float* y,
                       int B, int T, int H, int n, int w_static, int slices,
                       void* stream) {
  if (n != HN || B <= 0 || H <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
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
