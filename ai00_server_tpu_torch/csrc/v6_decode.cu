// The RWKV-6 whole-network decode step (T = 1) for Hopper (sm_90a): its
// kernel of its own, plain C interface for ctypes.
//
// Replaces ai00_server_tpu/ops/v6_decode_pallas.py:forward_t1 (the Pallas
// _kernel): there one sequential grid over the layers keeps the residual in
// on-chip scratch.  On this card a layer is a fixed sequence of eleven
// launches, and the caller replays the whole stack from one CUDA graph:
//
//   v7_ln_mix(xa, dx, 1) -> matmul{maa down, tanh} -> matmul{maa up x5,
//   token-shift combine} -> matmul{decay down, tanh} -> matmul{r, k, v, g
//   (SiLU)}
//   -> matmul{decay up, exp(-exp)} -> v6_wkv_gn -> matmul{Wo, += x}
//   -> v7_ln_mix(2) -> matmul{fkey relu^2, frec sigmoid}
//   -> matmul{fval, += rf * . into x}
//
// The products are v7_skinny_matmul (plain weights or codes, with the v6
// epilogues) and the LayerNorms v7_ln_mix (the first of a layer also writes
// xa and dx), both in v7_decode.cu.  The TPU kernel splits the (C, 5D) token-shift LoRA into five (C, D) stages so
// that it never slices lanes at non-tile offsets; here it is one (C, 5D)
// product and five (D, C) products that read their stage as a strided view.
// Values round through the activation type T at the Pallas kernel's points:
// r, k, v through T and then f32, g f32 up to the gate, the WKV output
// through T after ln_x, relu(.)^2 through T; the residual and the shift
// states stay f32.
//
// This file holds v6_wkv_gn: the WKV step with the u bonus on the k-major
// state IN PLACE (an inactive row keeps its state bit for bit; every row
// gets its y), GroupNorm of the f32 y per head, ln_x, rounding through T
// (the fused stacks; the phased ones of v56_phased keep it f32) and the
// gate by g: the operand of Wo.  The decay w is read with a batch stride:
// C for v6's per-token (B, C) decay, 0 for RWKV-5's static decay, which the
// v5 stack (ops/v5_decode.py) passes as its vecs row 0 (exp(-exp(time_decay)),
// the row the Pallas v5 kernel reads, ops/v5_decode_pallas.py:163).
//
// Compiled once per head size (-DHEAD_N, ops/_build.py).  Bounded by the
// bytes of the state (4 HN^2 bytes a head, 16 KB at HN = 64, read once,
// written once for active rows); at B <= 8 a launch is a chain of
// latencies around 2-4 MB, and the design shortens it:
//  - a programmatic dependent launch that asks for its state, the bonus u,
//    ln_x's weights and (RWKV-5) the static decay before it waits for the
//    kernel before it, so the state's DRAM round trip overlaps that kernel;
//  - one block per (b, h) that spreads the k rows over N / 4 row groups of
//    four (N = HEAD_P: 16 at HN = 64, 32 at 128, 8 at 32), a thread holding
//    4 x 4 state elements with 16-byte loads and stores;
//  - the row groups' partial y meet in a fixed tree (lanes by shuffles,
//    then the warps through shared memory: one block barrier), and the
//    GroupNorm runs in one warp by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"

using namespace decode;

namespace {

constexpr int HN = HEAD;    // head size in device memory
constexpr int N = HEAD_P;   // head size of the tiles (decode_common.cuh)
constexpr int KR = 4;       // k rows a thread
constexpr int RG = N / KR;  // row groups a block

// vecs rows: decay (v6: the LoRA's bias, not read here; v5: the static
// decay itself), first, lnx_w, lnx_b
constexpr int VEC_FIRST = 1, VEC_LNX_W = 2, VEC_LNX_B = 3;

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block per (b, h): a thread holds four value columns (column group
// cg) over four k rows (row group rg).  Rows and columns past the head
// (HN = 40 is laid out at N = 64) are masked: they read and write nothing
// and add zero.
constexpr int CG = N / 4;             // column groups
constexpr int WARPS = RG * CG / 32;   // 8 at N = 64
constexpr int THREADS6 = 32 * WARPS;

template <typename T>
__global__ void __launch_bounds__(THREADS6)
v6_wkv_gn_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ g, const float* __restrict__ vecs,
                 const uint8_t* __restrict__ active, float* __restrict__ S,
                 T* __restrict__ out, int H, int C, int w_stride,
                 int round_yf) {
  __shared__ __align__(16) float part[WARPS][N];
  grid_launch_dependents();
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = tid % CG, rg = tid / CG;
  const int col = 4 * cg;                // the thread's first column
  const int k0 = KR * rg;                // and first k row
  const bool rows = in_head(k0), cols = rows && in_head(col);
  const size_t vo = (size_t)bh * HN;     // == b * C + h * HN
  const int c0 = h * HN;
  float* state = S + vo * HN;
  // The epilogue runs in warp 0: lane l has columns l + 32 o.
  const bool epi = warp == 0;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

  // Before the wait, what no launch of the stack before this one writes:
  // this layer's state (written only by this same launch a step earlier;
  // the engine's copies into the state pool precede the whole step, whose
  // first launch is an ordinary one) and the weights.
  float4 s[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i)
    s[i] = cols ? ld4_l2(state + (size_t)(k0 + i) * HN + col) : z;
  const float4 u = rows ? ld4(vecs + VEC_FIRST * (size_t)C + c0 + k0) : z;
  float lnw[HEAD_LANE], lnb[HEAD_LANE];
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o) {
    const int c = c0 + lane + 32 * o;
    const bool mine = epi && in_head(lane + 32 * o);
    lnw[o] = mine ? vecs[VEC_LNX_W * (size_t)C + c] : 0.f;
    lnb[o] = mine ? vecs[VEC_LNX_B * (size_t)C + c] : 0.f;
  }
  const bool static_w = w_stride == 0;
  float4 wv = static_w && rows ? ld4(w + c0 + k0) : z;
  grid_wait();

  // After it, what the launches before write: r, k, v, g, the decay (v6)
  // and active (from the lengths), all from L2 (ld4_l2).
  if (!static_w && rows) wv = ld4_l2(w + (size_t)b * w_stride + c0 + k0);
  const float4 rv = rows ? ld4_l2(r + vo + k0) : z;
  const float4 kv = rows ? ld4_l2(k + vo + k0) : z;
  const float4 vv = cols ? ld4_l2(v + vo + col) : z;
  float gv[HEAD_LANE];
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o)
    gv[o] = epi && in_head(lane + 32 * o) ? __ldcg(g + vo + lane + 32 * o)
                                          : 0.f;
  const bool act = __ldcg(active + b) != 0;

  // The step on the thread's 4 x 4 elements, y partial over its rows.
  float y[4] = {0.f, 0.f, 0.f, 0.f};
  float sr[KR][4];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    sr[i][0] = s[i].x, sr[i][1] = s[i].y;
    sr[i][2] = s[i].z, sr[i][3] = s[i].w;
    const float ki = at(kv, i), ri = at(rv, i);
    const float ui = at(u, i), wi = at(wv, i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ae = ki * at(vv, e);
      y[e] = fmaf(fmaf(ui, ae, sr[i][e]), ri, y[e]);
      sr[i][e] = fmaf(wi, sr[i][e], ae);
    }
  }
  // An inactive row keeps its state bit for bit (and is not written).
  if (act && cols) {
#pragma unroll
    for (int i = 0; i < KR; ++i)
      *reinterpret_cast<float4*>(state + (size_t)(k0 + i) * HN + col) =
          make_float4(sr[i][0], sr[i][1], sr[i][2], sr[i][3]);
  }

  // The N / 4 row groups' partial y in a fixed tree: neighbouring groups
  // first (the lanes CG apart), then the warps in pairs.
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] += __shfl_xor_sync(0xffffffffu, y[e], off);
  if (lane < CG)
    *reinterpret_cast<float4*>(&part[warp][4 * cg]) =
        make_float4(y[0], y[1], y[2], y[3]);
  __syncthreads();
  if (!epi) return;

  float yo[HEAD_LANE];
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o) {
    float t[WARPS];
#pragma unroll
    for (int i = 0; i < WARPS; ++i) t[i] = part[i][lane + 32 * o];
#pragma unroll
    for (int n = WARPS; n > 1; n >>= 1)
#pragma unroll
      for (int i = 0; i < n / 2; ++i) t[i] = t[2 * i] + t[2 * i + 1];
    yo[o] = t[0];
  }

  // GroupNorm of the f32 y over the head, ln_x, gate.
  const Moments m = head_moments(yo);
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o) {
    if (!in_head(lane + 32 * o)) continue;
    const float d = yo[o] - m.mean;
    const float yf = d * rsqrtf(m.var + GN_EPS) * lnw[o] + lnb[o];
    out[vo + lane + 32 * o] =
        from_f<T>((round_yf ? rnd<T>(yf) : yf) * gv[o]);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the weights' and activations' type T).
// round_yf: 1 rounds the f32 ln_x output through T before the gate (the
// fused stacks), 0 gates it in f32 (the phased ones).  B x H blocks.
// Every f32 operand 16-byte aligned.  A programmatic dependent launch that
// reads S, vecs and (w_stride 0) w before it waits for the kernel before
// it: whatever writes them must have finished before this kernel starts (a
// synchronisation, or a launch without PDL between them).

int v6_wkv_gn_launch(const float* r, const float* k, const float* v,
                     const float* w, const float* g, const float* vecs,
                     const uint8_t* active, float* S, void* out, int B, int H,
                     int n, int w_stride, int round_yf, int dtype,
                     void* stream) {
  if (n != HN || B <= 0 || H <= 0 || (w_stride != 0 && w_stride != H * HN) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* kern = dtype == 1
                         ? (const void*)v6_wkv_gn_kernel<__nv_bfloat16>
                         : (const void*)v6_wkv_gn_kernel<float>;
  int h = H, c = H * HN, ws = w_stride, ry = round_yf;
  void* params[] = {(void*)&r, (void*)&k,      (void*)&v, (void*)&w,
                    (void*)&g, (void*)&vecs,   (void*)&active,
                    (void*)&S, (void*)&out,    &h,        &c,
                    &ws,       &ry};
  const cudaError_t e = launch_ex(kern, dim3(B * H), THREADS6, 0, 0, true,
                                  (cudaStream_t)stream, params);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
