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
// the row the Pallas v5 kernel reads, ops/v5_decode_pallas.py:163).  Bounded by the bytes of the state (read
// once, written once for active rows); one block of 64 threads per (b, h),
// thread v holding column v of the state in registers, the device code
// shared with wkv56_t1 (wkv56_common.cuh); the GroupNorm's two sums over the
// head are two warp shuffles and one shared-memory add each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "wkv56_common.cuh"

using namespace decode;
using namespace wkv56;

namespace {

// vecs rows: decay (v6: the LoRA's bias, not read here; v5: the static
// decay itself), first, lnx_w, lnx_b
constexpr int VEC_FIRST = 1, VEC_LNX_W = 2, VEC_LNX_B = 3;

template <typename T>
__global__ void __launch_bounds__(N)
v6_wkv_gn_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ g, const float* __restrict__ vecs,
                 const uint8_t* __restrict__ active, float* __restrict__ S,
                 T* __restrict__ out, int H, int C, int w_stride,
                 int round_yf) {
  __shared__ __align__(16) float sv[4][N];  // r, k, w, u
  __shared__ float red[2];
  grid_launch_dependents();
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const size_t vo = (size_t)bh * N;  // == b * C + h * N
  const int c = h * N + tid;
  float* state = S + vo * N;

  float s[N];
  load_col(s, state, tid);
  sv[0][tid] = r[vo + tid];
  sv[1][tid] = k[vo + tid];
  sv[2][tid] = w[(size_t)b * w_stride + h * N + tid];
  sv[3][tid] = vecs[VEC_FIRST * (size_t)C + c];
  const float vv = v[vo + tid];
  const float gv = g[vo + tid];
  const float lnw = vecs[VEC_LNX_W * (size_t)C + c];
  const float lnb = vecs[VEC_LNX_B * (size_t)C + c];
  const bool act = active[b] != 0;
  __syncthreads();

  const float y = step(s, sv[0], sv[1], sv[2], sv[3], vv, act);
  if (act) store_col(s, state, tid);

  // GroupNorm of the f32 y over the head, ln_x, gate.
  const float mean = head_sum(y, red) / N;
  const float d = y - mean;
  const float var = head_sum(d * d, red) / N;
  const float yf = d * rsqrtf(var + GN_EPS) * lnw + lnb;
  out[vo + tid] = from_f<T>((round_yf ? rnd<T>(yf) : yf) * gv);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the weights' and activations' type T).
// round_yf: 1 rounds the f32 ln_x output through T before the gate (the
// fused stacks), 0 gates it in f32 (the phased ones).

int v6_wkv_gn_launch(const float* r, const float* k, const float* v,
                     const float* w, const float* g, const float* vecs,
                     const uint8_t* active, float* S, void* out, int B, int H,
                     int n, int w_stride, int round_yf, int dtype,
                     void* stream) {
  if (n != N || B <= 0 || H <= 0 || (w_stride != 0 && w_stride != H * N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int C = H * N;
  if (dtype == 1)
    v6_wkv_gn_kernel<__nv_bfloat16><<<B * H, N, 0, st>>>(
        r, k, v, w, g, vecs, active, S, (__nv_bfloat16*)out, H, C,
        w_stride, round_yf);
  else if (dtype == 0)
    v6_wkv_gn_kernel<float><<<B * H, N, 0, st>>>(
        r, k, v, w, g, vecs, active, S, (float*)out, H, C, w_stride,
        round_yf);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
