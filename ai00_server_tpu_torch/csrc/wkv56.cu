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
// (the Pallas _wkv56_kernel): the same recurrence over a T-token chunk, with
// the state resident on chip for the whole chunk.  A masked step leaves S
// unchanged; its y is that of models/v5.wkv_scan (the JAX Pallas wrapper
// folds the mask into w=1, k=0 and gives another y there: only valid steps'
// y are compared).
//
// What bounds them on an H100 at the serving shape (B=8, H=32, N=64):
//  * t1: bytes.  The state is read once and written once (2 x 4.2 MB); each
//    state element takes ~5 flops, far below the card's ~20 flops/byte f32
//    balance point.  Design: one block of 64 threads per (b, h), thread v
//    holding column v of the state in registers (wkv56_common.cuh): the
//    block's loads of a state row are 256 contiguous bytes, the readout and
//    the update are sums inside one thread, and the 64 loads of a thread
//    are all issued before the first is used.  The state crosses HBM
//    exactly once each way.
//  * chunk: latency.  At T=256 each (b, h) is 256 sequential steps of 64
//    x 4 multiply-adds per thread; 256 blocks of 2 warps leave most of the
//    card's issue slots idle, and the state traffic (2 x 4.2 MB) and the
//    inputs (4 x 16.8 MB) are small beside that chain.  Design: the state
//    lives in registers for the whole chunk, and a step's readout keeps four
//    partial sums (a chain of 16 dependent multiply-adds, not 64); TT steps
//    of r, k, v, w are staged at a time into shared memory with coalesced
//    float4 loads straight from the (B, T, H, N) layout (no transpose or
//    padding outside); each thread writes its y column per step (64
//    contiguous floats per block).  The sequential dependence in t is the limit left
//    for a later version (the chunked matmul form on tensor cores).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv56_common.cuh"

using namespace wkv56;

namespace {

constexpr int TT = 16;  // time steps staged per tile (chunk)

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

__global__ void __launch_bounds__(N)
wkv56_chunk_kernel(const float* __restrict__ S0, const float* __restrict__ r,
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

int wkv56_chunk_launch(const float* S, const float* r, const float* k,
                       const float* v, const float* w, const float* u,
                       const uint8_t* mask, float* S_out, float* y, int B,
                       int T, int H, int n, int w_static, void* stream) {
  if (n != N || B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  wkv56_chunk_kernel<<<B * H, N, 0, (cudaStream_t)stream>>>(
      S, r, k, v, w, u, mask, S_out, y, T, H, w_static);
  return (int)cudaGetLastError();
}

}  // extern "C"
