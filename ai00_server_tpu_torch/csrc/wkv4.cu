// RWKV-4 WKV kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Both compute v4's per-channel recurrence on the numerically stable
// exponential accumulator (aa, bb, pp), f32 whatever the activation type
// (pp is a running log-scale):
//
//   readout  ww = u + k;  q = max(pp, ww)
//            y  = (e^(pp-q) aa + e^(ww-q) v) / (e^(pp-q) bb + e^(ww-q))
//   update   ww = pp + w  (w = -exp(time_decay));  q = max(ww, k)
//            aa = e^(ww-q) aa + e^(k-q) v;  bb = e^(ww-q) bb + e^(k-q);  pp = q
//
// v4_wkv_launch is the WKV stage of the fused RWKV-4 decode step: it
// replaces the (aa, bb, pp) lines of the Pallas kernel
// ai00_server_tpu/ops/v4_decode_pallas.py:forward_t1 (_kernel, :142-166).
// One step for every (b, c), the state updated IN PLACE for active rows (an
// inactive row keeps its bits), the output r * y rounded through the
// activation type T: the operand of Wo.  It moves ~0.3 MB at the 0.4B
// width (B = 8, C = 1024), so it is bound by launch latency; one thread
// per (b, c), coalesced along c.
//
// wkv4_chunk_launch is the same recurrence over a T-token chunk (prefill,
// and the layer path at T = 1).  The JAX package runs it as a lax.scan
// (ai00_server_tpu/models/v4.py:_wkv_scan, :49-84), not as Pallas; here it
// is one kernel, so a chunk is one launch a layer and not T of them.  k and
// v come in the activation type TI (bf16 on the serving path, as the
// projections give them) and are widened to f32 in registers, as _wkv_scan
// does inside its body; y is f32.  What bounds it: latency.  At B = 8,
// C = 1024, T = 256 it moves ~17 MB in bf16 (a bound of ~0.005 ms) but each
// (b, c) is a chain of 256 dependent steps of four exponentials and a
// division.  Design: one thread per (b, c) keeps its
// (aa, bb, pp) in registers for the whole chunk; the loads of k, v and the
// mask for the next TT steps are requested before the current TT steps are
// computed (they do not depend on the state) and are kept as loaded until
// the step that uses them (widened at the load, a bf16 value made the
// thread wait there for it), so the chain waits on arithmetic, not on
// memory; 64-thread blocks spread the 8192 threads over 128 SMs.  A masked step leaves the state unchanged; its y reads the kept
// state (models/v4._wkv_scan does the same).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

using namespace decode;

namespace {

constexpr int THREADS = 64;
constexpr int TT = 16;  // steps whose inputs are in flight at once

// One step on one channel: returns y from the state before the step and,
// if update, advances (aa, bb, pp).
__device__ __forceinline__ float wkv4_step(float& aa, float& bb, float& pp,
                                           float k, float v, float w,
                                           float u, bool update) {
  float ww = u + k;
  float q = fmaxf(pp, ww);
  float e1 = expf(pp - q), e2 = expf(ww - q);
  const float y = (e1 * aa + e2 * v) / (e1 * bb + e2);
  ww = pp + w;
  q = fmaxf(ww, k);
  e1 = expf(ww - q);
  e2 = expf(k - q);
  if (update) {
    aa = e1 * aa + e2 * v;
    bb = e1 * bb + e2;
    pp = q;
  }
  return y;
}

// vecs rows: w = -exp(time_decay), u = time_first (the fused layout's).
template <typename T>
__global__ void __launch_bounds__(THREADS)
v4_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ vecs,
              const uint8_t* __restrict__ active, float* __restrict__ aa,
              float* __restrict__ bb, float* __restrict__ pp,
              T* __restrict__ out, int B, int C) {
  grid_launch_dependents();
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * C) return;
  const int b = (int)(i / C), c = (int)(i % C);
  float a = aa[i], bv = bb[i], p = pp[i];
  const bool act = active[b] != 0;
  const float y = wkv4_step(a, bv, p, k[i], v[i], vecs[c], vecs[C + c], act);
  if (act) {
    aa[i] = a;
    bb[i] = bv;
    pp[i] = p;
  }
  out[i] = from_f<T>(r[i] * y);
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
wkv4_chunk_kernel(const float* __restrict__ aa0, const float* __restrict__ bb0,
                  const float* __restrict__ pp0, const TI* __restrict__ k,
                  const TI* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const uint8_t* __restrict__ mask,
                  float* __restrict__ aa1, float* __restrict__ bb1,
                  float* __restrict__ pp1, float* __restrict__ y, int B,
                  int T, int C) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * C) return;
  const int b = (int)(i / C), c = (int)(i % C);
  const float wc = w[c], uc = u[c];
  float a = aa0[i], bv = bb0[i], p = pp0[i];
  const size_t row = (size_t)b * T;  // (b, t) -> row + t

  // The buffers hold the loaded values as they are (TI, the mask byte):
  // each is widened or tested only where a step uses it, so no instruction
  // waits on a load before the arithmetic that comes first.
  TI kb[TT], vb[TT];
  uint8_t mb[TT];
#pragma unroll
  for (int j = 0; j < TT; ++j) {
    const bool in = j < T;
    kb[j] = in ? k[(row + j) * C + c] : TI(0.f);
    vb[j] = in ? v[(row + j) * C + c] : TI(0.f);
    mb[j] = in ? mask[row + j] : 0;
  }
  for (int t0 = 0; t0 < T; t0 += TT) {
    TI kn[TT], vn[TT];
    uint8_t mn[TT];
#pragma unroll
    for (int j = 0; j < TT; ++j) {  // the next TT steps, requested first
      const int t = t0 + TT + j;
      const bool in = t < T;
      kn[j] = in ? k[(row + t) * C + c] : TI(0.f);
      vn[j] = in ? v[(row + t) * C + c] : TI(0.f);
      mn[j] = in ? mask[row + t] : 0;
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int t = t0 + j;
      if (t < T)
        y[(row + t) * C + c] = wkv4_step(a, bv, p, to_f(kb[j]), to_f(vb[j]),
                                         wc, uc, mb[j] != 0);
    }
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      kb[j] = kn[j];
      vb[j] = vn[j];
      mb[j] = mn[j];
    }
  }
  aa1[i] = a;
  bb1[i] = bv;
  pp1[i] = p;
}

int blocks(int B, int C) {
  return (int)(((size_t)B * C + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the activation type T of the output).
int v4_wkv_launch(const float* r, const float* k, const float* v,
                  const float* vecs, const uint8_t* active, float* aa,
                  float* bb, float* pp, void* out, int B, int C, int dtype,
                  void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    v4_wkv_kernel<__nv_bfloat16><<<blocks(B, C), THREADS, 0, st>>>(
        r, k, v, vecs, active, aa, bb, pp, (__nv_bfloat16*)out, B, C);
  else if (dtype == 0)
    v4_wkv_kernel<float><<<blocks(B, C), THREADS, 0, st>>>(
        r, k, v, vecs, active, aa, bb, pp, (float*)out, B, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16 (the type of k and v).
int wkv4_chunk_launch(const float* aa, const float* bb, const float* pp,
                      const void* k, const void* v, const float* w,
                      const float* u, const uint8_t* mask, float* aa_out,
                      float* bb_out, float* pp_out, float* y, int B, int T,
                      int C, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    wkv4_chunk_kernel<__nv_bfloat16><<<blocks(B, C), THREADS, 0, st>>>(
        aa, bb, pp, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, w, u,
        mask, aa_out, bb_out, pp_out, y, B, T, C);
  else if (dtype == 0)
    wkv4_chunk_kernel<float><<<blocks(B, C), THREADS, 0, st>>>(
        aa, bb, pp, (const float*)k, (const float*)v, w, u, mask, aa_out,
        bb_out, pp_out, y, B, T, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
