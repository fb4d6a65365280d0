// The WKV stage of the RWKV-7 decode step (T = 1) for Hopper (sm_90a): the
// fused stacks' v7_wkv_gn launch, plain C interface for ctypes.  Compiled
// once per head size (-DHEAD_N, ops/_build.py); the other kernels of the
// stacks (v7_decode.cu) do not depend on it.
//
// Replaces the WKV lines of the Pallas decode kernel (ai00_server_tpu/ops/
// v7_decode_pallas.py:_kernel, the removal key, the delta-rule step, the
// GroupNorm, the bonus and the gate; and those of v7_phased_pallas.py's
// phases, which the phased stack runs through this same kernel).
//
// Bounded by the bytes of the state (4 HN^2 bytes a head, read once,
// written once for active rows: 16 KB at HN = 64), with the vector
// prologue and the GroupNorm / bonus / gate epilogue fused around the
// state's update.  At B <= 8 the launch is a chain of latencies around
// 0.5-8 MB, so the design shortens the chain:
//  - a programmatic dependent launch that asks for its state rows and
//    weights before it waits for the kernel before it (the LoRA-up
//    product), so the state's DRAM round trip overlaps that kernel;
//  - one block per (b, h) and one block barrier (the y exchange): a thread
//    holds a 4 x 4 tile of the state (wkv7_common.cuh: N / 4 row groups of
//    CQ = N / 4 threads, N = HEAD_P; 256 threads at HN = 64, 1024 at 128,
//    64 at 32) and computes the prologue of its four columns in registers
//    (16-byte loads throughout), the norm and bonus over the head as its
//    four terms and log2(CQ) shuffles, and the GroupNorm runs within a warp
//    by shuffles (decode_common.cuh:head_moments).  Rows and columns past
//    HN (HN = 40 is laid out at N = 64) are masked: they read and write
//    nothing and add zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"
#include "wkv7_common.cuh"

using namespace decode;
using namespace wkv7;

namespace {

// One block per (b, h).  A thread holds a 4 x 4 tile of the state: four
// value rows (row group tid / CQ) by four columns (cq); the CQ threads of a
// row group cover its rows' columns, 4 N contiguous bytes a row.  A thread
// computes the vector prologue of its four columns in registers; the
// removal key's squared norm and the bonus sum over the head are its four
// terms in pairs, then the CQ threads' by shuffles in pairs (the norm's
// squares and sums unfused), so every thread holds the same bits and no
// barrier precedes the update.  The rows' y meet in shared memory (the
// block's one barrier), and every warp takes the GroupNorm of all HN in
// the same order (head_moments).

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv_gn_kernel(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ a, const float* __restrict__ g,
              const float* __restrict__ vmix, float* __restrict__ v_first,
              const float* __restrict__ vecs,
              const uint8_t* __restrict__ active, float* __restrict__ S,
              T* __restrict__ out, int H, int C, int is_first) {
  __shared__ float ys[N];
  grid_launch_dependents();
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int cq = tid % CQ, col = 4 * cq;
  const int row0 = 4 * (tid / CQ);  // the first of its four rows
  const int orow = row0 + (cq & 3);  // the row whose output lane cq < 4 has
  // Masked: rows or columns past the head.
  const bool rows = in_head(row0), cols = rows && in_head(col);
  const size_t vo = (size_t)bh * HN;  // == b * C + h * HN
  const int c0 = h * HN;
  float* st = S + (vo + row0) * HN + col;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

  // Before the wait, what no launch of the stack before this one writes:
  // this layer's state (written only by this same launch a step earlier;
  // the engine's copies into the state pool precede the whole step, whose
  // first launch is an ordinary one) and the weights.  vecs rows: w0 a0 v0
  // k_k k_a r_k lnx_w lnx_b.
  float4 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = cols ? ld4_l2(st + (size_t)i * HN) : z;
  const float4 kkw = cols ? ld4(vecs + 3 * (size_t)C + c0 + col) : z;
  const float4 kaw = cols ? ld4(vecs + 4 * (size_t)C + c0 + col) : z;
  const float4 rkw = cols ? ld4(vecs + 5 * (size_t)C + c0 + col) : z;
  const float lnw = rows ? vecs[6 * (size_t)C + c0 + orow] : 0.f;
  const float lnb = rows ? vecs[7 * (size_t)C + c0 + orow] : 0.f;
  grid_wait();

  // After it, what the launches before write: r, k, v, w, a, g, vmix and
  // v_first (layer 0's launch writes it), and active (from the lengths),
  // all from L2 (ld4_l2).
  const bool act = __ldcg(active + b) != 0;
  const float4 rv = cols ? ld4_l2(r + vo + col) : z;
  const float4 kv = cols ? ld4_l2(k + vo + col) : z;
  const float4 av = cols ? ld4_l2(a + vo + col) : z;
  float4 wv = cols ? ld4_l2(w + vo + col) : z;
  const float4 vv = rows ? ld4_l2(v + vo + row0) : z;
  float4 v2 = vv;
  if (!is_first && rows) {
    const float4 vf = ld4_l2(v_first + vo + row0);
    const float4 vm = ld4_l2(vmix + vo + row0);
    v2 = make_float4(vv.x + (vf.x - vv.x) * vm.x, vv.y + (vf.y - vv.y) * vm.y,
                     vv.z + (vf.z - vv.z) * vm.z, vv.w + (vf.w - vv.w) * vm.w);
  }
  const float gv = rows ? __ldcg(g + vo + orow) : 0.f;

  float4 kk = make_float4(kv.x * kkw.x, kv.y * kkw.y, kv.z * kkw.z,
                          kv.w * kkw.w);
  float4 k2 = make_float4(kv.x * (1.f + (av.x - 1.f) * kaw.x),
                          kv.y * (1.f + (av.y - 1.f) * kaw.y),
                          kv.z * (1.f + (av.z - 1.f) * kaw.z),
                          kv.w * (1.f + (av.w - 1.f) * kaw.w));
  // The bonus reads the unmasked k2.
  const float bonus = group_sum(
      (rv.x * k2.x * rkw.x + rv.y * k2.y * rkw.y)
      + (rv.z * k2.z * rkw.z + rv.w * k2.w * rkw.w));
  if (!act) {
    wv = make_float4(1.f, 1.f, 1.f, 1.f);
    k2 = z;
    kk = z;
  }
  // The squared norm: products unfused, the four in pairs, then the group
  // in pairs (ops/v7_decode.py:quad_sum).
  const float n2 = group_sum((__fmul_rn(kk.x, kk.x) + __fmul_rn(kk.y, kk.y))
                             + (__fmul_rn(kk.z, kk.z) + __fmul_rn(kk.w, kk.w)));
  const float inv = fmaxf(sqrtf(n2), 1e-12f);
  kk = make_float4(rnd<T>(kk.x / inv), rnd<T>(kk.y / inv),
                   rnd<T>(kk.z / inv), rnd<T>(kk.w / inv));
  if (is_first && cq == 0 && rows)
    *reinterpret_cast<float4*>(v_first + vo + row0) = vv;

  // An inactive row keeps its state bit for bit (and is not written).
  const float v2r[4] = {v2.x, v2.y, v2.z, v2.w};
  if (act) {
    const float4 kka = make_float4(kk.x * av.x, kk.y * av.y, kk.z * av.z,
                                   kk.w * av.w);
    float skk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) skk[i] = dot4(s[i], kk);
#pragma unroll
    for (int i = 0; i < 4; ++i) skk[i] = group_sum(skk[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i].x = s[i].x * wv.x - skk[i] * kka.x + v2r[i] * k2.x;
      s[i].y = s[i].y * wv.y - skk[i] * kka.y + v2r[i] * k2.y;
      s[i].z = s[i].z * wv.z - skk[i] * kka.z + v2r[i] * k2.z;
      s[i].w = s[i].w * wv.w - skk[i] * kka.w + v2r[i] * k2.w;
      if (cols) *reinterpret_cast<float4*>(st + (size_t)i * HN) = s[i];
    }
  }
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = dot4(s[i], rv);
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = group_sum(y[i]);
  const int e = cq & 3;
  const float yv = e == 0 ? y[0] : e == 1 ? y[1] : e == 2 ? y[2] : y[3];

  // The head's y into ys (0 past HN).
  if (cq < 4) ys[orow] = yv;
  __syncthreads();

  // GroupNorm of the f32 y over the head, bonus, gate.
  float yl[HEAD_LANE];
#pragma unroll
  for (int o = 0; o < HEAD_LANE; ++o) yl[o] = ys[lane + 32 * o];
  const Moments m = head_moments(yl);
  if (cq < 4 && rows) {
    const float yn = (yv - m.mean) * rsqrtf(m.var + GN_EPS);
    const float yf = (yn * lnw + lnb) + bonus * v2r[e];
    out[vo + orow] = from_f<T>(yf * gv);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the weights' and activations' type T).  n: the
// head size the library was built for (HEAD_N).  One launch per layer, B x
// H blocks.  Every f32 operand 16-byte aligned.  A programmatic dependent
// launch that reads S and vecs before it waits for the kernel before it:
// whatever writes them must have finished before this kernel starts (a
// synchronisation, or a launch without PDL between them).
int v7_wkv_gn_launch(const float* r, const float* k, const float* v,
                     const float* w, const float* a, const float* g,
                     const float* vmix, float* v_first, const float* vecs,
                     const uint8_t* active, float* S, void* out, int B, int H,
                     int n, int is_first, int dtype, void* stream) {
  if (n != HN || B <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* kern = dtype == 1 ? (const void*)wkv_gn_kernel<__nv_bfloat16>
                                : (const void*)wkv_gn_kernel<float>;
  int h = H, c = H * HN, first = is_first;
  void* params[] = {(void*)&r,    (void*)&k,      (void*)&v,
                    (void*)&w,    (void*)&a,      (void*)&g,
                    (void*)&vmix, (void*)&v_first, (void*)&vecs,
                    (void*)&active, (void*)&S,    (void*)&out,
                    &h,           &c,             &first};
  const cudaError_t e = launch_ex(kern, dim3(B * H), THREADS, 0, 0, true,
                                  (cudaStream_t)stream, params);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
