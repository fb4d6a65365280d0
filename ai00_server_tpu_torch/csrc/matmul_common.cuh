// Shared code of the decode steps' product kernels (v7_decode.cu's
// v7_skinny_matmul, phased.cu's phased_matmul): one product of a launch as
// the launchers describe it, the epilogue every output element goes
// through, and the host-side reading of a launch's descriptor table.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace decode {

constexpr float W_SCALE = 0.6065306597126334f;  // exp(-0.5)

enum Act { ACT_NONE = 0, ACT_TANH = 1, ACT_SIGMOID = 2, ACT_WDECAY = 3,
           ACT_RELU2 = 4, ACT_SILU = 5, ACT_EXPEXP = 6 };
// OUT_MIX: y (T) = xa + dx * (mix + round_T(s)), each step rounded through T
// (e0 = xa, e1 = dx: (B, N) T; e2 = mix: (N,) T).  OUT_GADD: y (the f32
// residual) += gate * s (e0 = gate: (B, N) f32).
enum Out { OUT_T = 0, OUT_F32 = 1, OUT_ADD = 2, OUT_MIX = 3, OUT_GADD = 4 };

struct MMProblem {
  const void* x;      // (B, K) T, rows ldx elements apart
  const void* W;      // (K, N) T, or int8 codes when scale is set
  const float* scale; // (K / 128, N) f32 per-block scales, or null
  void* y;            // (B, N): T, f32, or the f32 residual added into
  const float* bias;  // (N,) f32 or null, added before the activation
  const void* e0;     // epilogue operands of OUT_MIX / OUT_GADD, or null
  const void* e1;
  const void* e2;
  int K, N, ldx;
  int act, round_t, out;
  int ksplit, kb;     // K is cut into ksplit slices of kb rows
  int blk0;           // first block of this product in the launch
  int scr0, cnt0;     // offsets into the scratch floats / the counters
};

// What the epilogue of output (b, c) reads besides the sum, read apart from
// its stores so that a caller can read several outputs' operands before
// writing any (the loads then overlap).
struct EpiIn {
  float bias, y, e0, e1, e2;
};

template <typename T>
__device__ __forceinline__ EpiIn epilogue_in(const MMProblem& P, int b,
                                             int c) {
  const size_t i = (size_t)b * P.N + c;
  EpiIn in = {P.bias != nullptr ? P.bias[c] : 0.f, 0.f, 0.f, 0.f, 0.f};
  if (P.out == OUT_ADD || P.out == OUT_GADD)
    in.y = static_cast<const float*>(P.y)[i];
  if (P.out == OUT_GADD) in.e0 = static_cast<const float*>(P.e0)[i];
  if (P.out == OUT_MIX) {
    in.e0 = to_f(static_cast<const T*>(P.e0)[i]);
    in.e1 = to_f(static_cast<const T*>(P.e1)[i]);
    in.e2 = to_f(static_cast<const T*>(P.e2)[c]);
  }
  return in;
}

template <typename T>
__device__ __forceinline__ void epilogue_out(const MMProblem& P, int b, int c,
                                             float s, const EpiIn& in) {
  if (P.bias != nullptr) s += in.bias;
  switch (P.act) {
    case ACT_TANH: s = tanhf(s); break;
    case ACT_SIGMOID: s = sigmoidf(s); break;
    case ACT_WDECAY: s = expf(-W_SCALE * sigmoidf(s)); break;
    case ACT_RELU2: s = fmaxf(s, 0.f); s = s * s; break;
    case ACT_SILU: s = s * sigmoidf(s); break;
    case ACT_EXPEXP: s = expf(-expf(s)); break;
    default: break;
  }
  const size_t i = (size_t)b * P.N + c;
  if (P.out == OUT_ADD) {
    static_cast<float*>(P.y)[i] = in.y + s;
  } else if (P.out == OUT_GADD) {
    static_cast<float*>(P.y)[i] = in.y + in.e0 * s;
  } else if (P.out == OUT_MIX) {
    const float t = rnd<T>(in.e2 + rnd<T>(s));
    const float d = rnd<T>(in.e1 * t);
    static_cast<T*>(P.y)[i] = from_f<T>(in.e0 + d);
  } else if (P.out == OUT_F32) {
    static_cast<float*>(P.y)[i] = P.round_t ? rnd<T>(s) : s;
  } else {
    static_cast<T*>(P.y)[i] = from_f<T>(s);
  }
}

template <typename T>
__device__ __forceinline__ void epilogue(const MMProblem& P, int b, int c,
                                         float s) {
  epilogue_out<T>(P, b, c, s, epilogue_in<T>(P, b, c));
}

// One row d of a launch's descriptor table - 12 int64: x, W, y, bias
// (pointers; bias may be 0), K, N, act | round_t << 8 | out << 16, scale
// (pointer, or 0 for a plain weight), ldx (elements between rows of x,
// >= K), e0, e1, e2 (the epilogue's operands, pointers or 0) - read into P
// with the row operands moved to batch row b0.  tsize: bytes of T; quant:
// every product of the launch has codes and scales, K a multiple of
// qblock; N a multiple of cpt.  False where the row is not a product the
// kernels take.
inline bool parse_problem(const int64_t* d, int b0, size_t tsize, bool quant,
                          int qblock, int cpt, MMProblem& P) {
  P.K = (int)d[4];
  P.N = (int)d[5];
  P.scale = (const float*)(uintptr_t)d[7];
  P.ldx = (int)d[8];
  P.act = (int)(d[6] & 0xff);
  P.round_t = (int)((d[6] >> 8) & 0xff);
  P.out = (int)((d[6] >> 16) & 0xff);
  if (P.K <= 0 || P.N <= 0 || P.N % cpt || (P.scale != nullptr) != quant ||
      (quant && P.K % qblock) || P.ldx < P.K || P.out > OUT_GADD ||
      ((P.out == OUT_MIX || P.out == OUT_GADD) && d[9] == 0) ||
      (P.out == OUT_MIX && (d[10] == 0 || d[11] == 0)))
    return false;
  // T for what is stored in T (OUT_T, OUT_MIX and its xa / dx), else f32.
  const size_t ysize = P.out == OUT_T || P.out == OUT_MIX ? tsize : 4;
  P.x = (const char*)(uintptr_t)d[0] + (size_t)b0 * P.ldx * tsize;
  P.W = (const void*)(uintptr_t)d[1];
  P.y = (char*)(uintptr_t)d[2] + (size_t)b0 * P.N * ysize;
  P.bias = (const float*)(uintptr_t)d[3];
  P.e0 = d[9] ? (const char*)(uintptr_t)d[9] + (size_t)b0 * P.N * ysize
              : nullptr;
  P.e1 = d[10] ? (const char*)(uintptr_t)d[10] + (size_t)b0 * P.N * ysize
               : nullptr;
  P.e2 = (const void*)(uintptr_t)d[11];
  return true;
}

}  // namespace decode
