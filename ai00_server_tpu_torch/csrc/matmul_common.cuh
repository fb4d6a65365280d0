// Shared code of the product kernels (v7_decode.cu's v7_skinny_matmul,
// phased.cu's phased_matmul, quant.cu's dequantizing products): one product
// of a launch as the launchers describe it, the epilogue every output
// element goes through, the host-side reading of a launch's descriptor
// table and plan, the exact bf16 decodes of int8 and int4 codes, A's
// fragment of a code tile for mma.sync and the product itself, cp.async,
// the sum of a tile's K slices over a thread block cluster, and the launch
// with cluster and programmatic-dependent-launch attributes.

#pragma once

#include <cooperative_groups.h>
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
  int kb;             // rows of K a cluster rank sums
  int blk0;           // first tile (cluster) of this product in the launch
};

constexpr int MM_MAXP = 5;       // products per launch
constexpr int MAX_CLUSTER = 8;   // blocks that split one tile's K
// A launch's row of the plan table: b0, rows, cs, clusters, then (blk0,
// kb) per product.
constexpr int PLAN_COLS = 4 + 2 * MM_MAXP;

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

// ---------------------------------------------------------------------------
// Register decodes (bf16x2 lanes, exact)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// Byte X of words a (row k) and b (row k + 1) as [a.X, a.X, b.X, b.X]: one
// bf16x2 lane per row of K once decoded.
template <int X>
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
  return prmt(a, b, X | X << 4 | (4 + X) << 8 | (4 + X) << 12);
}
// Signed int8 code c in each lane's low byte -> bf16 c: 128 + (c & 127),
// minus 256 where c < 0 (its bit 7 set) and 128 where not; all exact.
__device__ __forceinline__ uint32_t dec8(uint32_t t) {
  return bf16x2_sub((t & 0x007F007Fu) | 0x43004300u,
                    (t & 0x00800080u) | 0x43004300u);
}
// Nibble n (low, or high when HI) of each lane's low byte -> bf16 n - 8:
// 128 + n minus 136, exact.
template <bool HI>
__device__ __forceinline__ uint32_t dec4(uint32_t t) {
  return bf16x2_sub(((HI ? t >> 4 : t) & 0x000F000Fu) | 0x43004300u,
                    0x43084308u);
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// A's fragment of a code tile, and the bf16 product
// ---------------------------------------------------------------------------
//
// The weight is mma's A with its output columns as the m side.  A thread
// (gid = lane / 4, tq = lane % 4) holds code words w0 .. w3 of the stored
// rows 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 of a step, each a few neighbouring
// columns of its gid: the m16 tile whose row gid is the column at byte X of
// the words and whose row gid + 8 is the column at byte X + 1 has its A
// fragment here (so a tile's rows are a permutation of its columns, undone
// where the sums are stored).  The weight is dequantized as the Pallas
// kernels do, w = round_bf16(level * round_bf16(s)): s_lo / s_hi are the two
// columns' scales, already rounded - (s, s) bf16 pairs for int8 codes, floats
// for 4-bit ones.

struct AFrag {
  uint32_t a0, a1, a2, a3;
};

// int8 codes: decoded exactly in bf16x2 and scaled with one bf16x2 multiply.
__device__ __forceinline__ AFrag frag_int8(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3, int X,
                                           uint32_t s_lo, uint32_t s_hi) {
  const uint32_t lo = X | X << 4 | (4 + X) << 8 | (4 + X) << 12;
  const uint32_t hi = lo + 0x1111u;  // byte X + 1
  return {bf16x2_mul(dec8(prmt(w0, w1, lo)), s_lo),
          bf16x2_mul(dec8(prmt(w0, w1, hi)), s_hi),
          bf16x2_mul(dec8(prmt(w2, w3, lo)), s_lo),
          bf16x2_mul(dec8(prmt(w2, w3, hi)), s_hi)};
}

// Packed 4-bit codes: the nibble at bit sh of each word (the column at byte
// X: sh = 8 X, + 4 for the high nibbles) and at sh + 8 (byte X + 1) through
// the 16-entry table, times the scale in f32 (exact: an integer level times
// a bf16), rounded once.
__device__ __forceinline__ AFrag frag_4bit(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3, int sh,
                                           float s_lo, float s_hi,
                                           const float* lut) {
  auto v = [&](uint32_t w, int e, float s) {
    return lut[(w >> (sh + 8 * e)) & 15u] * s;
  };
  return {pack_bf16(v(w0, 0, s_lo), v(w1, 0, s_lo)),
          pack_bf16(v(w0, 1, s_hi), v(w1, 1, s_hi)),
          pack_bf16(v(w2, 0, s_lo), v(w3, 0, s_lo)),
          pack_bf16(v(w2, 1, s_hi), v(w3, 1, s_hi))};
}

// D (16 x 8, f32) += A (16 x 16, bf16, row-major) B (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const AFrag& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.a0), "r"(a.a1), "r"(a.a2), "r"(a.a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// cp.async: 16 or 4 bytes global -> shared (zeros where !valid)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// ---------------------------------------------------------------------------
// The K slices of a tile summed over a thread block cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four f32 of a cluster block's shared memory (a shared::cluster address).
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// After every block of the cluster has left its slice's sums in `tile`
// ([row][TP] f32, BN columns from col0), each block adds one share of the
// tile's outputs over the cluster's tiles IN RANK ORDER through
// distributed shared memory and runs the epilogue: a thread takes four
// neighbouring columns at a time, reads them from each rank with one
// explicit shared::cluster load, and reads the epilogue operands of all
// four before it stores any.  The second barrier keeps every block's tile
// alive until all have read it.
template <typename T, int BN, int TP, int THREADS>
__device__ __forceinline__ void reduce_tile(const MMProblem& P,
                                            float* tile, int col0, int rows) {
  static_assert(BN % 4 == 0 && TP % 4 == 0, "float4 reads of the tile");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  uint32_t parts[MAX_CLUSTER];  // registers only: the rank loops unrolled
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER; ++j) {
    parts[j] = 0;
    if (j < cs)
      asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
          : "=r"(parts[j])
          : "r"(smem_u32(tile)), "r"(j));
  }
  const int quads = rows * (BN / 4);
  for (int q = rank * THREADS + (int)threadIdx.x; q < quads;
       q += cs * THREADS) {
    const int b = q / (BN / 4), c = 4 * (q % (BN / 4));
    if (col0 + c >= P.N) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      if (j < cs) {
        const float4 t = ld_cluster4(parts[j] + 4 * (b * TP + c));
        v.x += t.x;
        v.y += t.y;
        v.z += t.z;
        v.w += t.w;
      }
    const float s[4] = {v.x, v.y, v.z, v.w};
    const int ne = min(4, P.N - col0 - c);  // a ragged N's last quad
    EpiIn in[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < ne) in[e] = epilogue_in<T>(P, b, col0 + c + e);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < ne) epilogue_out<T>(P, b, col0 + c + e, s[e], in[e]);
  }
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Host: the launch
// ---------------------------------------------------------------------------

// `kernel` over `blocks` blocks of `threads`, in clusters of cs blocks (0:
// no cluster attribute) and, with pdl, as a programmatic dependent launch:
// its blocks may start once every block of the kernel before it in the
// stream has run griddepcontrol.launch_dependents (or exited), and each
// waits in griddepcontrol.wait before it reads what that kernel writes.
inline cudaError_t launch_ex(const void* kernel, dim3 grid, int threads,
                             int smem, int cs, bool pdl, cudaStream_t st,
                             void** params) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cs > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cs;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelExC(&cfg, kernel, params);
}

}  // namespace decode
