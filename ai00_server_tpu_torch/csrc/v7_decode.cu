// The RWKV-7 whole-network decode step (T = 1) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces ai00_server_tpu/ops/v7_decode_pallas.py:forward_t1 (the Pallas
// _kernel): there one sequential grid over the layers keeps the residual in
// on-chip scratch.  On this card blocks run in no order and every stage of a
// layer needs the whole width of the stage before it, so a layer is a fixed
// sequence of nine launches of three kernels:
//
//   ln_mix(6) -> matmul{r,k,v} -> matmul{LoRA down x4} -> matmul{LoRA up x4}
//   -> wkv_gn -> matmul{Wo, += x} -> ln_mix(1) -> matmul{fkey} -> matmul{fval, += x}
//
// and the caller replays the whole stack from one CUDA graph.  Activations
// are T (the plain weights' type: bf16 or f32); the residual, the state and
// every sum are f32, and values round through T at the points of the Pallas
// kernel.  The six big projections of a layer may arrive as int8 codes with
// per-128-row-block scales (the Pallas kernel's int8 mode) or as packed
// 4-bit codes with per-64-row-block scales (its nf4 / sf4 / int4 modes): the
// product then dequantizes in T as it loads, w = round_T(level *
// round_T(s)), the scale applied per block before the f32 sum.  An int8
// code is its own level; a nibble's level comes from the 16-entry table of
// its mode (integers, exact in bf16), which the caller passes and the block
// keeps in shared memory.
//
// What bounds them on an H100 at the serving shape (B = 8, C = 1024,
// F = 4096, bf16):
//  * v7_skinny_matmul (replaces the products of the Pallas _kernel,
//    v7_decode_pallas.py:140-270, and of the v6 / v5 / v4 decode kernels):
//    bytes of the weight.  B <= 8 rows against a (K, N) weight is 2 B flops
//    per weight element, far under the card's balance point, so the design
//    streams each weight byte once for all rows and keeps bytes in flight
//    from the first instruction on.  A weight is 0.1-30 MB: a launch is a
//    chain of latencies (start, first loads, reduction, epilogue) around a
//    stream that lasts 0.1-10 us, and the design shortens the chain:
//    - programmatic dependent launch: a launch's blocks start while the
//      kernel before it runs (every kernel of the stacks lets the next one
//      start at once), ask for their first weight steps, and only then
//      wait for the kernel before (griddepcontrol.wait) and read x;
//    - bf16 products on the tensor cores (mma.sync m16n8k16): the weight
//      is A - its output columns the m side - and the 8 batch rows are n;
//      a warp's step is 16 stored rows of its 64 (bf16) or 128 (codes)
//      columns, four 16-byte loads a thread that interleaved in registers
//      (prmt) are A's fragments; int8 codes decode exactly in bf16x2
//      arithmetic (dec8) and take their scale with one bf16x2 multiply,
//      4-bit codes through the table in f32 and one rounding, so
//      w = round_T(level * round_T(s)) as the Pallas kernel has it;
//    - a warp keeps 2-4 steps (4-8 KB) in flight, a block of 8 warps 32-64
//      KB: the card's few MB in flight;
//    - K is split over the 8 warps of a block and, per the launch plan
//      (ops/v7_decode.py `plan`: tiles of 64 or 128 columns, one cluster
//      each, K slices of whole scale blocks over up to 8 blocks of a
//      thread block cluster: the finest split with one block an SM, or
//      two for long unsplit launches), over the blocks of a cluster; the
//      warps' sums meet in shared memory in warp order, the blocks' in
//      distributed shared memory in rank order (reduce_tile,
//      matmul_common.cuh): no work space, and the same bits on every run.
//      A launch without a split skips the cluster's barriers and fetches
//      its epilogue operands under the block's one;
//    - up to five products share one launch (r/k/v, the LoRAs, RWKV-6's
//      five token-shift offsets), each with its epilogue: besides v7's
//      activations, SiLU and RWKV-6's decay exp(-exp(s)); besides storing,
//      adding into the f32 residual, adding gated by an f32 vector (v6's
//      receptance-gated channel mix) and v6's token-shift combine xa + dx
//      * (mix + s) in T.  A product's input rows may be a strided view (v6
//      reads its five low-rank stages out of one (B, 5D) product).
//    In f32 (the parity models), and for bf16 shapes the tensor-core
//    kernel does not take, the same plan runs on CUDA-core FMAs.
//  * v7_wkv_gn: bytes of the state (16 KB a head, read once, written once
//    for active rows), with the vector prologue and the GroupNorm / bonus /
//    gate epilogue fused around the state's update.  At B <= 8 the
//    launch is a chain of latencies around 2 MB, so the design shortens
//    the chain:
//    - a programmatic dependent launch that asks for its state rows and
//      weights before it waits for the kernel before it (the LoRA-up
//      product), so the state's DRAM round trip overlaps that kernel;
//    - one block per (b, h) and one block barrier (the y exchange): a
//      thread holds a 4 x 4 tile of the state and computes the prologue
//      of its four columns in registers (16-byte loads throughout), the
//      norm and bonus over the head as its four terms and four shuffles,
//      and the GroupNorm runs within a warp by shuffles.
//  * v7_ln_mix: latency (decode_common.cuh).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"
#include "wkv7_common.cuh"

using namespace decode;
using namespace wkv7;

namespace {

// ---------------------------------------------------------------------------
// v7_skinny_matmul: up to five y = epilogue(x @ W) in one launch
// ---------------------------------------------------------------------------

constexpr int SK_ROWS = 8;               // batch rows per launch: mma's n
constexpr int SK_WARPS = 8;
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_STEP = 16;              // stored rows of a warp's step
constexpr int QB8 = 128;                 // rows of K per scale block: int8
constexpr int QB4 = 64;                  //                 packed 4-bit

// The products (MMProblem), their epilogue and the cluster's sum of the K
// slices are matmul_common.cuh's.
struct SKArgs {
  MMProblem p[MM_MAXP];
  int n, rows;
  float levels[16];  // 4-bit codes: what a nibble decodes to
};


__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The block's cluster rank, its product and its slice [k0, k1) of K.
struct Slice {
  MMProblem P;
  int col0, k0, k1;
};

template <int TN>
__device__ __forceinline__ Slice slice_of(const SKArgs& a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;  // the cluster: one tile of a product
  int pi = 0;
  while (pi + 1 < a.n && cid >= a.p[pi + 1].blk0) ++pi;
  Slice sl;
  sl.P = a.p[pi];
  sl.col0 = (cid - sl.P.blk0) * TN;
  sl.k0 = rank * sl.P.kb;
  sl.k1 = max(sl.k0, min(sl.P.K, sl.k0 + sl.P.kb));
  return sl;
}

// The warps' partial sums ([warp][row][TN]) added in warp order, the
// cluster's blocks in rank order, and the epilogue.  With one block a
// cluster a thread owns at most one quad (four columns of a row) of the
// rows x TN <= 1024 outputs: it fetches the epilogue's operands for it
// first, so that their loads overlap the barrier, and adds the warps' sums
// straight out of `part` (no tile, no cluster barrier).  A cluster leaves
// each block's sums in its tile ([row][TN + 4]) for reduce_tile
// (matmul_common.cuh).
template <typename T, int TN>
__device__ __forceinline__ void finish(const MMProblem& P, float* part,
                                       float* tile, int col0, int rows) {
  constexpr int TP = TN + 4;
  auto warp_sum = [&](int b, int c) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w) {
      const float4 t = *reinterpret_cast<const float4*>(
          part + (w * SK_ROWS + b) * TN + c);
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
    }
    return v;
  };
  const int quads = rows * (TN / 4);
  if (cooperative_groups::this_cluster().num_blocks() > 1) {
    __syncthreads();
    for (int q = threadIdx.x; q < quads; q += SK_THREADS) {
      const int b = q / (TN / 4), c = 4 * (q % (TN / 4));
      *reinterpret_cast<float4*>(tile + b * TP + c) = warp_sum(b, c);
    }
    reduce_tile<T, TN, TP, SK_THREADS>(P, tile, col0, rows);
    return;
  }
  const int q = threadIdx.x;
  const int b = q / (TN / 4), c = 4 * (q % (TN / 4));
  const int ne = q < quads ? max(0, min(4, P.N - col0 - c)) : 0;
  EpiIn in[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < ne) in[e] = epilogue_in<T>(P, b, col0 + c + e);
  __syncthreads();
  if (ne == 0) return;
  const float4 v = warp_sum(b, c);
  const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < ne) epilogue_out<T>(P, b, col0 + c + e, s[e], in[e]);
}

// bf16: the weight is mma's A (its columns the m side: one m16 tile is 16
// output columns), the batch rows B (n = 8); the codes are decoded into
// bf16 in registers.  A thread's four 16-byte loads of a step are rows 2 t,
// 2 t + 1, 2 t + 8, 2 t + 9 (t = lane % 4) of the step's 16 stored rows at
// its gid's (lane / 4) 8 bf16 or 16 code columns, which is A's fragment
// for k-step pairs once two rows' words are interleaved (prmt): m16 tile j
// holds the gid's columns 2 j (its row gid) and 2 j + 1 (row gid + 8), so
// the tiles' rows are a permutation of the columns, undone at the store.
// A step of packed 4-bit codes (16 byte rows) is two k-steps: the low
// nibbles (rows 16 h .. of a 64-row block) and the high ones (32 + 16 h ..).
template <int WQ>
__global__ void __launch_bounds__(SK_THREADS, 2)
skinny_tc_kernel(const __grid_constant__ SKArgs a) {
  constexpr bool Q = WQ != 0, Q4 = WQ == 4;
  constexpr int TN = Q ? 128 : 64;  // a 16-byte load a thread, 8 gids
  constexpr int CPL = Q ? 16 : 8;   // columns of a thread's 16-byte load
  constexpr int MT = CPL / 2;       // m16 tiles a k-step
  constexpr int KS = Q4 ? 2 : 1;    // k-steps a step
  constexpr int D = Q ? 2 : 4;      // steps in flight a warp
  constexpr int SQB = Q4 ? QB4 / 2 : QB8;  // stored rows a scale block
  __shared__ __align__(16) float part[SK_WARPS * SK_ROWS * TN];
  __shared__ __align__(16) float tile[SK_ROWS * (TN + 4)];
  __shared__ float lut[16];
  grid_launch_dependents();
  if (Q4 && threadIdx.x < 16) lut[threadIdx.x] = a.levels[threadIdx.x];
  const Slice sl = slice_of<TN>(a);
  const MMProblem& P = sl.P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int col = sl.col0 + CPL * gid;
  const bool col_ok = col < P.N;  // N is a multiple of CPL: all or none
  // This block's stored rows (byte rows of 4-bit codes: two rows of K
  // each) in steps, a contiguous run of them a warp.
  const int r0 = Q4 ? sl.k0 / 2 : sl.k0, r1 = Q4 ? sl.k1 / 2 : sl.k1;
  const int steps = (r1 - r0 + SK_STEP - 1) / SK_STEP;
  const int per = (steps + SK_WARPS - 1) / SK_WARPS;
  const int sb = min(steps, warp * per);
  const int n = min(steps, sb + per) - sb;
  const size_t pitch = (size_t)P.N * (Q ? 1 : 2);
  const char* wbase = static_cast<const char*>(P.W) + (size_t)col * (Q ? 1 : 2);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(P.x);

  auto load = [&](uint4 (&r)[4], int st) {
    const int base = r0 + SK_STEP * (sb + st);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sr = base + 2 * tq + (e & 1) + 8 * (e >> 1);
      r[e] = col_ok && sr < r1 ? ldg_stream(wbase + (size_t)sr * pitch)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // The first row of K of k-step ks of step st.
  auto krow = [&](int st, int ks) {
    const int base = r0 + SK_STEP * (sb + st);
    if constexpr (Q4)
      return QB4 * (base / (QB4 / 2)) + SK_STEP * ((base % (QB4 / 2)) / 16) +
             32 * ks;
    else
      return base;
  };
  // B's fragment: x row gid at rows k + 2 t, + 1 and + 8, + 9.
  auto load_x = [&](uint32_t (&xb)[2 * KS], int st) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k = krow(st, ks) + 2 * tq;
      const __nv_bfloat16* xr = x + (size_t)gid * P.ldx + k;
      const bool ok = gid < a.rows;
      const unsigned int* xw = reinterpret_cast<const unsigned int*>(xr);
      xb[2 * ks] = ok && k < P.K ? __ldcg(xw) : 0u;
      xb[2 * ks + 1] = ok && k + 8 < P.K ? __ldcg(xw + 4) : 0u;
    }
  };
  // The scales of the columns (rounded to bf16): (s, s) pairs for int8,
  // floats for 4-bit codes.
  uint32_t s2[Q && !Q4 ? 16 : 1];
  float sf[Q4 ? 16 : 1];
  int cur = -1;
  auto scales = [&](int st) {
    const int j = (r0 + SK_STEP * (sb + st)) / SQB;
    if (j == cur || !col_ok) return;
    cur = j;
    const float4* sp =
        reinterpret_cast<const float4*>(P.scale + (size_t)j * P.N + col);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(sp + q);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Q4)
          sf[4 * q + e] = rnd<__nv_bfloat16>(f[e]);
        else if constexpr (Q)
          s2[4 * q + e] = pack_bf16(f[e], f[e]);
      }
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // One step: its A fragments decoded, KS x MT products.
  auto step = [&](const uint4 (&r)[4], const uint32_t (&xb)[2 * KS]) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if constexpr (!Q) {
        const uint32_t w0 = word(r[0], t), w1 = word(r[1], t);
        const uint32_t w2 = word(r[2], t), w3 = word(r[3], t);
        mma_bf16(acc[t],
                 AFrag{prmt(w0, w1, 0x5410), prmt(w0, w1, 0x7632),
                       prmt(w2, w3, 0x5410), prmt(w2, w3, 0x7632)},
                 xb[0], xb[1]);
      } else {
        const int wi = t >> 1, X = 2 * (t & 1);  // word, byte of column 2 t
        const uint32_t w0 = word(r[0], wi), w1 = word(r[1], wi);
        const uint32_t w2 = word(r[2], wi), w3 = word(r[3], wi);
        if constexpr (!Q4) {
          mma_bf16(acc[t],
                   frag_int8(w0, w1, w2, w3, X, s2[4 * wi + X],
                             s2[4 * wi + X + 1]),
                   xb[0], xb[1]);
        } else {
          const float sa = sf[4 * wi + X], sb2 = sf[4 * wi + X + 1];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)  // low nibbles, then high
            mma_bf16(acc[t],
                     frag_4bit(w0, w1, w2, w3, 8 * X + 4 * ks, sa, sb2, lut),
                     xb[2 * ks], xb[2 * ks + 1]);
        }
      }
    }
  };

  // D steps of weights in flight; x (written by the kernel before) only
  // after the wait.
  uint4 buf[D][4];
  uint32_t xb[D][2 * KS];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < n) load(buf[d], d);
  if (Q && n > 0) scales(0);
  if (Q4) __syncthreads();  // the table
  grid_wait();
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < n) load_x(xb[d], d);
  for (int i0 = 0; i0 < n; i0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int i = i0 + d;
      if (i < n) {
        if (Q) scales(i);
        step(buf[d], xb[d]);
        if (i + D < n) {
          load(buf[d], i + D);
          load_x(xb[d], i + D);
        }
      }
    }
  }

  // acc[t]: (column CPL gid + 2 t, rows 2 tq, 2 tq + 1), then column + 1.
  float* pw = part + warp * SK_ROWS * TN;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int c = CPL * gid + 2 * t;
    pw[(2 * tq) * TN + c] = acc[t][0];
    pw[(2 * tq + 1) * TN + c] = acc[t][1];
    pw[(2 * tq) * TN + c + 1] = acc[t][2];
    pw[(2 * tq + 1) * TN + c + 1] = acc[t][3];
  }
  finish<__nv_bfloat16, TN>(P, part, tile, sl.col0, a.rows);
}

// One element of T read through L2 (x: written by the kernel before), or
// through the read-only path (weights), as a float.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float ld_nc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_nc(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// CUDA-core FMAs, no TF32: the f32 parity models, and bf16 products whose
// shapes the tensor-core kernel does not take (N not a multiple of 8 - of
// 16 for codes - or K odd).  A lane owns four columns of the block's 128;
// a step is 16 stored rows (16 rows of K, or 16 byte rows = 32 rows of K of
// packed 4-bit codes), the weight dequantized in T as it is summed.
template <typename T, int WQ>
__global__ void __launch_bounds__(SK_THREADS, 2)
skinny_fma_kernel(const __grid_constant__ SKArgs a) {
  constexpr bool Q = WQ != 0, Q4 = WQ == 4;
  constexpr int TN = 128;
  constexpr int SQB = Q4 ? QB4 / 2 : QB8;
  __shared__ __align__(16) float part[SK_WARPS * SK_ROWS * TN];
  __shared__ __align__(16) float tile[SK_ROWS * (TN + 4)];
  __shared__ float lut[16];
  grid_launch_dependents();
  if (Q4 && threadIdx.x < 16) lut[threadIdx.x] = a.levels[threadIdx.x];
  const Slice sl = slice_of<TN>(a);
  const MMProblem& P = sl.P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = sl.col0 + 4 * lane;
  const bool col_ok = col < P.N;  // codes: N is a multiple of 4
  const int r0 = Q4 ? sl.k0 / 2 : sl.k0, r1 = Q4 ? sl.k1 / 2 : sl.k1;
  const int steps = (r1 - r0 + SK_STEP - 1) / SK_STEP;
  const int per = (steps + SK_WARPS - 1) / SK_WARPS;
  const int sb = min(steps, warp * per);
  const int n = min(steps, sb + per) - sb;
  const T* x = static_cast<const T*>(P.x);
  if (Q4) __syncthreads();  // the table
  grid_wait();

  float acc[SK_ROWS][4];
#pragma unroll
  for (int b = 0; b < SK_ROWS; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
  // acc[b] += x[b, k] w for one row of K.
  auto fma_row = [&](const float (&w)[4], int k) {
#pragma unroll
    for (int b = 0; b < SK_ROWS; ++b) {
      const float xv = b < a.rows ? ld_cg(x + (size_t)b * P.ldx + k) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
    }
  };
  for (int st = 0; st < n; ++st) {
    const int base = r0 + SK_STEP * (sb + st);
    float s[4] = {1.f, 1.f, 1.f, 1.f};  // the scales, rounded to T
    if (Q && col_ok) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          P.scale + (size_t)(base / SQB) * P.N + col));
      s[0] = rnd<T>(v.x), s[1] = rnd<T>(v.y);
      s[2] = rnd<T>(v.z), s[3] = rnd<T>(v.w);
    }
#pragma unroll 4
    for (int u = 0; u < SK_STEP; ++u) {
      const int sr = base + u;
      if (!col_ok || sr >= r1) continue;  // uniform over the warp
      float w[4];
      if constexpr (!Q) {
        const T* wp = static_cast<const T*>(P.W) + (size_t)sr * P.N + col;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = col + e < P.N ? ld_nc(wp + e) : 0.f;
        fma_row(w, sr);
      } else {
        const uint32_t c = __ldg(reinterpret_cast<const unsigned int*>(
            static_cast<const int8_t*>(P.W) + (size_t)sr * P.N + col));
        if constexpr (!Q4) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = rnd<T>(static_cast<float>(static_cast<int8_t>(c >> (8 * e)))
                          * s[e]);
          fma_row(w, sr);
        } else {
          // Byte row sr: rows 64 j + i (low nibbles) and + 32 (high) of K.
          const int k = QB4 * (sr / (QB4 / 2)) + sr % (QB4 / 2);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = rnd<T>(lut[(c >> (8 * e + 4 * h)) & 15u] * s[e]);
            fma_row(w, k + 32 * h);
          }
        }
      }
    }
  }
  float* pw = part + warp * SK_ROWS * TN;
#pragma unroll
  for (int b = 0; b < SK_ROWS; ++b)
    *reinterpret_cast<float4*>(pw + b * TN + 4 * lane) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  finish<T, TN>(P, part, tile, sl.col0, a.rows);
}

// ---------------------------------------------------------------------------
// v7_wkv_gn: vector prologue, WKV step in place, GroupNorm, bonus, gate
// ---------------------------------------------------------------------------

// One block per (b, h).  A thread holds a 4 x 4 tile of the state: four
// value rows (row group tid / 16) by four columns (cq); the 16 threads of a
// row group cover its rows' 64 columns, 256 contiguous bytes a row.  A
// thread computes the vector prologue of its four columns in registers; the
// removal key's squared norm and the bonus sum over the head are its four
// terms in pairs, then the 16 threads' by shuffles in pairs (the norm's
// squares and sums unfused), so every thread holds the same bits and no
// barrier precedes the update.  The rows' y meet in shared memory (the
// block's one barrier), and every warp takes the GroupNorm of all 64 in
// the same order (head_moments).  The layout, CQ and group_sum are
// wkv7_common.cuh's, shared with wkv7.cu's one-step kernel.

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
  const size_t vo = (size_t)bh * N;  // == b * C + h * N
  const int c0 = h * N;
  float* st = S + (vo + row0) * N + col;

  // Before the wait, what no launch of the stack before this one writes:
  // this layer's state (written only by this same launch a step earlier;
  // the engine's copies into the state pool precede the whole step, whose
  // first launch is an ordinary one) and the weights.  vecs rows: w0 a0 v0
  // k_k k_a r_k lnx_w lnx_b.
  float4 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = ld4_l2(st + (size_t)i * N);
  const float4 kkw = ld4(vecs + 3 * (size_t)C + c0 + col);
  const float4 kaw = ld4(vecs + 4 * (size_t)C + c0 + col);
  const float4 rkw = ld4(vecs + 5 * (size_t)C + c0 + col);
  const float lnw = vecs[6 * (size_t)C + c0 + orow];
  const float lnb = vecs[7 * (size_t)C + c0 + orow];
  grid_wait();

  // After it, what the launches before write: r, k, v, w, a, g, vmix and
  // v_first (layer 0's launch writes it), and active (from the lengths),
  // all from L2 (ld4_l2).
  const bool act = __ldcg(active + b) != 0;
  const float4 rv = ld4_l2(r + vo + col), kv = ld4_l2(k + vo + col);
  const float4 av = ld4_l2(a + vo + col);
  float4 wv = ld4_l2(w + vo + col);
  const float4 vv = ld4_l2(v + vo + row0);
  float4 v2 = vv;
  if (!is_first) {
    const float4 vf = ld4_l2(v_first + vo + row0);
    const float4 vm = ld4_l2(vmix + vo + row0);
    v2 = make_float4(vv.x + (vf.x - vv.x) * vm.x, vv.y + (vf.y - vv.y) * vm.y,
                     vv.z + (vf.z - vv.z) * vm.z, vv.w + (vf.w - vv.w) * vm.w);
  }
  const float gv = __ldcg(g + vo + orow);

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
    k2 = make_float4(0.f, 0.f, 0.f, 0.f);
    kk = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // The squared norm: products unfused, the four in pairs, then the group
  // in pairs (ops/v7_decode.py:quad_sum).
  const float n2 = group_sum((__fmul_rn(kk.x, kk.x) + __fmul_rn(kk.y, kk.y))
                             + (__fmul_rn(kk.z, kk.z) + __fmul_rn(kk.w, kk.w)));
  const float inv = fmaxf(sqrtf(n2), 1e-12f);
  kk = make_float4(rnd<T>(kk.x / inv), rnd<T>(kk.y / inv),
                   rnd<T>(kk.z / inv), rnd<T>(kk.w / inv));
  if (is_first && cq == 0)
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
      *reinterpret_cast<float4*>(st + (size_t)i * N) = s[i];
    }
  }
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = dot4(s[i], rv);
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = group_sum(y[i]);
  const int e = cq & 3;
  const float yv = e == 0 ? y[0] : e == 1 ? y[1] : e == 2 ? y[2] : y[3];

  // The head's 64 y into ys.
  if (cq < 4) ys[orow] = yv;
  __syncthreads();

  // GroupNorm of the f32 y over the head, bonus, gate.
  const Moments m = head_moments(ys[lane], ys[lane + 32]);
  if (cq < 4) {
    const float yn = (yv - m.mean) * rsqrtf(m.var + GN_EPS);
    const float yf = (yn * lnw + lnb) + bonus * v2r[e];
    out[vo + orow] = from_f<T>(yf * gv);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the weights' and activations' type T).

// out: (base + n_mix, B, C) T; base is 0, or 2 to put xa and dx first.
// C a multiple of 4 up to LN_MAXC; every pointer 16-byte aligned (T = f32)
// or 8-byte (bf16).  A programmatic dependent launch.
int v7_ln_mix_launch(const float* x, const void* ln, float* shift,
                     const void* mix, const uint8_t* active, void* out, int B,
                     int C, int n_mix, int base, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || C % 4 || C > LN_MAXC || n_mix <= 0 || n_mix > 6 ||
      (base != 0 && base != 2) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // Chunks of at least 32 groups of four columns (one a thread), as many
  // as fill about two blocks an SM of the card's 132, whole rows read by
  // each.
  const int C4 = C / 4;
  int parts = (2 * 132 + B - 1) / B;
  parts = max(1, min(parts, C4 / 32));
  int chunk = (C4 + parts - 1) / parts;
  chunk = min(LN_THREADS, chunk);
  parts = (C4 + chunk - 1) / chunk;
  const dim3 grid(parts, B, 1);
  int c = C, nm = n_mix, bs = base, rows = B;
  void* params[] = {(void*)&x, (void*)&ln, (void*)&shift, (void*)&mix,
                    (void*)&active, (void*)&out, &rows, &c, &nm, &bs, &chunk};
  const void* k = dtype == 1 ? (const void*)ln_mix_kernel<__nv_bfloat16>
                             : (const void*)ln_mix_kernel<float>;
  const cudaError_t e =
      launch_ex(k, grid, LN_THREADS, 0, 0, true, (cudaStream_t)stream, params);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// desc: n_prob rows of 12 int64 on the HOST (parse_problem,
// matmul_common.cuh).  plan: n_launch rows of PLAN_COLS int64 on the HOST,
// one per launch, from ops/v7_decode.py `plan`: b0 (first batch row), rows
// (at most 8), cs (cluster size: the blocks that split a tile's K),
// clusters (the launch's tiles: 64 columns of bf16 weights, else 128),
// then per product blk0 (its first tile) and kb (the rows of K a cluster
// rank sums: whole scale blocks of codes - 128 rows int8, 64 packed 4-bit -
// else a multiple of 16).  dtype: 0 = f32, 1 = bf16 (T).  wbits: 0 plain
// weights of type T, 8 int8 codes (K / 128, 128, N), 4 packed 4-bit codes
// (K / 64, 32, N) with levels = 16 int32 on the host, what a nibble decodes
// to; every product of codes with its (K / block, N) f32 scales, N a
// multiple of 4.  bf16 runs on the tensor cores (64-column tiles of plain
// weights, 128 of codes) where every product's N is a multiple of 8 (16 for
// codes) and K is even - W then 16-byte aligned, x rows 4-byte aligned -
// and otherwise, as f32 does, on the FMA kernel (128-column tiles).  No
// work space: the partial sums stay in the clusters' shared memory.
// Programmatic dependent launches: a block reads the weights, codes, scales
// and levels before it waits for the kernel before it, and x and the
// epilogue's operands after.
int v7_skinny_matmul_launch(const int64_t* desc, int n_prob,
                            const int64_t* plan, int n_launch, int dtype,
                            int wbits, const int32_t* levels, void* stream) {
  if (n_prob <= 0 || n_prob > MM_MAXP || n_launch <= 0 ||
      (dtype != 0 && dtype != 1) || (wbits != 0 && wbits != 8 && wbits != 4) ||
      (wbits == 4) != (levels != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool bf = dtype == 1, quant = wbits != 0;
  const size_t tsize = bf ? 2 : 4;
  const int qblock = wbits == 4 ? QB4 : QB8;
  const int align = quant ? qblock : SK_STEP;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = 0; l < n_launch; ++l) {
    const int64_t* pl = plan + (size_t)l * PLAN_COLS;
    const int b0 = (int)pl[0], rows = (int)pl[1], cs = (int)pl[2],
              clusters = (int)pl[3];
    if (b0 < 0 || rows <= 0 || rows > SK_ROWS || cs < 1 ||
        cs > MAX_CLUSTER || clusters < 1)
      return (int)cudaErrorInvalidValue;
    SKArgs a;
    a.n = n_prob;
    a.rows = rows;
    for (int i = 0; i < 16; ++i)
      a.levels[i] = levels != nullptr ? (float)levels[i] : 0.f;
    // bf16 takes the tensor cores where every product's columns come in
    // whole 16-byte loads and K is even.
    bool tc = bf;
    for (int i = 0; i < n_prob; ++i) {
      MMProblem& P = a.p[i];
      if (!parse_problem(desc + 12 * i, b0, tsize, quant, qblock,
                         quant ? 4 : 1, P))
        return (int)cudaErrorInvalidValue;
      tc = tc && P.N % (quant ? 16 : 8) == 0 && P.K % 2 == 0;
    }
    const int tn = tc && !quant ? 64 : 128;
    int tiles = 0;
    for (int i = 0; i < n_prob; ++i) {
      MMProblem& P = a.p[i];
      P.blk0 = (int)pl[4 + 2 * i];
      P.kb = (int)pl[5 + 2 * i];
      // The plan covers the product: its tiles follow the previous ones,
      // and cs slices of kb rows cover K.
      if (P.blk0 != tiles || P.kb <= 0 || P.kb % align ||
          (int64_t)P.kb * cs < P.K)
        return (int)cudaErrorInvalidValue;
      tiles += (P.N + tn - 1) / tn;
    }
    if (tiles != clusters) return (int)cudaErrorInvalidValue;
    const void* k;
    if (tc)
      k = wbits == 4   ? (const void*)skinny_tc_kernel<4>
          : wbits == 8 ? (const void*)skinny_tc_kernel<8>
                       : (const void*)skinny_tc_kernel<0>;
    else if (bf)
      k = wbits == 4   ? (const void*)skinny_fma_kernel<__nv_bfloat16, 4>
          : wbits == 8 ? (const void*)skinny_fma_kernel<__nv_bfloat16, 8>
                       : (const void*)skinny_fma_kernel<__nv_bfloat16, 0>;
    else
      k = wbits == 4   ? (const void*)skinny_fma_kernel<float, 4>
          : wbits == 8 ? (const void*)skinny_fma_kernel<float, 8>
                       : (const void*)skinny_fma_kernel<float, 0>;
    void* params[] = {&a};
    cudaError_t err = launch_ex(k, dim3(clusters * cs), SK_THREADS, 0, cs,
                                true, st, params);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One launch per layer, B x H blocks.  Every f32 operand 16-byte aligned.
// A programmatic dependent launch that reads S and vecs before it waits
// for the kernel before it: whatever writes them must have finished before
// this kernel starts (a synchronisation, or a launch without PDL between
// them).
int v7_wkv_gn_launch(const float* r, const float* k, const float* v,
                     const float* w, const float* a, const float* g,
                     const float* vmix, float* v_first, const float* vecs,
                     const uint8_t* active, float* S, void* out, int B, int H,
                     int n, int is_first, int dtype, void* stream) {
  if (n != N || B <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* kern = dtype == 1 ? (const void*)wkv_gn_kernel<__nv_bfloat16>
                                : (const void*)wkv_gn_kernel<float>;
  int h = H, c = H * N, first = is_first;
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
