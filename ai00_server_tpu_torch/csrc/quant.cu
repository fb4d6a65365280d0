// Dequant-in-matmul kernels on int8 and on packed 4-bit codes for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces ai00_server_tpu/ops/quant_pallas.py:matmul_int8, matmul_int8_l
// (y = x . (codes x per-128-row-block scale), the second on layer l of
// stacked codes), matmul_4bit, matmul_4bit_l (the same on nf4 / sf4 / int4
// codes, two a byte, per-64-row-block scales) and
// ai00_server_tpu/ops/ffn_pallas.py:ffn7_t1_l (the RWKV-7 channel mix at
// T = 1 on quantized layer l, any of the four modes).  The Pallas kernels
// walk a sequential grid of 128-row tiles with the output block resident in
// VMEM; here one kernel computes
//
//   y (rows <= 64, N) = epilogue(prologue(x) (rows, K) . dequant(q, s))
//
// and the entry points run it per the launch plan of
// ops/quant_matmul.py:plan: matmul_* one launch per 64 rows of x (on layer l
// of stacked codes by offsetting the base pointers: no slicing copy),
// ffn7_t1_l two per 64 rows (the key product with the token-shift mix as
// prologue and relu^2 as epilogue, then the value product, a programmatic
// dependent that streams its codes while the key product runs and waits for
// hk only before it reads it).
//
// Rounding follows the Pallas kernels: the weight is dequantized in the
// activation type T, w = round_T(level * round_T(s)), then x . w is summed
// in f32.  An int8 code is its own level; a nibble's level is one of 16
// integers (exact in bf16) that the caller passes as a table, so nf4, sf4
// and int4 are one kernel.  4-bit layout: byte row i of a 64-row block holds
// block row i in its low nibble and row 32 + i in its high nibble.
//
// What bounds it on an H100 at the serving shapes (rows 1 .. 64; K, N in
// 1024 .. 65536): the bytes of the codes - at most 2 x 64 operations per
// code byte, far under the card's balance point - so the design reads every
// code byte once for all the rows of a launch and keeps the bytes in
// flight:
//  * a block owns 128 output columns and a K slice; it streams the slice in
//    stages of 64 rows of K (8 KB of int8 codes, 4 KB packed, their scales
//    and the stage's rows of x) through a cp.async ring in shared memory,
//    so the next stages are in flight while it works on one;
//  * bf16 runs on the tensor cores (mma.sync m16n8k16): the weight is A -
//    its 128 columns the m side, one m16 tile a warp - decoded from shared
//    memory into A's fragments by the code path v7_skinny_matmul uses
//    (matmul_common.cuh: frag_int8 / frag_4bit), and the launch's rows are
//    n, 1-8 n-tiles of 8 (the row tile, a template parameter: 8, 16, 32 or
//    64) read by ldmatrix, so one decoded fragment feeds up to 8 products;
//    rows past the launch's are neither read nor stored (eight warps of
//    one m16 tile each beat four of two at 64 rows, 1.1-1.3x, and
//    ldmatrix beat 32-bit shared loads there by up to 1.1x: PERF.md);
//  * f32 (the parity models) runs the same plan on CUDA-core FMAs, never
//    bf16 mma on f32 inputs;
//  * K is split over the blocks of a thread block cluster where the column
//    tiles alone would not fill the card (the plan's cs and kb: slices of
//    whole scale blocks); the slices' sums meet in distributed shared
//    memory in rank order (reduce_tile): no work space, no float atomics,
//    the same bits on every run and under a CUDA-graph replay;
//  * programmatic dependent launch: a block asks for its first stages'
//    codes and scales before griddepcontrol.wait and for x after it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"
#include "matmul_common.cuh"

using namespace decode;

namespace {

constexpr int QB8 = 128;   // rows of K a scale block: int8
constexpr int QB4 = 64;    //                          packed 4-bit
constexpr int TN = 128;    // output columns a block
constexpr int CH = 64;     // rows of K a stage
constexpr int CP = TN + 16;  // a stored code row in shared memory, bytes
constexpr int PP = CH + 4;   // a row of the prologue's f32 shift state
constexpr int TP = TN + 4;   // a row of the sums' tile, floats
constexpr int PLAN_Q = 6;    // a plan row: r0, rows, rt, cs, tiles, kb
constexpr int DEPTH = 4;     // stages in the ring
constexpr int THREADS = 256; // 8 warps: a 16-column m16 tile each (bf16)

template <typename T>
__host__ __device__ constexpr bool on_tc() {
  return sizeof(T) == 2;
}
// A row of x's stage, elements: 16-byte rows, bank-conflict-free B reads.
template <typename T>
__host__ __device__ constexpr int xpitch() {
  return on_tc<T>() ? CH + 8 : CH + 4;
}

// One launch's product and, for the channel mix's key product, its
// prologue.
struct QArgs {
  MMProblem P;           // x, W (the layer's codes), scale, y, K, N, act,
                         // out, kb; bias, e0-e2 null
  const float* prev;     // prologue: (rows, K) f32 shift state, else null
  const void* mix;       // (K,) T
  const uint8_t* active; // (rows,)
  float* new_shift;      // (rows, K) f32: where(active, x, prev)
  int rows;              // rows of x and y from their base pointers
  float levels[16];      // 4-bit codes: what a nibble decodes to
};

// Byte offsets in one stage of the ring.
template <typename T, int WQ, int RT>
struct Stage {
  static constexpr int CROWS = WQ == 8 ? CH : CH / 2;  // stored code rows
  static constexpr int SCALES = CROWS * CP;
  static constexpr int X = SCALES + TN * 4;
  static constexpr int PREV = X + RT * xpitch<T>() * (int)sizeof(T);
  static constexpr int MIX = PREV + RT * PP * 4;
  static constexpr int BYTES = PREV;  // without the prologue's operands
  static constexpr int BYTES_PRO = MIX + CH * (int)sizeof(T);
  static constexpr int TILE = RT * TP * 4;  // the sums, after the ring
  static constexpr int smem(bool pro) {
    return DEPTH * (pro ? BYTES_PRO : BYTES) > TILE
               ? DEPTH * (pro ? BYTES_PRO : BYTES)
               : TILE;
  }
};

// bf16 on the tensor cores: warp w owns the m16 tile of columns 16 w ..
// 16 w + 15, a thread columns 2 gid and 2 gid + 1 of it (rows gid and gid +
// 8 of the tile), and every row of x as NT n-tiles.
template <int WQ, int RT>
struct TcMath {
  using T = __nv_bfloat16;
  static constexpr int NT = RT / 8;
  static constexpr int XP = xpitch<T>();
  float acc[NT][4];

  __device__ __forceinline__ int first_col() const {
    return (threadIdx.x >> 5) * 16 + 2 * ((threadIdx.x & 31) >> 2);
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // B of every n-tile at stage row kk - x row 8 j + gid, rows kk + 2 tq, + 1
  // and + 8, + 9 - by ldmatrix: lanes 8 i .. 8 i + 7 address the rows of
  // matrix i, n-tile j + i / 2 at rows kk + 8 (i % 2) .. of K.
  __device__ __forceinline__ void bfrag(uint32_t (&b)[NT][2], const T* xs,
                                        int kk) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int nt = NT == 1 ? j : j + (lane >> 4);
      const uint32_t a = smem_u32(xs + (8 * nt + (lane & 7)) * XP + kk +
                                  8 * ((lane >> 3) & 1));
      if constexpr (NT == 1)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b[j][0]), "=r"(b[j][1])
            : "r"(a));
      else
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]),
              "=r"(b[j + 1][1])
            : "r"(a));
    }
  }

  // The products of one stage: codes at st, scales at sc, x at xs.
  __device__ __forceinline__ void stage(const unsigned char* st,
                                        const float* sc, const T* xs,
                                        const float* lut) {
    const int tq = threadIdx.x & 3;
    const int wc = first_col();
    auto code = [&](int r) -> uint32_t {  // the thread's 2 bytes of row r
      return *reinterpret_cast<const uint16_t*>(st + r * CP + wc);
    };
    uint32_t b[NT][2];
    if constexpr (WQ == 8) {
      const uint32_t s_lo = pack_bf16(sc[wc], sc[wc]);  // (s, s) bf16 pairs
      const uint32_t s_hi = pack_bf16(sc[wc + 1], sc[wc + 1]);
#pragma unroll
      for (int u = 0; u < CH / 16; ++u) {
        const int r = 16 * u + 2 * tq;
        const AFrag a = frag_int8(code(r), code(r + 1), code(r + 8),
                                  code(r + 9), 0, s_lo, s_hi);
        bfrag(b, xs, 16 * u);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
      }
    } else {
      const float s_lo = rnd<T>(sc[wc]), s_hi = rnd<T>(sc[wc + 1]);
      // Byte rows 16 h ..: rows of K 16 h .. (low nibbles), 32 + 16 h ..
      // (high).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * h + 2 * tq;
        const uint32_t w0 = code(r), w1 = code(r + 1), w2 = code(r + 8),
                       w3 = code(r + 9);
#pragma unroll
        for (int nib = 0; nib < 2; ++nib) {
          const AFrag a = frag_4bit(w0, w1, w2, w3, 4 * nib, s_lo, s_hi, lut);
          bfrag(b, xs, 32 * nib + 16 * h);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[j], a, b[j][0], b[j][1]);
        }
      }
    }
  }

  // acc[j]: (column wc, rows 8 j + 2 tq, + 1), then column wc + 1.
  __device__ __forceinline__ void store(float* tile) const {
    const int tq = threadIdx.x & 3, wc = first_col();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(8 * j + 2 * tq + (e & 1)) * TP + wc + (e >> 1)] = acc[j][e];
  }
};

// CUDA-core FMAs (f32): lane l owns columns 4 l .. 4 l + 3, warp w the rows
// RPW w .. RPW (w + 1); every row of K in order.
template <typename T, int WQ, int RT>
struct FmaMath {
  static constexpr int RPW = RT / 8;
  static constexpr int XP = xpitch<T>();
  float acc[RPW][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  __device__ __forceinline__ void stage(const unsigned char* st,
                                        const float* sc, const T* xs,
                                        const float* lut) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = rnd<T>(sc[4 * lane + e]);
    auto fma_row = [&](const float (&w)[4], int k) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float xv = to_f(xs[(RPW * warp + r) * XP + k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(xv, w[e], acc[r][e]);
      }
    };
    auto word = [&](int r) {
      return *reinterpret_cast<const uint32_t*>(st + r * CP + 4 * lane);
    };
    if constexpr (WQ == 8) {
#pragma unroll 4
      for (int k = 0; k < CH; ++k) {
        const uint32_t c = word(k);
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = rnd<T>(static_cast<float>(static_cast<int8_t>(c >> (8 * e)))
                        * s[e]);
        fma_row(w, k);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < CH / 2; ++i) {
        const uint32_t c = word(i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = rnd<T>(lut[(c >> (8 * e + 4 * h)) & 15u] * s[e]);
          fma_row(w, i + 32 * h);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* tile) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      *reinterpret_cast<float4*>(tile + (RPW * warp + r) * TP + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
};

template <typename T, int WQ, int RT>
using Math = typename std::conditional<on_tc<T>(), TcMath<WQ, RT>,
                                       FmaMath<T, WQ, RT>>::type;

// Block b of a launch: cluster b / cs is column tile b / cs, its rank r the
// K slice [r kb, (r + 1) kb).
template <typename T, int WQ, int RT>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __grid_constant__ QArgs a) {
  using S = Stage<T, WQ, RT>;
  constexpr int XP = xpitch<T>();
  constexpr int QB = WQ == 8 ? QB8 : QB4;
  constexpr int XC = CH * (int)sizeof(T) / 16;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lut[16];
  grid_launch_dependents();
  const MMProblem& P = a.P;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int col0 = tile * TN;
  const int k0 = rank * P.kb, k1 = max(k0, min(P.K, k0 + P.kb));
  const int nst = (k1 - k0) / CH;  // the plan's slices are whole stages
  const bool pro = a.prev != nullptr;
  const int sbytes = pro ? S::BYTES_PRO : S::BYTES;
  const int tid = threadIdx.x;
  if (WQ == 4 && tid < 16) lut[tid] = a.levels[tid];

  const char* q = static_cast<const char*>(P.W);
  const char* x = static_cast<const char*>(P.x);
  auto slot = [&](int s) { return smem + (s % DEPTH) * sbytes; };
  // Stage s's codes and scales: no kernel before this one writes them.
  auto load_codes = [&](int s) {
    unsigned char* st = slot(s);
    const int kr = k0 + CH * s;
    const int br = WQ == 8 ? kr : kr / 2;  // its first stored row
    if (P.N % 16 == 0) {
      for (int c = tid; c < S::CROWS * (TN / 16); c += THREADS) {
        const int r = c / (TN / 16), e = c % (TN / 16);
        const int col = col0 + 16 * e;
        const bool ok = col < P.N;
        cp_async16(st + r * CP + 16 * e,
                   ok ? q + (size_t)(br + r) * P.N + col : q, ok);
      }
    } else {  // rows 4-byte aligned only: 4-byte copies
      for (int c = tid; c < S::CROWS * (TN / 4); c += THREADS) {
        const int r = c / (TN / 4), e = c % (TN / 4);
        const int col = col0 + 4 * e;
        const bool ok = col < P.N;
        cp_async4(st + r * CP + 4 * e,
                  ok ? q + (size_t)(br + r) * P.N + col : q, ok);
      }
    }
    for (int c = tid; c < TN / 4; c += THREADS) {
      const int col = col0 + 4 * c;
      const bool ok = col < P.N;
      cp_async16(st + S::SCALES + 16 * c,
                 ok ? P.scale + (size_t)(kr / QB) * P.N + col : P.scale, ok);
    }
  };
  // Stage s's rows of x (and of the prologue's operands), after the wait.
  auto load_x = [&](int s) {
    unsigned char* st = slot(s);
    const int kr = k0 + CH * s;
    for (int c = tid; c < RT * XC; c += THREADS) {
      const int r = c / XC, e = c % XC;
      const bool ok = r < a.rows;
      cp_async16(st + S::X + r * XP * (int)sizeof(T) + 16 * e,
                 ok ? x + ((size_t)r * P.K + kr) * sizeof(T) + 16 * e : x,
                 ok);
    }
    if (!pro) return;
    for (int c = tid; c < RT * (CH / 4); c += THREADS) {
      const int r = c / (CH / 4), e = c % (CH / 4);
      const bool ok = r < a.rows;
      cp_async16(st + S::PREV + r * PP * 4 + 16 * e,
                 ok ? a.prev + (size_t)r * P.K + kr + 4 * e : a.prev, ok);
    }
    for (int c = tid; c < XC; c += THREADS)
      cp_async16(st + S::MIX + 16 * c,
                 static_cast<const char*>(a.mix) + (size_t)kr * sizeof(T) +
                     16 * c,
                 true);
  };
  // The channel mix's token shift, in place on stage s's x (rounded to T);
  // column tile 0 writes the new shift state of the stage's rows of K.
  auto prologue = [&](int s) {
    unsigned char* st = slot(s);
    T* xs = reinterpret_cast<T*>(st + S::X);
    const float* ps = reinterpret_cast<const float*>(st + S::PREV);
    const T* ms = reinterpret_cast<const T*>(st + S::MIX);
    const int kr = k0 + CH * s;
    for (int i = tid; i < a.rows * CH; i += THREADS) {
      const int r = i / CH, k = i % CH;
      const float v = to_f(xs[r * XP + k]), pv = ps[r * PP + k];
      if (tile == 0)
        a.new_shift[(size_t)r * P.K + kr + k] = a.active[r] ? v : pv;
      xs[r * XP + k] = from_f<T>(v + (pv - v) * to_f(ms[k]));
    }
  };

  Math<T, WQ, RT> m;
  m.zero();
  for (int s = 0; s < DEPTH - 1; ++s)
    if (s < nst) load_codes(s);
  grid_wait();
  for (int s = 0; s < DEPTH - 1; ++s) {  // group s: stage s's x (group 0
    if (s < nst) load_x(s);              // also the first codes)
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<DEPTH - 2>();  // group s has landed
    __syncthreads();             // ... for every thread; slot s - 1 is free
    if (pro) {
      prologue(s);
      __syncthreads();
    }
    const int n = s + DEPTH - 1;
    if (n < nst) {
      load_codes(n);
      load_x(n);
    }
    cp_async_commit();
    const unsigned char* st = slot(s);
    m.stage(st, reinterpret_cast<const float*>(st + S::SCALES),
            reinterpret_cast<const T*>(st + S::X), lut);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the tile of sums
  float* sums = reinterpret_cast<float*>(smem);
  m.store(sums);
  if (cs > 1) {
    reduce_tile<T, TN, TP, THREADS>(P, sums, col0, a.rows);
    return;
  }
  __syncthreads();
  for (int qd = tid; qd < a.rows * (TN / 4); qd += THREADS) {
    const int b = qd / (TN / 4), c = 4 * (qd % (TN / 4));
    if (col0 + c >= P.N) continue;  // N is a multiple of 4
    const float4 v = *reinterpret_cast<const float4*>(sums + b * TP + c);
    const float s[4] = {v.x, v.y, v.z, v.w};
    EpiIn in[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) in[e] = epilogue_in<T>(P, b, col0 + c + e);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      epilogue_out<T>(P, b, col0 + c + e, s[e], in[e]);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

template <typename T, int WQ, int RT>
cudaError_t launch_rt(QArgs& a, int cs, int tiles, cudaStream_t st) {
  const void* k = (const void*)qmm_kernel<T, WQ, RT>;
  static bool sized = false;  // the largest shared memory it asks for
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Stage<T, WQ, RT>::smem(true));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  void* params[] = {&a};
  const cudaError_t e =
      launch_ex(k, dim3(tiles * cs), THREADS,
                Stage<T, WQ, RT>::smem(a.prev != nullptr), cs, true, st,
                params);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int WQ>
cudaError_t launch_t(QArgs& a, int rt, int cs, int tiles, cudaStream_t st) {
  switch (rt) {
    case 8: return launch_rt<T, WQ, 8>(a, cs, tiles, st);
    case 16: return launch_rt<T, WQ, 16>(a, cs, tiles, st);
    case 32: return launch_rt<T, WQ, 32>(a, cs, tiles, st);
    default: return launch_rt<T, WQ, 64>(a, cs, tiles, st);
  }
}

// One launch of plan row pl (r0, rows, rt, cs, tiles, kb) with a's
// product; a.P's x / y and the prologue's operands point at row 0.
cudaError_t launch(QArgs a, const int64_t* pl, bool four, int dtype,
                   size_t xsize, size_t ysize, cudaStream_t st) {
  const int r0 = (int)pl[0], rt = (int)pl[2], cs = (int)pl[3],
            tiles = (int)pl[4];
  a.rows = (int)pl[1];
  a.P.kb = (int)pl[5];
  a.P.x = (const char*)a.P.x + (size_t)r0 * a.P.K * xsize;
  a.P.y = (char*)a.P.y + (size_t)r0 * a.P.N * ysize;
  if (a.prev != nullptr) {
    a.prev += (size_t)r0 * a.P.K;
    a.active += r0;
    a.new_shift += (size_t)r0 * a.P.K;
  }
  if (dtype == 1)
    return four ? launch_t<__nv_bfloat16, 4>(a, rt, cs, tiles, st)
                : launch_t<__nv_bfloat16, 8>(a, rt, cs, tiles, st);
  return four ? launch_t<float, 4>(a, rt, cs, tiles, st)
              : launch_t<float, 8>(a, rt, cs, tiles, st);
}

bool bad_shape(int R, int K, int N, bool four, int dtype) {
  return R <= 0 || K <= 0 || N <= 0 || K % (four ? QB4 : QB8) || N % 4 ||
         (dtype != 0 && dtype != 1);
}

// The plan covers rows 0 .. R in order, each launch's row tile holds its
// rows, the tiles cover N and cs slices of whole scale blocks cover K.
bool bad_plan(const int64_t* plan, int n_launch, int R, int K, int N,
              bool four) {
  if (n_launch <= 0) return true;
  const int align = four ? QB4 : QB8;
  int64_t next = 0;
  for (int i = 0; i < n_launch; ++i) {
    const int64_t* pl = plan + (size_t)i * PLAN_Q;
    const int64_t r0 = pl[0], rows = pl[1], rt = pl[2], cs = pl[3],
                  tiles = pl[4], kb = pl[5];
    if (r0 != next || rows < 1 || rows > rt ||
        (rt != 8 && rt != 16 && rt != 32 && rt != 64) || cs < 1 ||
        cs > MAX_CLUSTER || tiles != (N + TN - 1) / TN || kb <= 0 ||
        kb % align || kb * cs < K)
      return true;
    next = r0 + rows;
  }
  return next != R;
}

// Layer l of stacked codes (K, N) - int8, or packed 4-bit - into P.
void set_weight(MMProblem& P, const void* q, const float* s, bool four,
                int l, int K, int N) {
  P.W = (const char*)q + (size_t)l * (four ? K / 2 : K) * N;
  P.scale = s + (size_t)l * (K / (four ? QB4 : QB8)) * N;
  P.K = K;
  P.N = N;
  P.ldx = K;
}

void set_levels(QArgs& a, const int32_t* levels) {
  for (int i = 0; i < 16; ++i)
    a.levels[i] = levels != nullptr ? (float)levels[i] : 0.f;
}

}  // namespace

extern "C" {

// y (R, N) = x (R, K) . dequant(q[l], s[l]), per the plan: n_launch rows of
// 6 int64 on the HOST from ops/quant_matmul.py:plan - r0 (first row), rows
// (<= rt), rt (the row tile: 8, 16, 32 or 64), cs (cluster size: the blocks
// that split a tile's K), tiles (128-column tiles, ceil(N / 128)), kb (the
// rows of K a cluster rank sums: whole scale blocks).  levels null: int8
// codes, q (L, K / 128, 128, N), s (L, K / 128, 1, N); levels 16 int32 on
// the host (what a nibble decodes to: the mode): packed 4-bit codes, q (L,
// K / 64, 32, N) uint8 (byte row i of a block: block row i in the low
// nibble, row 32 + i in the high one), s (L, K / 64, 1, N).  Unstacked
// codes are l = 0.  dtype: 0 = f32, 1 = bf16 (T, x's type); y is f32 when
// out_f32, else T.  N a multiple of 4; q, s and x 16-byte aligned.
int quant_matmul_launch(const void* x, const void* q, const float* s,
                        const int32_t* levels, int l, void* y, int R, int K,
                        int N, int dtype, int out_f32, const int64_t* plan,
                        int n_launch, void* stream) {
  const bool four = levels != nullptr;
  if (bad_shape(R, K, N, four, dtype) || l < 0 ||
      bad_plan(plan, n_launch, R, K, N, four))
    return (int)cudaErrorInvalidValue;
  const size_t tsize = dtype == 1 ? 2 : 4;
  QArgs a = {};
  set_weight(a.P, q, s, four, l, K, N);
  set_levels(a, levels);
  a.P.x = x;
  a.P.y = y;
  a.P.act = ACT_NONE;
  a.P.out = out_f32 ? OUT_F32 : OUT_T;
  for (int i = 0; i < n_launch; ++i) {
    const cudaError_t err =
        launch(a, plan + (size_t)i * PLAN_Q, four, dtype, tsize,
               out_f32 ? 4 : tsize, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The RWKV-7 channel mix at T = 1 on layer l of stacked codes:
//   fxk = round_T(xf + (shift - xf) * mix_k)
//   hk  = round_T(relu(fxk . K_l)^2)          (B, F) T, work space
//   out = hk . V_l                            (B, C) f32, not rounded
//   new_shift = where(active, xf, shift)      (B, C) f32
// xf (B, C) T; shift (B, C) f32; mix_k (C,) T; active (B,) bool; codes as
// quant_matmul_launch's (levels null: int8, key (C, F), value (F, C)).
// key_plan / val_plan: the plans of the two products (the same rows), run
// as key launch i, value launch i, ...; each launch a programmatic
// dependent of the one before.
int ffn7_t1_l_launch(const void* xf, const float* shift, const void* mix_k,
                     const uint8_t* active, const void* key_q,
                     const float* key_s, const void* val_q,
                     const float* val_s, const int32_t* levels, int l,
                     float* out, float* new_shift, void* hk, int B, int C,
                     int F, int dtype, const int64_t* key_plan,
                     const int64_t* val_plan, int n_launch, void* stream) {
  const bool four = levels != nullptr;
  if (bad_shape(B, C, F, four, dtype) || bad_shape(B, F, C, four, dtype) ||
      l < 0 || bad_plan(key_plan, n_launch, B, C, F, four) ||
      bad_plan(val_plan, n_launch, B, F, C, four))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_launch; ++i)
    if (key_plan[i * PLAN_Q] != val_plan[i * PLAN_Q] ||
        key_plan[i * PLAN_Q + 1] != val_plan[i * PLAN_Q + 1])
      return (int)cudaErrorInvalidValue;
  const size_t tsize = dtype == 1 ? 2 : 4;
  QArgs k = {}, v = {};
  set_weight(k.P, key_q, key_s, four, l, C, F);
  set_levels(k, levels);
  k.P.x = xf;
  k.P.y = hk;
  k.P.act = ACT_RELU2;
  k.P.out = OUT_T;
  k.prev = shift;
  k.mix = mix_k;
  k.active = active;
  k.new_shift = new_shift;
  set_weight(v.P, val_q, val_s, four, l, F, C);
  set_levels(v, levels);
  v.P.x = hk;
  v.P.y = out;
  v.P.act = ACT_NONE;
  v.P.out = OUT_F32;
  cudaStream_t st = (cudaStream_t)stream;
  for (int i = 0; i < n_launch; ++i) {
    cudaError_t err = launch(k, key_plan + (size_t)i * PLAN_Q, four, dtype,
                             tsize, tsize, st);
    if (err == cudaSuccess)
      err = launch(v, val_plan + (size_t)i * PLAN_Q, four, dtype, tsize, 4,
                   st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
