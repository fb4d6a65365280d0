// The products of the phased decode steps (T = 1, wide batches) for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the projection phases of
// ai00_server_tpu/ops/v7_phased_pallas.py:forward_t1 and
// ai00_server_tpu/ops/v56_phased_pallas.py:forward_t1: there the weight
// windows of a layer stream through VMEM once per step with ALL B rows
// resident, and _mono_dot (v7_phased_pallas.py:200) multiplies each window
// - the x tile and the weight cast to the activation type T, the sub-dot of
// every 128-row (int8) or 64-row (packed int4) scale block summed in f32,
// the block's scale multiplying that f32 sub-sum, then the blocks added.
// On this card the stacks (ops/v7_phased.py, ops/v56_phased.py) keep the
// launch sequence of the fused ones (v7_decode.cu, v6_decode.cu) and swap
// v7_skinny_matmul, which holds 8 batch rows and so reads every weight
// byte again for each 8 rows of a wide batch, for phased_matmul here, which
// holds up to 64 rows and reads each weight byte once for all of them.
// Its products, epilogues and descriptor table are v7_skinny_matmul's
// (matmul_common.cuh); the weights are T (bf16 or f32), int8 codes
// (K / 128, 128, N) or packed 4-bit codes (K / 64, 32, N: byte row i holds
// block row i in its low nibble and row 32 + i in its high one), each code
// block with its (1, N) f32 scales.  A 4-bit code is int4's code - 8, or
// (nf4, sf4) the code's entry of the mode's 16 integer levels in [-127,
// 127] (ops/quant.py LEVELS): the TPU's phased kernel reads those models as
// int8 surrogate codes of the same levels and scales (its quant.py
// to_int8_surrogate), so the sums are the same; here they stay packed, at
// half the bytes.
//
// What bounds it on an H100 at the shapes of the wide-batch step (B = 16 to
// 64 rows, K and N 1024 to 10240): the bytes of the weight (2 B flops per
// weight element: 128 at B = 64 against int8 codes, under the card's 295
// bf16 flops per byte) - if the products run on the tensor cores, the
// codes are decoded off the critical path and the weight streams with
// enough bytes in flight.  In bf16 (phased_tc_kernel):
//  * the weight is the A operand and the batch rows are N ("swap AB"): a
//    consumer warpgroup runs wgmma.m64nNk16 (N = the rows rounded up to 16,
//    32 or 64) on two 64-column tiles, 128 output columns; x^T is the
//    shared-memory B operand in its natural K-major layout (128-byte
//    swizzle).  A block is two consumer warpgroups, 256 columns, and one
//    producer warp;
//  * the producer keeps a ring of stages in flight (64 rows of K each: the
//    weight rows as stored, as TMA 2-D boxes of 128 bytes a row, 128-byte
//    swizzle, and the stage's x box; 5 to 12 stages, about 200 KB), one
//    mbarrier pair per stage; the weights stay in the layout the fused
//    module holds;
//  * A's register fragments come from shared memory: bf16 weights by
//    ldmatrix.trans (one instruction per 64 x 16 tile, so all three modes
//    share one wgmma form); codes as 32-bit words - four columns of one row
//    of K - decoded in registers (int8 as 128 + low 7 bits minus 128 or 256
//    by its sign bit, int4 as 128 + nibble minus 136, both exact in bf16x2
//    arithmetic; nf4 / sf4, four codes at a time, as the bf16 bytes of
//    their levels that prmt picks from a table in the kernel's parameters,
//    dec_lut), so a decoded tile never goes back to shared memory.  A
//    code word's four columns are rows of two m64 tiles, so the tiles' rows
//    are a permutation of the columns, undone when the sums are stored;
//  * the fragments are double-buffered: a k-step's decode overlaps the
//    wgmma of the one before (deeper buffers and batched k-steps measured
//    slower at 64 rows);
//  * a scale block restarts the wgmma accumulator (scale-d = 0); its f32
//    sub-sum then joins the running sum times its column's scale, blocks in
//    order;
//  * K is split over the blocks of a thread block cluster (up to 8), as far
//    as filling the card needs, in as few waves of clusters as the card
//    holds (a cluster stays in one GPC: 15 clusters of 8 at once, 39 of 3;
//    the launch plan is ops/phased_matmul.py `plan`): each block leaves its
//    partial sums in its shared memory, and after a cluster barrier each
//    block adds one share of the outputs over the cluster's blocks IN RANK
//    ORDER through distributed shared memory (explicit shared::cluster
//    loads, four columns at a time) and runs the epilogue.  The partial
//    sums never leave the SMs, and equal inputs give equal bits (no float
//    atomics);
//  * x is staged once per 256 output columns: its bytes are 2 B / (256 w)
//    of the weight's (w bytes per weight element): 0.25 bf16, 0.5 int8 and
//    1.0 int4 at B = 64, a quarter of that at B = 16.
// Measured (PERF.md, Findings): a launch pays a fixed ~5 us (the launch, the
// first loads, two cluster barriers, the epilogue), and at 64 rows a pass
// of codes costs the consumer about as much as its loads, so the 2.9B
// launches sit at 1.7-5x their bytes bound.
// In f32 (the parity models, phased_fma_kernel) the same plan's slices and
// reduction run on FMA in 128-column tiles, 32 rows of K a pass: a thread
// keeps one column of 32 rows.  Up to five products share a launch; more
// than 64 rows run as further launches.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"

using namespace decode;
namespace cg = cooperative_groups;

namespace {

constexpr int PM_ROWS = 64;      // batch rows per launch
constexpr int PM_MAXP = MM_MAXP; // products per launch
constexpr int QB8 = 128;         // rows of K per scale block: int8 codes
constexpr int QB4 = 64;          //                            packed 4-bit
// The kernels' weight kinds (WQ): plain T, int8 codes, packed int4 codes
// (code - 8), packed 4-bit codes through a level table (nf4, sf4).
constexpr int WQ_INT8 = 8, WQ_INT4 = 4, WQ_LUT = 16;
__host__ __device__ constexpr bool packed4(int wq) {
  return wq == WQ_INT4 || wq == WQ_LUT;
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed stages
// ---------------------------------------------------------------------------

constexpr int TC_BN = 256;                     // output columns per block
constexpr int TC_CONSUMERS = 256;              // two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and one producer warp
constexpr int KC = 64;                         // rows of K per stage
constexpr int TC_TP = TC_BN + 4;               // f32 pitch of the partial tile
constexpr int RING_BUDGET = 200 * 1024;
constexpr int ABUF = 2;  // A fragment buffers: k-steps a decode runs ahead

// Shared memory of a block for weight kind WQ (0 bf16, else codes) and NR
// padded rows: STAGES stages, each the weight boxes (128-byte
// rows, 128-byte swizzle: bf16 64 columns x 64 rows, codes 128 columns x 64
// rows or 32 byte rows) and the x box (NR rows x 64 of K), then the
// stages' full / empty barriers.  The partial tile takes the ring's place
// once the slice is summed.
template <int WQ, int NR>
struct TC {
  static constexpr int WBOX_COLS = WQ == 0 ? 64 : 128;
  static constexpr int WBOX_ROWS = packed4(WQ) ? KC / 2 : KC;
  static constexpr int WBOXES = TC_BN / WBOX_COLS;
  static constexpr int WBOX = WBOX_ROWS * 128;
  static constexpr int XBOX = NR * 128;
  static constexpr int STAGE = WBOXES * WBOX + XBOX;
  static constexpr int STAGES =
      RING_BUDGET / STAGE < 12 ? RING_BUDGET / STAGE : 12;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int TILE = NR * TC_TP * 4;
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;  // + alignment
  static_assert(RING >= TILE, "the partial tile must fit in the ring");
};

struct TCArgs {
  CUtensorMap wmap[PM_MAXP];  // the weights (codes) as stored, 2-D
  CUtensorMap xmap[PM_MAXP];  // x: (rows, K) with row stride ldx
  MMProblem p[PM_MAXP];
  // WQ_LUT: the bf16 bits of the 16 levels, their low bytes in lut[0 .. 3]
  // and high bytes in lut[4 .. 7], four entries a word.
  uint32_t lut[8];
  int n, rows;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// A K-major operand of 128-byte rows with the 128-byte swizzle (TMA's):
// 8-row groups 1024 bytes apart; a k-step of 16 bf16 advances the start
// address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving an accumulator across the asynchronous
// wgmma that owns it.
template <int M>
__device__ __forceinline__ void pin(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PM_F8(d, o)                                                        \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),             \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// D (64 x N, f32) (+)= A (64 x 16, bf16 registers) x B (16 x N, bf16 in
// shared memory, K-major, descriptor b); scale_d = 0 starts a new sum.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : PM_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : PM_F8(d, 0), PM_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : PM_F8(d, 0), PM_F8(d, 8), PM_F8(d, 16), PM_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// Bytes X and X + 1 (X even) of code words a (row k) and b (row k + 1) as
// [a.X, b.X, a.X+1, b.X+1]: four codes, two A fragment words once decoded.
template <int X>
__device__ __forceinline__ uint32_t quad(uint32_t a, uint32_t b) {
  return prmt(a, b, X | (4 + X) << 4 | (X + 1) << 8 | (5 + X) << 12);
}
// The low (or, HI, high) nibbles c0 .. c3 of q's bytes through the level
// table -> w0 = bf16x2 (level c0, level c1), w1 = (level c2, level c3),
// exact.  The low 3 bits of the four codes are gathered into prmt's four
// selectors (in the order c0, c2, c1, c3), four prmt take the bf16 low and
// high bytes of entries 0-7 and of entries 8-15, a fifth spreads each
// code's bit 3 over its byte (prmt's sign-replicate mode, the nibble's top
// bit at its byte's top), two lop3 pick, and two prmt interleave the
// bytes into the words.  lut: lut[0 .. 3] the low bytes, lut[4 .. 7] the
// high bytes, entries 4 i .. 4 i + 3 in word i.
template <bool HI>
__device__ __forceinline__ void dec_lut(uint32_t q, const uint32_t (&lut)[8],
                                        uint32_t& w0, uint32_t& w1) {
  const uint32_t x = (HI ? q >> 4 : q) & 0x07070707u;
  const uint32_t sel = x | (x >> 12);
  const uint32_t m = prmt(HI ? q : q << 4, 0u, 0xB9A8u);
  const uint32_t lo =
      (prmt(lut[0], lut[1], sel) & ~m) | (prmt(lut[2], lut[3], sel) & m);
  const uint32_t hi =
      (prmt(lut[4], lut[5], sel) & ~m) | (prmt(lut[6], lut[7], sel) & m);
  w0 = prmt(lo, hi, 0x6240u);
  w1 = prmt(lo, hi, 0x7351u);
}

template <typename T, int WQ, int NR>
__global__ void __launch_bounds__(TC_THREADS, 1)
phased_tc_kernel(const __grid_constant__ TCArgs args) {
  using G = TC<WQ, NR>;
  constexpr bool Q = WQ != 0, Q4 = packed4(WQ);
  constexpr int ND = NR / 2;  // accumulator floats per m64 tile
  extern __shared__ unsigned char tc_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::RING);
  uint64_t* empty = full + G::STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;  // the cluster: one tile of a product
  int pi = 0;
  while (pi + 1 < args.n && cid >= args.p[pi + 1].blk0) ++pi;
  const MMProblem P = args.p[pi];  // in registers (see reduce_tile)
  const int col0 = (cid - P.blk0) * TC_BN;
  const int k0 = rank * P.kb, k1 = min(P.K, k0 + P.kb);
  const int passes = k1 > k0 ? (k1 - k0 + KC - 1) / KC : 0;
  const int tid = threadIdx.x;
  float* tile = reinterpret_cast<float*>(smem);  // [row][TC_TP]

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // The producer: one thread keeps the ring full.
    if (tid == TC_CONSUMERS) {
      const CUtensorMap* wm = &args.wmap[pi];
      const CUtensorMap* xm = &args.xmap[pi];
#pragma unroll 1
      for (int pass = 0; pass < passes; ++pass) {
        const int s = pass % G::STAGES;
        if (pass >= G::STAGES) mbar_wait(empty + s, (pass / G::STAGES - 1) & 1);
        mbar_expect_tx(full + s, G::STAGE);
        unsigned char* st = smem + s * G::STAGE;
        const int kc = k0 + pass * KC;
#pragma unroll
        for (int b = 0; b < G::WBOXES; ++b)
          tma_load(st + b * G::WBOX, wm, col0 + b * G::WBOX_COLS,
                   Q4 ? kc / 2 : kc, full + s);
        tma_load(st + G::WBOXES * G::WBOX, xm, kc, 0, full + s);
      }
    }
  } else {
    const int g = tid >> 7;  // the consumer warpgroup: columns 128 g ..
    const int w = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    // The warpgroup's columns hold something (uniform over it).
    const bool live = col0 + g * 128 < P.N;
    // Output column of accumulator row lo / hi (+8) of m64 tile mt.
    auto col_of = [&](int mt, int hi) {
      return Q ? g * 128 + 32 * w + 4 * gq + 2 * mt + hi
               : g * 128 + 64 * mt + 16 * w + gq + 8 * hi;
    };
    float acc[2][ND], sub[2][ND];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[mt][i] = sub[mt][i] = 0.f;
    // [buffer][m64 tile][fragment register]: a k-step's decode waits only
    // for the wgmma ABUF k-steps back.
    uint32_t afr[ABUF][2][4];
    int first = 1;          // the next wgmma starts a new sum
    // WQ_LUT: the level table, read where the decode needs it (kernel
    // parameters: operands of the prmt, no registers held).
    const uint32_t (&lut)[8] = args.lut;

    // One k-step: the fragments in buffer `buf`, x rows kx .. kx + 15 of
    // the stage.  Before the k-step at position `pos` of a pass writes its
    // buffer, the ABUF - 1 k-steps after that buffer's last use stay in
    // flight; from position ABUF - 1 on, all of the previous pass's wgmmas
    // are done and its stage goes back to the producer.
    auto mma = [&](int buf, uint64_t xd, int kx) {
      wgmma_fence();
      const uint64_t b = xd + (uint64_t)((kx * 2) >> 4);
      if constexpr (Q) {
        pin(sub[0]);
        pin(sub[1]);
        wgmma_rs<NR>(sub[0], afr[buf][0], b, !first);
        wgmma_rs<NR>(sub[1], afr[buf][1], b, !first);
        pin(sub[0]);
        pin(sub[1]);
      } else {
        pin(acc[0]);
        pin(acc[1]);
        wgmma_rs<NR>(acc[0], afr[buf][0], b, !first);
        wgmma_rs<NR>(acc[1], afr[buf][1], b, !first);
        pin(acc[0]);
        pin(acc[1]);
      }
      wgmma_commit();
      first = 0;
    };
    // The stage of the pass before `pass` back to the producer, one arrival
    // a warp.
    auto release = [&](int pass) {
      if (pass > 0 && lane == 0) mbar_arrive(empty + (pass - 1) % G::STAGES);
    };
    auto step_wait = [&](int pass, int pos) {
      wgmma_wait<ABUF - 1>();
      if (pos == ABUF - 1) release(pass);
    };

#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      const int s = pass % G::STAGES;
      const int kc = k0 + pass * KC;
      unsigned char* st = smem + s * G::STAGE;
      const uint64_t xd = sw128_desc(st + G::WBOXES * G::WBOX);
      // This pass ends a scale block: its scales, loaded early.
      const bool ends = Q && (Q4 || ((kc - k0) / KC) % 2 == 1 ||
                              kc + KC >= k1);
      float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      if (ends && live) {
        const int j = kc / (Q4 ? QB4 : QB8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int c = col0 + col_of(mt, hi);
            sc[mt][hi] = c < P.N ? __ldg(P.scale + (size_t)j * P.N + c) : 0.f;
          }
      }
      mbar_wait(full + s, (pass / G::STAGES) & 1);
      if (live) {
        const uint32_t wb = smem_u32(st + (Q ? g : 2 * g) * G::WBOX);
        if constexpr (!Q) {
          // ldmatrix.trans: lane l addresses row (l & 7) of matrix l >> 3
          // (m 0-7 / 8-15 by l >> 3 & 1, k 0-7 / 8-15 by l >> 4).
          const int r = lane & 7, mi = (lane >> 3) & 1, ki = lane >> 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            step_wait(pass, j);
            const int k = 16 * j + 8 * ki + r;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4_trans(afr[j % ABUF][mt],
                            wb + mt * G::WBOX + k * 128 +
                                (((2 * w + mi) ^ r) << 4));
            mma(j % ABUF, xd, 16 * j);
          }
        } else if constexpr (!Q4) {
          // int8: rows 16 j + 2 tq, + 1, + 8, + 9; this thread's four
          // columns 32 w + 4 gq .. + 3 of the warpgroup's box.
          const int ch = 2 * w + (gq >> 2), off = 4 * (gq & 3);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t wd[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 16 * j + 2 * tq + (e & 1) + 8 * (e >> 1);
              wd[e] = lds32(wb + k * 128 + ((ch ^ (k & 7)) << 4) + off);
            }
            step_wait(pass, j);
            uint32_t (&a)[2][4] = afr[j % ABUF];
            a[0][0] = dec8(pair<0>(wd[0], wd[1]));
            a[0][1] = dec8(pair<1>(wd[0], wd[1]));
            a[0][2] = dec8(pair<0>(wd[2], wd[3]));
            a[0][3] = dec8(pair<1>(wd[2], wd[3]));
            a[1][0] = dec8(pair<2>(wd[0], wd[1]));
            a[1][1] = dec8(pair<3>(wd[0], wd[1]));
            a[1][2] = dec8(pair<2>(wd[2], wd[3]));
            a[1][3] = dec8(pair<3>(wd[2], wd[3]));
            mma(j % ABUF, xd, 16 * j);
          }
        } else if constexpr (WQ == WQ_LUT) {
          // nf4 / sf4: the byte rows of int4's layout, four codes of two
          // rows a quad (q[i][j]: words 2 i, 2 i + 1, bytes 2 j, 2 j + 1:
          // fragment words (j, 2 i) and (j, 2 i + 1)).
          const int ch = 2 * w + (gq >> 2), off = 4 * (gq & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t wd[4], q[2][2];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 16 * h + 2 * tq + (e & 1) + 8 * (e >> 1);
              wd[e] = lds32(wb + k * 128 + ((ch ^ (k & 7)) << 4) + off);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              q[i][0] = quad<0>(wd[2 * i], wd[2 * i + 1]);
              q[i][1] = quad<2>(wd[2 * i], wd[2 * i + 1]);
            }
            // Issued in the order k-step 0, 2, 1, 3: positions 2 h, 2 h + 1.
            step_wait(pass, 2 * h);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                dec_lut<false>(q[i][j], lut, afr[(2 * h) % ABUF][j][2 * i],
                               afr[(2 * h) % ABUF][j][2 * i + 1]);
            mma((2 * h) % ABUF, xd, 16 * h);
            step_wait(pass, 2 * h + 1);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                dec_lut<true>(q[i][j], lut,
                              afr[(2 * h + 1) % ABUF][j][2 * i],
                              afr[(2 * h + 1) % ABUF][j][2 * i + 1]);
            mma((2 * h + 1) % ABUF, xd, 32 + 16 * h);
          }
        } else {
          // int4: byte rows 16 h + 2 tq, + 1, + 8, + 9 hold K rows 16 h ..
          // (low nibbles: k-step h) and 32 + 16 h .. (high: k-step h + 2).
          const int ch = 2 * w + (gq >> 2), off = 4 * (gq & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t wd[4], t[2][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 16 * h + 2 * tq + (e & 1) + 8 * (e >> 1);
              wd[e] = lds32(wb + k * 128 + ((ch ^ (k & 7)) << 4) + off);
            }
            t[0][0] = pair<0>(wd[0], wd[1]);
            t[0][1] = pair<1>(wd[0], wd[1]);
            t[0][2] = pair<0>(wd[2], wd[3]);
            t[0][3] = pair<1>(wd[2], wd[3]);
            t[1][0] = pair<2>(wd[0], wd[1]);
            t[1][1] = pair<3>(wd[0], wd[1]);
            t[1][2] = pair<2>(wd[2], wd[3]);
            t[1][3] = pair<3>(wd[2], wd[3]);
            // Issued in the order k-step 0, 2, 1, 3: positions 2 h, 2 h + 1.
            step_wait(pass, 2 * h);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                afr[(2 * h) % ABUF][mt][e] = dec4<false>(t[mt][e]);
            mma((2 * h) % ABUF, xd, 16 * h);
            step_wait(pass, 2 * h + 1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                afr[(2 * h + 1) % ABUF][mt][e] = dec4<true>(t[mt][e]);
            mma((2 * h + 1) % ABUF, xd, 32 + 16 * h);
          }
        }
        if constexpr (Q) {
          if (ends) {
            // The block's f32 sub-sums times their columns' scales join
            // the running sums.
            wgmma_wait<0>();
            pin(sub[0]);
            pin(sub[1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int i = 0; i < ND; ++i)
                acc[mt][i] += sub[mt][i] * sc[mt][(i >> 1) & 1];
            first = 1;
          }
        }
      } else {
        release(pass);
      }
    }
    wgmma_wait<0>();
    pin(acc[0]);
    pin(acc[1]);
    // Both warpgroups are done with the ring: the partial tile takes its
    // place.
    asm volatile("bar.sync 1, %0;\n" ::"n"(TC_CONSUMERS) : "memory");
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int b = 8 * (i >> 2) + 2 * tq + (i & 1);
        tile[b * TC_TP + col_of(mt, (i >> 1) & 1)] = acc[mt][i];
      }
  }

  reduce_tile<T, TC_BN, TC_TP, TC_THREADS>(P, tile, col0, args.rows);
}

// ---------------------------------------------------------------------------
// f32: FMA (the parity models)
// ---------------------------------------------------------------------------

constexpr int PM_THREADS = 256;  // eight warps
constexpr int PM_BN = 128;       // output columns per block
constexpr int KC32 = 32;         // rows of K per pass
constexpr int TLD = PM_BN + 4;   // f32 pitch of the partial-sum tile
constexpr int TILE_BYTES = PM_ROWS * TLD * 4;
constexpr int LD32 = PM_ROWS + 4;  // f32 pitch of the staged x, [k][row]
constexpr int FMA_SMEM = KC32 * LD32 * 4 + KC32 * PM_BN * 4 > TILE_BYTES
                             ? KC32 * LD32 * 4 + KC32 * PM_BN * 4
                             : TILE_BYTES;

struct PMGroup {
  MMProblem p[PM_MAXP];  // blk0: first cluster (tile) of the product;
  int n;                 // kb: rows of K a cluster rank sums
  float levels[16];      // WQ_LUT: what a nibble decodes to
};

// One slice [k0, k1) of K for the PM_BN columns from col0: thread t sums
// column t % 128 of the tile for rows 32 (t / 128) .. + 31, 32 rows of K a
// pass, the next pass's weight words in registers while this one is
// summed; the slice's sums go to `tile` ([row][TLD] f32, in `smem`).
// WQ_LUT codes decode through `lut` (16 floats in shared memory).
template <int WQ>
__device__ __forceinline__ void fma_slice(const MMProblem& P, int k0, int k1,
                                          int col0, int rows,
                                          unsigned char* smem, float* tile,
                                          const float* lut) {
  constexpr bool Q = WQ != 0, Q4 = packed4(WQ);
  constexpr int QB = Q4 ? QB4 : QB8;
  float (*xs)[LD32] = reinterpret_cast<float (*)[LD32]>(smem);  // [k][row]
  float (*ws)[PM_BN] =
      reinterpret_cast<float (*)[PM_BN]>(smem + KC32 * LD32 * 4);  // [k][col]
  const int tid = threadIdx.x;
  const int cl = tid % PM_BN, r0 = 32 * (tid / PM_BN);

  // A pass is 32 stored rows: rows of K, or the 32 byte rows of a 4-bit
  // block whose low (first pass of the block) or high nibbles it takes.
  constexpr int WPR = Q ? PM_BN / 4 : PM_BN;  // words per stored row
  constexpr int UNITS = KC32 * WPR / PM_THREADS;
  const size_t pitch = Q ? (size_t)P.N : (size_t)P.N * 4;
  const char* Wb = static_cast<const char*>(P.W);
  uint32_t raw[UNITS];
  auto load = [&](int kc0) {
    const int sr0 = Q4 ? kc0 / QB4 * (QB4 / 2) : kc0;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int unit = tid + u * PM_THREADS;
      const int r = unit / WPR, w = unit % WPR;
      const int c = col0 + w * (Q ? 4 : 1);
      const bool ok = c < P.N && (Q4 || kc0 + r < k1);
      raw[u] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
                        Wb + (size_t)(sr0 + r) * pitch +
                        (size_t)c * (Q ? 1 : 4)))
                  : 0u;
    }
  };
  auto store = [&](int kc0) {
    const int shift = 4 * ((kc0 / KC32) & 1);  // 4-bit: low or high nibbles
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int unit = tid + u * PM_THREADS;
      const int r = unit / WPR, w = unit % WPR;
      if constexpr (!Q) {
        ws[r][w] = __uint_as_float(raw[u]);
      } else if constexpr (!Q4) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ws[r][4 * w + e] =
              (float)static_cast<int8_t>((raw[u] >> (8 * e)) & 0xffu);
      } else {
        const bool ok = col0 + 4 * w < P.N;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (int)((raw[u] >> (8 * e + shift)) & 15u);
          ws[r][4 * w + e] =
              !ok ? 0.f : WQ == WQ_LUT ? lut[c] : (float)(c - 8);
        }
      }
    }
  };
  auto stage_x = [&](int kc0) {
    const int kv = min(KC32, k1 - kc0);
    const float* x = static_cast<const float*>(P.x);
#pragma unroll
    for (int u = 0; u < PM_ROWS * KC32 / 4 / PM_THREADS; ++u) {
      const int unit = tid + u * PM_THREADS;
      const int m = unit / (KC32 / 4), q = unit % (KC32 / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < rows && 4 * q < kv)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)m * P.ldx +
                                                  kc0 + 4 * q));
      xs[4 * q][m] = v.x;
      xs[4 * q + 1][m] = v.y;
      xs[4 * q + 2][m] = v.z;
      xs[4 * q + 3][m] = v.w;
    }
  };

  float acc[32], sub[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sub[i] = 0.f;
  const bool busy = r0 < rows;  // uniform over the warp
  const int c = col0 + cl;
  const int passes = k1 > k0 ? (k1 - k0 + KC32 - 1) / KC32 : 0;
  if (passes > 0) load(k0);
  for (int pass = 0; pass < passes; ++pass) {
    const int kc0 = k0 + pass * KC32;
    __syncthreads();
    store(kc0);
    stage_x(kc0);
    __syncthreads();
    if (pass + 1 < passes) load(kc0 + KC32);
    if (busy) {
#pragma unroll 4
      for (int kk = 0; kk < KC32; ++kk) {
        const float w = ws[kk][cl];
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][r0 + i]);
          sub[i] = fmaf(xv.x, w, sub[i]);
          sub[i + 1] = fmaf(xv.y, w, sub[i + 1]);
          sub[i + 2] = fmaf(xv.z, w, sub[i + 2]);
          sub[i + 3] = fmaf(xv.w, w, sub[i + 3]);
        }
      }
    }
    const int kend = min(k1, kc0 + KC32);
    if (Q ? (kend - k0) % QB == 0 || kend == k1 : kend == k1) {
      const int j = (kend - 1) / QB;
      const float s =
          !Q ? 1.f : (c < P.N ? __ldg(P.scale + (size_t)j * P.N + c) : 0.f);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[i] += sub[i] * s;
        sub[i] = 0.f;
      }
    }
  }
  __syncthreads();  // the staging is free: the tile takes its place
#pragma unroll
  for (int i = 0; i < 32; ++i) tile[(r0 + i) * TLD + cl] = acc[i];
}

template <int WQ>
__global__ void __launch_bounds__(PM_THREADS, 2)
phased_fma_kernel(const PMGroup g, int rows) {
  extern __shared__ __align__(16) unsigned char pm_smem[];
  __shared__ float lut[16];  // WQ_LUT; read after fma_slice's first barrier
  if (WQ == WQ_LUT && threadIdx.x < 16)
    lut[threadIdx.x] = g.levels[threadIdx.x];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;  // the cluster: one tile of a product
  int pi = 0;
  while (pi + 1 < g.n && cid >= g.p[pi + 1].blk0) ++pi;
  const MMProblem P = g.p[pi];
  const int col0 = (cid - P.blk0) * PM_BN;
  const int k0 = rank * P.kb, k1 = min(P.K, k0 + P.kb);
  float* tile = reinterpret_cast<float*>(pm_smem);  // [row][TLD]

  fma_slice<WQ>(P, k0, k1, col0, rows, pm_smem, tile, lut);

  reduce_tile<float, PM_BN, TLD, PM_THREADS>(P, tile, col0, rows);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The opt-in above 48 KB of shared memory, once per kernel.
cudaError_t size_once(const void* kernel, int smem, bool& sized) {
  if (sized) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) sized = true;
  return e;
}

template <int WQ>
cudaError_t launch_fma(const PMGroup& g, int rows, int blocks, int cs,
                       cudaStream_t st) {
  static bool sized = false;
  const void* k = (const void*)phased_fma_kernel<WQ>;
  cudaError_t e = size_once(k, FMA_SMEM, sized);
  if (e != cudaSuccess) return e;
  PMGroup gc = g;
  int r = rows;
  void* params[] = {&gc, &r};
  return launch_ex(k, dim3(blocks), PM_THREADS, FMA_SMEM, cs, false, st,
                   params);
}

// The bf16 kernel for weight kind WQ and NR padded rows, its shared
// memory, sized once.
template <int WQ, int NR>
cudaError_t tc_kernel(const void** k, int* smem) {
  static bool sized = false;
  *k = (const void*)phased_tc_kernel<__nv_bfloat16, WQ, NR>;
  *smem = TC<WQ, NR>::SMEM;
  return size_once(*k, *smem, sized);
}

template <int WQ>
cudaError_t tc_kernel_rows(int rows, const void** k, int* smem) {
  if (rows <= 16) return tc_kernel<WQ, 16>(k, smem);
  if (rows <= 32) return tc_kernel<WQ, 32>(k, smem);
  return tc_kernel<WQ, 64>(k, smem);
}

cudaError_t tc_kernel_for(int wq, int rows, const void** k, int* smem) {
  if (wq == WQ_LUT) return tc_kernel_rows<WQ_LUT>(rows, k, smem);
  if (wq == WQ_INT4) return tc_kernel_rows<WQ_INT4>(rows, k, smem);
  if (wq == WQ_INT8) return tc_kernel_rows<WQ_INT8>(rows, k, smem);
  return tc_kernel_rows<0>(rows, k, smem);
}

// cuTensorMapEncodeTiled from libcuda, which the process has already loaded.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 2-D map of `rows` rows of `cols` elements, `pitch` bytes apart, read
// in boxes of box_cols x box_rows with the 128-byte swizzle; elements out
// of bounds read as zeros.
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
            uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// desc: n_prob rows of the descriptor table on the HOST (parse_problem,
// matmul_common.cuh).  plan: n_launch rows of PLAN_COLS int64 on the HOST,
// one per launch, from ops/phased_matmul.py `plan`: b0 (first batch row),
// rows (at most 64), cs (cluster size: the blocks that split a tile's K),
// clusters (the launch's tiles: 256 columns in bf16, 128 in f32), then per
// product blk0 (its first tile) and kb (the rows of K a cluster rank sums,
// whole scale blocks).  dtype: 0 = f32, 1 = bf16.  wbits: 0 plain weights
// of type T, 8 int8 codes (K / 128, 128, N), 4 packed 4-bit codes (K / 64,
// 32, N), every product with its scales.  levels: null for plain weights,
// int8 codes and int4 codes (code - 8); for nf4 / sf4 codes (wbits 4) the
// mode's 16 levels as int32 on the HOST, each in [-128, 127] (what a
// nibble decodes to).  W and x 16-byte aligned; N a multiple of 16; K and
// ldx multiples of 8.  No work space: the partial sums stay in the
// clusters' shared memory.
int phased_matmul_launch(const int64_t* desc, int n_prob, const int64_t* plan,
                         int n_launch, int dtype, int wbits,
                         const int32_t* levels, void* stream) {
  if (n_prob <= 0 || n_prob > PM_MAXP || n_launch <= 0 ||
      (dtype != 0 && dtype != 1) ||
      (wbits != 0 && wbits != 8 && wbits != 4) ||
      (levels != nullptr && wbits != 4))
    return (int)cudaErrorInvalidValue;
  const int wq = levels != nullptr ? WQ_LUT : wbits;
  // The bf16 bits of each level (exact: at most 8 significant bits), low
  // bytes in lut[0 .. 3], high bytes in lut[4 .. 7].
  uint32_t lut[8] = {};
  float lutf[16] = {};
  for (int i = 0; levels != nullptr && i < 16; ++i) {
    if (levels[i] < -128 || levels[i] > 127) return (int)cudaErrorInvalidValue;
    lutf[i] = (float)levels[i];
    uint32_t bits;
    memcpy(&bits, &lutf[i], 4);
    lut[i / 4] |= ((bits >> 16) & 0xffu) << (8 * (i % 4));
    lut[4 + i / 4] |= (bits >> 24) << (8 * (i % 4));
  }
  const bool tc = dtype == 1;
  const size_t tsize = tc ? 2 : 4;
  const bool quant = wbits != 0;
  const int qblock = wbits == 4 ? QB4 : QB8;
  const int cpt = quant ? 4 : 4 / (int)tsize;  // columns per 32-bit word
  const int step = wbits == 8 ? QB8 : KC;       // kb: a multiple of this
  const int bn = tc ? TC_BN : PM_BN;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = 0; l < n_launch; ++l) {
    const int64_t* pl = plan + (size_t)l * PLAN_COLS;
    const int b0 = (int)pl[0], rows = (int)pl[1], cs = (int)pl[2],
              clusters = (int)pl[3];
    if (b0 < 0 || rows <= 0 || rows > PM_ROWS || cs < 1 ||
        cs > MAX_CLUSTER || clusters < 1)
      return (int)cudaErrorInvalidValue;
    TCArgs a;
    PMGroup g;
    a.n = g.n = n_prob;
    a.rows = rows;
    for (int i = 0; i < 8; ++i) a.lut[i] = lut[i];
    for (int i = 0; i < 16; ++i) g.levels[i] = lutf[i];
    int tiles = 0;
    for (int i = 0; i < n_prob; ++i) {
      MMProblem& P = g.p[i];
      if (!parse_problem(desc + 12 * i, b0, tsize, quant, qblock, cpt, P) ||
          P.N % 16 || P.K % 8 || P.ldx % 8)
        return (int)cudaErrorInvalidValue;
      P.blk0 = (int)pl[4 + 2 * i];
      P.kb = (int)pl[5 + 2 * i];
      // The plan covers the product: its tiles follow the previous ones,
      // and cs slices of kb rows (whole steps) cover K.
      if (P.blk0 != tiles || P.kb <= 0 || P.kb % step ||
          (int64_t)P.kb * cs < P.K)
        return (int)cudaErrorInvalidValue;
      tiles += (P.N + bn - 1) / bn;
      a.p[i] = P;
      if (tc) {
        const bool ok =
            encode(&a.xmap[i], P.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, P.K,
                   rows, (uint64_t)P.ldx * 2, 64, rows <= 16   ? 16
                                                  : rows <= 32 ? 32
                                                               : 64) &&
            (wbits == 0
                 ? encode(&a.wmap[i], P.W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          P.N, P.K, (uint64_t)P.N * 2, 64, KC)
                 : encode(&a.wmap[i], P.W, CU_TENSOR_MAP_DATA_TYPE_UINT8, P.N,
                          wbits == 4 ? P.K / 2 : P.K, P.N, 128,
                          wbits == 4 ? KC / 2 : KC));
        if (!ok) return (int)cudaErrorInvalidValue;
      }
    }
    if (tiles != clusters) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    const int blocks = clusters * cs;
    if (tc) {
      const void* k;
      int smem;
      err = tc_kernel_for(wq, rows, &k, &smem);
      void* params[] = {&a};
      if (err == cudaSuccess)
        err = launch_ex(k, dim3(blocks), TC_THREADS, smem, cs, false, st,
                        params);
    } else if (wq == WQ_LUT)
      err = launch_fma<WQ_LUT>(g, rows, blocks, cs, st);
    else if (wq == WQ_INT4)
      err = launch_fma<WQ_INT4>(g, rows, blocks, cs, st);
    else if (wq == WQ_INT8)
      err = launch_fma<WQ_INT8>(g, rows, blocks, cs, st);
    else
      err = launch_fma<0>(g, rows, blocks, cs, st);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// How many clusters of cs blocks of the bf16 kernel for `wq` codes and
// `rows` rows the card holds at once (ops/phased_matmul.py plans with it);
// a negative cudaError_t on failure.  wq: 0 plain, 8 int8, 4 int4, 16 the
// level-table kernel (nf4 / sf4), so each kind is asked of its own kernel.
int phased_max_clusters(int wq, int rows, int cs) {
  if ((wq != 0 && wq != WQ_INT8 && wq != WQ_INT4 && wq != WQ_LUT) ||
      rows <= 0 || cs < 1 || cs > MAX_CLUSTER)
    return -(int)cudaErrorInvalidValue;
  const void* k;
  int smem;
  cudaError_t e = tc_kernel_for(wq, rows, &k, &smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * MAX_CLUSTER, 1, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
