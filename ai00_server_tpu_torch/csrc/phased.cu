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
// (K / 128, 128, N) or packed int4 codes (K / 64, 32, N: byte row i holds
// block row i in its low nibble and row 32 + i in its high one, the value
// code - 8), each code block with its (1, N) f32 scales.
//
// What bounds it on an H100 at the shapes of the wide-batch step (B = 16 to
// 64 rows, K and N 1024 to 10240): the bytes of the weight, at 2 B flops per
// weight element (128 at B = 64 against int8 codes, under the card's 295
// bf16 flops per byte), if the products run on the tensor cores and the
// weight streams with enough bytes in flight.  In bf16:
//  * a block owns 128 output columns and a slice of K; its eight warps each
//    take 16 columns for all rows with mma.sync.m16n8k16 (bf16 in, f32
//    sums: int8 codes and code - 8 are exact in bf16, so the tensor core
//    computes the TPU kernel's sub-dots), up to four 16-row tiles, the
//    fragments read with ldmatrix (the weight's with .trans, so it stays in
//    its (k, n) order);
//  * a pass is 64 rows of K: cp.async copies the pass's weight rows as
//    stored and the 64 x rows into a ring of four stages, three passes
//    ahead, so the loads never wait on the arithmetic; codes are converted
//    to a bf16 tile once per pass (rows padded by 16 bytes: no bank
//    conflicts in the stores or in ldmatrix);
//  * a scale block's sums stay apart until it ends and are then scaled and
//    added, in block order;
//  * K is split over the blocks of a thread block cluster (up to 8, chosen
//    so that a launch has about two blocks per SM): each block leaves its
//    partial sums in its shared memory, and after a cluster barrier each
//    block adds one share of the outputs over the cluster's blocks IN
//    RANK ORDER through distributed shared memory and runs the epilogue.
//    The partial sums never leave the SMs, and equal inputs give equal
//    bits (no float atomics).
// In f32 (the parity models) the same slices and reduction run on FMA,
// 32 rows of K a pass: a thread keeps one column of 32 rows.  Up to five
// products share a launch; more than 64 rows run as further launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"

using namespace decode;
namespace cg = cooperative_groups;

namespace {

constexpr int PM_ROWS = 64;      // batch rows per launch: four 16-row tiles
constexpr int PM_THREADS = 256;  // eight warps
constexpr int PM_BN = 128;       // output columns per block, 16 a warp
constexpr int PM_MAXP = 5;       // products per launch
constexpr int MAX_CLUSTER = 8;   // blocks that split one tile's K
constexpr int FILL = 264;        // blocks a launch aims for: two per SM
constexpr int QB8 = 128;         // rows of K per scale block: int8 codes
constexpr int QB4 = 64;          //                            packed int4
constexpr int KC16 = 64;         // rows of K per pass: bf16 (4 mma steps)
constexpr int KC32 = 32;         //                     f32
constexpr int STAGES = 4;        // bf16: passes in the cp.async ring
constexpr int XLD = KC16 + 8;    // bf16 pitch of a staged x row (144 B)
constexpr int WLD = PM_BN + 8;   // bf16 pitch of a staged weight row (272 B)
constexpr int TLD = PM_BN + 4;   // f32 pitch of the partial-sum tile
constexpr int TILE_BYTES = PM_ROWS * TLD * 4;
constexpr int LD32 = PM_ROWS + 4;  // f32 pitch of the staged x, [k][row]

struct PMGroup {
  MMProblem p[PM_MAXP];  // blk0: first cluster (tile) of the product;
  int n;                 // ksplit: the cluster's size; kb: its slices
};

// Shared memory of a bf16 block, per weight kind WQ (0 plain, 8 int8, 4
// packed int4): a ring of STAGES passes, each the weight rows as stored
// (bf16 rows padded to WLD, read by ldmatrix in place; code rows as they
// come) and the x rows, then the bf16 tile the codes are converted into.
template <int WQ>
struct Ring {
  static constexpr int RAW_ROWS = WQ == 4 ? KC16 / 2 : KC16;
  static constexpr int RAW_PITCH = WQ == 0 ? WLD * 2 : PM_BN;
  static constexpr int RAW = RAW_ROWS * RAW_PITCH;
  static constexpr int X = PM_ROWS * XLD * 2;
  static constexpr int STAGE = RAW + X;
  static constexpr int WSB = WQ == 0 ? 0 : KC16 * WLD * 2;
  static constexpr int RING = STAGES * STAGE + WSB;
  static constexpr int BYTES = RING > TILE_BYTES ? RING : TILE_BYTES;
};

template <typename T, int WQ>
constexpr int smem_bytes() {
  if constexpr (sizeof(T) == 2) {
    return Ring<WQ>::BYTES;
  } else {
    constexpr int stage = KC32 * LD32 * 4 + KC32 * PM_BN * 4;
    return stage > TILE_BYTES ? stage : TILE_BYTES;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p,
                                        bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One slice [k0, k1) of K for the PM_BN columns from col0, bf16, on the
// tensor cores; the slice's sums go to `tile` ([row][TLD] f32, in `smem`,
// which the ring occupies until then).
template <int WQ>
__device__ __forceinline__ void mma_slice(const MMProblem& P, int k0, int k1,
                                          int col0, int rows,
                                          unsigned char* smem, float* tile) {
  using R = Ring<WQ>;
  constexpr bool Q = WQ != 0, Q4 = WQ == 4;
  constexpr int QB = Q4 ? QB4 : QB8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' row / pair
  const int mtiles = (rows + 15) / 16;
  const int passes = k1 > k0 ? (k1 - k0 + KC16 - 1) / KC16 : 0;
  const size_t pitch = Q ? (size_t)P.N : (size_t)P.N * 2;  // bytes a row
  const char* Wb = static_cast<const char*>(P.W);
  const char* xb = static_cast<const char*>(P.x);
  __nv_bfloat16* wsb =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * R::STAGE);

  // Copy pass `pass` into its stage; every thread commits one group per
  // call, a pass past the slice an empty one.  A chunk is 16 bytes: 8
  // bf16 columns or 16 codes of a stored row, 8 values of an x row.  The
  // rows of a slice come in eights and N in sixteens, so a chunk is in or
  // out as a whole; an out chunk is zeros.
  auto issue = [&](int pass) {
    if (pass < passes) {
      const int kc0 = k0 + pass * KC16;
      unsigned char* st = smem + (pass % STAGES) * R::STAGE;
      constexpr int CPR = (Q ? PM_BN : PM_BN * 2) / 16;  // chunks a row
      const int sr0 = Q4 ? kc0 / 2 : kc0;
      for (int u = tid; u < R::RAW_ROWS * CPR; u += PM_THREADS) {
        const int r = u / CPR, q = u % CPR;
        const int c = col0 + q * (Q ? 16 : 8);
        const bool ok = c < P.N && (Q4 || kc0 + r < k1);
        cp16(st + r * R::RAW_PITCH + q * 16,
             ok ? Wb + (size_t)(sr0 + r) * pitch + (size_t)c * (Q ? 1 : 2)
                : Wb,
             ok);
      }
      for (int u = tid; u < PM_ROWS * (KC16 / 8); u += PM_THREADS) {
        const int m = u / (KC16 / 8), q = u % (KC16 / 8);
        const bool ok = m < rows && kc0 + 8 * q < k1;
        cp16(st + R::RAW + (m * XLD + 8 * q) * 2,
             ok ? xb + ((size_t)m * P.ldx + kc0 + 8 * q) * 2 : xb, ok);
      }
    }
    cp_commit();
  };
  // Codes of a stage -> the bf16 tile [k][WLD]: a thread converts 4 codes
  // (one 32-bit word) at a time.  A packed int4 byte row i gives rows i
  // (low nibbles) and 32 + i (high nibbles); a column past N gives zeros
  // (a zero byte would decode to -8).
  auto convert = [&](const unsigned char* st) {
    for (int u = tid; u < R::RAW_ROWS * (PM_BN / 4); u += PM_THREADS) {
      const int r = u / (PM_BN / 4), w = u % (PM_BN / 4);
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(st + r * PM_BN + 4 * w);
      if constexpr (!Q4) {
        uint2 o;
        o.x = pack_bf16((float)static_cast<int8_t>(v & 0xffu),
                        (float)static_cast<int8_t>((v >> 8) & 0xffu));
        o.y = pack_bf16((float)static_cast<int8_t>((v >> 16) & 0xffu),
                        (float)static_cast<int8_t>(v >> 24));
        *reinterpret_cast<uint2*>(wsb + r * WLD + 4 * w) = o;
      } else {
        const bool ok = col0 + 4 * w < P.N;
        uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
        if (ok) {
          lo.x = pack_bf16((float)((int)(v & 15u) - 8),
                           (float)((int)((v >> 8) & 15u) - 8));
          lo.y = pack_bf16((float)((int)((v >> 16) & 15u) - 8),
                           (float)((int)((v >> 24) & 15u) - 8));
          hi.x = pack_bf16((float)((int)((v >> 4) & 15u) - 8),
                           (float)((int)((v >> 12) & 15u) - 8));
          hi.y = pack_bf16((float)((int)((v >> 20) & 15u) - 8),
                           (float)((int)(v >> 28) - 8));
        }
        *reinterpret_cast<uint2*>(wsb + r * WLD + 4 * w) = lo;
        *reinterpret_cast<uint2*>(wsb + (KC16 / 2 + r) * WLD + 4 * w) = hi;
      }
    }
  };

  float acc[4][2][4], sub[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sub[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int pass = 0; pass < passes; ++pass) {
    const int kc0 = k0 + pass * KC16;
    const unsigned char* st = smem + (pass % STAGES) * R::STAGE;
    cp_wait<STAGES - 2>();  // this thread's copies of the pass landed
    __syncthreads();        // everyone's; the previous pass is consumed
    issue(pass + STAGES - 1);
    if constexpr (Q) {
      convert(st);
      __syncthreads();
    }
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + R::RAW);
    const __nv_bfloat16* ws =
        Q ? wsb : reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
    for (int kk = 0; kk < KC16; kk += 16) {
      // Both 8-column tiles of the warp, k 0-7 and 8-15 each.
      uint32_t b[4];
      ldsm_x4(b, ws + (kk + (lane & 15)) * WLD + warp * 16 + (lane >> 4) * 8,
              true);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mtiles) break;  // uniform over the block
        uint32_t a[4];
        ldsm_x4(a, xs + (mt * 16 + (lane & 15)) * XLD + kk + (lane >> 4) * 8,
                false);
        mma_bf16(sub[mt][0], a, b[0], b[1]);
        mma_bf16(sub[mt][1], a, b[2], b[3]);
      }
    }
    // A scale block ends with this pass: its f32 sums times its scales
    // join the slice's sums (plain weights: one block, the whole slice).
    const int kend = min(k1, kc0 + KC16);
    if (Q ? (kend - k0) % QB == 0 || kend == k1 : kend == k1) {
      const int j = (kend - 1) / QB;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = col0 + warp * 16 + nt * 8 + 2 * tq + h;
          const float s =
              !Q ? 1.f
                 : (c < P.N ? __ldg(P.scale + (size_t)j * P.N + c) : 0.f);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int e = h; e < 4; e += 2) {
              acc[mt][nt][e] += sub[mt][nt][e] * s;
              sub[mt][nt][e] = 0.f;
            }
        }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the tile takes its place
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = mt * 16 + gq + 8 * h;
        const int c = warp * 16 + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(tile + b * TLD + c) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// The same slice in f32 on FMA: thread t sums column t % 128 of the tile
// for rows 32 (t / 128) .. + 31, 32 rows of K a pass, the next pass's
// weight words in registers while this one is summed.
template <int WQ>
__device__ __forceinline__ void fma_slice(const MMProblem& P, int k0, int k1,
                                          int col0, int rows,
                                          unsigned char* smem, float* tile) {
  constexpr bool Q = WQ != 0, Q4 = WQ == 4;
  constexpr int QB = Q4 ? QB4 : QB8;
  float (*xs)[LD32] = reinterpret_cast<float (*)[LD32]>(smem);  // [k][row]
  float (*ws)[PM_BN] =
      reinterpret_cast<float (*)[PM_BN]>(smem + KC32 * LD32 * 4);  // [k][col]
  const int tid = threadIdx.x;
  const int cl = tid % PM_BN, r0 = 32 * (tid / PM_BN);

  // A pass is 32 stored rows: rows of K, or the 32 byte rows of an int4
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
    const int shift = 4 * ((kc0 / KC32) & 1);  // int4: low or high nibbles
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
        for (int e = 0; e < 4; ++e)
          ws[r][4 * w + e] =
              ok ? (float)((int)((raw[u] >> (8 * e + shift)) & 15u) - 8)
                 : 0.f;
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

template <typename T, int WQ>
__global__ void __launch_bounds__(PM_THREADS, 2)
phased_matmul_kernel(const PMGroup g, int rows) {
  extern __shared__ __align__(16) unsigned char pm_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;  // the cluster: one tile of a product
  int pi = 0;
  while (pi + 1 < g.n && cid >= g.p[pi + 1].blk0) ++pi;
  const MMProblem& P = g.p[pi];
  const int col0 = (cid - P.blk0) * PM_BN;
  const int k0 = rank * P.kb, k1 = min(P.K, k0 + P.kb);
  float* tile = reinterpret_cast<float*>(pm_smem);  // [row][TLD]

  if constexpr (sizeof(T) == 2)
    mma_slice<WQ>(P, k0, k1, col0, rows, pm_smem, tile);
  else
    fma_slice<WQ>(P, k0, k1, col0, rows, pm_smem, tile);

  // Each block adds its share of the tile's outputs over the cluster's
  // slices, in rank order, and runs the epilogue; the second barrier keeps
  // every block's tile alive until all have read it.
  cluster.sync();
  const float* parts[MAX_CLUSTER];
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER; ++j)
    parts[j] = j < cs ? cluster.map_shared_rank(tile, j) : tile;
  for (int o = rank * PM_THREADS + threadIdx.x; o < rows * PM_BN;
       o += cs * PM_THREADS) {
    const int b = o / PM_BN, c = o % PM_BN;
    if (col0 + c >= P.N) continue;
    float v[MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      v[j] = j < cs ? parts[j][b * TLD + c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) s += v[j];
    epilogue<T>(P, b, col0 + c, s);
  }
  cluster.sync();
}

template <typename T, int WQ>
cudaError_t launch(const PMGroup& g, int rows, int blocks, int cs,
                   cudaStream_t st) {
  constexpr int smem = smem_bytes<T, WQ>();
  static bool sized = false;  // the opt-in above 48 KB, once per kernel
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        phased_matmul_kernel<T, WQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(PM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, phased_matmul_kernel<T, WQ>, g, rows);
}

}  // namespace

extern "C" {

// desc: n_prob rows of the descriptor table on the HOST (parse_problem,
// matmul_common.cuh).  dtype: 0 = f32, 1 = bf16.  wbits: 0 plain weights
// of type T, 8 int8 codes (K / 128, 128, N), 4 packed int4 codes (K / 64,
// 32, N), every product with its scales.  W and x 16-byte aligned; N a
// multiple of 16; K and ldx multiples of 8.  The rows' inputs and outputs
// hold B rows; B above 64 runs as further launches of 64 rows each.  No
// work space: the partial sums stay in the clusters' shared memory.
int phased_matmul_launch(const int64_t* desc, int n_prob, int B, int dtype,
                         int wbits, void* stream) {
  if (n_prob <= 0 || n_prob > PM_MAXP || B <= 0 ||
      (dtype != 0 && dtype != 1) || (wbits != 0 && wbits != 8 && wbits != 4))
    return (int)cudaErrorInvalidValue;
  const size_t tsize = dtype == 1 ? 2 : 4;
  const bool quant = wbits != 0;
  const int qblock = wbits == 4 ? QB4 : QB8;
  const int cpt = quant ? 4 : 4 / (int)tsize;  // columns per 32-bit word
  const int step = wbits == 8 ? QB8 : KC16;     // slices: whole passes, blocks
  cudaStream_t st = (cudaStream_t)stream;
  for (int b0 = 0; b0 < B; b0 += PM_ROWS) {
    const int rows = B - b0 < PM_ROWS ? B - b0 : PM_ROWS;
    PMGroup g;
    g.n = n_prob;
    int tiles = 0, steps = 1;
    for (int i = 0; i < n_prob; ++i) {
      MMProblem& P = g.p[i];
      if (!parse_problem(desc + 12 * i, b0, tsize, quant, qblock, cpt, P) ||
          P.N % 16 || P.K % 8 || P.ldx % 8)
        return (int)cudaErrorInvalidValue;
      P.blk0 = tiles;
      tiles += (P.N + PM_BN - 1) / PM_BN;
      steps = max(steps, (P.K + step - 1) / step);
    }
    // Cluster size: about FILL blocks, at most MAX_CLUSTER, and no more
    // slices than the longest K has steps.
    const int cs = min(min(MAX_CLUSTER, steps), max(1, (FILL + tiles - 1) /
                                                          tiles));
    for (int i = 0; i < n_prob; ++i) {
      MMProblem& P = g.p[i];
      P.ksplit = cs;
      P.kb = ((P.K + cs - 1) / cs + step - 1) / step * step;
    }
    cudaError_t err;
    const int blocks = tiles * cs;
    if (dtype == 1 && wbits == 4)
      err = launch<__nv_bfloat16, 4>(g, rows, blocks, cs, st);
    else if (dtype == 1 && wbits == 8)
      err = launch<__nv_bfloat16, 8>(g, rows, blocks, cs, st);
    else if (dtype == 1)
      err = launch<__nv_bfloat16, 0>(g, rows, blocks, cs, st);
    else if (wbits == 4)
      err = launch<float, 4>(g, rows, blocks, cs, st);
    else if (wbits == 8)
      err = launch<float, 8>(g, rows, blocks, cs, st);
    else
      err = launch<float, 0>(g, rows, blocks, cs, st);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
