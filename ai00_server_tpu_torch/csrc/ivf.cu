// IVF probe scoring for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel ai00_server_tpu/ops/retrieval.py:
// _ivf_search_pallas (kernel :316-326, pallas_call :342).  For each (query
// qi, probe rank r) the probed cluster c = probe[qi, r] holds a (cap, D)
// block of int8 codes, bf16 or f32 values; every row of it is dotted with
// the query, multiplied by pscale[c, row] (int8 codes' per-vector scale;
// no multiply without pscale) and set to -inf where packed_ids[c, row] < 0
// (an empty slot).  A probe id outside [0, nlist) gives -inf and id -1 in
// every slot.  Out: the dense (Q, nprobe, cap) f32 score table and the
// matching int32 id table; the top-k after it is PyTorch.
//
// Types: the query comes in f32 from the probe (q . centroids).  For int8
// blocks it is rounded to bf16 first, as both JAX paths round it
// (retrieval.py:256-257, :312); each product code * q is then exact in
// f32.  Float blocks are scored in f32 (the JAX XLA path's rounding): the
// Pallas path's bf16 cast of float blocks and queries is not copied.  Sums
// are f32, in another order than the plain version.
//
// What bounds it: bytes, the filled rows of the probed clusters (2 cap D
// operations on cap (D + 8) bytes for int8: far below the card's operations
// a byte).  Queries that share a cluster share its bytes, so the design
// reads each probed cluster ONCE and scores every query that probes it:
//  * ivf_group_kernel sorts the Q * nprobe (query, rank) pairs by cluster
//    on the device, a bitonic sort of up to GROUP pairs in one block, a
//    pair a thread (keys cluster << 32 | position: stable; partners within
//    a warp by shuffles, across warps through shared memory), and writes
//    the runs of equal clusters compactly (start, length, cluster, -1 off
//    the index) beside the sorted pairs.  Pairs beyond GROUP go to further
//    blocks, each sorting its own GROUP (a cluster probed from two groups
//    is read once for each).  No size returns to the host: the scoring
//    grid is fixed by (Q * nprobe, cap) and a slot past the last run exits
//    at once.  The same launch's other blocks copy the queries into a
//    scratch of rows padded to whole slices, bf16 for int8 blocks (the
//    rounding above) and f32 else, so the scoring kernel copies them in
//    16-byte pieces.
//  * ivf_score_kernel: a block owns one run's cluster and TR = 128 of its
//    rows.  It streams the rows' codes along D, SLICE = 128 bytes of a
//    row a stage, through a RING-deep cp.async ring in shared memory (as
//    quant.cu's qmm_kernel streams weight codes), with the run's queries'
//    same slice beside them, QG = 32 queries a pass.  int8 codes are
//    mma.sync m16n8k16's A, decoded exactly to bf16 (matmul_common.cuh's
//    dec8), eight warps an m16 tile of rows each; the pass's queries are
//    B, eight at a time; f32 sums.  72 KB of ring a block, three blocks an
//    SM: on chip_smoke.py's int8 index that read fastest of the tiles of
//    64-256 rows, rings of 2-6 stages and slices of 128 or 256 bytes timed
//    (PERF.md §6).  bf16 and f32 blocks take the same staging and f32
//    FMAs, a thread a row and every other query.  A row whose id
//    is < 0 is not read (its stage is zero-filled: cp.async with no source
//    bytes), and a tile with no filled row reads no code.  pscale and the
//    empty-slot mask go in the epilogue, and the scores go straight to
//    their (qi, r, row) places in the dense table.  A run of more than QG
//    queries streams its tile again for each further pass: from L2, where
//    the block has just read it.
// Rows are copied in 16-byte pieces where D * sizeof(T) is a multiple of
// 16 and packed is 16-byte aligned (D = 1024, or the 3C = 3072 of a
// pooling="state" vector), else element by element (a ragged D such as
// 37): one kernel path, the copy chosen by a flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_common.cuh"

namespace {

using decode::AFrag;
using decode::cp_async16;
using decode::cp_async_commit;
using decode::cp_async_wait;
using decode::dec8;
using decode::mma_bf16;
using decode::prmt;
using decode::to_f;

constexpr int TR = 128;       // candidate rows a scoring block
constexpr int ST = 2 * TR;    // its threads: a warp per 16 rows
constexpr int QG = 32;        // queries of a run a pass
constexpr int SLICE = 128;    // bytes of a row a stage holds
constexpr int RING = 3;       // stages of the ring
constexpr int GROUP = 1024;   // pairs a grouping block sorts, one a thread
constexpr int CONV_BLOCKS = 128;  // blocks copying the queries
// The largest D the wrapper takes (ivf_max_d): the domain of the first
// design, whose block held one f32 query copy in 227 KB of shared memory.
constexpr int MAX_D = 232448 / 4;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float((int)0xff800000u);
}

// The stage layout of element type T: KS elements of a row a stage; code
// rows CODE_LD bytes apart (int8: 128 with the 16-byte chunks of odd rows
// swapped by halves, so the mma A loads are conflict-free; floats: 144,
// so a thread a row reads conflict-free); the queries QE bytes an element
// (bf16 for codes, f32 else), Q_LD bytes a query.
template <typename T>
struct Stage {
  static constexpr bool CODES = sizeof(T) == 1;
  static constexpr int KS = SLICE / (int)sizeof(T);
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  static constexpr int CODE_LD = CODES ? SLICE : SLICE + 16;
  static constexpr int QE = CODES ? 2 : 4;
  static constexpr int Q_LD = KS * QE;
  static constexpr int QCH = Q_LD / 16;             // 16-byte chunks a query
  static constexpr int CODE_BYTES = TR * CODE_LD;
  static constexpr int BYTES = CODE_BYTES + QG * Q_LD;

  __device__ static int code_at(int row, int ch) {
    return CODES ? row * SLICE + ((ch ^ ((row & 1) << 2)) << 4)
                 : row * CODE_LD + (ch << 4);
  }
  __device__ static int query_at(int n, int ch) {
    return CODES ? n * Q_LD + ((ch ^ (n & 1)) << 4) : n * Q_LD + (ch << 4);
  }
};

// ---- the grouping ----

__global__ void __launch_bounds__(GROUP)
ivf_group_kernel(const int* __restrict__ probe, int P, int nlist,
                 int groups, int4* __restrict__ runs,
                 int* __restrict__ order, const float* __restrict__ q,
                 void* __restrict__ qs, int Q, int D, int Dp, int q_bf16) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= groups) {  // the query copy, padded with zeros
    const size_t total = (size_t)Q * Dp;
    for (size_t e = (size_t)(blockIdx.x - groups) * GROUP + tid; e < total;
         e += (size_t)(gridDim.x - groups) * GROUP) {
      const size_t qi = e / Dp;
      const int d = (int)(e % Dp);
      const float v = d < D ? q[qi * D + d] : 0.f;
      if (q_bf16)
        static_cast<__nv_bfloat16*>(qs)[e] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(qs)[e] = v;
    }
    return;
  }
  __shared__ unsigned long long xch[GROUP];
  __shared__ int starts[GROUP];
  __shared__ int wsum[GROUP / 32];
  const int lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * GROUP;
  const int cnt = min(GROUP, P - base);
  int n = 1;
  while (n < cnt) n <<= 1;

  // Thread tid holds the key of position tid; the bitonic network's
  // partners within a warp by shuffles, across warps through xch.  Keys of
  // threads past n are ~0 and meet only each other.
  unsigned long long key = ~0ull;
  if (tid < cnt) {
    const int c = probe[base + tid];
    const unsigned cm = c >= 0 && c < nlist ? (unsigned)c : (unsigned)nlist;
    key = (unsigned long long)cm << 32 | (unsigned)tid;
  }
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long other;
      if (stride >= 32) {
        __syncthreads();  // the last readers of xch are done
        xch[tid] = key;
        __syncthreads();
        other = xch[tid ^ stride];
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, stride);
      }
      const bool keep_min = ((tid & stride) == 0) == ((tid & size) == 0);
      key = keep_min == (other < key) ? other : key;
    }
  __syncthreads();
  xch[tid] = key;
  __syncthreads();

  // Run leaders numbered by a block scan; then each run's start, length
  // and cluster.
  const int f = tid < cnt &&
                (tid == 0 || (key >> 32) != (xch[tid - 1] >> 32));
  int v = f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = wsum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += u;
    }
    wsum[lane] = x;
  }
  __syncthreads();
  const int nruns = wsum[GROUP / 32 - 1];
  if (f) starts[v - 1 + (warp ? wsum[warp - 1] : 0)] = tid;
  __syncthreads();
  if (tid < cnt) {
    order[base + tid] = base + (int)(key & 0xffffffffu);
    int4 run = make_int4(0, 0, -1, 0);
    if (tid < nruns) {
      const int s = starts[tid], e = tid + 1 < nruns ? starts[tid + 1] : cnt;
      const int c = (int)(xch[s] >> 32);
      run = make_int4(base + s, e - s, c < nlist ? c : -1, 0);
    }
    runs[base + tid] = run;
  }
}

// ---- the scoring ----

// Stage s of a pass into `st`: the block's TR rows' slice s of codes
// (zeros for empty rows and past D) and its queries' slice s.
template <typename T>
__device__ __forceinline__ void load_stage(
    unsigned char* st, int s, const T* rows, const T* packed, int D,
    const int* ids_s, bool aligned, const unsigned char* qs, int Dp,
    const int* qidx, int nq, int nqr) {
  using L = Stage<T>;
  const int tid = threadIdx.x;
  for (int i = tid; i < TR * (SLICE / 16); i += ST) {
    const int row = i / (SLICE / 16), ch = i % (SLICE / 16);
    const int d0 = s * L::KS + ch * L::EPC;
    const bool filled = ids_s[row] >= 0;
    const T* x = rows + (size_t)row * D;
    unsigned char* dst = st + L::code_at(row, ch);
    if (aligned) {
      const bool on = filled && d0 < D;
      cp_async16(dst, on ? x + d0 : packed, on);
    } else {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      T* ev = reinterpret_cast<T*>(&u);
      if (filled)
#pragma unroll
        for (int e = 0; e < L::EPC; ++e)
          if (d0 + e < D) ev[e] = x[d0 + e];
      *reinterpret_cast<uint4*>(dst) = u;
    }
  }
  unsigned char* qd = st + L::CODE_BYTES;
  for (int i = tid; i < nqr * L::QCH; i += ST) {
    const int n = i / L::QCH, ch = i % L::QCH;
    const bool on = n < nq;
    const unsigned char* src =
        qs + ((size_t)qidx[on ? n : 0] * Dp + (size_t)s * L::KS) * L::QE +
        ch * 16;
    cp_async16(qd + L::query_at(n, ch), src, on);
  }
  cp_async_commit();
}

// Grid: ntiles blocks for each of the P run slots (slot-major, so the
// blocks of real runs come first).
template <typename T>
__global__ void __launch_bounds__(ST)
ivf_score_kernel(const int4* __restrict__ runs, const int* __restrict__ order,
                 const unsigned char* __restrict__ qs,
                 const T* __restrict__ packed, const int* __restrict__ pids,
                 const float* __restrict__ pscale, float* __restrict__ s_out,
                 int* __restrict__ i_out, int nprobe, int cap, int D, int Dp,
                 int ntiles, int aligned) {
  using L = Stage<T>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int ids_s[TR];
  __shared__ float ps_s[TR];
  __shared__ int pidx[QG], qidx[QG];
  const int tid = threadIdx.x;
  const int slot = blockIdx.x / ntiles, r0 = (blockIdx.x % ntiles) * TR;
  const int4 run = runs[slot];
  if (run.y == 0) return;  // not the first slot of a run
  const int start = run.x, len = run.y, c = run.z;
  const int nrows = min(TR, cap - r0);

  int id = -1;
  if (tid < TR) {
    float ps = 1.f;
    if (c >= 0 && tid < nrows) {
      const size_t o = (size_t)c * cap + r0 + tid;
      id = pids[o];
      if (pscale != nullptr) ps = pscale[o];
    }
    ids_s[tid] = id;
    ps_s[tid] = ps;
  }
  if (tid < QG) {
    const int p = tid < len ? order[start + tid] : 0;
    pidx[tid] = p;
    qidx[tid] = p / nprobe;
  }
  if (!__syncthreads_or(id >= 0)) {
    // An empty tile, or no cluster: every slot -inf with its id (-1 off
    // the index); no code is read.
    for (int i = tid; i < len * nrows; i += ST) {
      const int n = i / nrows, row = i % nrows;
      const size_t o = (size_t)order[start + n] * cap + r0 + row;
      s_out[o] = neg_inf();
      i_out[o] = ids_s[row];
    }
    return;
  }

  const T* rows = packed + ((size_t)c * cap + r0) * D;
  const int NS = Dp / L::KS;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int g0 = 0; g0 < len; g0 += QG) {
    const int nq = min(QG, len - g0);
    if (g0 > 0) {
      __syncthreads();  // the last pass is done with the ring and pidx
      if (tid < nq) {
        const int p = order[start + g0 + tid];
        pidx[tid] = p;
        qidx[tid] = p / nprobe;
      }
      __syncthreads();
    }
    const int nqr = L::CODES ? (nq + 7) & ~7 : nq;  // whole n8 tiles
    float acc[L::CODES ? QG / 8 : QG / 2][L::CODES ? 4 : 1] = {};
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) {
      if (i < NS)
        load_stage<T>(ring + i * L::BYTES, i, rows, packed, D, ids_s,
                      aligned, qs, Dp, qidx, nq, nqr);
      else
        cp_async_commit();
    }
    for (int s = 0; s < NS; ++s) {
      cp_async_wait<RING - 2>();
      __syncthreads();  // stage s is in; stage s - 1 is free again
      const int nx = s + RING - 1;
      if (nx < NS)
        load_stage<T>(ring + (nx % RING) * L::BYTES, nx, rows, packed, D,
                      ids_s, aligned, qs, Dp, qidx, nq, nqr);
      else
        cp_async_commit();
      const unsigned char* cb = ring + (s % RING) * L::BYTES;
      const unsigned char* qb = cb + L::CODE_BYTES;
      if constexpr (L::CODES) {
        // Warp w: rows 16 w + g and + 8.  Thread t's 16-byte chunk of a
        // 64-byte k group holds elements 16 t .. 16 t + 15; k step j takes
        // its bytes 4 j .. 4 j + 3 as mma's k 2t, 2t+1 (A's a0 / a1, B's
        // b0) and 2t+8, 2t+9 (a2 / a3, b1), the queries the same elements.
        const int rA = 16 * warp + g, rB = rA + 8;
#pragma unroll
        for (int kg = 0; kg < SLICE / 64; ++kg) {
          const uint4 wa = *reinterpret_cast<const uint4*>(
              cb + L::code_at(rA, 4 * kg + t));
          const uint4 wb = *reinterpret_cast<const uint4*>(
              cb + L::code_at(rB, 4 * kg + t));
          const uint32_t ua[4] = {wa.x, wa.y, wa.z, wa.w};
          const uint32_t ub[4] = {wb.x, wb.y, wb.z, wb.w};
          AFrag af[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            af[j] = {dec8(prmt(ua[j], 0u, 0x0100u)),
                     dec8(prmt(ub[j], 0u, 0x0100u)),
                     dec8(prmt(ua[j], 0u, 0x0302u)),
                     dec8(prmt(ub[j], 0u, 0x0302u))};
#pragma unroll
          for (int nt = 0; nt < QG / 8; ++nt) {
            if (8 * nt >= nq) break;
            const int n = 8 * nt + g;
            const uint4 q0 = *reinterpret_cast<const uint4*>(
                qb + L::query_at(n, 8 * kg + 2 * t));
            const uint4 q1 = *reinterpret_cast<const uint4*>(
                qb + L::query_at(n, 8 * kg + 2 * t + 1));
            mma_bf16(acc[nt], af[0], q0.x, q0.y);
            mma_bf16(acc[nt], af[1], q0.z, q0.w);
            mma_bf16(acc[nt], af[2], q1.x, q1.y);
            mma_bf16(acc[nt], af[3], q1.z, q1.w);
          }
        }
      } else {
        // Thread: row tid % TR, queries h, h + 2, ... (h = tid / TR); the
        // row's elements in order along D.
        const int row = tid % TR, h = tid / TR;
        const float* qf = reinterpret_cast<const float*>(qb);
#pragma unroll
        for (int ch = 0; ch < SLICE / 16; ++ch) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(cb + L::code_at(row, ch));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int ei = 0; ei < L::EPC; ++ei) {
            const float x = to_f(e[ei]);
            const int k = ch * L::EPC + ei;
#pragma unroll
            for (int j = 0; j < QG / 2; ++j) {
              if (2 * j + h >= nq) break;
              acc[j][0] = fmaf(x, qf[(2 * j + h) * L::KS + k], acc[j][0]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    // The scores to their (qi, r, row) places: pscale, then -inf where the
    // slot is empty.
    auto put = [&](int n, int row, float v) {
      if (n < nq && row < nrows)
        s_out[(size_t)pidx[n] * cap + r0 + row] =
            ids_s[row] >= 0 ? v * ps_s[row] : neg_inf();
    };
    if constexpr (L::CODES) {
#pragma unroll
      for (int nt = 0; nt < QG / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put(8 * nt + 2 * t + (e & 1), 16 * warp + g + 8 * (e >> 1),
              acc[nt][e]);
    } else {
#pragma unroll
      for (int j = 0; j < QG / 2; ++j)
        put(2 * j + tid / TR, tid % TR, acc[j][0]);
    }
    for (int i = tid; i < nq * nrows; i += ST) {
      const int n = i / nrows, row = i % nrows;
      i_out[(size_t)pidx[n] * cap + r0 + row] = ids_s[row];
    }
  }
}

// The grouping of P pairs into scratch (the runs, then the sorted pairs),
// and with q the query copy into qs.
int launch_group(const int* probe, long long P, int nlist, int* scratch,
                 const float* q, void* qs, int Q, int D, int Dp, int q_bf16,
                 cudaStream_t st) {
  if (P <= 0 || P > 0x7fffffffLL / 5) return (int)cudaErrorInvalidValue;
  const int groups = (int)((P + GROUP - 1) / GROUP);
  ivf_group_kernel<<<groups + (q != nullptr ? CONV_BLOCKS : 0), GROUP, 0,
                     st>>>(
      probe, (int)P, nlist, groups, reinterpret_cast<int4*>(scratch),
      scratch + 4 * P, q, qs, Q, D, Dp, q_bf16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* q, const int* probe, const void* packed,
           const int* pids, const float* pscale, float* s_out, int* i_out,
           int* scratch, void* qs, int Q, int nprobe, int nlist, int cap,
           int D, int Dp, cudaStream_t st) {
  using L = Stage<T>;
  if (Dp != (D + L::KS - 1) / L::KS * L::KS) return (int)cudaErrorInvalidValue;
  const long long P = (long long)Q * nprobe;
  const int ntiles = (cap + TR - 1) / TR;
  if (P * ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int4* runs = reinterpret_cast<const int4*>(scratch);
  const int* order = scratch + 4 * P;
  cudaError_t e = (cudaError_t)launch_group(probe, P, nlist, scratch, q, qs,
                                            Q, D, Dp, L::CODES ? 1 : 0, st);
  if (e != cudaSuccess) return (int)e;
  const int smem = RING * L::BYTES;
  e = cudaFuncSetAttribute(ivf_score_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int aligned = (size_t)D * sizeof(T) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  ivf_score_kernel<T><<<(unsigned)(P * ntiles), ST, smem, st>>>(
      runs, order, static_cast<const unsigned char*>(qs),
      static_cast<const T*>(packed), pids, pscale, s_out, i_out, nprobe, cap,
      D, Dp, ntiles, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest D the kernel takes.
int ivf_max_d(void) { return MAX_D; }

// Elements of a row a stage holds for dtype (0 = f32, 1 = bf16, 2 = int8):
// the query copy's rows are padded to a multiple of it.
int ivf_slice_elems(int dtype) {
  return dtype == 2 ? Stage<int8_t>::KS
                    : dtype == 1 ? Stage<__nv_bfloat16>::KS
                                 : Stage<float>::KS;
}

// The grouping alone (the tests hold it against ops/retrieval.py:
// ivf_group_plain): scratch as below, for P = Q nprobe pairs.
int ivf_group_launch(const int* probe, int P, int nlist, int* scratch,
                     void* stream) {
  if (nlist <= 0) return (int)cudaErrorInvalidValue;
  return launch_group(probe, P, nlist, scratch, nullptr, nullptr, 0, 0, 0, 0,
                      (cudaStream_t)stream);
}

// dtype: the type of packed, 0 = f32, 1 = bf16, 2 = int8 (the query is
// rounded to bf16 for int8).  pscale may be null (no multiply).  scratch:
// 5 Q nprobe int32, 16-byte aligned (the runs, then the sorted pairs); qs:
// Q x Dp of bf16 (int8) or f32, Dp = D padded to ivf_slice_elems(dtype).
// Two launches: the grouping (and the query copy), then the scoring.
int ivf_score_launch(const float* q, const int* probe, const void* packed,
                     const int* pids, const float* pscale, float* s_out,
                     int* i_out, int* scratch, void* qs, int Q, int nprobe,
                     int nlist, int cap, int D, int Dp, int dtype,
                     void* stream) {
  if (Q <= 0 || nprobe <= 0 || nlist <= 0 || cap <= 0 || D <= 0 ||
      D > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(q, probe, packed, pids, pscale, s_out, i_out,
                           scratch, qs, Q, nprobe, nlist, cap, D, Dp, st);
    case 1:
      return launch<__nv_bfloat16>(q, probe, packed, pids, pscale, s_out,
                                   i_out, scratch, qs, Q, nprobe, nlist, cap,
                                   D, Dp, st);
    case 2:
      return launch<int8_t>(q, probe, packed, pids, pscale, s_out, i_out,
                            scratch, qs, Q, nprobe, nlist, cap, D, Dp, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
