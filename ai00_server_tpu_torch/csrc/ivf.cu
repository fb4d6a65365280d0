// IVF probe scoring for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel ai00_server_tpu/ops/retrieval.py:
// _ivf_search_pallas (kernel :316-326, pallas_call :342).  For each (query
// qi, probe rank r) the probed cluster c = probe[qi, r] holds a (cap, D)
// block of int8 codes, bf16 or f32 values; every row of it is dotted with
// the query, multiplied by pscale[c, row] (int8 codes' per-vector scale;
// no multiply without pscale) and set to -inf where packed_ids[c, row] < 0
// (an empty slot).  Out: the dense (Q, nprobe, cap) f32 score table and
// the matching int32 id table; the top-k after it is PyTorch.
//
// Types: the query comes in f32 from the probe (q . centroids).  For int8
// blocks it is rounded to bf16 first, as both JAX paths round it
// (retrieval.py:256-257, :312), and each product code * q is exact in f32.
// Float blocks are scored in f32 (the JAX XLA path's rounding): the Pallas
// path's bf16 cast of float blocks and queries is not copied.  Sums are
// f32, in another order than the plain version.
//
// What bounds it: bytes.  A probe reads cap * (D * elem + 8) bytes (the
// block, its ids and scales) and does 2 * cap * D operations, far below
// the card's ~20 operations a byte in f32.  Design, simple first: one
// block of 8 warps per (qi, r), which loads its own probe index (no scalar
// prefetch).  The query sits in shared memory once, as f32, swizzled so
// that for the vector part (d < nvec * VEC) lane l reading its j-th
// element reads word j * nvec + l (consecutive lanes, consecutive words:
// no bank conflicts); a ragged tail keeps its natural place after it, and
// the scalar loads read through the same index map (q_at).  Dynamic shared
// memory (4 bytes a dimension, above 48 KB by attribute) takes D up to
// ivf_max_d() = 58,112: the 3C of a pooling="state" vector at C = 1024 is
// 3072.  One warp per candidate row,
// the warps striding over cap; lanes take 16-byte vector loads along D
// where the row is 16-byte aligned, then a scalar tail for a ragged D; an
// unaligned row is read element by element.  Empty slots are not read.  A
// warp-shuffle reduction, then pscale and the pad mask, then the write.
//
// Left for later: queries that probe the same cluster re-read it (nothing
// is shared across the Q blocks of one cluster), each warp has only one
// row's loads in flight, and no TMA / cp.async pipeline feeds the warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SMEM = 232448;  // bytes a block may use (H100)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

__device__ __forceinline__ float neg_inf() {
  return __int_as_float((int)0xff800000u);
}

// The shared-memory word of query element d (see the note above).
template <int VEC>
__device__ __forceinline__ int q_at(int d, int nvec) {
  return d < nvec * VEC ? (d % VEC) * nvec + d / VEC : d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ivf_score_kernel(const float* __restrict__ q, const int* __restrict__ probe,
                 const T* __restrict__ packed, const int* __restrict__ pids,
                 const float* __restrict__ pscale, float* __restrict__ s_out,
                 int* __restrict__ i_out, int nprobe, int nlist, int cap,
                 int D, int round_q) {
  constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte load
  const int nvec = D / VEC;            // vector loads in an aligned row
  extern __shared__ float qs[];        // D floats, qs[q_at(d)] = q[d]

  const size_t qr = blockIdx.x;        // qi * nprobe + r
  const size_t qi = qr / nprobe;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float v = q[qi * D + d];
    if (round_q) v = __bfloat162float(__float2bfloat16_rn(v));
    qs[q_at<VEC>(d, nvec)] = v;
  }
  __syncthreads();

  const int c = probe[qr];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_row = s_out + qr * cap;
  int* i_row = i_out + qr * cap;
  if (c < 0 || c >= nlist) {  // not a cluster: every slot empty
    for (int row = threadIdx.x; row < cap; row += THREADS) {
      s_row[row] = neg_inf();
      i_row[row] = -1;
    }
    return;
  }
  const size_t cbase = (size_t)c * cap;
  for (int row = warp; row < cap; row += WARPS) {
    const int id = pids[cbase + row];
    float acc = 0.f;
    if (id >= 0) {
      const T* x = packed + (cbase + row) * (size_t)D;
      int done = 0;
      if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
        const uint4* xv = reinterpret_cast<const uint4*>(x);
        for (int v = lane; v < nvec; v += 32) {
          const uint4 raw = xv[v];
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc += qs[j * nvec + v] * to_f(e[j]);
        }
        done = nvec * VEC;
      }
      for (int d = done + lane; d < D; d += 32)
        acc += qs[q_at<VEC>(d, nvec)] * to_f(x[d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      float s = neg_inf();
      if (id >= 0) s = pscale ? acc * pscale[cbase + row] : acc;
      s_row[row] = s;
      i_row[row] = id;
    }
  }
}

template <typename T>
int launch(const float* q, const int* probe, const void* packed,
           const int* pids, const float* pscale, float* s_out, int* i_out,
           int Q, int nprobe, int nlist, int cap, int D, int round_q,
           cudaStream_t st) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ivf_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t blocks = (size_t)Q * nprobe;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  ivf_score_kernel<T><<<(unsigned)blocks, THREADS, smem, st>>>(
      q, probe, (const T*)packed, pids, pscale, s_out, i_out, nprobe, nlist,
      cap, D, round_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest D the kernel takes: the query fills the shared memory a block
// may use.
int ivf_max_d(void) { return MAX_SMEM / (int)sizeof(float); }

// dtype: the type of packed, 0 = f32, 1 = bf16, 2 = int8 (the query is
// rounded to bf16 for int8).  pscale may be null (no multiply).
int ivf_score_launch(const float* q, const int* probe, const void* packed,
                     const int* pids, const float* pscale, float* s_out,
                     int* i_out, int Q, int nprobe, int nlist, int cap,
                     int D, int dtype, void* stream) {
  if (Q <= 0 || nprobe <= 0 || nlist <= 0 || cap <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(q, probe, packed, pids, pscale, s_out, i_out, Q,
                           nprobe, nlist, cap, D, 0, st);
    case 1:
      return launch<__nv_bfloat16>(q, probe, packed, pids, pscale, s_out,
                                   i_out, Q, nprobe, nlist, cap, D, 0, st);
    case 2:
      return launch<int8_t>(q, probe, packed, pids, pscale, s_out, i_out, Q,
                            nprobe, nlist, cap, D, 1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
