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
// its mode, which the caller passes and the block keeps in shared memory
// (16 words in 16 banks: no lookup conflicts).
//
// What bounds them on an H100 at the serving shape (B = 8, C = 1024,
// F = 4096, bf16):
//  * v7_skinny_matmul: bytes of the weight.  B <= 8 rows against a (K, N)
//    weight is 2 B flops per weight element, far under the card's balance
//    point, so the design streams each weight byte once for all rows.  A
//    weight is a few MB - about what the card must have in flight to run
//    at its memory rate - so the kernel is one round of loads and a chain
//    of latencies after it, and the design keeps that chain short: a block
//    owns 64 output columns (bf16; 32 in f32) and a 128-row slice of K; a
//    warp reads one weight row as 128 contiguous bytes, 4 bytes a thread,
//    and every thread asks for all 16 of its rows before it does anything
//    else; the rows' inputs sit in shared memory as f32 and a thread keeps
//    B x 2 sums in registers.  K is split over the warps of a block (one
//    shared-memory reduction, no shuffles) and, so that a (1024, 1024)
//    weight fills the card (128 blocks), over blocks:
//    each block writes its partial sums to scratch and the block that
//    arrives last at the tile's counter adds them IN SPLIT ORDER and runs
//    the epilogue - one launch, and the same bits on every run (no float
//    atomics).  Up to five products share one launch (r/k/v, the LoRAs,
//    RWKV-6's five token-shift offsets).  The epilogue covers both stacks:
//    besides v7's activations, SiLU and RWKV-6's decay exp(-exp(s)); besides
//    storing, adding into the f32 residual, adding gated by an f32 vector
//    (v6's receptance-gated channel mix) and v6's token-shift combine
//    xa + dx * (mix + s) in T.  A product's input rows may be a strided view
//    (v6 reads its five low-rank stages out of one (B, 5D) product).
//    With int8 codes the same 4 bytes a thread are 4 columns, so a block
//    owns 128 columns and a thread keeps B x 4 sums; a slice of 128 rows
//    is one scale block, a slice of 256 rows (K > 1024) two, and the
//    scales are fetched with the first codes.  Half the bytes on half the
//    blocks: the (1024, 1024) products run on 64 blocks.
//    With packed 4-bit codes a byte row is two rows of K (block row i in the
//    low nibbles, row 32 + i in the high ones), so a thread's 4 bytes are
//    4 columns x 2 rows and its slice half as many loads: 8 words for 128
//    rows of K (two scale blocks), 16 for 256 (four); the same 128-column
//    blocks and the same split of K as int8.
//  * v7_wkv_gn: bytes of the state (read once, written once for active
//    rows), as wkv7_t1, with the vector prologue and the GroupNorm / bonus /
//    gate epilogue fused around the same register layout.
//  * v7_ln_mix: latency (decode_common.cuh).

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

constexpr int MM_NB = 8;       // batch rows per launch
constexpr int MM_THREADS = 32 * MM_NB;  // a warp per batch row when staging
constexpr int MM_UNROLL = 16;  // weight rows in flight per thread
constexpr int MM_MAXP = 5;     // products per launch
constexpr int MM_KB_MAX = 256; // rows of K per block

// The products (MMProblem) and their epilogue are matmul_common.cuh's.
struct MMGroup {
  MMProblem p[MM_MAXP];
  int n;
  float levels[16];  // 4-bit codes: what a nibble decodes to
};

// 4 bytes of a weight row as floats: 2 bf16 columns, 1 f32 column, or 4
// int8 codes dequantized in T with their block's scales (sv, rounded to T).
template <typename T>
__device__ __forceinline__ void unpack4(uint32_t r, float (&w)[2],
                                        const float*) {
  w[0] = __uint_as_float(r << 16);  // a bf16 is the high half of an f32;
  w[1] = __uint_as_float(r & 0xffff0000u);  // column 0 is the low half-word
}
template <typename T>
__device__ __forceinline__ void unpack4(uint32_t r, float (&w)[1],
                                        const float*) {
  w[0] = __uint_as_float(r);
}
template <typename T>
__device__ __forceinline__ void unpack4(uint32_t r, float (&w)[4],
                                        const float* sv) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int code = static_cast<int8_t>((r >> (8 * e)) & 0xffu);
    w[e] = rnd<T>(static_cast<float>(code) * sv[e]);
  }
}

constexpr int MM_QB = 128;   // rows per scale block of int8 codes
constexpr int MM_QB4 = 64;   // rows per scale block of 4-bit codes

// WQ: bits per weight code (8: int8 codes, 4: packed nibbles, each with
// per-block scales), or 0 for plain weights of type T.
template <typename T, int WQ>
__global__ void __launch_bounds__(MM_THREADS)
skinny_matmul_kernel(const MMGroup g, int B, float* scratch,
                     unsigned int* counters) {
  constexpr bool Q = WQ != 0, Q4 = WQ == 4;
  // Columns per thread (4 bytes of a row): 4 codes / 2 bf16 / 1 f32.
  constexpr int CPT = Q ? 4 : 4 / (int)sizeof(T);
  constexpr int TN = 32 * CPT;         // columns per block: a warp spans them
  constexpr int WARPS = MM_THREADS / 32;
  constexpr int UN = MM_UNROLL;
  __shared__ __align__(16) float xs[MM_KB_MAX * MM_NB];  // [k][b]
  __shared__ __align__(16) float red[WARPS][MM_NB][TN];
  __shared__ float lut[16];
  __shared__ bool is_last;

  if (Q4 && threadIdx.x < 16)  // visible after the barrier behind the staging
    lut[threadIdx.x] = g.levels[threadIdx.x];
  int pi = 0;
  while (pi + 1 < g.n && (int)blockIdx.x >= g.p[pi + 1].blk0) ++pi;
  const MMProblem& P = g.p[pi];
  const int local = blockIdx.x - P.blk0;
  const int tile = local / P.ksplit, ks = local % P.ksplit;
  const int k0 = ks * P.kb, k1 = min(P.K, k0 + P.kb);
  const int col0 = tile * TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int col = col0 + lane * CPT;
  const bool col_ok = col < P.N;  // N is a multiple of CPT: all in or all out

  // Warp w takes rows r0 + w, r0 + w + WARPS, ... of the weight as it is
  // stored - rows of K, or byte rows of packed 4-bit codes, two rows of K
  // each: one row is 128 contiguous bytes across the warp.  UN rows are in
  // flight per thread; the first batch is asked for before anything else.
  constexpr int WSIZE = Q ? 1 : (int)sizeof(T);  // bytes per stored element
  constexpr int RPK = Q4 ? 2 : 1;                // rows of K per stored row
  const int r0 = k0 / RPK, r1 = k1 / RPK;
  const uint32_t* W = reinterpret_cast<const uint32_t*>(
      static_cast<const char*>(P.W) + (size_t)col * WSIZE);
  const size_t stride = (size_t)P.N * WSIZE / 4;  // row pitch in words
  uint32_t raw[UN];
  auto load = [&](int rbase) {
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int r = rbase + u * WARPS;
      raw[u] = (col_ok && r < r1) ? __ldg(W + (size_t)r * stride) : 0u;
    }
  };
  load(r0 + warp);
  // The scales of this slice's blocks, rounded to T (kb is 128 or 256 and k0
  // a multiple of it): one or two blocks of int8 codes, two or four of
  // 4-bit codes.
  constexpr int SQB = Q4 ? MM_QB4 : MM_QB;
  constexpr int NSC = MM_KB_MAX / SQB;
  float sc[NSC][4] = {};
  if (Q && col_ok) {
#pragma unroll
    for (int j = 0; j < NSC; ++j)
      if (k0 + j * SQB < k1) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            P.scale + (size_t)(k0 / SQB + j) * P.N + col));
        sc[j][0] = rnd<T>(v.x);
        sc[j][1] = rnd<T>(v.y);
        sc[j][2] = rnd<T>(v.z);
        sc[j][3] = rnd<T>(v.w);
      }
  }

  // This slice of every row's input, as f32, k-major.
  const T* x = static_cast<const T*>(P.x);
  const int klen = k1 - k0;
  // Warp b stages row b: 32 consecutive inputs per load, all of a thread's
  // loads in flight at once (WARPS == MM_NB).
  constexpr int XPT = MM_KB_MAX / 32;
  float xin[XPT];
#pragma unroll
  for (int u = 0; u < XPT; ++u) {
    const int kk = lane + 32 * u;
    xin[u] = (kk < klen && warp < B)
                 ? to_f(x[(size_t)warp * P.ldx + k0 + kk]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < XPT; ++u) {
    const int kk = lane + 32 * u;
    if (kk < klen) xs[kk * MM_NB + warp] = xin[u];
  }
  __syncthreads();

  float acc[MM_NB][CPT];
#pragma unroll
  for (int b = 0; b < MM_NB; ++b)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[b][e] = 0.f;

  // Row k of the staged inputs: the batch rows' values, as floats.
  auto inputs = [&](int k, float (&xv)[MM_NB]) {
    const float4 xa = *reinterpret_cast<const float4*>(&xs[k * MM_NB]);
    const float4 xb = *reinterpret_cast<const float4*>(&xs[k * MM_NB + 4]);
    xv[0] = xa.x, xv[1] = xa.y, xv[2] = xa.z, xv[3] = xa.w;
    xv[4] = xb.x, xv[5] = xb.y, xv[6] = xb.z, xv[7] = xb.w;
  };

  if constexpr (Q4) {
    // One pass: UN * WARPS = 128 byte rows = 256 rows of K = MM_KB_MAX.
    // Byte row warp + 8 u of the slice lies in scale block u / 4, at block
    // byte row i = warp + 8 (u % 4): K rows 64 (u / 4) + i (low nibbles)
    // and + 32 (high nibbles).
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      constexpr int HALF = MM_QB4 / 2;
      const int j = u / 4;
      const int klo = MM_QB4 * j + warp + WARPS * (u % 4);
      if (r0 + warp + u * WARPS < r1) {  // uniform over the warp
        float wlo[4], whi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t byte = (raw[u] >> (8 * e)) & 0xffu;
          wlo[e] = rnd<T>(lut[byte & 15u] * sc[j][e]);
          whi[e] = rnd<T>(lut[byte >> 4] * sc[j][e]);
        }
        float xl[MM_NB], xh[MM_NB];
        inputs(klo, xl);
        inputs(klo + HALF, xh);
#pragma unroll
        for (int b = 0; b < MM_NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[b][e] = fmaf(xh[b], whi[e], fmaf(xl[b], wlo[e], acc[b][e]));
      }
    }
  } else {
    for (int kbase = k0 + warp; kbase < k1; kbase += UN * WARPS) {
      if (kbase != k0 + warp) load(kbase);
      // UN * WARPS = 128 rows per pass: one scale block of int8 codes.
      const bool hi = kbase - k0 >= MM_QB;
      const float sv[4] = {hi ? sc[1][0] : sc[0][0], hi ? sc[1][1] : sc[0][1],
                           hi ? sc[1][2] : sc[0][2], hi ? sc[1][3] : sc[0][3]};
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int k = kbase + u * WARPS;
        if (k < k1) {  // uniform over the warp
          float wv[CPT], xv[MM_NB];
          unpack4<T>(raw[u], wv, sv);
          inputs(k - k0, xv);
#pragma unroll
          for (int b = 0; b < MM_NB; ++b)
#pragma unroll
            for (int e = 0; e < CPT; ++e)
              acc[b][e] = fmaf(xv[b], wv[e], acc[b][e]);
        }
      }
    }
  }

  // Add the warps' sums through shared memory, in warp order.
#pragma unroll
  for (int b = 0; b < MM_NB; ++b)
#pragma unroll
    for (int e = 0; e < CPT; ++e) red[warp][b][lane * CPT + e] = acc[b][e];
  __syncthreads();

  constexpr int n_out = MM_NB * TN;
  auto block_sum_of = [&](int o) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][o / TN][o % TN];
    return s;
  };
  if (P.ksplit == 1) {
    for (int o = tid; o < n_out; o += MM_THREADS) {
      const int b = o / TN, c = col0 + o % TN;
      if (b < B && c < P.N) epilogue<T>(P, b, c, block_sum_of(o));
    }
    return;
  }

  // K split over blocks: park this block's partial sums, and let the
  // block that arrives last add all of them in split order.
  float* part = scratch + P.scr0;
  for (int o = tid; o < n_out; o += MM_THREADS) {
    const int b = o / TN, c = col0 + o % TN;
    if (b < B && c < P.N)
      part[((size_t)ks * MM_NB + b) * P.N + c] = block_sum_of(o);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int ticket = atomicAdd(&counters[P.cnt0 + tile], 1u);
    is_last = ticket == (unsigned int)P.ksplit - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int o = tid; o < n_out; o += MM_THREADS) {
    const int b = o / TN, c = col0 + o % TN;
    if (b >= B || c >= P.N) continue;
    const float* src = part + (size_t)b * P.N + c;
    const size_t pitch = (size_t)MM_NB * P.N;
    float s = 0.f;
    for (int j0 = 0; j0 < P.ksplit; j0 += 8) {  // 8 loads in flight
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = j0 + j < P.ksplit ? __ldcg(src + (j0 + j) * pitch) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    epilogue<T>(P, b, c, s);
  }
  if (tid == 0) counters[P.cnt0 + tile] = 0u;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// v7_wkv_gn: vector prologue, WKV step in place, GroupNorm, bonus, gate
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv_gn_kernel(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ a, const float* __restrict__ g,
              const float* __restrict__ vmix, float* __restrict__ v_first,
              const float* __restrict__ vecs,
              const uint8_t* __restrict__ active, float* __restrict__ S,
              T* __restrict__ out, int H, int C, int is_first) {
  __shared__ __align__(16) float sv[6][N];  // r, w, k2, v2, kk, a
  __shared__ float ys[N];
  __shared__ float red[2];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / TPR, q = tid % TPR;
  const size_t vo = (size_t)bh * N;  // == b * C + h * N
  const int c = h * N + tid;         // channel, for tid < N
  const bool act = active[b] != 0;

  float4* state = reinterpret_cast<float4*>(S + (vo + row) * N);
  float4 s[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = state[4 * j + q];

  // vecs rows: w0 a0 v0 k_k k_a r_k lnx_w lnx_b
  float rv = 0.f, wv = 0.f, av = 0.f, kk = 0.f, k2 = 0.f, v2 = 0.f, rk = 0.f;
  float gv = 0.f, lnw = 0.f, lnb = 0.f;  // for the epilogue, fetched now
  if (tid < N) {
    gv = g[vo + tid];
    lnw = vecs[6 * (size_t)C + c];
    lnb = vecs[7 * (size_t)C + c];
    rv = r[vo + tid];
    const float kv = k[vo + tid];
    const float vv = v[vo + tid];
    av = a[vo + tid];
    wv = w[vo + tid];
    kk = kv * vecs[3 * (size_t)C + c];
    k2 = kv * (1.f + (av - 1.f) * vecs[4 * (size_t)C + c]);
    if (is_first) {
      v2 = vv;
      v_first[vo + tid] = vv;
    } else {
      v2 = vv + (v_first[vo + tid] - vv) * vmix[vo + tid];
    }
    rk = rv * k2 * vecs[5 * (size_t)C + c];  // the bonus reads the unmasked k2
    if (!act) {
      wv = 1.f;
      k2 = 0.f;
      kk = 0.f;
    }
  }
  const float norm2 = head_sum(kk * kk, red);
  const float bonus = head_sum(rk, red);
  if (tid < N) {
    kk = rnd<T>(kk / fmaxf(sqrtf(norm2), 1e-12f));
    sv[0][tid] = rv;
    sv[1][tid] = wv;
    sv[2][tid] = k2;
    sv[3][tid] = v2;
    sv[4][tid] = kk;
    sv[5][tid] = av;
  }
  __syncthreads();

  // An inactive row keeps its state bit for bit (and is not written).
  if (act) {
    update(s, sv[1], sv[2], sv[4], sv[5], sv[3][row], q);
#pragma unroll
    for (int j = 0; j < J; ++j) state[4 * j + q] = s[j];
  }
  const float yv = readout(s, sv[0], q);
  if (q == 0) ys[row] = yv;
  __syncthreads();

  // GroupNorm of the f32 y over the head, bonus, gate.
  const float y = tid < N ? ys[tid] : 0.f;
  const float mean = head_sum(y, red) / N;
  const float d = tid < N ? y - mean : 0.f;
  const float var = head_sum(d * d, red) / N;
  if (tid < N) {
    const float yn = d * rsqrtf(var + GN_EPS);
    const float yf = (yn * lnw + lnb) + bonus * v2;
    out[vo + tid] = from_f<T>(yf * gv);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the weights' and activations' type T).

// out: (base + n_mix, B, C) T; base is 0, or 2 to put xa and dx first.
int v7_ln_mix_launch(const float* x, const void* ln, float* shift,
                     const void* mix, const uint8_t* active, void* out, int B,
                     int C, int n_mix, int base, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || n_mix <= 0 || (base != 0 && base != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    ln_mix_kernel<T><<<B, LN_THREADS, 0, st>>>(
        x, (const T*)ln, shift, (const T*)mix, active, (T*)out, B, C, n_mix,
        base);
  } else if (dtype == 0) {
    ln_mix_kernel<float><<<B, LN_THREADS, 0, st>>>(
        x, (const float*)ln, shift, (const float*)mix, active, (float*)out, B,
        C, n_mix, base);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// desc: n_prob rows of 12 int64 on the HOST: x, W, y, bias (pointers; bias
// may be 0), K, N, act | round_t << 8 | out << 16, scale (pointer, or 0
// for a plain weight), ldx (elements between rows of x, >= K), e0, e1, e2
// (the epilogue's operands, pointers or 0).  wbits says what all of the launch's W hold: 0 plain
// weights of type T (no scales); 8 int8 codes (K / 128, 128, N), K a
// multiple of 128; 4 packed 4-bit codes (K / 64, 32, N), K a multiple of 64,
// with levels = 16 int32 on the host, what a nibble decodes to.  With codes
// N is a multiple of 4 and every product has its scale.  The rows'
// inputs and outputs hold B rows; B above MM_NB runs as further launches
// of MM_NB rows each.  scratch / counters: device work space of
// scratch_floats floats and n_counters zeroed uint32 (left zeroed).
int v7_skinny_matmul_launch(const int64_t* desc, int n_prob, int B, int dtype,
                            int wbits, const int32_t* levels, float* scratch,
                            int scratch_floats, unsigned int* counters,
                            int n_counters, void* stream) {
  if (n_prob <= 0 || n_prob > MM_MAXP || B <= 0 ||
      (dtype != 0 && dtype != 1) || (wbits != 0 && wbits != 8 && wbits != 4) ||
      (wbits == 4) != (levels != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t tsize = dtype == 1 ? 2 : 4;
  const bool quant = wbits != 0;
  const int qblock = wbits == 4 ? MM_QB4 : MM_QB;
  const int cpt = quant ? 4 : 4 / (int)tsize;  // columns per thread
  const int tn = 32 * cpt;                     // columns per block
  cudaStream_t st = (cudaStream_t)stream;
  for (int b0 = 0; b0 < B; b0 += MM_NB) {
    MMGroup g;
    g.n = n_prob;
    for (int i = 0; i < 16; ++i)
      g.levels[i] = levels != nullptr ? (float)levels[i] : 0.f;
    int blocks = 0, scr = 0, cnt = 0;
    for (int i = 0; i < n_prob; ++i) {
      const int64_t* d = desc + 12 * i;
      MMProblem& P = g.p[i];
      if (!parse_problem(d, b0, tsize, quant, qblock, cpt, P))
        return (int)cudaErrorInvalidValue;
      P.kb = P.K <= 1024 ? 128 : MM_KB_MAX;
      P.ksplit = (P.K + P.kb - 1) / P.kb;
      const int tiles = (P.N + tn - 1) / tn;
      P.blk0 = blocks;
      P.scr0 = scr;
      P.cnt0 = cnt;
      blocks += tiles * P.ksplit;
      if (P.ksplit > 1) {
        scr += P.ksplit * MM_NB * P.N;
        cnt += tiles;
      }
    }
    if (scr > scratch_floats || cnt > n_counters)
      return (int)cudaErrorInvalidValue;
    const int rows = B - b0 < MM_NB ? B - b0 : MM_NB;
    if (dtype == 1 && wbits == 4)
      skinny_matmul_kernel<__nv_bfloat16, 4><<<blocks, MM_THREADS, 0, st>>>(
          g, rows, scratch, counters);
    else if (dtype == 1 && wbits == 8)
      skinny_matmul_kernel<__nv_bfloat16, 8><<<blocks, MM_THREADS, 0, st>>>(
          g, rows, scratch, counters);
    else if (dtype == 1)
      skinny_matmul_kernel<__nv_bfloat16, 0><<<blocks, MM_THREADS, 0, st>>>(
          g, rows, scratch, counters);
    else if (wbits == 4)
      skinny_matmul_kernel<float, 4><<<blocks, MM_THREADS, 0, st>>>(
          g, rows, scratch, counters);
    else if (wbits == 8)
      skinny_matmul_kernel<float, 8><<<blocks, MM_THREADS, 0, st>>>(
          g, rows, scratch, counters);
    else
      skinny_matmul_kernel<float, 0><<<blocks, MM_THREADS, 0, st>>>(
          g, rows, scratch, counters);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int v7_wkv_gn_launch(const float* r, const float* k, const float* v,
                     const float* w, const float* a, const float* g,
                     const float* vmix, float* v_first, const float* vecs,
                     const uint8_t* active, float* S, void* out, int B, int H,
                     int n, int is_first, int dtype, void* stream) {
  if (n != N || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int C = H * N;
  if (dtype == 1)
    wkv_gn_kernel<__nv_bfloat16><<<B * H, THREADS, 0, st>>>(
        r, k, v, w, a, g, vmix, v_first, vecs, active, S,
        (__nv_bfloat16*)out, H, C, is_first);
  else if (dtype == 0)
    wkv_gn_kernel<float><<<B * H, THREADS, 0, st>>>(
        r, k, v, w, a, g, vmix, v_first, vecs, active, S, (float*)out, H, C,
        is_first);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
