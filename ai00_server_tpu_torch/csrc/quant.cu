// Dequant-in-matmul kernels on int8 and on packed 4-bit codes for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces ai00_server_tpu/ops/quant_pallas.py:matmul_int8, matmul_int8_l
// (y = x . (codes x per-128-row-block scale), the second on layer l of
// stacked codes), matmul_4bit, matmul_4bit_l (the same on nf4 / sf4 / int4
// codes, two a byte, per-64-row-block scales) and
// ai00_server_tpu/ops/ffn_pallas.py:ffn7_t1_l (the RWKV-7 channel mix at
// T = 1 on quantized layer l, any of the four modes).  The Pallas kernels
// walk a sequential grid with the output block resident in VMEM; on this
// card blocks run in no order, so one kernel computes
//
//   y (B <= 8, N) = epilogue(prologue(x) (B, K) . dequant(q, s))
//
// and the entry points compose it: matmul_int8 / matmul_4bit one launch per
// 8 rows, matmul_int8_l / matmul_4bit_l the same after offsetting the base
// pointers to layer l (no slicing copy), ffn7_t1_l two dependent launches
// (key product with the token-shift mix as prologue and relu^2 as epilogue,
// then the value product; the value product needs every column of the
// first).
//
// Rounding follows the Pallas kernels: the weight is dequantized in the
// activation type T, w = round_T(level * round_T(s)), then x . w is summed
// in f32.  An int8 code is its own level; a nibble's level is one of 16
// integers (exact in bf16) that the caller passes as a table, so nf4, sf4
// and int4 are one kernel.  The Pallas kernel builds that lookup from a
// select tree over packed constants for want of a gather; here the 16 levels
// sit in shared memory as floats - 16 words in 16 banks, so a warp's 32
// lookups never conflict.
//
// 4-bit layout: byte row i of a 64-row block holds block row i in its low
// nibble and row 32 + i in its high nibble.  A thread's word of 4 bytes is
// 4 columns x 2 rows of K: it multiplies the staged inputs of both rows.
//
// What bounds it on an H100 at the serving shapes (B = 8; K, N in 1024 ..
// 65536): the bytes of the codes - 2 B operations per weight byte is far
// under the card's balance point - so every code byte is read once for all
// rows.  A block owns 128 output columns (a warp reads one row of codes as
// 128 contiguous bytes, 4 codes a thread) and a slice of K; it walks the
// slice in chunks of 128 rows (one scale block), each thread asking for the
// next chunk's 16 words (8 words of packed 4-bit codes: the same 128 rows
// of K, two scale blocks) before it works on this one's.  The chunk's inputs
// sit in shared memory as f32 and a thread keeps B x 4 sums in registers.
// K is split over the 8 warps (one shared-memory reduction, in warp order)
// and, where the column tiles alone would not fill the card, over blocks:
// each parks its partial sums in scratch and the block that arrives last at
// the tile's counter adds them in split order - one launch, the same bits on
// every run, no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 128;               // rows per scale block (INT8_BLOCK)
constexpr int QB4 = 64;               // the same for 4-bit codes (NF4_BLOCK)
constexpr int NB = 8;                 // batch rows per launch
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;   // a warp per batch row when staging
constexpr int TN = 128;               // columns per block: 32 lanes x 4 codes
constexpr int CH = 128;               // rows per chunk: one int8 scale block
constexpr int UN = CH / WARPS;        // code rows in flight per thread
constexpr int UN4 = CH / 2 / WARPS;   // the same in byte rows of 4-bit codes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round through T and come back (the ".astype(cd)" points).
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// What a nibble decodes to.  An argument of its own, not a member of QMM:
// with these 64 bytes inside QMM the int8 kernel, which never reads them,
// compiled to another register allocation and ran 5-15% slower on the card.
struct Levels {
  float v[16];
};

struct QMM {
  const void* x;          // (B, K) T: the operand, or xf of the channel mix
  const float* prev;      // channel mix: (B, K) f32 shift state, else null
  const void* mix;        // channel mix: (K,) T
  const uint8_t* active;  // channel mix: (B,)
  float* new_shift;       // channel mix: (B, K) f32, where(active, xf, prev)
  const void* q;          // (K, N) int8 codes, or (K / 2, N) packed bytes
  const float* s;         // (K / 128, N) scales; 4-bit: (K / 64, N)
  void* y;                // (B, N): T, or f32 when out_f32
  int K, N, B;
  int kb, ksplit;         // K is cut into ksplit slices of kb rows
  int relu2, out_f32;
  float* scratch;         // ksplit * NB * N partial sums when ksplit > 1
  unsigned int* counters; // one per column tile, zero between launches
};

template <typename T>
__device__ __forceinline__ void store(const QMM& P, int b, int c, float s) {
  if (P.relu2) {
    s = fmaxf(s, 0.f);
    s = s * s;
  }
  const size_t i = (size_t)b * P.N + c;
  if (P.out_f32)
    static_cast<float*>(P.y)[i] = s;
  else
    static_cast<T*>(P.y)[i] = from_f<T>(s);
}

// The end of both kernels: add the warps' sums through shared memory, in
// warp order, and - where K is split over blocks - park the block's partial
// sums and let the block that arrives last add all of them in split order.
template <typename T>
__device__ __forceinline__ void reduce_and_store(
    const QMM& P, const float (&acc)[NB][4], float (&red)[WARPS][NB][TN],
    bool& is_last, int tile, int ks, int col0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][b][lane * 4 + e] = acc[b][e];
  __syncthreads();

  constexpr int n_out = NB * TN;
  auto block_sum_of = [&](int o) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][o / TN][o % TN];
    return s;
  };
  if (P.ksplit == 1) {
    for (int o = tid; o < n_out; o += THREADS) {
      const int b = o / TN, c = col0 + o % TN;
      if (b < P.B && c < P.N) store<T>(P, b, c, block_sum_of(o));
    }
    return;
  }

  for (int o = tid; o < n_out; o += THREADS) {
    const int b = o / TN, c = col0 + o % TN;
    if (b < P.B && c < P.N)
      P.scratch[((size_t)ks * NB + b) * P.N + c] = block_sum_of(o);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int ticket = atomicAdd(&P.counters[tile], 1u);
    is_last = ticket == (unsigned int)P.ksplit - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int o = tid; o < n_out; o += THREADS) {
    const int b = o / TN, c = col0 + o % TN;
    if (b >= P.B || c >= P.N) continue;
    const float* src = P.scratch + (size_t)b * P.N + c;
    const size_t step = (size_t)NB * P.N;
    float s = 0.f;
    for (int j0 = 0; j0 < P.ksplit; j0 += 8) {  // 8 loads in flight
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = j0 + j < P.ksplit ? __ldcg(src + (j0 + j) * step) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    store<T>(P, b, c, s);
  }
  if (tid == 0) P.counters[tile] = 0u;  // ready for the next launch
}

// Warp b stages row b of the chunk at c0 as f32, k-major, into xs; the
// channel mix's token shift is applied (and the new shift state written by
// tile 0) on the way.
template <typename T>
__device__ __forceinline__ void stage_inputs(const QMM& P, float* xs, int c0,
                                             int k1, int tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(P.x);
  float xin[CH / 32];
#pragma unroll
  for (int u = 0; u < CH / 32; ++u) {
    const int k = c0 + lane + 32 * u;
    float v = 0.f;
    if (k < k1 && warp < P.B) {
      const size_t i = (size_t)warp * P.K + k;
      v = to_f(x[i]);
      if (P.prev != nullptr) {  // the channel mix's token shift
        const float pv = P.prev[i];
        const float m = to_f(static_cast<const T*>(P.mix)[k]);
        if (tile == 0) P.new_shift[i] = P.active[warp] ? v : pv;
        v = rnd<T>(v + (pv - v) * m);
      }
    }
    xin[u] = v;
  }
#pragma unroll
  for (int u = 0; u < CH / 32; ++u) xs[(lane + 32 * u) * NB + warp] = xin[u];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(const QMM P) {
  __shared__ __align__(16) float xs[CH * NB];  // [k][b]
  __shared__ __align__(16) float red[WARPS][NB][TN];
  __shared__ bool is_last;

  const int tile = blockIdx.x, ks = blockIdx.y;
  const int k0 = ks * P.kb, k1 = min(P.K, k0 + P.kb);
  const int col0 = tile * TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int col = col0 + lane * 4;
  const bool col_ok = col < P.N;  // N is a multiple of 4: all in or all out

  const uint32_t* W = reinterpret_cast<const uint32_t*>(
      static_cast<const int8_t*>(P.q) + col);
  const size_t pitch = (size_t)P.N / 4;  // row pitch in words

  // A chunk's codes (row c0 + warp + u * WARPS is 128 contiguous bytes
  // across the warp) and its scales; kb is 64 or a multiple of 128 and k0 a
  // multiple of kb, so a chunk lies in one scale block.
  auto load = [&](int c0, uint32_t (&raw)[UN], float4& sc) {
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int k = c0 + warp + u * WARPS;
      raw[u] = (col_ok && k < k1) ? __ldg(W + (size_t)k * pitch) : 0u;
    }
    sc = col_ok ? __ldg(reinterpret_cast<const float4*>(
                      P.s + (size_t)(c0 / QB) * P.N + col))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;

  uint32_t cur[UN], nxt[UN];
  float4 sc_cur, sc_nxt;
  load(k0, cur, sc_cur);
  for (int c0 = k0; c0 < k1; c0 += CH) {
    const bool more = c0 + CH < k1;
    if (more) load(c0 + CH, nxt, sc_nxt);

    stage_inputs<T>(P, xs, c0, k1, tile);
    __syncthreads();

    const float sv[4] = {rnd<T>(sc_cur.x), rnd<T>(sc_cur.y), rnd<T>(sc_cur.z),
                         rnd<T>(sc_cur.w)};
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int kk = warp + u * WARPS;
      if (c0 + kk < k1) {  // uniform over the warp
        float wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int code = static_cast<int8_t>((cur[u] >> (8 * e)) & 0xffu);
          wv[e] = rnd<T>(static_cast<float>(code) * sv[e]);
        }
        const float4 xa = *reinterpret_cast<const float4*>(&xs[kk * NB]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[kk * NB + 4]);
        const float xv[NB] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[b][e] = fmaf(xv[b], wv[e], acc[b][e]);
      }
    }
    __syncthreads();  // xs is staged again by the next chunk
    if (more) {
#pragma unroll
      for (int u = 0; u < UN; ++u) cur[u] = nxt[u];
      sc_cur = sc_nxt;
    }
  }

  reduce_and_store<T>(P, acc, red, is_last, tile, ks, col0);
}

// The same product on packed 4-bit codes.  A chunk is 128 rows of K = 64
// byte rows = two scale blocks; warp w holds byte rows w, w + 8, ... of it,
// so word u of a thread lies in scale block u / 4 of the chunk, at block
// byte row i = w + 8 (u % 4): K rows 64 (u / 4) + i (low nibbles) and
// + 32 (high nibbles).
template <typename T>
__global__ void __launch_bounds__(THREADS)
q4_matmul_kernel(const QMM P, const Levels lv) {
  __shared__ __align__(16) float xs[CH * NB];  // [k][b]
  __shared__ __align__(16) float red[WARPS][NB][TN];
  __shared__ float lut[16];
  __shared__ bool is_last;

  const int tile = blockIdx.x, ks = blockIdx.y;
  const int k0 = ks * P.kb, k1 = min(P.K, k0 + P.kb);
  const int col0 = tile * TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int col = col0 + lane * 4;
  const bool col_ok = col < P.N;  // N is a multiple of 4: all in or all out
  if (tid < 16) lut[tid] = lv.v[tid];  // visible after the first barrier

  const uint32_t* W = reinterpret_cast<const uint32_t*>(
      static_cast<const uint8_t*>(P.q) + col);
  const size_t pitch = (size_t)P.N / 4;  // byte-row pitch in words

  // kb is a multiple of 64 and k0 of kb, so a chunk starts on a scale block
  // and its second block may lie beyond k1.
  auto load = [&](int c0, uint32_t (&raw)[UN4], float4 (&sc)[2]) {
#pragma unroll
    for (int u = 0; u < UN4; ++u) {
      const int k = c0 + QB4 * (u / 4);  // first K row of the word's block
      const int br = c0 / 2 + warp + u * WARPS;
      raw[u] = (col_ok && k < k1) ? __ldg(W + (size_t)br * pitch) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sc[j] = (col_ok && c0 + QB4 * j < k1)
                  ? __ldg(reinterpret_cast<const float4*>(
                        P.s + (size_t)(c0 / QB4 + j) * P.N + col))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;

  uint32_t cur[UN4], nxt[UN4];
  float4 sc_cur[2], sc_nxt[2];
  load(k0, cur, sc_cur);
  for (int c0 = k0; c0 < k1; c0 += CH) {
    const bool more = c0 + CH < k1;
    if (more) load(c0 + CH, nxt, sc_nxt);
    stage_inputs<T>(P, xs, c0, k1, tile);
    __syncthreads();

    float sv[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sv[j][0] = rnd<T>(sc_cur[j].x);
      sv[j][1] = rnd<T>(sc_cur[j].y);
      sv[j][2] = rnd<T>(sc_cur[j].z);
      sv[j][3] = rnd<T>(sc_cur[j].w);
    }
#pragma unroll
    for (int u = 0; u < UN4; ++u) {
      constexpr int HALF = QB4 / 2;
      const int j = u / 4;
      const int klo = QB4 * j + warp + WARPS * (u % 4);
      if (c0 + QB4 * j < k1) {  // uniform over the block
        float wlo[4], whi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t byte = (cur[u] >> (8 * e)) & 0xffu;
          wlo[e] = rnd<T>(lut[byte & 15u] * sv[j][e]);
          whi[e] = rnd<T>(lut[byte >> 4] * sv[j][e]);
        }
        const float4 la = *reinterpret_cast<const float4*>(&xs[klo * NB]);
        const float4 lb = *reinterpret_cast<const float4*>(&xs[klo * NB + 4]);
        const float4 ha =
            *reinterpret_cast<const float4*>(&xs[(klo + HALF) * NB]);
        const float4 hb =
            *reinterpret_cast<const float4*>(&xs[(klo + HALF) * NB + 4]);
        const float xl[NB] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
        const float xh[NB] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[b][e] = fmaf(xh[b], whi[e], fmaf(xl[b], wlo[e], acc[b][e]));
      }
    }
    __syncthreads();  // xs is staged again by the next chunk
    if (more) {
#pragma unroll
      for (int u = 0; u < UN4; ++u) cur[u] = nxt[u];
      sc_cur[0] = sc_nxt[0];
      sc_cur[1] = sc_nxt[1];
    }
  }
  reduce_and_store<T>(P, acc, red, is_last, tile, ks, col0);
}

// Rows of K per block: the largest of 128, 256, ... that still gives the
// card 128 blocks, else 64 (half a scale block).
int choose_kb(int K, int N) {
  const long tiles = (N + TN - 1) / TN;
  int kb = 64;
  for (long c = QB; c < 2L * K; c *= 2)
    if (tiles * ((K + c - 1) / c) >= 128) kb = (int)c;
  return kb;
}

// Fills the split and the work space of one product; false if the work space
// is too small.
bool plan(QMM& P, float* scratch, long scratch_floats, unsigned int* counters,
          int n_counters) {
  P.kb = choose_kb(P.K, P.N);
  P.ksplit = (P.K + P.kb - 1) / P.kb;
  P.scratch = scratch;
  P.counters = counters;
  if (P.ksplit == 1) return true;
  return (long)P.ksplit * NB * P.N <= scratch_floats &&
         (P.N + TN - 1) / TN <= n_counters;
}

// lv: the levels of packed 4-bit codes, or null for int8 codes.
cudaError_t launch(const QMM& P, const Levels* lv, int dtype,
                   cudaStream_t st) {
  const bool four = lv != nullptr;
  const dim3 grid((P.N + TN - 1) / TN, P.ksplit);
  if (four && dtype == 1)
    q4_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(P, *lv);
  else if (four)
    q4_matmul_kernel<float><<<grid, THREADS, 0, st>>>(P, *lv);
  else if (dtype == 1)
    int8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(P);
  else
    int8_matmul_kernel<float><<<grid, THREADS, 0, st>>>(P);
  return cudaGetLastError();
}

bool bad_shape(int R, int K, int N, bool four, int dtype) {
  return R <= 0 || K <= 0 || N <= 0 || K % (four ? QB4 : QB) || N % 4 ||
         (dtype != 0 && dtype != 1);
}

// The 16 levels of a 4-bit mode as the kernel takes them (zeros for int8).
Levels make_levels(const int32_t* levels) {
  Levels lv = {};
  if (levels != nullptr)
    for (int i = 0; i < 16; ++i) lv.v[i] = (float)levels[i];
  return lv;
}

// The weight of layer l of stacked codes (K, N) - int8, or packed 4-bit -
// into P.
void set_weight(QMM& P, const void* q, const float* s, bool four, int l,
                int K, int N) {
  P.q = (const char*)q + (size_t)l * (four ? K / 2 : K) * N;
  P.s = s + (size_t)l * (K / (four ? QB4 : QB)) * N;
  P.K = K;
  P.N = N;
}

// y (R, N) = x (R, K) . dequant(layer l of the codes); R above 8 runs as
// further launches.
int product(const void* x, const void* q, const float* s,
            const int32_t* levels, int l, void* y, int R, int K, int N,
            int dtype, int out_f32, float* scratch, int scratch_floats,
            unsigned int* counters, int n_counters, void* stream) {
  const bool four = levels != nullptr;
  if (bad_shape(R, K, N, four, dtype) || l < 0)
    return (int)cudaErrorInvalidValue;
  const size_t tsize = dtype == 1 ? 2 : 4;
  const size_t ysize = out_f32 ? 4 : tsize;
  QMM P = {};
  const Levels lv = make_levels(levels);
  set_weight(P, q, s, four, l, K, N);
  P.out_f32 = out_f32;
  if (!plan(P, scratch, scratch_floats, counters, n_counters))
    return (int)cudaErrorInvalidValue;
  for (int r0 = 0; r0 < R; r0 += NB) {
    P.x = (const char*)x + (size_t)r0 * K * tsize;
    P.y = (char*)y + (size_t)r0 * N * ysize;
    P.B = R - r0 < NB ? R - r0 : NB;
    const cudaError_t err =
        launch(P, four ? &lv : nullptr, dtype, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the activations' type T).  scratch / counters:
// device work space of scratch_floats floats and n_counters zeroed uint32
// (left zeroed); the two functions below say how much a (K, N) product needs.

int matmul_int8_scratch_floats(int K, int N) {
  const int kb = choose_kb(K, N);
  const int ksplit = (K + kb - 1) / kb;
  return ksplit > 1 ? ksplit * NB * N : 0;
}

int matmul_int8_counters(int K, int N) {
  const int kb = choose_kb(K, N);
  return (K + kb - 1) / kb > 1 ? (N + TN - 1) / TN : 0;
}

// y (R, N) = x (R, K) . dequant(q[l], s[l]) with q (L, K / 128, 128, N) int8
// and s (L, K / 128, 1, N) f32; matmul_int8 is l = 0 on unstacked codes.
// y is f32 when out_f32, else T.  R above 8 runs as further launches.
int matmul_int8_l_launch(const void* x, const int8_t* q, const float* s, int l,
                         void* y, int R, int K, int N, int dtype, int out_f32,
                         float* scratch, int scratch_floats,
                         unsigned int* counters, int n_counters,
                         void* stream) {
  return product(x, q, s, nullptr, l, y, R, K, N, dtype, out_f32, scratch,
                 scratch_floats, counters, n_counters, stream);
}

int matmul_int8_launch(const void* x, const int8_t* q, const float* s, void* y,
                       int R, int K, int N, int dtype, int out_f32,
                       float* scratch, int scratch_floats,
                       unsigned int* counters, int n_counters, void* stream) {
  return product(x, q, s, nullptr, 0, y, R, K, N, dtype, out_f32, scratch,
                 scratch_floats, counters, n_counters, stream);
}

// The same on packed 4-bit codes: q (L, K / 64, 32, N) uint8 (byte row i of
// a block: block row i in the low nibble, row 32 + i in the high one), s
// (L, K / 64, 1, N) f32, levels 16 int32 on the HOST (what a nibble decodes
// to: the mode).  matmul_4bit is l = 0 on unstacked codes.
int matmul_4bit_l_launch(const void* x, const uint8_t* q, const float* s,
                         const int32_t* levels, int l, void* y, int R, int K,
                         int N, int dtype, int out_f32, float* scratch,
                         int scratch_floats, unsigned int* counters,
                         int n_counters, void* stream) {
  if (levels == nullptr) return (int)cudaErrorInvalidValue;
  return product(x, q, s, levels, l, y, R, K, N, dtype, out_f32, scratch,
                 scratch_floats, counters, n_counters, stream);
}

int matmul_4bit_launch(const void* x, const uint8_t* q, const float* s,
                       const int32_t* levels, void* y, int R, int K, int N,
                       int dtype, int out_f32, float* scratch,
                       int scratch_floats, unsigned int* counters,
                       int n_counters, void* stream) {
  return matmul_4bit_l_launch(x, q, s, levels, 0, y, R, K, N, dtype, out_f32,
                              scratch, scratch_floats, counters, n_counters,
                              stream);
}

// The RWKV-7 channel mix at T = 1 on layer l of stacked codes:
//   fxk = round_T(xf + (shift - xf) * mix_k)
//   hk  = round_T(relu(fxk . K_l)^2)          (B, F) T, work space
//   out = hk . V_l                            (B, C) f32, not rounded
//   new_shift = where(active, xf, shift)      (B, C) f32
// xf (B, C) T; shift (B, C) f32; mix_k (C,) T; active (B,) bool.
// levels null: int8 codes, key_q (L, C / 128, 128, F), key_s (L, C / 128, 1,
// F), val_q (L, F / 128, 128, C), val_s (L, F / 128, 1, C).  levels 16 int32
// on the host: packed 4-bit codes of that mode, key_q (L, C / 64, 32, F),
// key_s (L, C / 64, 1, F), val_q (L, F / 64, 32, C), val_s (L, F / 64, 1, C).
int ffn7_t1_l_launch(const void* xf, const float* shift, const void* mix_k,
                     const uint8_t* active, const void* key_q,
                     const float* key_s, const void* val_q,
                     const float* val_s, const int32_t* levels, int l,
                     float* out, float* new_shift, void* hk, int B, int C,
                     int F, int dtype, float* scratch, int scratch_floats,
                     unsigned int* counters, int n_counters, void* stream) {
  const bool four = levels != nullptr;
  if (bad_shape(B, C, F, four, dtype) || bad_shape(B, F, C, four, dtype) ||
      l < 0)
    return (int)cudaErrorInvalidValue;
  const size_t tsize = dtype == 1 ? 2 : 4;
  QMM Pk = {}, Pv = {};
  const Levels lv = make_levels(levels);
  Pk.mix = mix_k;
  set_weight(Pk, key_q, key_s, four, l, C, F);
  Pk.relu2 = 1;
  set_weight(Pv, val_q, val_s, four, l, F, C);
  Pv.out_f32 = 1;
  if (!plan(Pk, scratch, scratch_floats, counters, n_counters) ||
      !plan(Pv, scratch, scratch_floats, counters, n_counters))
    return (int)cudaErrorInvalidValue;
  for (int r0 = 0; r0 < B; r0 += NB) {
    const int rows = B - r0 < NB ? B - r0 : NB;
    Pk.x = (const char*)xf + (size_t)r0 * C * tsize;
    Pk.prev = shift + (size_t)r0 * C;
    Pk.active = active + r0;
    Pk.new_shift = new_shift + (size_t)r0 * C;
    Pk.y = (char*)hk + (size_t)r0 * F * tsize;
    Pk.B = rows;
    cudaError_t err =
        launch(Pk, four ? &lv : nullptr, dtype, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    Pv.x = Pk.y;
    Pv.y = out + (size_t)r0 * C;
    Pv.B = rows;
    err = launch(Pv, four ? &lv : nullptr, dtype, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
