// RWKV-4 WKV kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Both compute v4's per-channel recurrence on the numerically stable
// exponential accumulator (aa, bb, pp), f32 whatever the activation type
// (pp is a running log-scale):
//
//   readout  ww = u + k;  q = max(pp, ww)
//            y  = (e^(pp-q) aa + e^(ww-q) v) / (e^(pp-q) bb + e^(ww-q))
//   update   ww = pp + w  (w = -exp(time_decay));  q = max(ww, k)
//            aa = e^(ww-q) aa + e^(k-q) v;  bb = e^(ww-q) bb + e^(k-q);  pp = q
//
// v4_wkv_launch is the WKV stage of the fused RWKV-4 decode step: it
// replaces the (aa, bb, pp) lines of the Pallas kernel
// ai00_server_tpu/ops/v4_decode_pallas.py:forward_t1 (_kernel, :142-166).
// One step for every (b, c), the state updated IN PLACE for active rows (an
// inactive row keeps its bits), the output r * y rounded through the
// activation type T: the operand of Wo.  It moves ~0.3 MB at the 0.4B
// width (B = 8, C = 1024), so alone it sits at the launch floor; in the
// stack what it costs is the latency it adds between the r/k/v product and
// Wo.  Design: a programmatic dependent launch (as every other launch of
// the stack) that asks for this layer's state and its w / u rows before it
// waits for the r/k/v product, so the state's DRAM round trip overlaps
// that product; r, k, v and active are read after the wait, from L2
// (ld4_l2: never ld.global.nc, decode_common.cuh says why); four channels a
// thread with 16-byte loads and stores, 64-thread blocks (32 blocks at B =
// 8, C = 1024: a small grid beside the product still running).
//
// wkv4_chunk_launch is the same recurrence over a T-token chunk (prefill,
// and the layer path at T = 1).  The JAX package runs it as a lax.scan
// (ai00_server_tpu/models/v4.py:_wkv_scan, :49-84), not as Pallas; here it
// is one kernel, so a chunk is one launch a layer and not T of them.  k and
// v come in the activation type TI (bf16 on the serving path, as the
// projections give them) and are widened to f32 in registers, as _wkv_scan
// does inside its body; y is f32.  What bounds it: latency.  At B = 8,
// C = 1024, T = 256 it moves ~17 MB in bf16 (a bound of ~0.005 ms), but
// step by step each (b, c) is a chain of 256 dependent steps of four
// exponentials and a division, with about two warps an SM to hide it
// (0.0426 ms on an H100).  Design: the chunked form, parallel over T.  A
// run of steps from the zero state (0, 0, PP_INIT) gives a triple (aa_s,
// bb_s, pp_s) and its count n_s of valid steps (a masked step is the
// identity: it neither decays nor adds), and a state followed by such a run
// is
//
//   p = pp + n_s w;  q = max(p, pp_s)
//   aa = e^(p-q) aa + e^(pp_s-q) aa_s;  bb = e^(p-q) bb + e^(pp_s-q) bb_s
//   pp = q
//
// (every exponent <= 0; a run with n_s = 0 leaves the state as it is, bit
// for bit).  The combination is associative, so a block of 256 threads,
// G channels x NS runs of R = 8 steps (NS from the plan, ops/wkv4.py:plan;
// G = 256 / NS), works in three phases:
//   1. each thread (lane: channel; warp: run) steps its R steps from the
//      zero state, its k, v and mask kept in registers, and puts its run in
//      shared memory;
//   2. after a barrier the same threads, transposed (the NS runs of a
//      channel in NS neighbouring lanes), scan the runs with shuffles
//      (log2 NS rounds) and combine the channel's state with the runs
//      before each: every run's start state, to shared memory;
//   3. after a second barrier each thread steps its R steps again from its
//      true start state and writes y; the last run's end is the state
//      after the window.
// Windows of NS x R steps follow each other (T up to NS R is one; a longer
// chunk takes several windows of 256 steps).  The chain falls from T steps
// to about 2R + log2 NS combinations, and the threads from B C to B C NS.
// A chunk of at most SEQ_STEPS (T = 1 on the layer path, short chunks)
// takes wkv4_chunk_seq_launch instead: one thread a channel steps through
// it (the kernel before the chunked form; on an H100 one run of the chunked
// kernel read ~0.8 us slower at T = 1).  A masked step leaves the state
// unchanged and its y reads the kept state (models/v4._wkv_scan does the
// same).  ops/wkv4.py:wkv4_chunk_mirror repeats this arithmetic in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "matmul_common.cuh"

using namespace decode;

namespace {

constexpr float PP_INIT = -1e30f;  // models/v4.py: the zero state's pp

// e^(a - q) and e^(b - q) for q = max(a, b) with one exponential: the one
// of the larger is e^0 = 1, and the other's argument, b - a or a - b, is
// -|a - b| bit for bit, so both equal the two expf calls.
__device__ __forceinline__ void exp_pair(float a, float b, float& ea,
                                         float& eb) {
  const float e = expf(-fabsf(a - b));
  ea = a >= b ? 1.f : e;
  eb = a >= b ? e : 1.f;
}

// y from the state before the step.
__device__ __forceinline__ float wkv4_out(float aa, float bb, float pp,
                                          float k, float v, float u) {
  float e1, e2;
  exp_pair(pp, u + k, e1, e2);
  return (e1 * aa + e2 * v) / (e1 * bb + e2);
}

// Advances (aa, bb, pp) by one step.
__device__ __forceinline__ void wkv4_update(float& aa, float& bb, float& pp,
                                            float k, float v, float w) {
  const float ww = pp + w;
  float e1, e2;
  exp_pair(ww, k, e1, e2);
  aa = e1 * aa + e2 * v;
  bb = e1 * bb + e2;
  pp = fmaxf(ww, k);
}

// ---------------------------------------------------------------------------
// v4_wkv
// ---------------------------------------------------------------------------

constexpr int V4_THREADS = 64;

__device__ __forceinline__ void as4(const float4& t, float (&v)[4]) {
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

// vecs rows: w = -exp(time_decay), u = time_first (the fused layout's).
// Thread i: row b, channels c .. c + 3.
template <typename T>
__global__ void __launch_bounds__(V4_THREADS)
v4_wkv_kernel(const float* r, const float* k, const float* v,
              const float* __restrict__ vecs, const uint8_t* active,
              float* aa, float* bb, float* pp, T* __restrict__ out, int B,
              int C) {
  grid_launch_dependents();
  const int C4 = C / 4;
  const int i = blockIdx.x * V4_THREADS + threadIdx.x;
  if (i >= B * C4) return;
  const int b = i / C4, c = 4 * (i - b * C4);
  const size_t o = (size_t)b * C + c;

  // Before the wait, what no launch of the stack before this one writes:
  // this layer's state (written only by this same launch a step earlier;
  // the engine's copies into the state pool precede the whole step, whose
  // first launch is an ordinary one) and the weights.
  float sa[4], sb[4], sp[4], w[4], u[4];
  as4(ld4_l2(aa + o), sa);
  as4(ld4_l2(bb + o), sb);
  as4(ld4_l2(pp + o), sp);
  as4(ld4(vecs + c), w);
  as4(ld4(vecs + C + c), u);
  grid_wait();

  // After it, what the launches before write: r, k, v and active.
  float rv[4], kv[4], vv[4], y[4];
  as4(ld4_l2(r + o), rv);
  as4(ld4_l2(k + o), kv);
  as4(ld4_l2(v + o), vv);
  const bool act = __ldcg(active + b) != 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    y[e] = rv[e] * wkv4_out(sa[e], sb[e], sp[e], kv[e], vv[e], u[e]);
    wkv4_update(sa[e], sb[e], sp[e], kv[e], vv[e], w[e]);
  }
  if (act) {  // an inactive row keeps its state bit for bit
    store4(aa + o, sa);
    store4(bb + o, sb);
    store4(pp + o, sp);
  }
  store4(out + o, y);
}

// ---------------------------------------------------------------------------
// wkv4_chunk
// ---------------------------------------------------------------------------

constexpr int SEQ_THREADS = 64;
constexpr int SEQ_STEPS = 16;    // the longest chunk stepped one by one
constexpr int CH_THREADS = 256;  // a chunked block: G channels x NS runs
constexpr int CH_RUN = 8;        // R: the steps of a run
constexpr int CH_MAX_RUNS = 32;  // NS: a channel's runs in one warp

// One thread a (b, c), the chunk's k, v and mask requested at once.
template <typename TI>
__global__ void __launch_bounds__(SEQ_THREADS)
wkv4_seq_kernel(const float* __restrict__ aa0, const float* __restrict__ bb0,
                const float* __restrict__ pp0, const TI* __restrict__ k,
                const TI* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const uint8_t* __restrict__ mask,
                float* __restrict__ aa1, float* __restrict__ bb1,
                float* __restrict__ pp1, float* __restrict__ y, int B, int T,
                int C) {
  const size_t i = (size_t)blockIdx.x * SEQ_THREADS + threadIdx.x;
  if (i >= (size_t)B * C) return;
  const int b = (int)(i / C), c = (int)(i % C);
  const float wc = w[c], uc = u[c];
  float a = aa0[i], bv = bb0[i], p = pp0[i];
  const size_t row = (size_t)b * T;  // (b, t) -> row + t
  TI kb[SEQ_STEPS], vb[SEQ_STEPS];
  uint8_t mb[SEQ_STEPS];
#pragma unroll
  for (int j = 0; j < SEQ_STEPS; ++j) {
    const bool in = j < T;
    kb[j] = in ? k[(row + j) * C + c] : TI(0.f);
    vb[j] = in ? v[(row + j) * C + c] : TI(0.f);
    mb[j] = in ? mask[row + j] : 0;
  }
#pragma unroll
  for (int j = 0; j < SEQ_STEPS; ++j) {
    if (j < T) {
      const float kf = to_f(kb[j]), vf = to_f(vb[j]);
      y[(row + j) * C + c] = wkv4_out(a, bv, p, kf, vf, uc);
      if (mb[j] != 0) wkv4_update(a, bv, p, kf, vf, wc);
    }
  }
  aa1[i] = a;
  bb1[i] = bv;
  pp1[i] = p;
}

// A run of steps from the zero state, and its count of valid steps.
struct Run {
  float aa, bb, pp;
  int n;
};

// State (or run) s followed by run g, on a channel of decay w.
__device__ __forceinline__ Run after(const Run& s, const Run& g, float w) {
  if (g.n == 0) return s;
  const float p = s.pp + (float)g.n * w;
  float e1, e2;
  exp_pair(p, g.pp, e1, e2);
  return {e1 * s.aa + e2 * g.aa, e1 * s.bb + e2 * g.bb, fmaxf(p, g.pp),
          s.n + g.n};
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d, int width) {
  constexpr unsigned FULL = 0xffffffffu;
  return {__shfl_up_sync(FULL, x.aa, d, width),
          __shfl_up_sync(FULL, x.bb, d, width),
          __shfl_up_sync(FULL, x.pp, d, width),
          __shfl_up_sync(FULL, x.n, d, width)};
}

// Grid (ceil(C / G), B), CH_THREADS threads, G = CH_THREADS / NS: see the
// note at the top.  NS a power of two, 2 to CH_MAX_RUNS.
template <typename TI>
__global__ void __launch_bounds__(CH_THREADS)
wkv4_chunk_kernel(const float* __restrict__ aa0, const float* __restrict__ bb0,
                  const float* __restrict__ pp0, const TI* __restrict__ k,
                  const TI* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const uint8_t* __restrict__ mask,
                  float* __restrict__ aa1, float* __restrict__ bb1,
                  float* __restrict__ pp1, float* __restrict__ y, int T,
                  int C, int NS) {
  constexpr int R = CH_RUN;
  __shared__ float4 runs[CH_THREADS];          // [NS][G]: a run, then a start
  __shared__ float carry[3 * CH_THREADS / 2];  // [3][G]: between windows
  const int G = CH_THREADS / NS;
  const int b = blockIdx.y, tid = threadIdx.x;
  // Phases 1 and 3: lane = channel, warp = run.
  const int ch = tid % G, sub = tid / G;
  const int c = blockIdx.x * G + ch;
  const bool on = c < C;
  // Phase 2: a channel's NS runs in NS neighbouring lanes.
  const int ch2 = tid / NS, sub2 = tid % NS;
  const int c2 = blockIdx.x * G + ch2;
  const float wc = on ? w[c] : 0.f, uc = on ? u[c] : 0.f;
  const float wc2 = c2 < C ? w[c2] : 0.f;
  const size_t row = (size_t)b * T;  // (b, t) -> row + t
  const bool last = sub == NS - 1;
  if (last && on) {
    carry[ch] = aa0[(size_t)b * C + c];
    carry[G + ch] = bb0[(size_t)b * C + c];
    carry[2 * G + ch] = pp0[(size_t)b * C + c];
  }
  for (int t0 = 0; t0 < T; t0 += NS * R) {
    const int s0 = t0 + sub * R;  // this thread's first step
    TI kb[R], vb[R];
    uint32_t valid = 0;  // bit j: step s0 + j is in the chunk and unmasked
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = s0 + j;
      const bool in = on && t < T;
      kb[j] = in ? k[(row + t) * C + c] : TI(0.f);
      vb[j] = in ? v[(row + t) * C + c] : TI(0.f);
      valid |= (in && mask[row + t] != 0 ? 1u : 0u) << j;
    }

    // Phase 1: the run from the zero state.
    float a = 0.f, bv = 0.f, p = PP_INIT;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (valid >> j & 1u) wkv4_update(a, bv, p, to_f(kb[j]), to_f(vb[j]), wc);
    runs[sub * G + ch] = make_float4(a, bv, p, __int_as_float(__popc(valid)));
    __syncthreads();

    // Phase 2: inclusive scan of the channel's runs, then each run's start:
    // the state at the window's start followed by the runs before it.
    const float4 r4 = runs[sub2 * G + ch2];
    Run x = {r4.x, r4.y, r4.z, __float_as_int(r4.w)};
    for (int d = 1; d < NS; d <<= 1) {
      const Run e = shfl_up(x, d, NS);
      if (sub2 >= d) x = after(e, x, wc2);
    }
    const Run before = shfl_up(x, 1, NS);
    const Run init = {carry[ch2], carry[G + ch2], carry[2 * G + ch2], 0};
    const Run st = sub2 == 0 ? init : after(init, before, wc2);
    runs[sub2 * G + ch2] = make_float4(st.aa, st.bb, st.pp, 0.f);
    __syncthreads();

    // Phase 3: the R steps from the true start state, with y.
    const float4 s4 = runs[sub * G + ch];
    a = s4.x, bv = s4.y, p = s4.z;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int t = s0 + j;
      if (on && t < T) {
        const float kf = to_f(kb[j]), vf = to_f(vb[j]);
        y[(row + t) * C + c] = wkv4_out(a, bv, p, kf, vf, uc);
        if (valid >> j & 1u) wkv4_update(a, bv, p, kf, vf, wc);
      }
    }
    if (last && on) {  // the state after the window
      carry[ch] = a;
      carry[G + ch] = bv;
      carry[2 * G + ch] = p;
    }
  }
  if (last && on) {
    aa1[(size_t)b * C + c] = carry[ch];
    bb1[(size_t)b * C + c] = carry[G + ch];
    pp1[(size_t)b * C + c] = carry[2 * G + ch];
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (the activation type T of the output).  C a
// multiple of 4 and every operand 16-byte aligned (the wrapper checks).  A
// programmatic dependent launch that reads aa, bb, pp and vecs before it
// waits for the kernel before it: whatever writes them must have finished
// before this kernel starts (a synchronisation, or a launch without PDL
// between them).
int v4_wkv_launch(const float* r, const float* k, const float* v,
                  const float* vecs, const uint8_t* active, float* aa,
                  float* bb, float* pp, void* out, int B, int C, int dtype,
                  void* stream) {
  if (B <= 0 || C <= 0 || C % 4 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* kern = dtype == 1 ? (const void*)v4_wkv_kernel<__nv_bfloat16>
                                : (const void*)v4_wkv_kernel<float>;
  const int groups = B * (C / 4);
  int b = B, c = C;
  void* params[] = {(void*)&r,  (void*)&k,  (void*)&v,  (void*)&vecs,
                    (void*)&active, (void*)&aa, (void*)&bb, (void*)&pp,
                    (void*)&out, &b, &c};
  const cudaError_t e =
      launch_ex(kern, dim3((groups + V4_THREADS - 1) / V4_THREADS),
                V4_THREADS, 0, 0, true, (cudaStream_t)stream, params);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16 (the type of k and v).  T at most SEQ_STEPS.
int wkv4_chunk_seq_launch(const float* aa, const float* bb, const float* pp,
                          const void* k, const void* v, const float* w,
                          const float* u, const uint8_t* mask, float* aa_out,
                          float* bb_out, float* pp_out, float* y, int B,
                          int T, int C, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || T > SEQ_STEPS || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)(((size_t)B * C + SEQ_THREADS - 1) / SEQ_THREADS);
  if (dtype == 1)
    wkv4_seq_kernel<__nv_bfloat16><<<blocks, SEQ_THREADS, 0, st>>>(
        aa, bb, pp, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, w, u,
        mask, aa_out, bb_out, pp_out, y, B, T, C);
  else if (dtype == 0)
    wkv4_seq_kernel<float><<<blocks, SEQ_THREADS, 0, st>>>(
        aa, bb, pp, (const float*)k, (const float*)v, w, u, mask, aa_out,
        bb_out, pp_out, y, B, T, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16 (the type of k and v).  NS runs of CH_RUN steps
// and CH_THREADS / NS channels a block (ops/wkv4.py:plan).
int wkv4_chunk_launch(const float* aa, const float* bb, const float* pp,
                      const void* k, const void* v, const float* w,
                      const float* u, const uint8_t* mask, float* aa_out,
                      float* bb_out, float* pp_out, float* y, int B, int T,
                      int C, int NS, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || NS < 2 || NS > CH_MAX_RUNS ||
      (NS & (NS - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int G = CH_THREADS / NS;
  const dim3 grid((C + G - 1) / G, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    wkv4_chunk_kernel<__nv_bfloat16><<<grid, CH_THREADS, 0, st>>>(
        aa, bb, pp, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, w, u,
        mask, aa_out, bb_out, pp_out, y, T, C, NS);
  else if (dtype == 0)
    wkv4_chunk_kernel<float><<<grid, CH_THREADS, 0, st>>>(
        aa, bb, pp, (const float*)k, (const float*)v, w, u, mask, aa_out,
        bb_out, pp_out, y, T, C, NS);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
