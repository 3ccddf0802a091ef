// Device helpers shared by the recurrent kernels.  The elementwise ones
// (conversions, sigmoid, sums, softmax, argmax rules, emit_token) serve all
// of them; gemv and block_argmax serve the kernels in which one block of
// THREADS threads owns one batch row (greedy_decode_compact.cu,
// compact_scan.cu, enhanced_scan.cu): weights are read in their torch (out,
// in) layout, one warp per output row with 16-byte loads, ROWS rows in
// flight per warp, against a float32 vector in shared memory.  The
// cooperative chains build on chain.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;  // weight rows each warp streams at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of weights (4 float or 8 bf16) dotted with float x from shared
// memory; w and x are 16-byte aligned.
__device__ __forceinline__ float dot16(const float* w, const float* x) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w));
  const float4 b = *reinterpret_cast<const float4*>(x);
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* w, const float* x) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(w));
  const float4 b0 = *reinterpret_cast<const float4*>(x);
  const float4 b1 = *reinterpret_cast<const float4*>(x + 4);
  // a bf16 is the upper half of a float32
  float s = __uint_as_float(a.x << 16) * b0.x;
  s = fmaf(__uint_as_float(a.x & 0xffff0000u), b0.y, s);
  s = fmaf(__uint_as_float(a.y << 16), b0.z, s);
  s = fmaf(__uint_as_float(a.y & 0xffff0000u), b0.w, s);
  s = fmaf(__uint_as_float(a.z << 16), b1.x, s);
  s = fmaf(__uint_as_float(a.z & 0xffff0000u), b1.y, s);
  s = fmaf(__uint_as_float(a.w << 16), b1.z, s);
  s = fmaf(__uint_as_float(a.w & 0xffff0000u), b1.w, s);
  return s;
}

// out[j] = sum_k W1[j, k] x1[k] + sum_k W2[j, k] x2[k] + bias[j] for j < M.
// W rows have leading dimensions ld1/ld2 (elements); K1, K2 are multiples of
// 16 / sizeof(T); W2 may be null with K2 = 0, bias may be null.
template <typename T>
__device__ void gemv(const T* __restrict__ W1, int ld1, int K1,
                     const float* __restrict__ x1, const T* __restrict__ W2,
                     int ld2, int K2, const float* __restrict__ x2,
                     const float* __restrict__ bias, int M,
                     float* __restrict__ out) {
  constexpr int N = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j0 = warp * ROWS; j0 < M; j0 += WARPS * ROWS) {
    const T* w1[ROWS];
    const T* w2[ROWS];
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const size_t j = (size_t)min(j0 + r, M - 1);  // tail rows re-read row M-1
      w1[r] = W1 + j * ld1;
      w2[r] = W2 + j * ld2;
      acc[r] = 0.f;
    }
    for (int k = lane * N; k < K1; k += 32 * N) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] += dot16(w1[r] + k, x1 + k);
    }
    for (int k = lane * N; k < K2; k += 32 * N) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] += dot16(w2[r] + k, x2 + k);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0 && j0 + r < M) out[j0 + r] = s + (bias ? bias[j0 + r] : 0.f);
    }
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Warp 0 turns the L scores in s into softmax weights in place, in float32
// as exp(x - max) / sum, and with WRITE also stores them to `out`.  The
// caller synchronises the block before and after.
template <bool WRITE>
__device__ __forceinline__ void warp0_softmax(float* s, int L, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, s[l]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(s[l] - m);
      s[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) {
      const float w = s[l] / sum;
      s[l] = w;
      if (WRITE) out[l] = w;
    }
  }
}

// (value, index) a beats (value, index) b under jnp.argmax: NaN is the
// largest value, and the lower index wins a tie.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

// Index of the largest of logits[0..V) / temperature over the block, valid in
// thread 0 only.  red_v and red_i hold WARPS values each; the caller
// synchronises the block before reusing them or logits.
__device__ __forceinline__ int block_argmax(const float* logits, int V,
                                            float temperature, float* red_v,
                                            int* red_i) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float best = -INFINITY;
  int bi = V;
  for (int v = tid; v < V; v += THREADS) {
    float x = logits[v];
    if (temperature != 1.f) x = x / temperature;
    if (beats(x, v, best, bi)) {
      best = x;
      bi = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (beats(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    best = red_v[0];
    bi = red_i[0];
    for (int w = 1; w < WARPS; ++w)
      if (beats(red_v[w], red_i[w], best, bi)) {
        best = red_v[w];
        bi = red_i[w];
      }
  }
  return bi;
}

constexpr int TOK_PAD = 0, TOK_START = 1, TOK_END = 2;

// Thread 0 records step t's token for its row: END and everything after it
// become PAD, and a finished row keeps feeding its last real token.
__device__ __forceinline__ void emit_token(int next, int32_t* out_t, int* tok,
                                           int* done) {
  const int is_end = next == TOK_END;
  *out_t = (*done || is_end) ? TOK_PAD : next;
  *done = *done || is_end;
  if (!*done) *tok = next;
}

}  // namespace
