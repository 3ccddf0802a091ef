// Device helpers shared by the recurrent kernels: conversions, sigmoid,
// sums, softmax, the argmax rule and emit_token.  The cooperative chains
// build on chain.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

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
