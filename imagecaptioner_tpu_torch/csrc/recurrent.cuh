// Device helpers shared by the recurrent kernels (greedy_decode.cu,
// decoder_scan.cu, decoder_scan_bwd.cu): one block of THREADS threads owns
// one batch row; weights are read in their torch (out, in) layout, one warp
// per output row with 16-byte loads, ROWS rows in flight per warp, against
// a float32 vector in shared memory.

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

}  // namespace
