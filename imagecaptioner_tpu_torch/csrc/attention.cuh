// Device code shared by the attention kernels (attention_core.cu,
// beam_attention.cu): type conversion, warp reductions, staging one head's
// K and V in shared memory as float, and one query row's softmax(q·kᵀ)·v
// over the staged head.
//
// Numerics (the JAX cores'): scores accumulate in float32 and are scaled
// after the dot, softmax runs in float32 as exp(s - max) / sum, the
// probabilities are rounded to v's type before the product with v, which
// accumulates in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

// The head dimension D is a template parameter (64, or 48 for the enhanced
// student's 384 / 8); a staged K row is padded to D + 1 words so that the
// per-lane key rows fall in distinct banks.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Floats of shared memory for one staged head and `warps` row workers.
template <int D>
__host__ __device__ inline size_t smem_floats(int Lk, int warps) {
  return (size_t)Lk * (D + 1) + (size_t)Lk * D + (size_t)warps * D + (size_t)warps * Lk;
}

// Carve the block's shared memory: K (Lk x (D + 1)), V (Lk x D), then one
// query row and one probability row per warp.
template <int D>
struct Smem {
  static constexpr int KSTRIDE = D + 1;
  float *k, *v, *q, *p;
  __device__ Smem(float* base, int Lk, int warps)
      : k(base), v(k + Lk * KSTRIDE), q(v + Lk * D), p(q + warps * D) {}
};

// All threads of the block copy one head's K and V (Lk x D, contiguous)
// into shared memory as float.  Ends with a block barrier.
template <int D, typename TK, typename TV>
__device__ __forceinline__ void stage_kv(const TK* __restrict__ kh,
                                         const TV* __restrict__ vh, int Lk,
                                         const Smem<D>& s) {
  for (int i = threadIdx.x; i < Lk * D; i += blockDim.x) {
    s.k[(i / D) * Smem<D>::KSTRIDE + (i % D)] = to_f(kh[i]);
    s.v[i] = to_f(vh[i]);
  }
  __syncthreads();
}

// One warp, one query row: qr points at the row's D values, orow at its D
// outputs.  Keys with index > last_key are masked to -inf (pass Lk for no
// mask).  A lane scores keys lane, lane+32, ...; the warp reduces max and
// sum with shuffles; the lanes then split the D output columns (lane and
// lane + 32; 32 < D <= 64).  qw (D floats) and pw (Lk floats) are this
// warp's scratch rows.
template <int D, typename TQ, typename TV>
__device__ __forceinline__ void attend_row(const TQ* __restrict__ qr,
                                           TV* __restrict__ orow,
                                           const Smem<D>& s, float* qw, float* pw,
                                           int Lk, int last_key, float scale,
                                           int lane) {
  static_assert(D > 32 && D <= 64, "a lane owns columns lane and lane + 32");
  const bool second = lane + 32 < D;
  qw[lane] = to_f(qr[lane]);
  if (second) qw[lane + 32] = to_f(qr[lane + 32]);
  __syncwarp();

  float m = -INFINITY;
  for (int j = lane; j < Lk; j += 32) {
    const float* kr = s.k + j * Smem<D>::KSTRIDE;
    float sc = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) sc = fmaf(qw[d], kr[d], sc);
    sc *= scale;
    if (j > last_key) sc = -INFINITY;
    pw[j] = sc;
    m = fmaxf(m, sc);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < Lk; j += 32) {
    const float e = expf(pw[j] - m);
    pw[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < Lk; j += 32) pw[j] = to_f(from_f<TV>(pw[j] / sum));
  __syncwarp();

  float a0 = 0.f, a1 = 0.f;
  for (int j = 0; j < Lk; ++j) {
    const float p = pw[j];
    a0 = fmaf(p, s.v[j * D + lane], a0);
    if (second) a1 = fmaf(p, s.v[j * D + lane + 32], a1);
  }
  orow[lane] = from_f<TV>(a0);
  if (second) orow[lane + 32] = from_f<TV>(a1);
  __syncwarp();  // qw and pw are reused by the warp's next row
}

}  // namespace attn
