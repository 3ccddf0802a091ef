// Attention core forward: out = softmax(q·kᵀ·scale [causal]) · v.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_attention.py
// `fused_attention_core` (`_make_kernel`, `_kernel_call`): one program per
// (batch, head) with the (Lq, Lk) score matrix kept on chip.
//
// Layout: q (BH, Lq, 64), k and v (BH, Lk, 64), contiguous; Lk <= 256.
// Numerics follow the JAX core: scores accumulate in float32, the causal
// mask sets col > row to -inf, softmax runs in float32 as exp(s - max) /
// sum, the probabilities are rounded to v's type before the product with v,
// which accumulates in float32; the output has v's type.
//
// What bounds it on the H100: at the serving shapes (B*H = 128 heads of
// 49 tokens, or 96 heads of 197) the work is a few MFLOP and well under a
// MB of traffic, so the kernel is bound by latency and launch overhead, not
// by the tensor cores or HBM.  The design therefore keeps everything in one
// launch: a block takes one (batch, head) and a tile of 16 query rows,
// stages that head's K and V in shared memory as float (K rows padded to 65
// words so the per-lane key rows fall in distinct banks), and each warp
// owns one query row at a time: a lane scores keys lane, lane+32, ...,
// the warp reduces max and sum with shuffles, and the lanes then split the
// 64 output columns.  The score matrix never reaches device memory.
// No library kernel (cuBLAS, cuDNN, SDPA) is called.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int KSTRIDE = D + 1;               // padded K row in shared memory

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

template <typename TQ, typename TV>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                 const TV* __restrict__ v, TV* __restrict__ out, int Lq, int Lk,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;                    // Lk * KSTRIDE
  float* v_s = k_s + Lk * KSTRIDE;      // Lk * D
  float* q_s = v_s + Lk * D;            // WARPS * D
  float* p_s = q_s + WARPS * D;         // WARPS * Lk

  const size_t bh = blockIdx.x;
  const TQ* kh = k + bh * Lk * D;
  const TV* vh = v + bh * Lk * D;
  for (int i = threadIdx.x; i < Lk * D; i += THREADS) {
    k_s[(i / D) * KSTRIDE + (i % D)] = to_f(kh[i]);
    v_s[i] = to_f(vh[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = q_s + warp * D;
  float* pw = p_s + warp * Lk;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = blockIdx.y * ROWS + rr * WARPS + warp;
    if (row >= Lq) break;  // uniform across the warp
    const TQ* qr = q + (bh * Lq + row) * D;
    qw[lane] = to_f(qr[lane]);
    qw[lane + 32] = to_f(qr[lane + 32]);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = k_s + j * KSTRIDE;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qw[d], kr[d], s);
      s *= scale;
      if (causal && j > row) s = -INFINITY;
      pw[j] = s;
      m = fmaxf(m, s);
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
      a0 = fmaf(p, v_s[j * D + lane], a0);
      a1 = fmaf(p, v_s[j * D + lane + 32], a1);
    }
    TV* orow = out + (bh * Lq + row) * D;
    orow[lane] = from_f<TV>(a0);
    orow[lane + 32] = from_f<TV>(a1);
    __syncwarp();  // qw and pw are reused by the next row
  }
}

template <typename TQ, typename TV>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Lq, int Lk, float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      (size_t)(Lk * KSTRIDE + Lk * D + WARPS * D + WARPS * Lk) * sizeof(float);
  auto kern = attention_kernel<TQ, TV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Lq + ROWS - 1) / ROWS);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TV*>(v), static_cast<TV*>(out), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int ic_attention_core(int qk_dtype, int v_dtype, const void* q,
                                 const void* k, const void* v, void* out, int BH,
                                 int Lq, int Lk, float scale, int causal,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qk_dtype == 0 && v_dtype == 0)
    return launch<float, float>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (qk_dtype == 1 && v_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (qk_dtype == 0 && v_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (qk_dtype == 1 && v_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
