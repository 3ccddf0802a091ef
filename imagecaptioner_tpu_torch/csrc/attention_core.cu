// Attention core forward: out = softmax(q·kᵀ·scale [causal]) · v.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_attention.py
// `fused_attention_core` (`_make_kernel`, `_kernel_call`): one program per
// (batch, head) with the (Lq, Lk) score matrix kept on chip.
//
// Layout: q (BH, Lq, D), k and v (BH, Lk, D), contiguous; D = 64, or 48 (the
// enhanced student's cross refinement, 384 / 8); Lk <= 256.
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
// No library kernel (cuBLAS, cuDNN, SDPA) is called.  The staging and the
// per-row work live in attention.cuh, shared with beam_attention.cu.

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 2;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block

template <int D, typename TQ, typename TV>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                 const TV* __restrict__ v, TV* __restrict__ out, int Lq, int Lk,
                 float scale, int causal) {
  extern __shared__ float smem[];
  const Smem<D> s(smem, Lk, WARPS);
  const size_t bh = blockIdx.x;
  stage_kv(k + bh * Lk * D, v + bh * Lk * D, Lk, s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = blockIdx.y * ROWS + rr * WARPS + warp;
    if (row >= Lq) break;  // uniform across the warp
    attend_row<D>(q + (bh * Lq + row) * D, out + (bh * Lq + row) * D, s,
                  s.q + warp * D, s.p + warp * Lk, Lk, causal ? row : Lk, scale,
                  lane);
  }
}

template <int D, typename TQ, typename TV>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Lq, int Lk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>(Lk, WARPS) * sizeof(float);
  auto kern = attention_kernel<D, TQ, TV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Lq + ROWS - 1) / ROWS);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TV*>(v), static_cast<TV*>(out), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int qk_dtype, int v_dtype, const void* q, const void* k,
             const void* v, void* out, int BH, int Lq, int Lk, float scale,
             int causal, cudaStream_t s) {
  if (qk_dtype == 0 && v_dtype == 0)
    return launch<D, float, float>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (qk_dtype == 1 && v_dtype == 1)
    return launch<D, __nv_bfloat16, __nv_bfloat16>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (qk_dtype == 0 && v_dtype == 1)
    return launch<D, float, __nv_bfloat16>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (qk_dtype == 1 && v_dtype == 0)
    return launch<D, __nv_bfloat16, float>(q, k, v, out, BH, Lq, Lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; D is 64 or 48.  Returns a
// cudaError_t.
extern "C" int ic_attention_core(int qk_dtype, int v_dtype, const void* q,
                                 const void* k, const void* v, void* out, int BH,
                                 int Lq, int Lk, int D, float scale, int causal,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dispatch<64>(qk_dtype, v_dtype, q, k, v, out, BH, Lq, Lk, scale, causal, s);
  if (D == 48)
    return dispatch<48>(qk_dtype, v_dtype, q, k, v, out, BH, Lq, Lk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
