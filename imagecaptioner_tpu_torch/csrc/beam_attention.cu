// Attention cores of one beam-search decode step.
//
// Replaces the TPU kernels of imagecaptioner_tpu/ops/pallas_beam_attn.py:
// `fused_beam_self_attention` (`_make_self_kernel`) and
// `fused_beam_cross_attention` (`_make_cross_kernel`).
//
// Rows: an image's K beams are the consecutive rows n*K .. n*K+K-1 of q and
// out, each row E = H*64 values with its heads side by side, a row's start
// `q_stride` / `out_stride` elements after the previous one (so q may be a
// column block of a packed q/k/v projection and nothing is transposed or
// copied around the call).
//
// Self: the cache k, v is head-major (R, H, S, 64) and is never reordered
// when beams are re-ranked.  anc (N, K, S) int32 names, for the beam now in
// slot i and each position s, the slot whose row holds that position of the
// beam's lineage.  The TPU kernel scores every query against all K slots
// and masks the others to -inf because its compiler wants 2-D tiles;
// exp(-inf) is exactly 0, so the same function is a gather: query (n, i, h)
// attends, at each s <= pos, row n*K + anc[n, i, s].  One warp per (row,
// head): per position the 32 lanes split the 64-wide dot (two neighbouring
// values a lane) and reduce with shuffles, one softmax over the lineage in
// float32, weights rounded to the cache type, context summed in float32.
//
// Cross: an image's K beams are K query rows over that image's memory K/V
// (N, H, L, 64): one block per (image, head) stages the head once and its
// warps take the K rows; the per-row work is attention.cuh's, shared with
// attention_core.cu.
//
// What bounds them on the H100: a step moves well under 10 MB (self: at
// most R*H*(pos+1) rows of 64 from k and from v; cross: N*H*L*64 of each)
// for a few MFLOP, so neither HBM nor arithmetic is the limit but latency:
// in the self kernel a warp's chain of small dependent loads, in the cross
// kernel the staging of one head by one block (PERF.md has the times beside
// the bounds).  The design therefore is one launch per core, no scratch in
// device memory, and no copy of q, k or v.
// No library kernel (cuBLAS, cuDNN, SDPA) is called.

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int D = 64;      // the teacher's head dimension
constexpr int MAX_S = 64;  // cache positions the self kernel takes
constexpr int SELF_WARPS = 4;
constexpr int CROSS_WARPS = 8;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(SELF_WARPS * 32)
beam_self_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ anc,
                 T* __restrict__ out, int out_stride, int R, int K, int H, int S,
                 int pos, float scale) {
  __shared__ float p_s[SELF_WARPS][MAX_S];
  __shared__ int row_s[SELF_WARPS][MAX_S];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int job = blockIdx.x * SELF_WARPS + warp;  // (row, head)
  if (job >= R * H) return;                        // uniform across the warp
  const int r = job / H, h = job % H;
  const int n = r / K;
  float* pw = p_s[warp];
  int* rows = row_s[warp];
  const int len = pos + 1;

  // the lineage: which cache row holds position s of this beam
  for (int s = lane; s < len; s += 32) rows[s] = n * K + anc[(size_t)r * S + s];
  __syncwarp();

  const float2 qv = load2(q + (size_t)r * q_stride + h * D + 2 * lane);
  for (int s = 0; s < len; ++s) {
    const T* kr = kc + (((size_t)rows[s] * H + h) * S + s) * D;
    const float2 kv = load2(kr + 2 * lane);
    const float sc = warp_sum(fmaf(qv.x, kv.x, qv.y * kv.y)) * scale;
    if (lane == 0) pw[s] = sc;
  }
  __syncwarp();

  float m = -INFINITY;
  for (int s = lane; s < len; s += 32) m = fmaxf(m, pw[s]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < len; s += 32) {
    const float e = expf(pw[s] - m);
    pw[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int s = lane; s < len; s += 32) pw[s] = to_f(from_f<T>(pw[s] / sum));
  __syncwarp();

  float a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < len; ++s) {
    const T* vr = vc + (((size_t)rows[s] * H + h) * S + s) * D;
    const float2 vv = load2(vr + 2 * lane);
    const float p = pw[s];
    a0 = fmaf(p, vv.x, a0);
    a1 = fmaf(p, vv.y, a1);
  }
  store2(out + (size_t)r * out_stride + h * D + 2 * lane, a0, a1);
}

template <typename T>
__global__ void __launch_bounds__(CROSS_WARPS * 32)
beam_cross_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ mk,
                  const T* __restrict__ mv, T* __restrict__ out, int out_stride,
                  int K, int H, int L, float scale) {
  extern __shared__ float smem[];
  const Smem<D> s(smem, L, CROSS_WARPS);
  const size_t nh = blockIdx.x;  // (image, head)
  const int n = nh / H, h = nh % H;
  stage_kv(mk + nh * L * D, mv + nh * L * D, L, s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < K; i += CROSS_WARPS) {
    const size_t r = (size_t)n * K + i;
    attend_row<D>(q + r * q_stride + h * D, out + r * out_stride + h * D, s,
                  s.q + warp * D, s.p + warp * L, L, L, scale, lane);
  }
}

template <typename T>
int launch_self(const void* q, int q_stride, const void* kc, const void* vc,
                const int* anc, void* out, int out_stride, int R, int K, int H,
                int S, int pos, float scale, cudaStream_t stream) {
  const int jobs = R * H;
  beam_self_kernel<T><<<(jobs + SELF_WARPS - 1) / SELF_WARPS, SELF_WARPS * 32, 0,
                        stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(kc),
      static_cast<const T*>(vc), anc, static_cast<T*>(out), out_stride, R, K, H,
      S, pos, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cross(const void* q, int q_stride, const void* mk, const void* mv,
                 void* out, int out_stride, int N, int K, int H, int L,
                 float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>(L, CROSS_WARPS) * sizeof(float);
  auto kern = beam_cross_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<N * H, CROSS_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(mk),
      static_cast<const T*>(mv), static_cast<T*>(out), out_stride, K, H, L,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, the caches and out share one
// type).  Strides are in elements and must be even, like every pointer's
// offset (two values are loaded at once).  Both return a cudaError_t.
extern "C" int ic_beam_self_attention(int dtype, const void* q, int q_stride,
                                      const void* kc, const void* vc,
                                      const void* anc, void* out, int out_stride,
                                      int R, int K, int H, int S, int pos,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > MAX_S || pos < 0 || pos >= S || K <= 0 || R % K != 0 ||
      q_stride % 2 != 0 || out_stride % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int* a = static_cast<const int*>(anc);
  if (dtype == 0)
    return launch_self<float>(q, q_stride, kc, vc, a, out, out_stride, R, K, H,
                              S, pos, scale, st);
  if (dtype == 1)
    return launch_self<__nv_bfloat16>(q, q_stride, kc, vc, a, out, out_stride,
                                      R, K, H, S, pos, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ic_beam_cross_attention(int dtype, const void* q, int q_stride,
                                       const void* mk, const void* mv, void* out,
                                       int out_stride, int N, int K, int H, int L,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cross<float>(q, q_stride, mk, mv, out, out_stride, N, K, H, L,
                               scale, st);
  if (dtype == 1)
    return launch_cross<__nv_bfloat16>(q, q_stride, mk, mv, out, out_stride, N,
                                       K, H, L, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
