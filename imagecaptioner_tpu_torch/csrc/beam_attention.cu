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
// copied around the call).  Numerics (the JAX cores'): scores accumulate in
// float32 and are scaled after the dot, softmax runs in float32 as
// exp(s - max) / sum, the weights are rounded to the cache's type before the
// product with v, which accumulates in float32.
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
// (N, H, L, 64).  One block per (image, head).  What bounds it on the H100
// is bytes: every (image, head) slice of K and V is read once (12.9 MB at
// the teacher's N=16, L=197, float32: 3.9 µs at 3.35 TB/s), for 2.6 MFLOP.
// So the block's first act is to put all of its bytes in flight: thread 0
// issues one bulk asynchronous copy (cp.async.bulk, the TMA's plain form)
// of the contiguous (L, 64) K slice and one of the V slice into shared
// memory, each completing on its own mbarrier, while the block loads its
// query rows.  The block scores as soon as K has landed, V still in flight:
// thread j takes key j for up to RG query rows at once, reading the key's
// row in an order rotated by j so that the 32 lanes of a warp hit 32
// different banks of the unpadded row.  A warp per query row takes max, sum
// and the normalised weights, rounded to the cache's type; then, once V has
// landed, thread (d, row group) sums P·V over the keys in order.  More than
// RG beams run in groups of RG over the same resident K/V.  The
// shared-memory ceiling is raised once per type and device, not per call.
//
// No library kernel (cuBLAS, cuDNN, SDPA) is called.

#include "recurrent.cuh"

namespace {

constexpr int D = 64;      // the teacher's head dimension
constexpr int MAX_S = 64;  // cache positions the self kernel takes
constexpr int MAX_L = 256; // memory tokens the cross kernel takes
constexpr int SELF_WARPS = 4;
constexpr int CROSS_THREADS = MAX_L;  // a key a thread
constexpr int RG = 8;                  // query rows a group (a warp each)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

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

// --- bulk asynchronous copies into shared memory, completing on an mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Thread 0: expect `bytes` on bar and copy them from global src to shared dst
// (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the first phase of bar (its copy) has completed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of the cross kernel: K and V as they lie in memory
// (L x 64 each), then RG query rows and RG rows of L weights in float32.
template <typename T>
__host__ __device__ inline size_t cross_smem(int L) {
  return align16(2 * (size_t)L * D * sizeof(T)) + 4 * ((size_t)RG * D + (size_t)RG * L);
}

// Score of key row kr (64 values, unpadded) against query rows q_s[0..nr):
// thread j reads the row from word j on, so a warp's lanes hit distinct banks.
template <int NR>
__device__ __forceinline__ void score_key(const float* kr, const float* q_s, int j,
                                          float* acc) {
#pragma unroll 8
  for (int i = 0; i < D; ++i) {
    const int d = (i + j) & (D - 1);
    const float k = kr[d];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = fmaf(q_s[r * D + d], k, acc[r]);
  }
}
template <int NR>
__device__ __forceinline__ void score_key(const __nv_bfloat16* kr, const float* q_s, int j,
                                          float* acc) {
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(kr);  // two keys' values a word
#pragma unroll 8
  for (int i = 0; i < D / 2; ++i) {
    const int w = (i + j) & (D / 2 - 1);
    const uint32_t u = kw[w];
    const float k0 = __uint_as_float(u << 16), k1 = __uint_as_float(u & 0xffff0000u);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float2 qv = *reinterpret_cast<const float2*>(q_s + r * D + 2 * w);
      acc[r] = fmaf(qv.y, k1, fmaf(qv.x, k0, acc[r]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CROSS_THREADS)
beam_cross_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ mk,
                  const T* __restrict__ mv, T* __restrict__ out, int out_stride,
                  int K, int H, int L, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];  // K landed, V landed
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)L * D;
  float* q_s = reinterpret_cast<float*>(smem + align16(2 * (size_t)L * D * sizeof(T)));
  float* p_s = q_s + RG * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t nh = blockIdx.x;  // (image, head)
  const int n = (int)(nh / H), h = (int)(nh % H);
  const uint32_t bytes = (uint32_t)(L * D * sizeof(T));

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(k_s, mk + nh * L * D, bytes, &bar[0]);
    bulk_load(v_s, mv + nh * L * D, bytes, &bar[1]);
  }

  for (int i0 = 0; i0 < K; i0 += RG) {
    const int nr = min(RG, K - i0);
    const size_t r0 = (size_t)n * K + i0;
    for (int i = tid; i < nr * D; i += CROSS_THREADS)
      q_s[i] = to_f(q[(r0 + i / D) * q_stride + h * D + i % D]);
    __syncthreads();  // also: the barriers are initialised before anyone waits

    // scores as soon as K has landed (V may still be in flight)
    bulk_wait(&bar[0]);
    if (tid < L) {
      float acc[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r] = 0.f;
      score_key<RG>(k_s + (size_t)tid * D, q_s, tid, acc);
      for (int r = 0; r < nr; ++r) p_s[r * L + tid] = acc[r] * scale;
    }
    __syncthreads();

    // a warp per query row: softmax, weights rounded to the cache's type
    if (warp < nr) {
      float* pr = p_s + warp * L;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, pr[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(pr[j] - m);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < L; j += 32) pr[j] = to_f(from_f<T>(pr[j] / sum));
    }
    __syncthreads();

    // P·V once V has landed: thread (d, g) sums rows g, g + 4 of the group
    bulk_wait(&bar[1]);
    const int d = tid % D;
    for (int r = tid / D; r < nr; r += CROSS_THREADS / D) {
      const float* pr = p_s + r * L;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(pr[j], to_f(v_s[(size_t)j * D + d]), acc);
      out[(r0 + r) * out_stride + h * D + d] = from_f<T>(acc);
    }
    __syncthreads();  // q_s and p_s are reused by the next group
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

// Raise the cross kernel's shared-memory ceiling to what L = MAX_L needs,
// once per type and device.
template <typename T>
cudaError_t cross_ceiling() {
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(beam_cross_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cross_smem<T>(MAX_L));
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T>
int launch_cross(const void* q, int q_stride, const void* mk, const void* mv,
                 void* out, int out_stride, int N, int K, int H, int L,
                 float scale, cudaStream_t stream) {
  const cudaError_t err = cross_ceiling<T>();
  if (err != cudaSuccess) return (int)err;
  beam_cross_kernel<T><<<N * H, CROSS_THREADS, cross_smem<T>(L), stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(mk),
      static_cast<const T*>(mv), static_cast<T*>(out), out_stride, K, H, L,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, the caches and out share one
// type).  Strides are in elements and must be even, like every pointer's
// offset (two values are loaded at once); the cross kernel's memory K and V
// must be 16-byte aligned (bulk copies).  Both return a cudaError_t.
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
  if (L <= 0 || L > MAX_L || K <= 0 || reinterpret_cast<uintptr_t>(mk) % 16 ||
      reinterpret_cast<uintptr_t>(mv) % 16)
    return (int)cudaErrorInvalidValue;
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
