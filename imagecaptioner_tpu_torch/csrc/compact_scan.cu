// Teacher-forced recurrence of the compact student's decoder (1-layer LSTM,
// dot attention, additive fusion), all T steps in one launch.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_lstm.py
// `_fused_compact_core_fwd_call` (`_kernel_compact_train`).  Per step t and
// batch row:
//   hp     = dtype(h)·W_a + b_a;  scores = hp·feats;  w = softmax_L(scores)
//   ctx    = sum_L w · feats
//   x0     = dtype(emb[t] + ctx)
//   gates  = x0·W_ih + dtype(h)·W_hh + b          (torch order i, f, g, o)
//   h and c stay float32 between steps.
// It writes h (T,B,H) in the compute dtype, attn (T,B,L) float32 and c
// (T,B,H) float32 (the residual the backward needs), always all three.  The
// compact decoder has no dropout, so there is no mask operand.
//
// What bounds it on the H100: every step is a chain of matrix-vector
// products over 1.2 MB of bf16 weights with a strict dependency from one
// step to the next; the bytes the function must move once are under 2 MB, so
// the HBM bound is microseconds and the kernel waits for the weight stream
// from L2 and the latency of the step chain.  Design, as decoder_scan.cu:
// one block of 512 threads owns one batch row for all T steps, the row's
// feats (L x E, float32) and the state live in shared memory, weights are
// read in their torch (out, in) layout, one warp per output row, 16-byte
// loads, four rows in flight per warp.  At B=16 only 16 of 132 SMs work.
// No library kernel (cuBLAS, cuDNN) is called.

#include "recurrent.cuh"

namespace {

template <typename T>
struct Args {
  const T* emb;         // (T, B, E)
  const T* feats;       // (B, L, E)
  const T* w_attn;      // (E, H)
  const float* b_attn;  // (E,)
  const T* w_ih;        // (4H, E)
  const T* w_hh;        // (4H, H)
  const float* b;       // (4H,)
  T* hs;                // (T, B, H)
  float* attn;          // (T, B, L)
  float* cs;            // (T, B, H)
  int steps, B, L, E, H;
};

// Shared-memory floats for one row (every array starts 16-byte aligned).
__host__ __device__ inline int smem_floats(int L, int E, int H) {
  return L * E + 2 * E + 2 * H + 4 * H + round4(L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) compact_scan_kernel(const Args<T> a) {
  const int L = a.L, E = a.E, H = a.H, B = a.B;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* feats_s = smem;                 // L*E
  float* hp_s = feats_s + L * E;         // E
  float* x0_s = hp_s + E;                // E, rounded
  float* hr_s = x0_s + E;                // H, h rounded
  float* c_s = hr_s + H;                 // H
  float* gates_s = c_s + H;              // 4H
  float* attn_s = gates_s + 4 * H;       // L (scores, then weights)

  const size_t row = (size_t)b * L * E;
  for (int i = tid; i < L * E; i += THREADS) feats_s[i] = to_f(a.feats[row + i]);
  for (int i = tid; i < H; i += THREADS) hr_s[i] = c_s[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    const size_t tb = (size_t)t * B + b;

    // attention query h·W_a + b_a
    gemv<T>(a.w_attn, H, H, hr_s, nullptr, 0, 0, nullptr, a.b_attn, E, hp_s);
    __syncthreads();

    // dot scores: one warp per feature token
    for (int l = warp; l < L; l += WARPS) {
      float s = 0.f;
      for (int e = lane; e < E; e += 32) s = fmaf(hp_s[e], feats_s[l * E + e], s);
      s = warp_sum(s);
      if (lane == 0) attn_s[l] = s;
    }
    __syncthreads();
    warp0_softmax<true>(attn_s, L, a.attn + tb * L);
    __syncthreads();

    // additive fusion: x0 = dtype(emb[t] + ctx)
    for (int e = tid; e < E; e += THREADS) {
      float c = 0.f;
      for (int l = 0; l < L; ++l) c = fmaf(attn_s[l], feats_s[l * E + e], c);
      x0_s[e] = round_to<T>(to_f(a.emb[tb * E + e]) + c);
    }
    __syncthreads();

    // the LSTM cell
    gemv<T>(a.w_ih, E, E, x0_s, a.w_hh, H, H, hr_s, a.b, 4 * H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float c = sigmoid(gates_s[H + j]) * c_s[j] +
                      sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
      const float h = sigmoid(gates_s[3 * H + j]) * tanhf(c);
      c_s[j] = c;
      hr_s[j] = round_to<T>(h);
      a.hs[tb * H + j] = from_f<T>(h);
      a.cs[tb * H + j] = c;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* const* p, int steps, int B, int L, int E, int H,
           cudaStream_t stream) {
  Args<T> a;
  a.emb = static_cast<const T*>(p[0]);
  a.feats = static_cast<const T*>(p[1]);
  a.w_attn = static_cast<const T*>(p[2]);
  a.b_attn = static_cast<const float*>(p[3]);
  a.w_ih = static_cast<const T*>(p[4]);
  a.w_hh = static_cast<const T*>(p[5]);
  a.b = static_cast<const float*>(p[6]);
  a.hs = static_cast<T*>(const_cast<void*>(p[7]));
  a.attn = static_cast<float*>(const_cast<void*>(p[8]));
  a.cs = static_cast<float*>(const_cast<void*>(p[9]));
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H;
  const size_t smem = (size_t)smem_floats(L, E, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      compact_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  compact_scan_kernel<T><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for these sizes, in bytes.
extern "C" long long ic_compact_scan_smem_bytes(int L, int E, int H) {
  return (long long)smem_floats(L, E, H) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (emb, feats, weights and hs; biases, attn
// and cs are float32).  ptrs: the 7 operands and 3 outputs in the order of
// Args.  Returns a cudaError_t.
extern "C" int ic_compact_scan(int dtype, const void* const* ptrs, int steps,
                               int B, int L, int E, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, steps, B, L, E, H, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ptrs, steps, B, L, E, H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
