// Teacher-forced recurrence of the full student's decoder (2-layer LSTM with
// Bahdanau attention), all T steps in one launch; eval and training forms in
// one kernel.
//
// Replaces the TPU kernels of imagecaptioner_tpu/ops/pallas_lstm.py:
// `pallas_full_decoder_scan` (`_kernel`) and, with the residual outputs and
// the dropout mask, `_fused_core_fwd_call` (`_kernel_train`).  Per step t and
// batch row:
//   hw     = dtype(h1)·W_h
//   scores = sum_E tanh(f_proj + hw);  w = softmax_L(scores)      (float32)
//   ctx    = sum_L w · feats
//   x0     = dtype(emb_w[t] + dtype(ctx)·W_c)
//   layer 0: gates = x0·W_ih0 + dtype(h0)·W_hh0 + b0   (torch order i,f,g,o)
//   layer 1 reads dtype(h0_new · mask[t]); layer 0's own recurrence keeps the
//   undropped h0_new.  h and c stay float32 between steps.
// It writes h_tops (T,B,H) in the compute dtype and attn (T,B,L) float32;
// with residual pointers given also h0 (T,B,H) compute dtype and c0, c1
// (T,B,H) float32.  f_proj = feats·W_f + b_attn and emb_w = emb·W_e + b_comb
// are computed outside, as in pallas_lstm.py.
//
// What bounds it on the H100: every step is a chain of matrix-vector
// products over the LSTM, attention and combine weights (7.7 MB in bf16,
// 15.4 MB in float32) with a strict dependency from one step to the next.
// The bytes the function must move once are small (weights + the T-length
// streams), so the HBM bound is microseconds; what the kernel really waits
// for is the weight stream from L2 into each SM and the latency of the step
// chain.  Design: batch rows are independent, so one block of 512 threads
// owns one row for all T steps and needs no grid-wide barrier.  The row's
// feats and f_proj (L x E each, float32) and all recurrent state live in
// shared memory; weights are read in their torch (out, in) layout, one warp
// per output row with 16-byte loads, four rows in flight per warp, and stay
// resident in the 50 MB L2 across rows and steps.  At B=16 only 16 of the
// 132 SMs work; splitting each step's gate columns across SMs is later
// speed work.  No library kernel (cuBLAS, cuDNN) is called.

#include "recurrent.cuh"

namespace {

template <typename T>
struct Args {
  const T* emb_w;     // (T, B, E)
  const T* f_proj;    // (B, L, E)
  const T* feats;     // (B, L, E)
  const float* mask;  // (T, B, H) or null (no dropout)
  const T* w_h;       // (E, H), leading dimension ld_h
  const T* w_c;       // (E, E), leading dimension ld_c
  const T* w_ih0;     // (4H, E)
  const T* w_hh0;     // (4H, H)
  const float* b0;    // (4H,)
  const T* w_ih1;     // (4H, H)
  const T* w_hh1;     // (4H, H)
  const float* b1;    // (4H,)
  T* h_tops;          // (T, B, H)
  float* attn;        // (T, B, L)
  T* h0s;             // (T, B, H) or null: the three residuals come together
  float* c0s;         // (T, B, H)
  float* c1s;         // (T, B, H)
  int steps, B, L, E, H, ld_h, ld_c;
};

// Shared-memory floats for one row (every array starts 16-byte aligned).
__host__ __device__ inline int smem_floats(int L, int E, int H) {
  return 2 * L * E + 3 * E + 5 * H + 4 * H + round4(L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) scan_kernel(const Args<T> a) {
  const int L = a.L, E = a.E, H = a.H, B = a.B;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* feats_s = smem;                // L*E
  float* fproj_s = feats_s + L * E;      // L*E
  float* hw_s = fproj_s + L * E;         // E
  float* ctx_s = hw_s + E;               // E, rounded
  float* x0_s = ctx_s + E;               // E, rounded
  float* hr0_s = x0_s + E;               // H, h0 rounded
  float* hr1_s = hr0_s + H;              // H, h1 rounded
  float* hfed_s = hr1_s + H;             // H, dtype(h0 * mask)
  float* c0_s = hfed_s + H;              // H
  float* c1_s = c0_s + H;                // H
  float* gates_s = c1_s + H;             // 4H
  float* attn_s = gates_s + 4 * H;       // L (scores, then weights)

  const size_t row = (size_t)b * L * E;
  for (int i = tid; i < L * E; i += THREADS) {
    feats_s[i] = to_f(a.feats[row + i]);
    fproj_s[i] = to_f(a.f_proj[row + i]);
  }
  for (int i = tid; i < H; i += THREADS) hr0_s[i] = hr1_s[i] = c0_s[i] = c1_s[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    const size_t tb = (size_t)t * B + b;

    // attention query h1·W_h
    gemv<T>(a.w_h, a.ld_h, H, hr1_s, nullptr, 0, 0, nullptr, nullptr, E, hw_s);
    __syncthreads();

    // Bahdanau scores: one warp per feature token
    for (int l = warp; l < L; l += WARPS) {
      float s = 0.f;
      for (int e = lane; e < E; e += 32) s += tanhf(fproj_s[l * E + e] + hw_s[e]);
      s = warp_sum(s);
      if (lane == 0) attn_s[l] = s;
    }
    __syncthreads();

    warp0_softmax<true>(attn_s, L, a.attn + tb * L);
    __syncthreads();

    // context, rounded to the weight dtype for the combine
    for (int e = tid; e < E; e += THREADS) {
      float c = 0.f;
      for (int l = 0; l < L; ++l) c = fmaf(attn_s[l], feats_s[l * E + e], c);
      ctx_s[e] = round_to<T>(c);
    }
    __syncthreads();

    // combine: x0 = emb_w[t] + ctx·W_c
    gemv<T>(a.w_c, a.ld_c, E, ctx_s, nullptr, 0, 0, nullptr, nullptr, E, x0_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS)
      x0_s[e] = round_to<T>(to_f(a.emb_w[tb * E + e]) + x0_s[e]);
    __syncthreads();

    // LSTM layer 0
    gemv<T>(a.w_ih0, E, E, x0_s, a.w_hh0, H, H, hr0_s, a.b0, 4 * H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float c = sigmoid(gates_s[H + j]) * c0_s[j] +
                      sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
      const float h = sigmoid(gates_s[3 * H + j]) * tanhf(c);
      c0_s[j] = c;
      hr0_s[j] = round_to<T>(h);
      hfed_s[j] = a.mask ? round_to<T>(h * a.mask[tb * H + j]) : hr0_s[j];
      if (a.h0s) {
        a.h0s[tb * H + j] = from_f<T>(h);
        a.c0s[tb * H + j] = c;
      }
    }
    __syncthreads();

    // LSTM layer 1: input is the dropped new h0, recurrent input the old h1
    gemv<T>(a.w_ih1, H, H, hfed_s, a.w_hh1, H, H, hr1_s, a.b1, 4 * H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float c = sigmoid(gates_s[H + j]) * c1_s[j] +
                      sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
      const float h = sigmoid(gates_s[3 * H + j]) * tanhf(c);
      c1_s[j] = c;
      hr1_s[j] = round_to<T>(h);
      a.h_tops[tb * H + j] = from_f<T>(h);
      if (a.h0s) a.c1s[tb * H + j] = c;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* const* p, int steps, int B, int L, int E, int H, int ld_h,
           int ld_c, cudaStream_t stream) {
  Args<T> a;
  a.emb_w = static_cast<const T*>(p[0]);
  a.f_proj = static_cast<const T*>(p[1]);
  a.feats = static_cast<const T*>(p[2]);
  a.mask = static_cast<const float*>(p[3]);
  a.w_h = static_cast<const T*>(p[4]);
  a.w_c = static_cast<const T*>(p[5]);
  a.w_ih0 = static_cast<const T*>(p[6]);
  a.w_hh0 = static_cast<const T*>(p[7]);
  a.b0 = static_cast<const float*>(p[8]);
  a.w_ih1 = static_cast<const T*>(p[9]);
  a.w_hh1 = static_cast<const T*>(p[10]);
  a.b1 = static_cast<const float*>(p[11]);
  a.h_tops = static_cast<T*>(const_cast<void*>(p[12]));
  a.attn = static_cast<float*>(const_cast<void*>(p[13]));
  a.h0s = static_cast<T*>(const_cast<void*>(p[14]));
  a.c0s = static_cast<float*>(const_cast<void*>(p[15]));
  a.c1s = static_cast<float*>(const_cast<void*>(p[16]));
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H;
  a.ld_h = ld_h; a.ld_c = ld_c;
  const size_t smem = (size_t)smem_floats(L, E, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<T><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for these sizes, in bytes.
extern "C" long long ic_decoder_scan_smem_bytes(int L, int E, int H) {
  return (long long)smem_floats(L, E, H) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (emb_w, f_proj, feats, weights, h_tops
// and h0s; biases, mask, attn, c0s and c1s are float32).  ptrs: the 17
// operands and outputs in the order of Args; mask may be null, and h0s, c0s,
// c1s are null together for the eval form.  Returns a cudaError_t.
extern "C" int ic_decoder_scan(int dtype, const void* const* ptrs, int steps,
                               int B, int L, int E, int H, int ld_h, int ld_c,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, steps, B, L, E, H, ld_h, ld_c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ptrs, steps, B, L, E, H, ld_h, ld_c, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
