// Whole-loop greedy decode for the full student (2-layer LSTM, Bahdanau
// attention), all max_length steps in one launch.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_greedy.py
// `pallas_greedy_decode_student` (`_make_kernel`).  Per step and batch row:
//   emb    = table[tok]
//   scores = sum_E tanh(f_proj + h1·W_h);  w = softmax_L(scores)
//   ctx    = sum_L w · feats
//   x0     = dtype(emb·W_e + dtype(ctx)·W_c + b_comb)
//   two LSTM cells (torch gate order i, f, g, o) with float32 h/c state;
//   the matmul inputs are h rounded to the weight dtype
//   logits = dtype(relu(dtype(h1)·fc1 + b))·fc2 + b, divided by temperature
//   next   = argmax (lowest index wins ties); END -> PAD from then on, and a
//            finished row keeps feeding its last real token.
// f_proj = feats·W_f + b_attn is computed outside, as in pallas_greedy.py.
//
// What bounds it on the H100: at B=32 every step is a chain of
// matrix-vector products over ~9.5 MB of bf16 weights (LSTM 7.3 MB, fc2
// 1.5 MB, attention and combine 0.5 MB) with a strict dependency from one
// step to the next, so the kernel is bound by how fast the weights stream
// from L2 into the SMs and by the latency of the step chain, not by
// arithmetic.  Design: batch rows are independent, so one block of 512
// threads owns one row for all steps and needs no grid-wide barrier.  The
// row's feats and f_proj (49x256 each) and all recurrent state stay in
// shared memory; the weights are read in their torch (out, in) layout, one
// warp per output row, 16-byte loads along the row, four rows in flight per
// warp; the whole weight set stays resident in the 50 MB L2 across rows and
// steps.  Splitting the gate columns of every step across all SMs (a
// persistent kernel with a grid barrier) is the later speed work.
// No library kernel (cuBLAS, cuDNN) is called.

#include "recurrent.cuh"

namespace {

template <typename T>
struct Args {
  const T* emb;      // (V, E)
  const T* f_proj;   // (B, L, E)
  const T* feats;    // (B, L, E)
  const T* w_attn;   // (E, H + E); columns [0, H) are W_h
  const T* w_comb;   // (E, 2E) = [W_e | W_c]
  const float* b_comb;
  const T* w_ih0;    // (4H, E)
  const T* w_hh0;    // (4H, H)
  const float* b0;   // (4H,)
  const T* w_ih1;    // (4H, H)
  const T* w_hh1;    // (4H, H)
  const float* b1;
  const T* fc1_w;    // (E, H)
  const float* fc1_b;
  const T* fc2_w;    // (V, E)
  const float* fc2_b;
  int32_t* out;      // (B, T)
  int L, E, H, V, steps;  // steps = max_length
  float temperature;
};

// Shared-memory floats for one row (every array starts 16-byte aligned).
__host__ __device__ inline int smem_floats(int L, int E, int H, int V) {
  return 2 * L * E + 5 * E + 4 * H + 4 * H + round4(L) + 2 * WARPS + round4(V);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) greedy_kernel(const Args<T> a) {
  const int L = a.L, E = a.E, H = a.H, V = a.V;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* feats_s = smem;                // L*E
  float* fproj_s = feats_s + L * E;      // L*E
  float* emb_s = fproj_s + L * E;        // E
  float* hw_s = emb_s + E;               // E
  float* ctx_s = hw_s + E;               // E, rounded
  float* x0_s = ctx_s + E;               // E, rounded
  float* hid_s = x0_s + E;               // E, rounded
  float* hr0_s = hid_s + E;              // H, h0 rounded
  float* hr1_s = hr0_s + H;              // H, h1 rounded
  float* c0_s = hr1_s + H;               // H
  float* c1_s = c0_s + H;                // H
  float* gates_s = c1_s + H;             // 4H
  float* attn_s = gates_s + 4 * H;       // L (scores, then weights)
  float* red_v = attn_s + round4(L);     // WARPS
  int* red_i = reinterpret_cast<int*>(red_v + WARPS);  // WARPS
  float* logits_s = red_v + 2 * WARPS;   // V
  __shared__ int tok_s, done_s;

  const size_t row = (size_t)b * L * E;
  for (int i = tid; i < L * E; i += THREADS) {
    feats_s[i] = to_f(a.feats[row + i]);
    fproj_s[i] = to_f(a.f_proj[row + i]);
  }
  for (int i = tid; i < H; i += THREADS) hr0_s[i] = hr1_s[i] = c0_s[i] = c1_s[i] = 0.f;
  if (tid == 0) {
    tok_s = TOK_START;
    done_s = 0;
  }
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
    // embedding row and the attention query h1·W_h
    const T* er = a.emb + (size_t)tok_s * E;
    for (int i = tid; i < E; i += THREADS) emb_s[i] = to_f(er[i]);
    gemv<T>(a.w_attn, H + E, H, hr1_s, nullptr, 0, 0, nullptr, nullptr, E, hw_s);
    __syncthreads();

    // Bahdanau scores: one warp per feature token
    for (int l = warp; l < L; l += WARPS) {
      float s = 0.f;
      for (int e = lane; e < E; e += 32) s += tanhf(fproj_s[l * E + e] + hw_s[e]);
      s = warp_sum(s);
      if (lane == 0) attn_s[l] = s;
    }
    __syncthreads();

    warp0_softmax<false>(attn_s, L, nullptr);
    __syncthreads();

    // context, rounded to the weight dtype for the combine
    for (int e = tid; e < E; e += THREADS) {
      float c = 0.f;
      for (int l = 0; l < L; ++l) c = fmaf(attn_s[l], feats_s[l * E + e], c);
      ctx_s[e] = round_to<T>(c);
    }
    __syncthreads();

    // combine: x0 = emb·W_e + ctx·W_c + b_comb
    gemv<T>(a.w_comb, 2 * E, E, emb_s, a.w_comb + E, 2 * E, E, ctx_s, a.b_comb, E, x0_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) x0_s[e] = round_to<T>(x0_s[e]);
    __syncthreads();

    // LSTM layer 0
    gemv<T>(a.w_ih0, E, E, x0_s, a.w_hh0, H, H, hr0_s, a.b0, 4 * H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float c = sigmoid(gates_s[H + j]) * c0_s[j] +
                      sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
      c0_s[j] = c;
      hr0_s[j] = round_to<T>(sigmoid(gates_s[3 * H + j]) * tanhf(c));
    }
    __syncthreads();

    // LSTM layer 1: input is the new h0, recurrent input the old h1
    gemv<T>(a.w_ih1, H, H, hr0_s, a.w_hh1, H, H, hr1_s, a.b1, 4 * H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float c = sigmoid(gates_s[H + j]) * c1_s[j] +
                      sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
      c1_s[j] = c;
      hr1_s[j] = round_to<T>(sigmoid(gates_s[3 * H + j]) * tanhf(c));
    }
    __syncthreads();

    // output MLP
    gemv<T>(a.fc1_w, H, H, hr1_s, nullptr, 0, 0, nullptr, a.fc1_b, E, hid_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) hid_s[e] = round_to<T>(fmaxf(hid_s[e], 0.f));
    __syncthreads();
    gemv<T>(a.fc2_w, E, E, hid_s, nullptr, 0, 0, nullptr, a.fc2_b, V, logits_s);
    __syncthreads();

    // argmax of logits / temperature
    const int next = block_argmax(logits_s, V, a.temperature, red_v, red_i);
    if (tid == 0) emit_token(next, a.out + (size_t)b * a.steps + t, &tok_s, &done_s);
    __syncthreads();
  }
}

template <typename T>
int launch(const void* const* p, int32_t* out, int B, int L, int E, int H,
           int V, int T_, float temperature, cudaStream_t stream) {
  Args<T> a;
  a.emb = static_cast<const T*>(p[0]);
  a.f_proj = static_cast<const T*>(p[1]);
  a.feats = static_cast<const T*>(p[2]);
  a.w_attn = static_cast<const T*>(p[3]);
  a.w_comb = static_cast<const T*>(p[4]);
  a.b_comb = static_cast<const float*>(p[5]);
  a.w_ih0 = static_cast<const T*>(p[6]);
  a.w_hh0 = static_cast<const T*>(p[7]);
  a.b0 = static_cast<const float*>(p[8]);
  a.w_ih1 = static_cast<const T*>(p[9]);
  a.w_hh1 = static_cast<const T*>(p[10]);
  a.b1 = static_cast<const float*>(p[11]);
  a.fc1_w = static_cast<const T*>(p[12]);
  a.fc1_b = static_cast<const float*>(p[13]);
  a.fc2_w = static_cast<const T*>(p[14]);
  a.fc2_b = static_cast<const float*>(p[15]);
  a.out = out;
  a.L = L; a.E = E; a.H = H; a.V = V; a.steps = T_;
  a.temperature = temperature;
  const size_t smem = (size_t)smem_floats(L, E, H, V) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  greedy_kernel<T><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for these sizes, in bytes.
extern "C" long long ic_greedy_smem_bytes(int L, int E, int H, int V) {
  return (long long)smem_floats(L, E, H, V) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (weights, feats and f_proj; biases are
// float32).  ptrs: the 16 operands in the order of Args.  Returns a
// cudaError_t.
extern "C" int ic_greedy_decode(int dtype, const void* const* ptrs, int32_t* out,
                                int B, int L, int E, int H, int V, int T,
                                float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, out, B, L, E, H, V, T, temperature, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ptrs, out, B, L, E, H, V, T, temperature, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
