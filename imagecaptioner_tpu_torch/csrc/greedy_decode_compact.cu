// Whole-loop greedy decode for the compact student (1-layer LSTM, dot
// attention, additive fusion, plain linear head), all max_length steps in one
// launch.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_greedy.py
// `pallas_greedy_decode_compact` (`_make_compact_kernel`).  Per step and
// batch row:
//   emb    = table[tok]                       (a row read, not a one-hot product)
//   hp     = dtype(h)·W_a + b_a;  scores = hp·feats;  w = softmax_L(scores)
//   ctx    = sum_L w · feats
//   x0     = dtype(emb + ctx)
//   one LSTM cell (torch gate order i, f, g, o), float32 h/c state, the
//   products read h rounded to the weight dtype
//   logits = dtype(h)·W_out + b_out, divided by temperature
//   next   = argmax (lowest index wins ties); END -> PAD from then on, and a
//            finished row keeps feeding its last real token.
//
// What bounds it on the H100: every step is a chain of matrix-vector
// products over ~2.7 MB of bf16 weights (head 1.5 MB, LSTM 1.0 MB, attention
// 0.1 MB) with a strict dependency from one step to the next, so the kernel
// waits for the weight stream from L2 and the latency of the step chain, not
// for arithmetic or HBM.  Design, as greedy_decode.cu: batch rows are
// independent, one block of 512 threads owns one row for all steps; the
// row's feats (49x256) and the state live in shared memory; weights are read
// in their torch (out, in) layout, one warp per output row, 16-byte loads,
// four rows in flight per warp, and stay in the 50 MB L2 across rows and
// steps.  No library kernel (cuBLAS, cuDNN) is called.

#include "recurrent.cuh"

namespace {

template <typename T>
struct Args {
  const T* emb;         // (V, E)
  const T* feats;       // (B, L, E)
  const T* w_attn;      // (E, H)
  const float* b_attn;  // (E,)
  const T* w_ih;        // (4H, E)
  const T* w_hh;        // (4H, H)
  const float* b;       // (4H,)
  const T* out_w;       // (V, H)
  const float* out_b;   // (V,)
  int32_t* out;         // (B, T)
  int L, E, H, V, steps;
  float temperature;
};

// Shared-memory floats for one row (every array starts 16-byte aligned).
__host__ __device__ inline int smem_floats(int L, int E, int H, int V) {
  return L * E + 2 * E + 2 * H + 4 * H + round4(L) + 2 * WARPS + round4(V);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) greedy_compact_kernel(const Args<T> a) {
  const int L = a.L, E = a.E, H = a.H, V = a.V;
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
  float* red_v = attn_s + round4(L);     // WARPS
  int* red_i = reinterpret_cast<int*>(red_v + WARPS);  // WARPS
  float* logits_s = red_v + 2 * WARPS;   // V
  __shared__ int tok_s, done_s;

  const size_t row = (size_t)b * L * E;
  for (int i = tid; i < L * E; i += THREADS) feats_s[i] = to_f(a.feats[row + i]);
  for (int i = tid; i < H; i += THREADS) hr_s[i] = c_s[i] = 0.f;
  if (tid == 0) {
    tok_s = TOK_START;
    done_s = 0;
  }
  __syncthreads();

  for (int t = 0; t < a.steps; ++t) {
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
    warp0_softmax<false>(attn_s, L, nullptr);
    __syncthreads();

    // additive fusion: x0 = dtype(emb + ctx)
    const T* er = a.emb + (size_t)tok_s * E;
    for (int e = tid; e < E; e += THREADS) {
      float c = 0.f;
      for (int l = 0; l < L; ++l) c = fmaf(attn_s[l], feats_s[l * E + e], c);
      x0_s[e] = round_to<T>(to_f(er[e]) + c);
    }
    __syncthreads();

    // the LSTM cell
    gemv<T>(a.w_ih, E, E, x0_s, a.w_hh, H, H, hr_s, a.b, 4 * H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float c = sigmoid(gates_s[H + j]) * c_s[j] +
                      sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
      c_s[j] = c;
      hr_s[j] = round_to<T>(sigmoid(gates_s[3 * H + j]) * tanhf(c));
    }
    __syncthreads();

    // head and argmax of logits / temperature
    gemv<T>(a.out_w, H, H, hr_s, nullptr, 0, 0, nullptr, a.out_b, V, logits_s);
    __syncthreads();
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
  a.feats = static_cast<const T*>(p[1]);
  a.w_attn = static_cast<const T*>(p[2]);
  a.b_attn = static_cast<const float*>(p[3]);
  a.w_ih = static_cast<const T*>(p[4]);
  a.w_hh = static_cast<const T*>(p[5]);
  a.b = static_cast<const float*>(p[6]);
  a.out_w = static_cast<const T*>(p[7]);
  a.out_b = static_cast<const float*>(p[8]);
  a.out = out;
  a.L = L; a.E = E; a.H = H; a.V = V; a.steps = T_;
  a.temperature = temperature;
  const size_t smem = (size_t)smem_floats(L, E, H, V) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_compact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  greedy_compact_kernel<T><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for these sizes, in bytes.
extern "C" long long ic_greedy_compact_smem_bytes(int L, int E, int H, int V) {
  return (long long)smem_floats(L, E, H, V) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (table, feats and weights; biases are
// float32).  ptrs: the 9 operands in the order of Args.  Returns a
// cudaError_t.
extern "C" int ic_greedy_decode_compact(int dtype, const void* const* ptrs,
                                        int32_t* out, int B, int L, int E, int H,
                                        int V, int T, float temperature,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, out, B, L, E, H, V, T, temperature, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ptrs, out, B, L, E, H, V, T, temperature, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
