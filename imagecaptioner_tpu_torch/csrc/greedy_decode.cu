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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAD = 0, START = 1, END = 2;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;  // weight rows each warp streams at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// (value, index) a beats (value, index) b under jnp.argmax: NaN is the
// largest value, and the lower index wins a tie.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

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

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

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
    tok_s = START;
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

    // softmax over L in warp 0
    if (warp == 0) {
      float m = -INFINITY;
      for (int l = lane; l < L; l += 32) m = fmaxf(m, attn_s[l]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float e = expf(attn_s[l] - m);
        attn_s[l] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int l = lane; l < L; l += 32) attn_s[l] = attn_s[l] / sum;
    }
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
    float best = -INFINITY;
    int bi = V;
    for (int v = tid; v < V; v += THREADS) {
      float x = logits_s[v];
      if (a.temperature != 1.f) x = x / a.temperature;
      if (beats(x, v, best, bi)) {
        best = x;
        bi = v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (beats(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      best = red_v[0];
      bi = red_i[0];
      for (int w = 1; w < WARPS; ++w)
        if (beats(red_v[w], red_i[w], best, bi)) {
          best = red_v[w];
          bi = red_i[w];
        }
      const int is_end = bi == END;
      a.out[(size_t)b * a.steps + t] = (done_s || is_end) ? PAD : bi;
      done_s = done_s || is_end;
      if (!done_s) tok_s = bi;
    }
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
