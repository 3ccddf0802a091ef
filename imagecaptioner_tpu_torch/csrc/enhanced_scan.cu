// Teacher-forced recurrence of the enhanced student's decoder, all T steps in
// one launch: multi-head image attention with a learned query projection,
// gated word/context fusion, three LSTM cells each followed by LayerNorm and
// dropout, and a highway output gate.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_enhanced.py
// `_fused_enhanced_core_fwd_call` (`_kernel_enhanced_train`).  Per step t and
// batch row (h0, h1, h2 are the layers' states after LayerNorm and dropout,
// float32 between steps; every matrix product reads its input rounded to
// the weight dtype and accumulates in float32):
//   q      = h2·W_qp + b_qp                                  (H -> E)
//   qh     = q·W_q + b_q, split into nh heads of hd = E / nh
//   per head: s = qh·K_h / sqrt(hd);  w = softmax_L(s);  wd = w · amask[t]
//             ctx_h = sum_L wd · V_h
//   ctx    = concat(ctx_h)·W_o + b_o;  attn = mean over heads of wd
//   gate   = sigmoid(gate_w[t] + ctx·W_gc);  fused = gate·embp[t] + (1-gate)·ctx
//   layer i: cell(x, h_i, c_i), then LayerNorm over H (biased variance, eps
//            1e-5, float32), then · lmask[i, t]; x is fused, then h0, then h1
//   ctxh   = ctx·W_cp + b_cp;  g = sigmoid(h2·W_hh' + ctx·W_hc + b_hw)
//   enh    = g·h2 + (1-g)·ctxh
// It writes h_tops (= h2), enh, h0s, h1s (T,B,H) in the compute dtype, attn
// (T,B,L) float32 and c0s, c1s, c2s (T,B,H) float32: the residuals of the
// reverse-time backward.  embp, gate_w (the word half of the gate with its
// bias) and the per-head K and V are computed outside, as in
// pallas_enhanced.py; the weights come in their torch (out, in) layout and
// are not split per head: the Pallas kernel's per-head operands serve its
// compiler's lane alignment, and a head here is a run of hd consecutive
// rows or columns.  amask and lmask may be null (all ones).
//
// What bounds it on the H100: a step reads 14.9 M weight elements for every
// batch row (six LSTM matrices 13.0 M, highway 1.2 M, attention projections
// 0.7 M): 30 MB in bf16, which the 50 MB L2 holds, 60 MB in float32, which it
// does not.  The bytes the function must move once are the weights and the
// T-length streams, tens of microseconds of HBM time; what the kernel waits
// for is each SM's weight stream (every row re-reads every matrix at every
// step) and the latency of the step chain.  Design: batch rows are
// independent, so one block of 512 threads owns one row for all T steps and
// needs no grid-wide barrier; all of the row's state (three h, three c, q,
// ctx, the nh x L scores) lives in shared memory, K and V of the row are
// read from L2 in place (staging them would take 196 KB in float32), the
// matrix-vector products are recurrent.cuh's (one warp per output row,
// 16-byte loads, four rows in flight per warp).  At B=16 only 16 of 132 SMs
// work; a block that takes several rows, or gate columns split across
// blocks, is the later speed work.  No library kernel is called.

#include "recurrent.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;

template <typename T>
struct Args {
  const T* embp;        // (T, B, E)
  const float* gate_w;  // (T, B, E)
  const T* k;           // (B, nh, L, hd)
  const T* v;           // (B, nh, L, hd)
  const float* amask;   // (T, B, nh, L) or null
  const float* lmask;   // (3, T, B, H) or null
  const T* wqp;         // (E, H)
  const float* bqp;     // (E,)
  const T* wq;          // (E, E)
  const float* bq;      // (E,)
  const T* wo;          // (E, E)
  const float* bo;      // (E,)
  const T* wg_c;        // (E, E)
  const T* wih[3];      // (4H, E), (4H, H), (4H, H)
  const T* whh[3];      // (4H, H)
  const float* bl[3];   // (4H,)
  const float* ln_g;    // (3, H)
  const float* ln_b;    // (3, H)
  const T* whg_h;       // (H, H)
  const T* whg_c;       // (H, E)
  const float* bhw;     // (H,)
  const T* wcp;         // (H, E)
  const float* bcp;     // (H,)
  T* h_tops;            // (T, B, H)
  T* enh;               // (T, B, H)
  float* attn;          // (T, B, L)
  T* hs[2];             // h0s, h1s (T, B, H)
  float* cs[3];         // c0s, c1s, c2s (T, B, H)
  int steps, B, L, E, H, nh;
};

// Shared-memory floats for one row (every array starts 16-byte aligned).
__host__ __device__ inline int smem_floats(int L, int E, int H, int nh) {
  return 6 * E + 13 * H + round4(nh * L) + 2 * WARPS;
}

// Sum of v over the block's threads; red holds WARPS floats.  Ends with the
// result in every thread and red free to reuse after the next barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) enhanced_scan_kernel(const Args<T> a) {
  const int L = a.L, E = a.E, H = a.H, B = a.B, nh = a.nh;
  const int hd = E / nh;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float scale = 1.f / sqrtf((float)hd);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // E, q rounded
  float* qh_s = q_s + E;              // E, per-head queries
  float* cat_s = qh_s + E;            // E, concat of ctx_h, rounded
  float* ctx_s = cat_s + E;           // E, float32 context
  float* ctxr_s = ctx_s + E;          // E, context rounded
  float* x_s = ctxr_s + E;            // E, gate pre-activation, then fused rounded
  float* hr_s = x_s + E;              // 3H, the layers' h rounded
  float* c_s = hr_s + 3 * H;          // 3H
  float* h2_s = c_s + 3 * H;          // H, this step's h2 in float32
  float* rh_s = h2_s + H;             // H, a cell's raw output
  float* gates_s = rh_s + H;          // 4H
  float* hw_s = gates_s + 4 * H;      // H, highway context projection
  float* sc_s = hw_s + H;             // nh*L, scores, then dropped weights
  float* red_s = sc_s + round4(nh * L);  // 2*WARPS

  for (int i = tid; i < 3 * H; i += THREADS) hr_s[i] = c_s[i] = 0.f;
  __syncthreads();

  const T* krow = a.k + (size_t)b * nh * L * hd;
  const T* vrow = a.v + (size_t)b * nh * L * hd;

  for (int t = 0; t < a.steps; ++t) {
    const size_t tb = (size_t)t * B + b;

    // --- query chain: q = h2·W_qp + b, qh = q·W_q + b ----------------------
    gemv<T>(a.wqp, H, H, hr_s + 2 * H, nullptr, 0, 0, nullptr, a.bqp, E, q_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) q_s[e] = round_to<T>(q_s[e]);
    __syncthreads();
    gemv<T>(a.wq, E, E, q_s, nullptr, 0, 0, nullptr, a.bq, E, qh_s);
    __syncthreads();

    // --- attention: one warp per head --------------------------------------
    for (int h = warp; h < nh; h += WARPS) {
      const float* qh = qh_s + h * hd;
      float* sc = sc_s + h * L;
      const T* kh = krow + (size_t)h * L * hd;
      const T* vh = vrow + (size_t)h * L * hd;
      float m = -INFINITY;
      for (int l = lane; l < L; l += 32) {
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qh[d], to_f(kh[l * hd + d]), s);
        s *= scale;
        sc[l] = s;
        m = fmaxf(m, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float e = expf(sc[l] - m);
        sc[l] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float* am = a.amask ? a.amask + (tb * nh + h) * L : nullptr;
      for (int l = lane; l < L; l += 32) sc[l] = sc[l] / sum * (am ? am[l] : 1.f);
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float c = 0.f;
        for (int l = 0; l < L; ++l) c = fmaf(sc[l], to_f(vh[l * hd + d]), c);
        cat_s[h * hd + d] = round_to<T>(c);
      }
    }
    __syncthreads();

    // head mean of the dropped weights; out-projection of the heads
    for (int l = tid; l < L; l += THREADS) {
      float s = 0.f;
      for (int h = 0; h < nh; ++h) s += sc_s[h * L + l];
      a.attn[tb * L + l] = s / (float)nh;
    }
    gemv<T>(a.wo, E, E, cat_s, nullptr, 0, 0, nullptr, a.bo, E, ctx_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) ctxr_s[e] = round_to<T>(ctx_s[e]);
    __syncthreads();

    // --- gated word/context fusion -----------------------------------------
    gemv<T>(a.wg_c, E, E, ctxr_s, nullptr, 0, 0, nullptr, nullptr, E, x_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) {
      const float g = sigmoid(a.gate_w[tb * E + e] + x_s[e]);
      x_s[e] = round_to<T>(g * to_f(a.embp[tb * E + e]) + (1.f - g) * ctx_s[e]);
    }
    __syncthreads();

    // --- three LSTM cells, each with LayerNorm and dropout -------------------
#pragma unroll
    for (int li = 0; li < 3; ++li) {
      const float* x = li == 0 ? x_s : hr_s + (li - 1) * H;  // the new h below
      const int K = li == 0 ? E : H;
      float* hr = hr_s + li * H;
      float* c = c_s + li * H;
      gemv<T>(a.wih[li], K, K, x, a.whh[li], H, H, hr, a.bl[li], 4 * H, gates_s);
      __syncthreads();
      float part = 0.f;
      for (int j = tid; j < H; j += THREADS) {
        const float cn = sigmoid(gates_s[H + j]) * c[j] +
                         sigmoid(gates_s[j]) * tanhf(gates_s[2 * H + j]);
        const float rh = sigmoid(gates_s[3 * H + j]) * tanhf(cn);
        c[j] = cn;
        a.cs[li][tb * H + j] = cn;
        rh_s[j] = rh;
        part += rh;
      }
      const float mu = block_sum(part, red_s) / (float)H;
      part = 0.f;
      for (int j = tid; j < H; j += THREADS) {
        const float d = rh_s[j] - mu;
        part = fmaf(d, d, part);
      }
      const float rstd = rsqrtf(block_sum(part, red_s) / (float)H + LN_EPS);
      const float* lm = a.lmask ? a.lmask + ((size_t)li * a.steps * B + tb) * H : nullptr;
      for (int j = tid; j < H; j += THREADS) {
        float h = (rh_s[j] - mu) * rstd * a.ln_g[li * H + j] + a.ln_b[li * H + j];
        if (lm) h *= lm[j];
        hr[j] = round_to<T>(h);
        if (li < 2) {
          a.hs[li][tb * H + j] = from_f<T>(h);
        } else {
          h2_s[j] = h;
          a.h_tops[tb * H + j] = from_f<T>(h);
        }
      }
      __syncthreads();
    }

    // --- highway output gate -------------------------------------------------
    gemv<T>(a.wcp, E, E, ctxr_s, nullptr, 0, 0, nullptr, a.bcp, H, hw_s);
    gemv<T>(a.whg_h, H, H, hr_s + 2 * H, a.whg_c, E, E, ctxr_s, a.bhw, H, gates_s);
    __syncthreads();
    for (int j = tid; j < H; j += THREADS) {
      const float g = sigmoid(gates_s[j]);
      a.enh[tb * H + j] = from_f<T>(g * h2_s[j] + (1.f - g) * hw_s[j]);
    }
    __syncthreads();
  }
}

template <typename P>
void take(P& dst, const void* src) {
  dst = static_cast<P>(const_cast<void*>(src));
}

template <typename T>
int launch(const void* const* p, int steps, int B, int L, int E, int H, int nh,
           cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  auto in = [&](auto& dst) { take(dst, p[i++]); };
  in(a.embp); in(a.gate_w); in(a.k); in(a.v); in(a.amask); in(a.lmask);
  in(a.wqp); in(a.bqp); in(a.wq); in(a.bq); in(a.wo); in(a.bo); in(a.wg_c);
  for (int li = 0; li < 3; ++li) { in(a.wih[li]); in(a.whh[li]); in(a.bl[li]); }
  in(a.ln_g); in(a.ln_b); in(a.whg_h); in(a.whg_c); in(a.bhw); in(a.wcp); in(a.bcp);
  in(a.h_tops); in(a.enh); in(a.attn); in(a.hs[0]); in(a.hs[1]);
  in(a.cs[0]); in(a.cs[1]); in(a.cs[2]);
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H; a.nh = nh;
  const size_t smem = (size_t)smem_floats(L, E, H, nh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      enhanced_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  enhanced_scan_kernel<T><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel needs for these sizes, in bytes.
extern "C" long long ic_enhanced_scan_smem_bytes(int L, int E, int H, int nh) {
  return (long long)smem_floats(L, E, H, nh) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (embp, k, v, the weight matrices and the
// four h outputs; gate_w, the masks, biases, LayerNorm affines, attn and the
// three c outputs are float32).  ptrs: the 29 operands (amask and lmask may
// be null) and 8 outputs in the order of Args.  Returns a cudaError_t.
extern "C" int ic_enhanced_scan(int dtype, const void* const* ptrs, int steps,
                                int B, int L, int E, int H, int nh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nh <= 0 || E % nh != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(ptrs, steps, B, L, E, H, nh, s);
  if (dtype == 1) return launch<__nv_bfloat16>(ptrs, steps, B, L, E, H, nh, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
