// Reverse-time analytic backward of the full student's teacher-forced decoder
// recurrence (csrc/decoder_scan.cu), all arithmetic in float32.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_lstm.py
// `_fused_core_bwd_pallas_call` (`_kernel_train_bwd`): one program that keeps
// every weight, every trajectory and all weight-gradient accumulators in
// on-chip memory for T reverse steps.  An SM has 227 KB of shared memory and
// the float32 weight-gradient accumulators alone are 15.5 MB, so the work is
// split in two here, along the line where it stops being sequential:
//
//  1. `steps_kernel`: the reverse-time recurrence.  Batch rows are
//     independent, so one block of 512 threads owns one row for all T steps
//     (as the forward does) and no step needs a grid-wide barrier.  Per step
//     it recomputes ctx, x0, both layers' gates and tanh(f_proj + hw) from
//     the stored trajectories, runs the layer-1, layer-0, combine and
//     attention backward, carries dh0, dc0, dh1, dc1 in shared memory,
//     accumulates df_proj and dfeats for its own row in device memory (no
//     other block touches that row: no atomics), and stores what the weight
//     gradients need for this (t, row): dgp0, dgp1 (4H), dhw, dx0 (E; dx0 is
//     also d(emb_w)[t]), the recomputed x0 and ctx (E) and the layer inputs
//     h0p, h1p, h0*mask (H).  The forward products read weight rows (one
//     warp per output row); the transposed products dgp·Wᵀ walk the same
//     row-major weights down their columns: a thread owns 16 bytes of
//     columns, groups of threads split the rows, and the groups' partial
//     sums are added in a fixed order in shared memory.
//  2. `weight_grad_kernel` and `bias_grad_kernel`: over all steps the eight
//     weight and bias gradients are plain sums over the N = T·B rows,
//     dW[o, i] = sum_n D[n, o] · X[n, i], written in the parameter's torch
//     (out, in) layout.  A tiled shared-memory product (64 x 64 output tile,
//     16 rows of N at a time, a 4 x 4 register tile per thread) over one job
//     table covering all six matrices fills the card; every output element
//     is summed by one thread in one order, so results repeat run to run.
//
// What bounds it on the H100: part 1 is bound as the forward is, by the
// weight stream from L2 (each step reads every weight twice: once for the
// recompute, once transposed) and the latency of the step chain, with 16 of
// 132 SMs busy at B=16; part 2 does 2·N·(4H·E + 3·4H·H + E·H + E·E) float32
// operations (5.8 GFLOP at T=47, B=16, E=256, H=512) on CUDA cores, which
// bounds it by operations.  No library kernel (cuBLAS, cuDNN) is called.

#include "recurrent.cuh"

namespace {

constexpr int PART = THREADS * 8;  // floats of partial sums (8 bf16 per 16 bytes)

// acc[0..N) += d * (16 bytes of weights at w)
__device__ __forceinline__ void axpy16(const float* w, float d, float* acc) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w));
  acc[0] = fmaf(d, a.x, acc[0]);
  acc[1] = fmaf(d, a.y, acc[1]);
  acc[2] = fmaf(d, a.z, acc[2]);
  acc[3] = fmaf(d, a.w, acc[3]);
}

__device__ __forceinline__ void axpy16(const __nv_bfloat16* w, float d, float* acc) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(w));
  acc[0] = fmaf(d, __uint_as_float(a.x << 16), acc[0]);
  acc[1] = fmaf(d, __uint_as_float(a.x & 0xffff0000u), acc[1]);
  acc[2] = fmaf(d, __uint_as_float(a.y << 16), acc[2]);
  acc[3] = fmaf(d, __uint_as_float(a.y & 0xffff0000u), acc[3]);
  acc[4] = fmaf(d, __uint_as_float(a.z << 16), acc[4]);
  acc[5] = fmaf(d, __uint_as_float(a.z & 0xffff0000u), acc[5]);
  acc[6] = fmaf(d, __uint_as_float(a.w << 16), acc[6]);
  acc[7] = fmaf(d, __uint_as_float(a.w & 0xffff0000u), acc[7]);
}

// out[k] = sum_j d[j] W[j, k] for k < K: the product with Wᵀ over the
// row-major (M, K) weight.  K is a multiple of 16 / sizeof(T) and at most
// THREADS * 16 / sizeof(T).  `part` holds PART floats.  Ends synchronised.
template <typename T>
__device__ void gemvT(const T* __restrict__ W, int ld, int M, int K,
                      const float* __restrict__ d, float* __restrict__ out,
                      float* __restrict__ part) {
  constexpr int N = 16 / sizeof(T);
  const int tpr = K / N;             // threads that cover one weight row
  const int groups = THREADS / tpr;  // row groups working side by side
  const int g = threadIdx.x / tpr, c = (threadIdx.x % tpr) * N;
  if (g < groups) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = g; j < M; j += groups) axpy16(W + (size_t)j * ld + c, d[j], acc);
#pragma unroll
    for (int i = 0; i < N; ++i) part[g * K + c + i] = acc[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += THREADS) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += part[gg * K + k];
    out[k] = s;
  }
  __syncthreads();
}

template <typename T>
struct Args {
  // residuals of the forward
  const T* emb_w;     // (T, B, E)
  const T* f_proj;    // (B, L, E)
  const T* feats;     // (B, L, E)
  const float* mask;  // (T, B, H) or null
  const T* w_h;       // (E, H), ld_h
  const T* w_c;       // (E, E), ld_c
  const T* w_ih0;     // (4H, E)
  const T* w_hh0;     // (4H, H)
  const float* b0;
  const T* w_ih1;     // (4H, H)
  const T* w_hh1;     // (4H, H)
  const float* b1;
  const T* h_tops;    // (T, B, H)
  const float* attn;  // (T, B, L)
  const T* h0s;       // (T, B, H)
  const float* c0s;   // (T, B, H)
  const float* c1s;   // (T, B, H)
  // cotangents (either may be null: zero)
  const T* dh_tops;     // (T, B, H)
  const float* dattn;   // (T, B, L)
  // outputs, float32
  float* df_proj;  // (B, L, E)
  float* dfeats;   // (B, L, E)
  float* dgp0;     // (T, B, 4H)
  float* dgp1;     // (T, B, 4H)
  float* dhw;      // (T, B, E)
  float* dx0;      // (T, B, E)  = d(emb_w)
  float* x0;       // (T, B, E)
  float* ctx;      // (T, B, E)
  float* h0p;      // (T, B, H)
  float* h1p;      // (T, B, H)
  float* h0d;      // (T, B, H)
  int steps, B, L, E, H, ld_h, ld_c;
};

__host__ __device__ inline int steps_smem_floats(int L, int E, int H) {
  return 2 * L * E + 2 * round4(L) + 6 * E + 9 * H + 16 * H + PART;
}

// sigmoid on the i, f, o blocks and tanh on the g block of a (4H) gate row
__device__ __forceinline__ void activate(float* g, int H) {
  for (int j = threadIdx.x; j < 4 * H; j += THREADS)
    g[j] = (j >= 2 * H && j < 3 * H) ? tanhf(g[j]) : sigmoid(g[j]);
}

// One LSTM cell's backward for this step.  act = (i, f, g, o) activations,
// dh the incoming d(h_new) without the carried part handled by the caller,
// dc_s the carried d(c) (updated to d(c_prev)), dgp the (4H) gate gradient.
__device__ __forceinline__ void cell_bwd(int j, int H, const float* act, float dh,
                                         float c, float c_prev, float* dc_s,
                                         float* dgp) {
  const float i = act[j], f = act[H + j], g = act[2 * H + j], o = act[3 * H + j];
  const float tc = tanhf(c);
  const float d_o = dh * tc;
  const float dc = dc_s[j] + dh * o * (1.f - tc * tc);
  dgp[j] = dc * g * i * (1.f - i);
  dgp[H + j] = dc * c_prev * f * (1.f - f);
  dgp[2 * H + j] = dc * i * (1.f - g * g);
  dgp[3 * H + j] = d_o * o * (1.f - o);
  dc_s[j] = dc * f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) steps_kernel(const Args<T> a) {
  const int L = a.L, E = a.E, H = a.H, B = a.B;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* feats_s = smem;                 // L*E
  float* fproj_s = feats_s + L * E;       // L*E
  float* w_s = fproj_s + L * E;           // L   attention weights of step t
  float* dw_s = w_s + round4(L);          // L   d(weights), then d(scores)
  float* ctx_s = dw_s + round4(L);        // E
  float* x0_s = ctx_s + E;                // E
  float* hw_s = x0_s + E;                 // E
  float* dhw_s = hw_s + E;                // E
  float* dx0_s = dhw_s + E;               // E
  float* dctx_s = dx0_s + E;              // E
  float* h0p_s = dctx_s + E;              // H   h0[t-1]
  float* h1p_s = h0p_s + H;               // H   h1[t-1]
  float* h0d_s = h1p_s + H;               // H   h0[t] * mask[t]
  float* dh0_s = h0d_s + H;               // H   carried d(h0)
  float* dc0_s = dh0_s + H;               // H
  float* dh1_s = dc0_s + H;               // H
  float* dc1_s = dh1_s + H;               // H
  float* ta_s = dc1_s + H;                // H   scratch
  float* tb_s = ta_s + H;                 // H   scratch
  float* act0_s = tb_s + H;               // 4H  layer-0 gate activations
  float* act1_s = act0_s + 4 * H;         // 4H
  float* dgp0_s = act1_s + 4 * H;         // 4H
  float* dgp1_s = dgp0_s + 4 * H;         // 4H
  float* part_s = dgp1_s + 4 * H;         // PART
  __shared__ float dot_s;

  const size_t row = (size_t)b * L * E;
  for (int i = tid; i < L * E; i += THREADS) {
    feats_s[i] = to_f(a.feats[row + i]);
    fproj_s[i] = to_f(a.f_proj[row + i]);
  }
  for (int j = tid; j < H; j += THREADS) dh0_s[j] = dc0_s[j] = dh1_s[j] = dc1_s[j] = 0.f;
  __syncthreads();

  for (int t = a.steps - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B + b;
    const size_t tp = tb - B;  // (t-1, b); used only when t > 0
    const bool first = (t == a.steps - 1);

    // ---- this step's trajectories ------------------------------------
    for (int l = tid; l < L; l += THREADS) w_s[l] = a.attn[tb * L + l];
    for (int j = tid; j < H; j += THREADS) {
      const float m = a.mask ? a.mask[tb * H + j] : 1.f;
      h0d_s[j] = to_f(a.h0s[tb * H + j]) * m;
      h0p_s[j] = t > 0 ? to_f(a.h0s[tp * H + j]) : 0.f;
      h1p_s[j] = t > 0 ? to_f(a.h_tops[tp * H + j]) : 0.f;
    }
    __syncthreads();

    // ---- recompute the forward intermediates --------------------------
    for (int e = tid; e < E; e += THREADS) {
      float c = 0.f;
      for (int l = 0; l < L; ++l) c = fmaf(w_s[l], feats_s[l * E + e], c);
      ctx_s[e] = c;
    }
    gemv<T>(a.w_h, a.ld_h, H, h1p_s, nullptr, 0, 0, nullptr, nullptr, E, hw_s);
    __syncthreads();
    gemv<T>(a.w_c, a.ld_c, E, ctx_s, nullptr, 0, 0, nullptr, nullptr, E, x0_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) x0_s[e] += to_f(a.emb_w[tb * E + e]);
    __syncthreads();
    gemv<T>(a.w_ih0, E, E, x0_s, a.w_hh0, H, H, h0p_s, a.b0, 4 * H, act0_s);
    gemv<T>(a.w_ih1, H, H, h0d_s, a.w_hh1, H, H, h1p_s, a.b1, 4 * H, act1_s);
    __syncthreads();
    activate(act0_s, H);
    activate(act1_s, H);
    __syncthreads();

    // ---- layer 1 backward ------------------------------------------------
    for (int j = tid; j < H; j += THREADS) {
      const float dh1 = dh1_s[j] + (a.dh_tops ? to_f(a.dh_tops[tb * H + j]) : 0.f);
      cell_bwd(j, H, act1_s, dh1, a.c1s[tb * H + j],
               t > 0 ? a.c1s[tp * H + j] : 0.f, dc1_s, dgp1_s);
    }
    __syncthreads();
    gemvT<T>(a.w_ih1, H, 4 * H, H, dgp1_s, ta_s, part_s);   // d(h0 * mask)
    gemvT<T>(a.w_hh1, H, 4 * H, H, dgp1_s, dh1_s, part_s);  // dh1_rec

    // ---- layer 0 backward ------------------------------------------------
    for (int j = tid; j < H; j += THREADS) {
      const float m = a.mask ? a.mask[tb * H + j] : 1.f;
      const float dh0 = dh0_s[j] + ta_s[j] * m;
      cell_bwd(j, H, act0_s, dh0, a.c0s[tb * H + j],
               t > 0 ? a.c0s[tp * H + j] : 0.f, dc0_s, dgp0_s);
    }
    __syncthreads();
    gemvT<T>(a.w_ih0, E, 4 * H, E, dgp0_s, dx0_s, part_s);
    gemvT<T>(a.w_hh0, H, 4 * H, H, dgp0_s, dh0_s, part_s);  // dh0_prev

    // ---- combine and attention backward ---------------------------------
    gemvT<T>(a.w_c, a.ld_c, E, E, dx0_s, dctx_s, part_s);
    for (int l = warp; l < L; l += WARPS) {
      float s = 0.f;
      for (int e = lane; e < E; e += 32) s = fmaf(dctx_s[e], feats_s[l * E + e], s);
      s = warp_sum(s);
      if (lane == 0) dw_s[l] = s + (a.dattn ? a.dattn[tb * L + l] : 0.f);
    }
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
      for (int l = lane; l < L; l += 32) s = fmaf(w_s[l], dw_s[l], s);
      s = warp_sum(s);
      if (lane == 0) dot_s = s;
    }
    __syncthreads();
    for (int l = tid; l < L; l += THREADS) dw_s[l] = w_s[l] * (dw_s[l] - dot_s);
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) {
      const float hwe = hw_s[e], dce = dctx_s[e];
      float acc = 0.f;
      for (int l = 0; l < L; ++l) {
        const float th = tanhf(fproj_s[l * E + e] + hwe);
        const float d = dw_s[l] * (1.f - th * th);
        acc += d;
        const size_t idx = row + (size_t)l * E + e;
        if (first) {
          a.df_proj[idx] = d;
          a.dfeats[idx] = w_s[l] * dce;
        } else {
          a.df_proj[idx] += d;
          a.dfeats[idx] += w_s[l] * dce;
        }
      }
      dhw_s[e] = acc;
    }
    __syncthreads();
    gemvT<T>(a.w_h, a.ld_h, E, H, dhw_s, tb_s, part_s);  // dh1_attn

    // ---- carry and per-step stores ----------------------------------------
    for (int j = tid; j < H; j += THREADS) {
      dh1_s[j] += tb_s[j];
      a.h0p[tb * H + j] = h0p_s[j];
      a.h1p[tb * H + j] = h1p_s[j];
      a.h0d[tb * H + j] = h0d_s[j];
    }
    for (int j = tid; j < 4 * H; j += THREADS) {
      a.dgp0[tb * 4 * H + j] = dgp0_s[j];
      a.dgp1[tb * 4 * H + j] = dgp1_s[j];
    }
    for (int e = tid; e < E; e += THREADS) {
      a.dhw[tb * E + e] = dhw_s[e];
      a.dx0[tb * E + e] = dx0_s[e];
      a.x0[tb * E + e] = x0_s[e];
      a.ctx[tb * E + e] = ctx_s[e];
    }
    __syncthreads();
  }
}

template <typename T>
int launch_steps(const void* const* p, int steps, int B, int L, int E, int H,
                 int ld_h, int ld_c, cudaStream_t stream) {
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
  a.h_tops = static_cast<const T*>(p[12]);
  a.attn = static_cast<const float*>(p[13]);
  a.h0s = static_cast<const T*>(p[14]);
  a.c0s = static_cast<const float*>(p[15]);
  a.c1s = static_cast<const float*>(p[16]);
  a.dh_tops = static_cast<const T*>(p[17]);
  a.dattn = static_cast<const float*>(p[18]);
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(p[19 + i])); };
  a.df_proj = out(0); a.dfeats = out(1); a.dgp0 = out(2); a.dgp1 = out(3);
  a.dhw = out(4); a.dx0 = out(5); a.x0 = out(6); a.ctx = out(7);
  a.h0p = out(8); a.h1p = out(9); a.h0d = out(10);
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H;
  a.ld_h = ld_h; a.ld_c = ld_c;
  const size_t smem = (size_t)steps_smem_floats(L, E, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      steps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  steps_kernel<T><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradients: C[o, i] = sum_n D[n, o] * X[n, i]
// ---------------------------------------------------------------------------

constexpr int TILE = 64;       // output tile edge
constexpr int CHUNK = 16;      // rows of N staged per iteration
constexpr int GEMM_THREADS = 256;
constexpr int MAX_JOBS = 6;

struct Job {
  const float* D;  // (N, M)
  const float* X;  // (N, K)
  float* C;        // (M, K)
  int M, K;
  int tile_begin;  // first block index of this job
};

struct Jobs {
  Job job[MAX_JOBS];
  int n_jobs;
  int N;
};

__global__ void __launch_bounds__(GEMM_THREADS) weight_grad_kernel(const Jobs jobs) {
  __shared__ __align__(16) float d_s[CHUNK][TILE];
  __shared__ __align__(16) float x_s[CHUNK][TILE];

  int ji = 0;
  while (ji + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[ji + 1].tile_begin) ++ji;
  const Job jb = jobs.job[ji];
  const int tiles_k = (jb.K + TILE - 1) / TILE;
  const int tile = blockIdx.x - jb.tile_begin;
  const int o0 = (tile / tiles_k) * TILE, i0 = (tile % tiles_k) * TILE;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // 4x4 outputs per thread
  const int ln = tid / 16, lc = (tid % 16) * 4;  // this thread's staged float4
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int n0 = 0; n0 < jobs.N; n0 += CHUNK) {
    const int n = n0 + ln;
    float4 dv = make_float4(0.f, 0.f, 0.f, 0.f), xv = dv;
    if (n < jobs.N) {  // M and K are multiples of 4: a float4 is in or out whole
      if (o0 + lc < jb.M)
        dv = __ldg(reinterpret_cast<const float4*>(jb.D + (size_t)n * jb.M + o0 + lc));
      if (i0 + lc < jb.K)
        xv = __ldg(reinterpret_cast<const float4*>(jb.X + (size_t)n * jb.K + i0 + lc));
    }
    *reinterpret_cast<float4*>(&d_s[ln][lc]) = dv;
    *reinterpret_cast<float4*>(&x_s[ln][lc]) = xv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const float4 d4 = *reinterpret_cast<const float4*>(&d_s[k][ty * 4]);
      const float4 x4 = *reinterpret_cast<const float4*>(&x_s[k][tx * 4]);
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
      const float xx[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(dd[r], xx[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int o = o0 + ty * 4 + r, i = i0 + tx * 4;
    if (o < jb.M && i < jb.K)
      *reinterpret_cast<float4*>(jb.C + (size_t)o * jb.K + i) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// db0[j] = sum_n dgp0[n, j], db1[j] = sum_n dgp1[n, j]; one thread a column.
__global__ void bias_grad_kernel(const float* __restrict__ dgp0,
                                 const float* __restrict__ dgp1,
                                 float* __restrict__ db0, float* __restrict__ db1,
                                 int N, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * M) return;
  const float* d = j < M ? dgp0 + j : dgp1 + (j - M);
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += d[(size_t)n * M];
  (j < M ? db0[j] : db1[j - M]) = s;
}

}  // namespace

// Dynamic shared memory of the reverse-time kernel, in bytes.
extern "C" long long ic_decoder_scan_bwd_smem_bytes(int L, int E, int H) {
  return (long long)steps_smem_floats(L, E, H) * (long long)sizeof(float);
}

// The reverse-time recurrence.  dtype: 0 = float32, 1 = bfloat16 (the type
// of emb_w, f_proj, feats, the weights, h_tops, h0s and dh_tops; everything
// else is float32).  ptrs: the 19 inputs of Args (mask, dh_tops and dattn
// may be null) followed by its 11 float32 outputs.  Returns a cudaError_t.
extern "C" int ic_decoder_scan_bwd_steps(int dtype, const void* const* ptrs,
                                         int steps, int B, int L, int E, int H,
                                         int ld_h, int ld_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_steps<float>(ptrs, steps, B, L, E, H, ld_h, ld_c, s);
  if (dtype == 1)
    return launch_steps<__nv_bfloat16>(ptrs, steps, B, L, E, H, ld_h, ld_c, s);
  return (int)cudaErrorInvalidValue;
}

// The weight and bias gradients from the per-step stores (all float32):
//   dw_ih0 (4H,E) = dgp0ᵀ·x0     dw_hh0 (4H,H) = dgp0ᵀ·h0p
//   dw_ih1 (4H,H) = dgp1ᵀ·h0d    dw_hh1 (4H,H) = dgp1ᵀ·h1p
//   dw_h   (E,H)  = dhwᵀ·h1p     dw_c   (E,E)  = dx0ᵀ·ctx
//   db0 = sum_n dgp0, db1 = sum_n dgp1.
// in: dgp0, dgp1, dhw, dx0, x0, ctx, h0p, h1p, h0d.  out: dw_h, dw_c, dw_ih0,
// dw_hh0, db0, dw_ih1, dw_hh1, db1.  N = T·B; E and H are multiples of 4.
extern "C" int ic_decoder_scan_bwd_weights(const void* const* in,
                                           const void* const* out, int N, int E,
                                           int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto I = [&](int i) { return static_cast<const float*>(in[i]); };
  auto O = [&](int i) { return static_cast<float*>(const_cast<void*>(out[i])); };
  const float *dgp0 = I(0), *dgp1 = I(1), *dhw = I(2), *dx0 = I(3), *x0 = I(4),
              *ctx = I(5), *h0p = I(6), *h1p = I(7), *h0d = I(8);
  Jobs jobs;
  jobs.N = N;
  jobs.n_jobs = MAX_JOBS;
  const Job table[MAX_JOBS] = {
      {dgp0, x0, O(2), 4 * H, E, 0},  {dgp0, h0p, O(3), 4 * H, H, 0},
      {dgp1, h0d, O(5), 4 * H, H, 0}, {dgp1, h1p, O(6), 4 * H, H, 0},
      {dhw, h1p, O(0), E, H, 0},      {dx0, ctx, O(1), E, E, 0},
  };
  int tiles = 0;
  for (int j = 0; j < MAX_JOBS; ++j) {
    jobs.job[j] = table[j];
    jobs.job[j].tile_begin = tiles;
    tiles += ((table[j].M + TILE - 1) / TILE) * ((table[j].K + TILE - 1) / TILE);
  }
  weight_grad_kernel<<<tiles, GEMM_THREADS, 0, s>>>(jobs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = 2 * 4 * H;
  bias_grad_kernel<<<(cols + 255) / 256, 256, 0, s>>>(dgp0, dgp1, O(4), O(7), N, 4 * H);
  return (int)cudaGetLastError();
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
