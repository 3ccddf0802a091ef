// Reverse-time analytic backward of the full student's teacher-forced decoder
// recurrence (csrc/decoder_scan.cu), all arithmetic in float32.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_lstm.py
// `_fused_core_bwd_pallas_call` (`_kernel_train_bwd`): one program that keeps
// every weight, every trajectory and all weight-gradient accumulators in
// on-chip memory for T reverse steps.  An SM has 227 KB of shared memory and
// the weights alone are 7.4 MB in bf16, so the work is split along what is
// truly sequential, and the sequential part is spread over the whole card:
//
//  1. Recompute (`prep_kernel`, `gemm_kernel`): everything the forward
//     computed that the backward needs depends only on stored residuals,
//     never on the carried gradients, so it is computed for all N = T·B
//     rows at once before the reverse loop, as tiled products that read each
//     weight once per tile: the layer inputs h0p, h1p, h0·mask; the context
//     ctx = attn·feats; hw = h1p·W_hᵀ; x0 = emb_w + ctx·W_cᵀ; both layers'
//     gate activations; and G = feats·W_cᵀ (B, L, E), which turns the
//     attention's d(weights) = dctx·featsᵀ = dx0·(W_c·featsᵀ) into one
//     product with dx0.
//  2. The reverse chain (`chain_kernel`): one persistent cooperative kernel,
//     as many blocks as the card holds (occupancy x SMs).  Block k owns a run
//     of the H columns and of the E columns of every transposed product and
//     keeps the matching column slices of W_ih1, W_hh1, W_hh0, W_h (H side)
//     and W_ih0, W_c (E side) resident in shared memory for all T steps.
//     Per step five dependent phases, each ended by a grid barrier:
//       a. [W_h] dh1 = dh1_rec + dhw[t+1]·W_h, then layer 1's cell backward
//          (elementwise in the owned columns) -> dgp1[t]
//       b. [W_ih1, W_hh1] d(h0·mask) and dh1_rec from dgp1, then layer 0's
//          cell backward -> dgp0[t]
//       c. [W_ih0, W_hh0] dx0[t] (= d(emb_w)) and the carried dh0
//       d. [W_c] dctx[t] = dx0·W_c; d(weights)[t] = dx0·Gᵀ + dattn, by
//          (row, token) pairs
//       e. d(scores) (the softmax backward, repeated by every block for its
//          rows) and dhw[t] = sum_l d(scores)·(1 - tanh²(f_proj + hw)), by
//          (row, column) pairs
//     The cell backwards are elementwise in the owned columns, so the
//     carried dh, dc of a column never leave the block that owns it.
//  3. After the loop (`post_kernel`): dfeats = sum_t w·dctx and df_proj =
//     sum_t d(scores)·(1 - tanh²), from the per-step stores.
//  4. `weight_grad_kernel` and `bias_grad_kernel`: the eight weight and
//     bias gradients are plain sums over the N rows of the per-step stores,
//     dW[o, i] = sum_n D[n, o] · X[n, i].
//
// Every sum is taken by one thread, or by one warp's shuffle tree, in a fixed
// order, with no floating-point atomics: results repeat bit for bit.
//
// What bounds it on the H100: the chain, a sequence of 5·T dependent phases
// whose products are small (B = 16 rows); each phase costs a grid barrier
// (a few microseconds) and one pass of the owned weight slices from shared
// memory plus the broadcast of a (B, 4H) float32 vector from L2.  The
// recompute and the weight gradients are bound by float32 operations on
// CUDA cores (about 2·N·(4H·(E + 3H) + E·H + E·E) each, 5.8 GFLOP at T=47,
// B=16, E=256, H=512).  No library kernel (cuBLAS, cuDNN) is called.
//
// The grid barrier, the slice staging and the column ownership (`Owned`)
// are shared with the forward chains, in chain.cuh.

#include "chain.cuh"

namespace {

// ---------------------------------------------------------------------------
// Operands
// ---------------------------------------------------------------------------

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
  const T* dh_tops;    // (T, B, H)
  const float* dattn;  // (T, B, L)
  // recompute stores, float32
  float* h0p;    // (T, B, H)   h0[t-1]
  float* h1p;    // (T, B, H)   h1[t-1]
  float* h0d;    // (T, B, H)   h0[t] * mask[t]
  float* ctx;    // (T, B, E)
  float* hw;     // (T, B, E)
  float* x0;     // (T, B, E)
  float* act0;   // (T, B, 4H)
  float* act1;   // (T, B, 4H)
  float* featsf; // (B, L, E)   feats as float32
  float* G;      // (B, L, E)   feats·W_cᵀ
  // chain stores, float32
  float* dgp0;   // (T, B, 4H)
  float* dgp1;   // (T, B, 4H)
  float* dx0;    // (T, B, E)  = d(emb_w)
  float* dctx;   // (T, B, E)
  float* dw;     // (T, B, L)  d(attention weights)
  float* ds;     // (T, B, L)  d(scores)
  float* dhw;    // (T, B, E)
  // carried state of the owned columns, float32 (B, H) each, zeroed
  float* dh0c;
  float* dc0;
  float* dc1;
  float* dh1rec;
  unsigned* barrier;  // two zeroed words: arrivals, generation
  // outputs
  float* df_proj;  // (B, L, E)
  float* dfeats;   // (B, L, E)
  int steps, B, L, E, H, ld_h, ld_c;
};

// ---------------------------------------------------------------------------
// 1. Recompute
// ---------------------------------------------------------------------------

// h0p, h1p, h0d (N x H), ctx (N x E) and featsf (B x L x E); one thread an
// element.
template <typename T>
__global__ void prep_kernel(const Args<T> a) {
  const int B = a.B, L = a.L, E = a.E, H = a.H;
  const size_t N = (size_t)a.steps * B;
  const size_t nh = N * H, ne = N * E, nf = (size_t)B * L * E;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nh + ne + nf;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < nh) {
      const size_t n = i / H;
      const bool first = n < (size_t)B;  // t == 0
      a.h0p[i] = first ? 0.f : to_f(a.h0s[i - (size_t)B * H]);
      a.h1p[i] = first ? 0.f : to_f(a.h_tops[i - (size_t)B * H]);
      a.h0d[i] = to_f(a.h0s[i]) * (a.mask ? a.mask[i] : 1.f);
    } else if (i < nh + ne) {
      const size_t k = i - nh, n = k / E;
      const int e = k % E, b = n % B;
      const float* w = a.attn + n * L;
      const T* f = a.feats + (size_t)b * L * E + e;
      float c = 0.f;
      for (int l = 0; l < L; ++l) c = fmaf(w[l], to_f(f[(size_t)l * E]), c);
      a.ctx[k] = c;
    } else {
      const size_t k = i - nh - ne;
      a.featsf[k] = to_f(a.feats[k]);
    }
  }
}

// C[n, m] = sum_k A1[n, k] W1[m, k] + sum_k A2[n, k] W2[m, k] + bias[m]
//           + add[n, m], then optionally the LSTM gate activations (tanh on
// the third quarter of m, sigmoid elsewhere).  A float32 (N x K, dense), W in
// T (M x K, row stride ld), C float32 (N x M).
template <typename T>
struct GemmJob {
  const float* A1;
  const T* W1;
  int K1, ld1;
  const float* A2;
  const T* W2;
  int K2, ld2;
  const float* bias;
  const T* add;
  float* C;
  int N, M, act;
  int tile_begin;
};

constexpr int MAX_GEMM_JOBS = 4;
constexpr int TILE = 64;   // output tile edge
constexpr int CHUNK = 16;  // k staged per iteration
constexpr int GEMM_THREADS = 256;

template <typename T>
struct GemmJobs {
  GemmJob<T> job[MAX_GEMM_JOBS];
  int n_jobs;
};

template <typename T>
__device__ __forceinline__ void accumulate(const float* A, const T* W, int K, int ldw,
                                           int N, int M, int n0, int m0,
                                           float (&acc)[4][4], float (*a_s)[TILE + 4],
                                           float (*w_s)[TILE + 4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    // stage A[n0..+64, k0..+16] and W[m0..+64, k0..+16] transposed: [k][n]
    for (int i = tid; i < TILE * CHUNK; i += GEMM_THREADS) {
      const int r = i / CHUNK, k = i % CHUNK;
      const int n = n0 + r, m = m0 + r, kk = k0 + k;
      a_s[k][r] = (n < N && kk < K) ? A[(size_t)n * K + kk] : 0.f;
      w_s[k][r] = (m < M && kk < K) ? to_f(W[(size_t)m * ldw + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = a_s[k][ty * 4 + i];
        wv[i] = w_s[k][tx * 4 + i];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(const GemmJobs<T> jobs) {
  __shared__ float a_s[CHUNK][TILE + 4];
  __shared__ float w_s[CHUNK][TILE + 4];
  int ji = 0;
  while (ji + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[ji + 1].tile_begin) ++ji;
  const GemmJob<T>& jb = jobs.job[ji];
  const int tiles_m = (jb.M + TILE - 1) / TILE;
  const int tile = blockIdx.x - jb.tile_begin;
  const int n0 = (tile / tiles_m) * TILE, m0 = (tile % tiles_m) * TILE;
  float acc[4][4] = {};
  accumulate(jb.A1, jb.W1, jb.K1, jb.ld1, jb.N, jb.M, n0, m0, acc, a_s, w_s);
  if (jb.A2) accumulate(jb.A2, jb.W2, jb.K2, jb.ld2, jb.N, jb.M, n0, m0, acc, a_s, w_s);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q = jb.M / 4;  // gate quarter (act only)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty * 4 + r;
    if (n >= jb.N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + tx * 4 + c;
      if (m >= jb.M) continue;
      float v = acc[r][c];
      if (jb.bias) v += jb.bias[m];
      if (jb.add) v += to_f(jb.add[(size_t)n * jb.M + m]);
      if (jb.act) v = (m >= 2 * q && m < 3 * q) ? tanhf(v) : sigmoid(v);
      jb.C[(size_t)n * jb.M + m] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The reverse chain
// ---------------------------------------------------------------------------

constexpr int CHAIN_THREADS = 512;
constexpr int CHAIN_WARPS = CHAIN_THREADS / 32;
constexpr int CMAX = 4;  // most columns a block owns on either side

// out_x[r * CMAX + c] = sum_k D[r, k] X[k * CMAX + c] for r < B, c < nc,
// and the same for Y when given (into out_y).  X and Y are column slices in
// shared memory; D is (B, K) float32 written in this kernel; a warp takes a
// row, its lanes split k, and a shuffle tree adds the lanes in a fixed
// order.  Ends synchronised.
template <typename T>
__device__ void slice_product(const float* D, int K, int B, const T* X, const T* Y,
                              int nc, float* out_x, float* out_y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (nc > 0) {
    for (int r = warp; r < B; r += CHAIN_WARPS) {
      float ax[CMAX] = {}, ay[CMAX] = {};
      const float* d = D + (size_t)r * K;
#pragma unroll 16
      for (int k = lane; k < K; k += 32) {
        const float dv = ld_cg(d + k);
        const T* xr = X + k * CMAX;
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < nc) ax[c] = fmaf(dv, to_f(xr[c]), ax[c]);
        if (Y) {
          const T* yr = Y + k * CMAX;
#pragma unroll
          for (int c = 0; c < CMAX; ++c)
            if (c < nc) ay[c] = fmaf(dv, to_f(yr[c]), ay[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        const float sx = warp_sum(ax[c]);
        const float sy = Y ? warp_sum(ay[c]) : 0.f;
        if (lane == 0 && c < nc) {
          out_x[r * CMAX + c] = sx;
          if (Y) out_y[r * CMAX + c] = sy;
        }
      }
    }
  }
  __syncthreads();
}

// One LSTM cell's backward for (row r, column j) of step t: dh the full
// d(h_new), dc the carried d(c) (updated to d(c_prev)), act the (4H) gate
// activations of the row, dgp the row's (4H) gate gradient.
__device__ __forceinline__ void cell_bwd(int j, int H, const float* act, float dh,
                                         float c, float c_prev, float* dc, float* dgp) {
  const float i = act[j], f = act[H + j], g = act[2 * H + j], o = act[3 * H + j];
  const float tc = tanhf(c);
  const float d_o = dh * tc;
  const float dcn = *dc + dh * o * (1.f - tc * tc);
  dgp[j] = dcn * g * i * (1.f - i);
  dgp[H + j] = dcn * c_prev * f * (1.f - f);
  dgp[2 * H + j] = dcn * i * (1.f - g * g);
  dgp[3 * H + j] = d_o * o * (1.f - o);
  *dc = dcn * f;
}

// The six weight slices a block keeps in shared memory (row stride CMAX),
// and its scratch (B x CMAX x 2 floats).
template <typename T>
struct ChainSlices {
  const T *w_h, *w_ih1, *w_hh1, *w_hh0;  // H side: columns [h0, h1)
  const T *w_ih0, *w_c;                  // E side: columns [e0, e1)
  float* px;
  float* py;
};

// Phase a of step t: dh1 carry, layer 1's cell backward -> dgp1[t].
template <typename T>
__device__ void phase_a(const Args<T>& a, const Owned& o, const ChainSlices<T>& s, int t) {
  const int B = a.B, E = a.E, H = a.H, nh = o.h1 - o.h0;
  const size_t tb = (size_t)t * B;
  if (t < a.steps - 1)
    slice_product<T>(a.dhw + (tb + B) * E, E, B, s.w_h, nullptr, nh, s.px, s.py);
  for (int i = threadIdx.x; i < B * nh; i += CHAIN_THREADS) {
    const int r = i / nh, c = i % nh, j = o.h0 + c;
    const size_t rj = (size_t)r * H + j, n = tb + r;
    float dh1 = 0.f;
    if (t < a.steps - 1) dh1 = a.dh1rec[rj] + s.px[r * CMAX + c];
    if (a.dh_tops) dh1 += to_f(a.dh_tops[n * H + j]);
    cell_bwd(j, H, a.act1 + n * 4 * H, dh1, a.c1s[n * H + j],
             t > 0 ? a.c1s[(n - B) * H + j] : 0.f, a.dc1 + rj, a.dgp1 + n * 4 * H);
  }
}

// Phase b: d(h0·mask), dh1_rec from dgp1[t]; layer 0's cell backward -> dgp0[t].
template <typename T>
__device__ void phase_b(const Args<T>& a, const Owned& o, const ChainSlices<T>& s, int t) {
  const int B = a.B, H = a.H, nh = o.h1 - o.h0;
  const size_t tb = (size_t)t * B;
  slice_product<T>(a.dgp1 + tb * 4 * H, 4 * H, B, s.w_ih1, s.w_hh1, nh, s.px, s.py);
  for (int i = threadIdx.x; i < B * nh; i += CHAIN_THREADS) {
    const int r = i / nh, c = i % nh, j = o.h0 + c;
    const size_t rj = (size_t)r * H + j, n = tb + r;
    a.dh1rec[rj] = s.py[r * CMAX + c];
    const float m = a.mask ? a.mask[n * H + j] : 1.f;
    const float dh0 = a.dh0c[rj] + s.px[r * CMAX + c] * m;
    cell_bwd(j, H, a.act0 + n * 4 * H, dh0, a.c0s[n * H + j],
             t > 0 ? a.c0s[(n - B) * H + j] : 0.f, a.dc0 + rj, a.dgp0 + n * 4 * H);
  }
}

// Phase c: dx0[t] (owned E columns) and the carried dh0 (owned H columns).
template <typename T>
__device__ void phase_c(const Args<T>& a, const Owned& o, const ChainSlices<T>& s, int t) {
  const int B = a.B, E = a.E, H = a.H, nh = o.h1 - o.h0, ne = o.e1 - o.e0;
  const size_t tb = (size_t)t * B;
  const float* dgp0 = a.dgp0 + tb * 4 * H;
  slice_product<T>(dgp0, 4 * H, B, s.w_hh0, nullptr, nh, s.px, s.py);
  for (int i = threadIdx.x; i < B * nh; i += CHAIN_THREADS) {
    const int r = i / nh, c = i % nh;
    a.dh0c[(size_t)r * H + o.h0 + c] = s.px[r * CMAX + c];
  }
  slice_product<T>(dgp0, 4 * H, B, s.w_ih0, nullptr, ne, s.py, s.px);
  for (int i = threadIdx.x; i < B * ne; i += CHAIN_THREADS) {
    const int r = i / ne, c = i % ne;
    a.dx0[(tb + r) * E + o.e0 + c] = s.py[r * CMAX + c];
  }
}

// Phase d: dctx[t] = dx0·W_c (owned E columns); dw[t] = dx0·Gᵀ + dattn by
// (row, token) pairs, a warp a pair.
template <typename T>
__device__ void phase_d(const Args<T>& a, const Owned& o, const ChainSlices<T>& s, int t) {
  const int B = a.B, L = a.L, E = a.E, ne = o.e1 - o.e0;
  const size_t tb = (size_t)t * B;
  const float* dx0 = a.dx0 + tb * E;
  slice_product<T>(dx0, E, B, s.w_c, nullptr, ne, s.px, s.py);
  for (int i = threadIdx.x; i < B * ne; i += CHAIN_THREADS) {
    const int r = i / ne, c = i % ne;
    a.dctx[(tb + r) * E + o.e0 + c] = s.px[r * CMAX + c];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = o.p0 + warp; p < o.p1; p += CHAIN_WARPS) {
    const int b = p / L, l = p % L;
    const float* g = a.G + ((size_t)b * L + l) * E;
    const float* d = dx0 + (size_t)b * E;
    float acc = 0.f;
    for (int e = lane; e < E; e += 32) acc = fmaf(ld_cg(d + e), g[e], acc);
    acc = warp_sum(acc);
    if (lane == 0) a.dw[(tb + b) * L + l] = acc + (a.dattn ? a.dattn[(tb + b) * L + l] : 0.f);
  }
}

// Phase e: d(scores) of the rows this block's (row, column) pairs touch
// (every block repeats the softmax backward for its rows), and dhw[t] for
// its pairs.  The block that owns (b, 0) stores d(scores)[t, b].
template <typename T>
__device__ void phase_e(const Args<T>& a, const Owned& o, float* ds_s, float* dot_s, int t) {
  const int B = a.B, L = a.L, E = a.E;
  const size_t tb = (size_t)t * B;
  if (o.q1 <= o.q0) return;
  const int b_first = o.q0 / E, b_last = (o.q1 - 1) / E, nb = b_last - b_first + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int bi = warp; bi < nb; bi += CHAIN_WARPS) {
    const size_t row = tb + b_first + bi;
    float acc = 0.f;
    for (int l = lane; l < L; l += 32) acc = fmaf(a.attn[row * L + l], ld_cg(a.dw + row * L + l), acc);
    acc = warp_sum(acc);
    if (lane == 0) dot_s[bi] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * L; i += CHAIN_THREADS) {
    const int bi = i / L, l = i % L;
    const size_t row = tb + b_first + bi;
    const float w = a.attn[row * L + l];
    const float d = w * (ld_cg(a.dw + row * L + l) - dot_s[bi]);
    ds_s[i] = d;
    if ((b_first + bi) * E >= o.q0) a.ds[row * L + l] = d;  // this block owns (b, 0)
  }
  __syncthreads();
  for (int q = o.q0 + warp; q < o.q1; q += CHAIN_WARPS) {  // a warp a pair
    const int b = q / E, e = q % E, bi = b - b_first;
    const size_t row = tb + b;
    const float hwe = a.hw[row * E + e];
    const T* fp = a.f_proj + (size_t)b * L * E + e;
    float acc = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float th = tanhf(to_f(fp[(size_t)l * E]) + hwe);
      acc += ds_s[bi * L + l] * (1.f - th * th);
    }
    acc = warp_sum(acc);
    if (lane == 0) a.dhw[row * E + e] = acc;
  }
}

template <typename T>
__host__ __device__ inline size_t chain_smem_bytes(int B, int L, int E, int H) {
  return (sizeof(T) * (size_t)CMAX * (3 * 4 * H + E + 4 * H + E) + 4 * (size_t)B * CMAX * 2 +
          4 * (size_t)(B * L + B) + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) chain_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, L = a.L, E = a.E, H = a.H;
  const Owned o(blockIdx.x, gridDim.x, B, L, E, H);
  const int nh = o.h1 - o.h0, ne = o.e1 - o.e0;
  T* w = reinterpret_cast<T*>(smem);
  ChainSlices<T> s;
  T* ih1 = w;
  T* hh1 = ih1 + 4 * H * CMAX;
  T* hh0 = hh1 + 4 * H * CMAX;
  T* wh = hh0 + 4 * H * CMAX;
  T* ih0 = wh + E * CMAX;
  T* wc = ih0 + 4 * H * CMAX;
  stage_slice(ih1, a.w_ih1, H, o.h0, 4 * H, nh, CMAX);
  stage_slice(hh1, a.w_hh1, H, o.h0, 4 * H, nh, CMAX);
  stage_slice(hh0, a.w_hh0, H, o.h0, 4 * H, nh, CMAX);
  stage_slice(wh, a.w_h, a.ld_h, o.h0, E, nh, CMAX);
  stage_slice(ih0, a.w_ih0, E, o.e0, 4 * H, ne, CMAX);
  stage_slice(wc, a.w_c, a.ld_c, o.e0, E, ne, CMAX);
  s.w_ih1 = ih1;
  s.w_hh1 = hh1;
  s.w_hh0 = hh0;
  s.w_h = wh;
  s.w_ih0 = ih0;
  s.w_c = wc;
  s.px = reinterpret_cast<float*>(wc + E * CMAX);
  s.py = s.px + B * CMAX;
  float* ds_s = s.py + B * CMAX;
  float* dot_s = ds_s + B * L;
  __syncthreads();

  for (int t = a.steps - 1; t >= 0; --t) {
    phase_a(a, o, s, t);
    grid_barrier(a.barrier, gridDim.x);
    phase_b(a, o, s, t);
    grid_barrier(a.barrier, gridDim.x);
    phase_c(a, o, s, t);
    grid_barrier(a.barrier, gridDim.x);
    phase_d(a, o, s, t);
    grid_barrier(a.barrier, gridDim.x);
    phase_e(a, o, ds_s, dot_s, t);
    if (t > 0) grid_barrier(a.barrier, gridDim.x);
  }
}

// ---------------------------------------------------------------------------
// 3. After the loop: dfeats[b, l, e] = sum_t w[t, b, l] dctx[t, b, e];
//    df_proj[b, l, e] = sum_t ds[t, b, l] (1 - tanh²(f_proj[b, l, e] + hw[t, b, e]))
// ---------------------------------------------------------------------------

template <typename T>
__global__ void post_kernel(const Args<T> a) {
  const int B = a.B, L = a.L, E = a.E;
  const size_t total = (size_t)B * L * E;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int e = i % E;
    const size_t bl = i / E;
    const int b = bl / L, l = bl % L;
    const float fp = to_f(a.f_proj[i]);
    float df = 0.f, dp = 0.f;
    for (int t = a.steps - 1; t >= 0; --t) {
      const size_t row = (size_t)t * B + b;
      df = fmaf(a.attn[row * L + l], a.dctx[row * E + e], df);
      const float th = tanhf(fp + a.hw[row * E + e]);
      dp += a.ds[row * L + l] * (1.f - th * th);
    }
    a.dfeats[i] = df;
    a.df_proj[i] = dp;
  }
}

// ---------------------------------------------------------------------------
// 4. Weight gradients: C[o, i] = sum_n D[n, o] * X[n, i]
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T>
Args<T> make_args(const void* const* p, int steps, int B, int L, int E, int H, int ld_h,
                  int ld_c) {
  Args<T> a;
  auto in = [&](int i) { return p[i]; };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  a.emb_w = static_cast<const T*>(in(0));
  a.f_proj = static_cast<const T*>(in(1));
  a.feats = static_cast<const T*>(in(2));
  a.mask = static_cast<const float*>(in(3));
  a.w_h = static_cast<const T*>(in(4));
  a.w_c = static_cast<const T*>(in(5));
  a.w_ih0 = static_cast<const T*>(in(6));
  a.w_hh0 = static_cast<const T*>(in(7));
  a.b0 = static_cast<const float*>(in(8));
  a.w_ih1 = static_cast<const T*>(in(9));
  a.w_hh1 = static_cast<const T*>(in(10));
  a.b1 = static_cast<const float*>(in(11));
  a.h_tops = static_cast<const T*>(in(12));
  a.attn = static_cast<const float*>(in(13));
  a.h0s = static_cast<const T*>(in(14));
  a.c0s = static_cast<const float*>(in(15));
  a.c1s = static_cast<const float*>(in(16));
  a.dh_tops = static_cast<const T*>(in(17));
  a.dattn = static_cast<const float*>(in(18));
  a.h0p = out(19); a.h1p = out(20); a.h0d = out(21); a.ctx = out(22); a.hw = out(23);
  a.x0 = out(24); a.act0 = out(25); a.act1 = out(26); a.featsf = out(27); a.G = out(28);
  a.dgp0 = out(29); a.dgp1 = out(30); a.dx0 = out(31); a.dctx = out(32); a.dw = out(33);
  a.ds = out(34); a.dhw = out(35);
  a.dh0c = out(36); a.dc0 = out(37); a.dc1 = out(38); a.dh1rec = out(39);
  a.barrier = reinterpret_cast<unsigned*>(out(40));
  a.df_proj = out(41); a.dfeats = out(42);
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H; a.ld_h = ld_h; a.ld_c = ld_c;
  return a;
}

template <typename T>
int launch_recompute(const Args<T>& a, cudaStream_t s) {
  const size_t N = (size_t)a.steps * a.B;
  const size_t total = N * (a.H + a.E) + (size_t)a.B * a.L * a.E;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  prep_kernel<T><<<blocks, 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (int)N, BL = a.B * a.L, E = a.E, H = a.H;
  // stage 1: hw, x0, gates1, G; stage 2: gates0 (reads x0)
  const GemmJob<T> first[4] = {
      {a.h1p, a.w_h, H, a.ld_h, nullptr, nullptr, 0, 0, nullptr, nullptr, a.hw, n, E, 0, 0},
      {a.ctx, a.w_c, E, a.ld_c, nullptr, nullptr, 0, 0, nullptr, a.emb_w, a.x0, n, E, 0, 0},
      {a.h0d, a.w_ih1, H, H, a.h1p, a.w_hh1, H, H, a.b1, nullptr, a.act1, n, 4 * H, 1, 0},
      {a.featsf, a.w_c, E, a.ld_c, nullptr, nullptr, 0, 0, nullptr, nullptr, a.G, BL, E, 0, 0}};
  const GemmJob<T> second[1] = {
      {a.x0, a.w_ih0, E, E, a.h0p, a.w_hh0, H, H, a.b0, nullptr, a.act0, n, 4 * H, 1, 0}};
  for (int stage = 0; stage < 2; ++stage) {
    GemmJobs<T> jobs;
    jobs.n_jobs = stage == 0 ? 4 : 1;
    int tiles = 0;
    for (int j = 0; j < jobs.n_jobs; ++j) {
      jobs.job[j] = stage == 0 ? first[j] : second[j];
      jobs.job[j].tile_begin = tiles;
      tiles += ((jobs.job[j].N + TILE - 1) / TILE) * ((jobs.job[j].M + TILE - 1) / TILE);
    }
    gemm_kernel<T><<<tiles, GEMM_THREADS, 0, s>>>(jobs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Blocks of the cooperative chain kernel the current device holds at once
// (0 if none).  Raises the kernel's shared-memory ceiling on that device to
// the device's opt-in maximum, so one call serves every shape there.
template <typename T>
int chain_blocks(int B, int L, int E, int H, size_t* smem_out) {
  const size_t smem = chain_smem_bytes<T>(B, L, E, H);
  if (smem_out) *smem_out = smem;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  if (smem > (size_t)optin) return 0;
  err = cudaFuncSetAttribute(chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel<T>,
                                                        CHAIN_THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// nblk: what chain_blocks gave on this device; the grid barrier needs every
// block resident, which the cooperative launch checks.
template <typename T>
int launch_chain(Args<T> a, int nblk, cudaStream_t s) {
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)chain_kernel<T>, dim3(nblk),
                                          dim3(CHAIN_THREADS), params,
                                          chain_smem_bytes<T>(a.B, a.L, a.E, a.H), s);
}
template <typename T>
int launch_post(const Args<T>& a, cudaStream_t s) {
  const size_t total = (size_t)a.B * a.L * a.E;
  post_kernel<T><<<(int)((total + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int stage, const void* const* ptrs, int steps, int B, int L, int E, int H, int ld_h,
        int ld_c, int nblk, cudaStream_t s) {
  const Args<T> a = make_args<T>(ptrs, steps, B, L, E, H, ld_h, ld_c);
  if (stage == 0) return launch_recompute(a, s);
  if (stage == 1) return launch_chain(a, nblk, s);
  return launch_post(a, s);
}

}  // namespace

// Blocks the cooperative chain kernel would run on (negative: a CUDA error
// code), and its dynamic shared memory in bytes through smem.
extern "C" int ic_decoder_scan_bwd_chain_blocks(int dtype, int B, int L, int E, int H,
                                                long long* smem) {
  size_t bytes = 0;
  const int n = dtype == 0 ? chain_blocks<float>(B, L, E, H, &bytes)
                           : chain_blocks<bf16>(B, L, E, H, &bytes);
  *smem = (long long)bytes;
  return n;
}

// One stage of the reverse-time backward: 0 the recompute, 1 the chain on
// nblk blocks (from ic_decoder_scan_bwd_chain_blocks on the current
// device), 2 the post-loop reductions.  dtype: 0 = float32, 1 = bfloat16
// (the type of emb_w, f_proj, feats, the weights, h_tops, h0s and dh_tops;
// everything else is float32).  ptrs: the 19 inputs (mask, dh_tops and
// dattn may be null), the 17 float32 stores, the 4 zeroed carries, the
// zeroed barrier words, df_proj and dfeats; see make_args.  Returns a
// cudaError_t.
extern "C" int ic_decoder_scan_bwd_stage(int stage, int dtype, const void* const* ptrs,
                                         int steps, int B, int L, int E, int H, int ld_h,
                                         int ld_c, int nblk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(stage, ptrs, steps, B, L, E, H, ld_h, ld_c, nblk, s);
  if (dtype == 1) return run<bf16>(stage, ptrs, steps, B, L, E, H, ld_h, ld_c, nblk, s);
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
