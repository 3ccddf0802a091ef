// Teacher-forced recurrence of the full student's decoder (2-layer LSTM with
// Bahdanau attention), all T steps in one cooperative launch; eval and
// training forms in one kernel.
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
// What bounds it on the H100: every step is a chain of small products
// (B rows) over 7.7 MB of bf16 weights (15.4 MB float32) with a strict
// dependency from one step to the next; the bytes and the arithmetic are
// microseconds, the chain's latency is what costs.  Design (chain.cuh, as
// greedy_decode.cu): one persistent cooperative launch, one block per SM.
// Block k owns a run of <= HCAP = 4 hidden units with all four gate rows of
// W_ih0, W_hh0, W_ih1, W_hh1 (so c0, c1 and the cell updates stay in the
// block) and a run of <= ECAP = 2 of the E outputs of W_h and W_c, and keeps
// those rows resident in shared memory for all T steps (62 KB a block in
// bf16, 123 KB in float32).  h0, h1, dtype(h0·mask), hw, ctx and x0 cross
// blocks through L2 behind a grid barrier; a phase stages its A operand into
// shared memory with one round of 16-byte loads (bf16; float32 reads it from
// L2 in place), and the block that attends to a batch row keeps that row's
// feats and f_proj in shared memory (bf16).  Step t runs five phases, each
// ended by the barrier:
//   1. hw(t) = h1(t-1)·W_hᵀ for the owned E outputs; the recurrent parts
//      h1(t-1)·W_hh1ᵀ and h0(t-1)·W_hh0ᵀ of the owned gates, kept in the
//      block;
//   2. the attention of step t, one block a batch row -> attn, ctx(t);
//   3. x0(t) for the owned E outputs;
//   4. layer 0's gates and cell -> h0(t), dtype(h0(t)·mask[t]);
//   5. layer 1's gates and cell -> h1(t) = h_tops[t].
// The bf16 gate products (16 output rows a block) run on tensor cores
// (mma.sync m16n8k16, float32 accumulation); the E-side products (<= 2
// output rows a block: W_h, W_c) and the float32 instance run on CUDA cores
// in float32 FMAs.  Every sum is in a fixed order and no atomics touch data,
// so runs repeat bit for bit.  Batches above BMAX = 32 rows run as
// consecutive chunks inside the launch.  No library kernel (cuBLAS, cuDNN)
// is called.

#include "chain.cuh"

namespace {

constexpr int ECAP = 2;    // most E outputs a block owns
constexpr int BMAX = 32;   // batch rows a chunk

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
  // workspace, crossing blocks through L2
  T *h0, *h1, *hfed;  // (BMAX, H)
  T *ctx, *x0;        // (BMAX, E)
  float* hw;          // (BMAX, E)
  unsigned* bar;      // two zeroed words
  int steps, B, L, E, H, ld_h, ld_c;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of one block: the resident weight rows; for bf16 two staged
// operands (BMAX x (H + PAD)) and a batch row's feats and f_proj; float32
// scratch.
template <typename T>
struct Layout {
  int ldE, ldH;
  size_t weights, acts, feats, floats;
  __host__ __device__ Layout(int L, int E, int H) {
    ldE = E + PAD;
    ldH = H + PAD;
    weights = (size_t)GATE_ROWS * ldE + 3 * (size_t)GATE_ROWS * ldH + (size_t)ECAP * ldH +
              (size_t)ECAP * ldE;
    acts = sizeof(T) == 2 ? 2 * (size_t)BMAX * (H > E ? ldH : ldE) : 0;
    feats = sizeof(T) == 2 ? 2 * (size_t)L * E : 0;
    floats = PART_FLOATS + BMAX * (3 * GATE_ROWS + ECAP + 2 * HCAP) + E + round4(L);
  }
  __host__ __device__ size_t bytes() const {
    return align16(sizeof(T) * (weights + acts + feats)) + 4 * floats;
  }
};

template <typename T>
size_t smem_bytes(int L, int E, int H) {
  return Layout<T>(L, E, H).bytes();
}

template <typename T>
size_t workspace_bytes(int E, int H) {
  return 3 * align16(sizeof(T) * BMAX * H) + 2 * align16(sizeof(T) * BMAX * E) +
         align16(4 * (size_t)BMAX * E) + 16;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, E = a.E, H = a.H, B = a.B, steps = a.steps;
  const int nblk = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int h0 = span_lo(blk, nblk, H), nh = span_lo(blk + 1, nblk, H) - h0;
  const int e0 = span_lo(blk, nblk, E), ne = span_lo(blk + 1, nblk, E) - e0;
  const Layout<T> lay(L, E, H);
  const int ldE = lay.ldE, ldH = lay.ldH;

  T* ih0 = reinterpret_cast<T*>(smem);       // GATE_ROWS x ldE
  T* hh0 = ih0 + GATE_ROWS * ldE;            // GATE_ROWS x ldH
  T* ih1 = hh0 + GATE_ROWS * ldH;            // GATE_ROWS x ldH
  T* hh1 = ih1 + GATE_ROWS * ldH;            // GATE_ROWS x ldH
  T* wh = hh1 + GATE_ROWS * ldH;             // ECAP x ldH
  T* wc = wh + ECAP * ldH;                   // ECAP x ldE
  T* act0 = wc + ECAP * ldE;                 // bf16: staged operands
  T* act1 = act0 + lay.acts / 2;
  T* feats_s = act0 + lay.acts;              // bf16: L x E, the attended row
  T* fproj_s = feats_s + lay.feats / 2;
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) * (lay.weights + lay.acts +
                                                                     lay.feats)));
  float* rec0 = part + PART_FLOATS;          // BMAX x GATE_ROWS: h0(t-1)·W_hh0ᵀ
  float* rec1 = rec0 + BMAX * GATE_ROWS;     // BMAX x GATE_ROWS: h1(t-1)·W_hh1ᵀ
  float* gs = rec1 + BMAX * GATE_ROWS;       // BMAX x GATE_ROWS: a phase's product
  float* es = gs + BMAX * GATE_ROWS;         // BMAX x ECAP: an E-side product
  float* c0s = es + BMAX * ECAP;             // BMAX x HCAP
  float* c1s = c0s + BMAX * HCAP;
  float* hw_s = c1s + BMAX * HCAP;           // E
  float* w_s = hw_s + E;                     // L

  stage_gate_rows(ih0, ldE, a.w_ih0, E, H, h0, nh);
  stage_gate_rows(hh0, ldH, a.w_hh0, H, H, h0, nh);
  stage_gate_rows(ih1, ldH, a.w_ih1, H, H, h0, nh);
  stage_gate_rows(hh1, ldH, a.w_hh1, H, H, h0, nh);
  stage_rows(wh, ldH, a.w_h, a.ld_h, H, e0, ne, ECAP);
  stage_rows(wc, ldE, a.w_c, a.ld_c, E, e0, ne, ECAP);

  const Src<T> none{nullptr, 0, 0, nullptr};
  const Src<T> h0src{a.h0, H, H, nullptr}, h1src{a.h1, H, H, nullptr};
  const Src<T> fedsrc{a.hfed, H, H, nullptr}, ctxsrc{a.ctx, E, E, nullptr};
  const Src<T> x0src{a.x0, E, E, nullptr};

  for (int b0 = 0; b0 < B; b0 += BMAX) {
    const int M = min(BMAX, B - b0);
    // bf16, at most a row a block: the attended row's feats stay resident
    const bool resident = lay.feats > 0 && M <= nblk;
    if (resident && blk < M)
      for (int i = tid; i < L * E / 8; i += THREADS) {
        const size_t o = (size_t)(b0 + blk) * L * E + 8 * (size_t)i;
        reinterpret_cast<uint4*>(feats_s)[i] = *reinterpret_cast<const uint4*>(a.feats + o);
        reinterpret_cast<uint4*>(fproj_s)[i] = *reinterpret_cast<const uint4*>(a.f_proj + o);
      }
    for (int i = tid; i < BMAX * HCAP; i += THREADS) c0s[i] = c1s[i] = 0.f;
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
      const size_t tb = (size_t)t * B + b0;  // row (t, b0) of the (T, B, ...) streams

      // 1. products of h1(t-1) and h0(t-1) (zero at t = 0)
      if (t > 0) {
        const View<T> A1 = operand(h1src, none, M, act0);
        const View<T> A0 = operand(h0src, none, M, act1);
        __syncthreads();
        product(A1, M, hh1, ldH, GATE_ROWS, rec1, GATE_ROWS, part);
        product_fma(A1, M, wh, ldH, ECAP, es, ECAP);
        product(A0, M, hh0, ldH, GATE_ROWS, rec0, GATE_ROWS, part);
      } else {
        for (int i = tid; i < BMAX * GATE_ROWS; i += THREADS) rec0[i] = rec1[i] = 0.f;
        for (int i = tid; i < BMAX * ECAP; i += THREADS) es[i] = 0.f;
        __syncthreads();
      }
      for (int i = tid; i < M * ne; i += THREADS) {
        const int m = i / ne, c = i % ne;
        a.hw[m * E + e0 + c] = es[m * ECAP + c];
      }
      grid_barrier(a.bar, nblk);

      // 2. attention of step t for the rows this block owns
      for (int b = blk; b < M; b += nblk) {
        const size_t o = (size_t)(b0 + b) * L * E;
        attend_row<T>(resident ? fproj_s : a.f_proj + o, resident ? feats_s : a.feats + o,
                      a.hw + (size_t)b * E, L, E, hw_s, w_s, a.ctx + (size_t)b * E,
                      a.attn + (tb + b) * L);
      }
      grid_barrier(a.bar, nblk);

      // 3. x0(t) for the owned E outputs
      const View<T> Ac = operand(ctxsrc, none, M, act0);
      __syncthreads();
      product_fma(Ac, M, wc, ldE, ECAP, es, ECAP);
      for (int i = tid; i < M * ne; i += THREADS) {
        const int m = i / ne, c = i % ne, e = e0 + c;
        a.x0[m * E + e] = from_f<T>(to_f(a.emb_w[(tb + m) * E + e]) + es[m * ECAP + c]);
      }
      grid_barrier(a.bar, nblk);

      // 4. layer 0 for the owned units
      const View<T> Ax = operand(x0src, none, M, act0);
      __syncthreads();
      product(Ax, M, ih0, ldE, GATE_ROWS, gs, GATE_ROWS, part);
      for (int i = tid; i < M * nh; i += THREADS) {
        const int m = i / nh, c = i % nh, j = h0 + c;
        const size_t n = tb + m;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m * GATE_ROWS + q * HCAP + c;
          g[q] = gs[r] + rec0[r] + a.b0[q * H + j];
        }
        const float h = lstm_cell(g[0], g[1], g[2], g[3], c0s + m * HCAP + c);
        const float fed = a.mask ? h * a.mask[n * H + j] : h;
        a.h0[m * H + j] = from_f<T>(h);
        a.hfed[m * H + j] = from_f<T>(fed);
        if (a.h0s) {
          a.h0s[n * H + j] = from_f<T>(h);
          a.c0s[n * H + j] = c0s[m * HCAP + c];
        }
      }
      grid_barrier(a.bar, nblk);

      // 5. layer 1: input the dropped new h0, recurrent part from phase 1
      const View<T> Af = operand(fedsrc, none, M, act0);
      __syncthreads();
      product(Af, M, ih1, ldH, GATE_ROWS, gs, GATE_ROWS, part);
      for (int i = tid; i < M * nh; i += THREADS) {
        const int m = i / nh, c = i % nh, j = h0 + c;
        const size_t n = tb + m;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m * GATE_ROWS + q * HCAP + c;
          g[q] = gs[r] + rec1[r] + a.b1[q * H + j];
        }
        const float h = lstm_cell(g[0], g[1], g[2], g[3], c1s + m * HCAP + c);
        a.h1[m * H + j] = from_f<T>(h);
        a.h_tops[n * H + j] = from_f<T>(h);
        if (a.h0s) a.c1s[n * H + j] = c1s[m * HCAP + c];
      }
      grid_barrier(a.bar, nblk);
    }
  }
}

template <typename T>
int blocks(int L, int E, int H, long long* smem) {
  *smem = (long long)smem_bytes<T>(L, E, H);
  return chain_grid(scan_kernel<T>, THREADS, smem_bytes<T>(L, E, H));
}

template <typename T>
int launch(const void* const* p, void* ws, int nblk, int steps, int B, int L, int E, int H,
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
  a.h_tops = static_cast<T*>(const_cast<void*>(p[12]));
  a.attn = static_cast<float*>(const_cast<void*>(p[13]));
  a.h0s = static_cast<T*>(const_cast<void*>(p[14]));
  a.c0s = static_cast<float*>(const_cast<void*>(p[15]));
  a.c1s = static_cast<float*>(const_cast<void*>(p[16]));
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto take = [&](size_t bytes) {
    unsigned char* r = w;
    w += align16(bytes);
    return r;
  };
  a.h0 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.h1 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.hfed = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.ctx = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.x0 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.hw = reinterpret_cast<float*>(take(4 * (size_t)BMAX * E));
  a.bar = reinterpret_cast<unsigned*>(take(16));
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H;
  a.ld_h = ld_h; a.ld_c = ld_c;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)scan_kernel<T>, dim3(nblk), dim3(THREADS),
                                          params, smem_bytes<T>(L, E, H), stream);
}

}  // namespace

// Blocks the cooperative scan kernel runs on for this dtype and these sizes
// on the current device (0 if it does not fit; negative: a CUDA error
// code), and its dynamic shared memory in bytes through smem.
extern "C" int ic_decoder_scan_blocks(int dtype, int L, int E, int H, long long* smem) {
  if (dtype == 0) return blocks<float>(L, E, H, smem);
  if (dtype == 1) return blocks<bf16>(L, E, H, smem);
  return -(int)cudaErrorInvalidValue;
}

// Bytes of the workspace a launch needs; the caller zeroes it.
extern "C" long long ic_decoder_scan_workspace_bytes(int dtype, int E, int H) {
  return (long long)(dtype == 0 ? workspace_bytes<float>(E, H) : workspace_bytes<bf16>(E, H));
}

// dtype: 0 = float32, 1 = bfloat16 (emb_w, f_proj, feats, weights, h_tops
// and h0s; biases, mask, attn, c0s and c1s are float32).  ptrs: the 17
// operands and outputs in the order of Args; mask may be null, and h0s, c0s,
// c1s are null together for the eval form.  ws: a zeroed workspace of
// ic_decoder_scan_workspace_bytes; nblk: from ic_decoder_scan_blocks (each
// block may own at most 4 hidden units and 2 of E).  Returns a cudaError_t.
extern "C" int ic_decoder_scan(int dtype, const void* const* ptrs, void* ws, int nblk,
                               int steps, int B, int L, int E, int H, int ld_h, int ld_c,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, ws, nblk, steps, B, L, E, H, ld_h, ld_c, s);
  if (dtype == 1) return launch<bf16>(ptrs, ws, nblk, steps, B, L, E, H, ld_h, ld_c, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
