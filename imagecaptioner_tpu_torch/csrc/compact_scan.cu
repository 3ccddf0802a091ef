// Teacher-forced recurrence of the compact student's decoder (1-layer LSTM,
// dot attention, additive fusion), all T steps in one cooperative launch.
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
// What bounds it on the H100: every step is a chain of small products
// (B <= 16 rows) over 1.2 MB of bf16 weights with a strict dependency from
// one step to the next; the bytes the function must move once are under
// 2 MB and the arithmetic is microseconds, so the chain's latency is what
// costs.  Design (chain.cuh, as decoder_scan.cu): one persistent cooperative
// launch, one block per SM.  Block k owns
//   - a run of <= HCAP = 4 hidden units (2 at H = 256 on 132 SMs) with all
//     four gate rows of W_ih and W_hh, so the cell update and c stay in the
//     block;
//   - a run of <= ECAP = 2 of the E outputs of W_a;
// and keeps those rows resident in shared memory for all T steps (18 KB a
// block in bf16, 36 KB in float32).  Block b < B also attends to batch row
// b and keeps that row's feats resident (25 KB bf16, 50 KB float32).  h,
// hp and x0 cross blocks through L2 behind a grid barrier; a phase stages
// its A operand into shared memory with one round of 16-byte loads (bf16;
// float32 reads it from L2 in place).  Step t runs three phases, each ended
// by the barrier:
//   1. hp(t) = dtype(h(t-1))·W_aᵀ + b_a for the owned E outputs; the
//      recurrent part dtype(h(t-1))·W_hhᵀ of the owned gates, kept in the
//      block;
//   2. the dot attention of step t, one block a batch row -> attn, x0(t);
//   3. x0(t)·W_ihᵀ for the owned gates, plus the recurrent part and b, and
//      the cell -> h(t), c(t).
// The bf16 gate products (16 output rows a block) run on tensor cores
// (mma.sync m16n8k16, float32 accumulation); the W_a products (<= 2 output
// rows a block) and the float32 instance run on CUDA cores in float32 FMAs.
// Every sum is in a fixed order and no atomics touch data, so runs repeat
// bit for bit.  Batches above BMAX = 16 rows run as consecutive chunks
// inside the launch.  No library kernel (cuBLAS, cuDNN) is called.

#include "chain.cuh"

namespace {

constexpr int ECAP = 2;    // most E outputs a block owns
constexpr int BMAX = 16;   // batch rows a chunk, one attending block each

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
  // workspace, crossing blocks through L2
  T* h;                 // (BMAX, H)
  T* x0;                // (BMAX, E)
  float* hp;            // (BMAX, E)
  unsigned* bar;        // two zeroed words
  int steps, B, L, E, H;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of one block: the resident weight rows; for bf16 one staged
// operand (BMAX x (max(E, H) + PAD)); the attended row's feats; float32
// scratch.
template <typename T>
struct Layout {
  int ldE, ldH;
  size_t weights, acts, feats, floats;
  __host__ __device__ Layout(int L, int E, int H) {
    ldE = E + PAD;
    ldH = H + PAD;
    weights = (size_t)GATE_ROWS * ldE + (size_t)GATE_ROWS * ldH + (size_t)ECAP * ldH;
    acts = sizeof(T) == 2 ? (size_t)BMAX * (H > E ? ldH : ldE) : 0;
    feats = (size_t)L * E;
    floats = PART_FLOATS + BMAX * (2 * GATE_ROWS + ECAP + HCAP) + E + round4(L);
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
  return align16(sizeof(T) * BMAX * H) + align16(sizeof(T) * BMAX * E) +
         align16(4 * (size_t)BMAX * E) + 16;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) compact_scan_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, E = a.E, H = a.H, B = a.B, steps = a.steps;
  const int nblk = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int h0 = span_lo(blk, nblk, H), nh = span_lo(blk + 1, nblk, H) - h0;
  const int e0 = span_lo(blk, nblk, E), ne = span_lo(blk + 1, nblk, E) - e0;
  const Layout<T> lay(L, E, H);
  const int ldE = lay.ldE, ldH = lay.ldH;

  T* ih = reinterpret_cast<T*>(smem);        // GATE_ROWS x ldE
  T* hh = ih + GATE_ROWS * ldE;              // GATE_ROWS x ldH
  T* wa = hh + GATE_ROWS * ldH;              // ECAP x ldH
  T* act = wa + ECAP * ldH;                  // bf16: BMAX x ld staged operand
  T* feats_s = act + lay.acts;               // L x E, the attended row
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) * (lay.weights + lay.acts +
                                                                     lay.feats)));
  float* rec = part + PART_FLOATS;           // BMAX x GATE_ROWS: h(t-1)·W_hhᵀ
  float* gs = rec + BMAX * GATE_ROWS;        // BMAX x GATE_ROWS: x0(t)·W_ihᵀ
  float* es = gs + BMAX * GATE_ROWS;         // BMAX x ECAP: h(t-1)·W_aᵀ
  float* cst = es + BMAX * ECAP;             // BMAX x HCAP: c of the owned units
  float* hp_s = cst + BMAX * HCAP;           // E
  float* w_s = hp_s + E;                     // L

  stage_gate_rows(ih, ldE, a.w_ih, E, H, h0, nh);
  stage_gate_rows(hh, ldH, a.w_hh, H, H, h0, nh);
  stage_rows(wa, ldH, a.w_attn, H, H, e0, ne, ECAP);

  const Src<T> none{nullptr, 0, 0, nullptr};
  const Src<T> hsrc{a.h, H, H, nullptr}, x0src{a.x0, E, E, nullptr};

  for (int b0 = 0; b0 < B; b0 += BMAX) {
    const int M = min(BMAX, B - b0);
    if (blk < M) {  // the attended row's feats, resident for the chunk
      const uint4* src = reinterpret_cast<const uint4*>(a.feats + (size_t)(b0 + blk) * L * E);
      for (int i = tid; i < (int)(L * E * sizeof(T) / 16); i += THREADS)
        reinterpret_cast<uint4*>(feats_s)[i] = src[i];
    }
    for (int i = tid; i < BMAX * HCAP; i += THREADS) cst[i] = 0.f;
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
      const size_t tb = (size_t)t * B + b0;  // row (t, b0) of the (T, B, ...) streams

      // 1. products of h(t-1) (zero at t = 0)
      if (t > 0) {
        const View<T> A = operand(hsrc, none, M, act);
        __syncthreads();
        product(A, M, hh, ldH, GATE_ROWS, rec, GATE_ROWS, part);
        product_fma(A, M, wa, ldH, ECAP, es, ECAP);
      } else {
        for (int i = tid; i < BMAX * GATE_ROWS; i += THREADS) rec[i] = 0.f;
        for (int i = tid; i < BMAX * ECAP; i += THREADS) es[i] = 0.f;
        __syncthreads();
      }
      for (int i = tid; i < M * ne; i += THREADS) {
        const int m = i / ne, c = i % ne, e = e0 + c;
        a.hp[m * E + e] = es[m * ECAP + c] + a.b_attn[e];
      }
      grid_barrier(a.bar, nblk);

      // 2. attention of step t for the row this block owns -> attn, x0(t)
      if (blk < M)
        attend_dot_row<T>(feats_s, a.hp + (size_t)blk * E, a.emb + (tb + blk) * E, L, E, hp_s,
                          w_s, a.x0 + (size_t)blk * E, a.attn + (tb + blk) * L);
      grid_barrier(a.bar, nblk);

      // 3. gates and cell for the owned units
      const View<T> Ax = operand(x0src, none, M, act);
      __syncthreads();
      product(Ax, M, ih, ldE, GATE_ROWS, gs, GATE_ROWS, part);
      for (int i = tid; i < M * nh; i += THREADS) {
        const int m = i / nh, c = i % nh, j = h0 + c;
        const size_t n = tb + m;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m * GATE_ROWS + q * HCAP + c;
          g[q] = gs[r] + rec[r] + a.b[q * H + j];
        }
        const float h = lstm_cell(g[0], g[1], g[2], g[3], cst + m * HCAP + c);
        a.h[m * H + j] = from_f<T>(h);
        a.hs[n * H + j] = from_f<T>(h);
        a.cs[n * H + j] = cst[m * HCAP + c];
      }
      grid_barrier(a.bar, nblk);
    }
  }
}

template <typename T>
int blocks(int L, int E, int H, long long* smem) {
  *smem = (long long)smem_bytes<T>(L, E, H);
  return chain_grid(compact_scan_kernel<T>, THREADS, smem_bytes<T>(L, E, H));
}

template <typename T>
int launch(const void* const* p, void* ws, int nblk, int steps, int B, int L, int E, int H,
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
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto take = [&](size_t bytes) {
    unsigned char* r = w;
    w += align16(bytes);
    return r;
  };
  a.h = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.x0 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.hp = reinterpret_cast<float*>(take(4 * (size_t)BMAX * E));
  a.bar = reinterpret_cast<unsigned*>(take(16));
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)compact_scan_kernel<T>, dim3(nblk),
                                          dim3(THREADS), params, smem_bytes<T>(L, E, H), stream);
}

}  // namespace

// Blocks the cooperative compact scan runs on for this dtype and these sizes
// on the current device (0 if it does not fit; negative: a CUDA error
// code), and its dynamic shared memory in bytes through smem.
extern "C" int ic_compact_scan_blocks(int dtype, int L, int E, int H, long long* smem) {
  if (dtype == 0) return blocks<float>(L, E, H, smem);
  if (dtype == 1) return blocks<bf16>(L, E, H, smem);
  return -(int)cudaErrorInvalidValue;
}

// Bytes of the workspace a launch needs.  The caller zeroes it once and may
// hand it to every later launch on the same stream: the barrier's words are
// back at zero after every barrier, and h, x0, hp are written before they
// are read.
extern "C" long long ic_compact_scan_workspace_bytes(int dtype, int E, int H) {
  return (long long)(dtype == 0 ? workspace_bytes<float>(E, H) : workspace_bytes<bf16>(E, H));
}

// dtype: 0 = float32, 1 = bfloat16 (emb, feats, weights and hs; biases, attn
// and cs are float32).  ptrs: the 7 operands and 3 outputs in the order of
// Args.  ws: the workspace of ic_compact_scan_workspace_bytes; nblk: from
// ic_compact_scan_blocks (each block may own at most 4 hidden units and 2 of
// E, and nblk >= min(B, 16): a block attends to one row).  Returns a
// cudaError_t.
extern "C" int ic_compact_scan(int dtype, const void* const* ptrs, void* ws, int nblk,
                               int steps, int B, int L, int E, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, ws, nblk, steps, B, L, E, H, s);
  if (dtype == 1) return launch<bf16>(ptrs, ws, nblk, steps, B, L, E, H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
