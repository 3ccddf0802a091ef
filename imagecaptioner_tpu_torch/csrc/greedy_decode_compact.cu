// Whole-loop greedy decode for the compact student (1-layer LSTM, dot
// attention, additive fusion, plain linear head), all max_length steps in one
// cooperative launch.
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
// What bounds it on the H100: every step is a chain of small products
// (B <= 32 rows) over ~2.7 MB of bf16 weights (head 1.5 MB, LSTM 1.0 MB,
// attention 0.1 MB) with a strict dependency from one step to the next;
// the bytes and the arithmetic are microseconds, the chain's latency is what
// costs.  Design (chain.cuh, as greedy_decode.cu): one persistent
// cooperative launch, one block per SM.  Block k owns
//   - a run of <= HCAP = 4 hidden units (2 at H = 256 on 132 SMs) with all
//     four gate rows of W_ih and W_hh, so the cell update and c stay in the
//     block;
//   - a run of <= ECAP = 2 of the E outputs of W_a;
//   - a run of <= VCAP = 24 of the V columns of W_out (23 at V = 2994);
// and keeps those rows resident in shared memory for all steps (30 KB a
// block in bf16, 61 KB in float32).  Block b < B also attends to batch row
// b: it keeps that row's feats resident (25 KB bf16, 50 KB float32) and its
// token state.  h, hp, x0 and the per-block partial argmaxes cross blocks
// through L2 behind a grid barrier; a phase stages its A operand into shared
// memory with one round of 16-byte loads (bf16; float32 reads it from L2 in
// place).  Step t runs three phases, each ended by the barrier:
//   1. from dtype(h(t-1)): logits(t-1) over the owned W_out columns and a
//      partial argmax a row; hp(t) = dtype(h(t-1))·W_aᵀ + b_a for the owned
//      E outputs; the recurrent part dtype(h(t-1))·W_hhᵀ of the owned gates,
//      kept in the block;
//   2. the block of row b reduces row b's partial argmaxes (lowest index
//      wins ties, as jnp.argmax) to token(t-1), applies END -> PAD and the
//      frozen-row feeding (emit_token) and stores it; then the dot attention
//      of step t -> x0(t) = dtype(emb[token] + ctx);
//   3. x0(t)·W_ihᵀ for the owned gates, plus the recurrent part and b, and
//      the cell -> h(t).
// A tail (phases 1-2 at t = steps) emits the last token: 3 T + 1 barriers a
// chunk.  The bf16 gate and logit products (16 and 24 output rows a block)
// run on tensor cores (mma.sync m16n8k16, float32 accumulation); the W_a
// products (<= 2 output rows a block) and the float32 instance run on CUDA
// cores in float32 FMAs.  Every sum is in a fixed order and no atomics touch
// data, so runs repeat bit for bit.  Batches above BMAX = 32 rows run as
// consecutive chunks inside the launch.  No library kernel is called.

#include "chain.cuh"

namespace {

constexpr int ECAP = 2;    // most E outputs a block owns
constexpr int VCAP = 24;   // most W_out columns a block owns (< 32: a lane each)
constexpr int BMAX = 32;   // batch rows a chunk, one attending block each

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
  // workspace, crossing blocks through L2
  T* h;                 // (BMAX, H)
  T* x0;                // (BMAX, E)
  float* hp;            // (BMAX, E)
  unsigned long long* best;  // (BMAX, nblk) partial argmaxes (pack_best)
  unsigned* bar;        // two zeroed words
  int B, L, E, H, V, steps;  // steps = max_length
  float temperature;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of one block: the resident weight rows; for bf16 one staged
// operand (BMAX x (max(E, H) + PAD)); the attended row's feats; float32
// scratch and the attended row's token state.  All of it is dynamic: the
// chain's grid query gives the kernel the device's whole opt-in maximum.
template <typename T>
struct Layout {
  int ldE, ldH;
  size_t weights, acts, feats, floats;
  __host__ __device__ Layout(int L, int E, int H) {
    ldE = E + PAD;
    ldH = H + PAD;
    weights = (size_t)GATE_ROWS * ldE + (size_t)(GATE_ROWS + ECAP + VCAP) * ldH;
    acts = sizeof(T) == 2 ? (size_t)BMAX * (H > E ? ldH : ldE) : 0;
    feats = (size_t)L * E;
    floats = PART_FLOATS + BMAX * (2 * GATE_ROWS + ECAP + VCAP + HCAP) + E + round4(L) + 4;
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
size_t workspace_bytes(int E, int H, int nblk) {
  return align16(sizeof(T) * BMAX * H) + align16(sizeof(T) * BMAX * E) +
         align16(4 * (size_t)BMAX * E) + align16(8 * (size_t)nblk * BMAX) + 16;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) greedy_compact_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, E = a.E, H = a.H, V = a.V, steps = a.steps;
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = span_lo(blk, nblk, H), nh = span_lo(blk + 1, nblk, H) - h0;
  const int e0 = span_lo(blk, nblk, E), ne = span_lo(blk + 1, nblk, E) - e0;
  const int v0 = span_lo(blk, nblk, V), nv = span_lo(blk + 1, nblk, V) - v0;
  const Layout<T> lay(L, E, H);
  const int ldE = lay.ldE, ldH = lay.ldH;

  T* ih = reinterpret_cast<T*>(smem);        // GATE_ROWS x ldE
  T* hh = ih + GATE_ROWS * ldE;              // GATE_ROWS x ldH
  T* wa = hh + GATE_ROWS * ldH;              // ECAP x ldH
  T* ow = wa + ECAP * ldH;                   // VCAP x ldH
  T* act = ow + VCAP * ldH;                  // bf16: BMAX x ld staged operand
  T* feats_s = act + lay.acts;               // L x E, the attended row
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) * (lay.weights + lay.acts +
                                                                     lay.feats)));
  float* rec = part + PART_FLOATS;           // BMAX x GATE_ROWS: h(t-1)·W_hhᵀ
  float* gs = rec + BMAX * GATE_ROWS;        // BMAX x GATE_ROWS: x0(t)·W_ihᵀ
  float* es = gs + BMAX * GATE_ROWS;         // BMAX x ECAP: h(t-1)·W_aᵀ
  float* ls = es + BMAX * ECAP;              // BMAX x VCAP: logits(t-1)
  float* cst = ls + BMAX * VCAP;             // BMAX x HCAP: c of the owned units
  float* hp_s = cst + BMAX * HCAP;           // E
  float* w_s = hp_s + E;                     // L
  int& tok_s = reinterpret_cast<int*>(w_s + round4(L))[0];  // the attended row's
  int& done_s = reinterpret_cast<int*>(w_s + round4(L))[1]; // token state

  stage_gate_rows(ih, ldE, a.w_ih, E, H, h0, nh);
  stage_gate_rows(hh, ldH, a.w_hh, H, H, h0, nh);
  stage_rows(wa, ldH, a.w_attn, H, H, e0, ne, ECAP);
  stage_rows(ow, ldH, a.out_w, H, H, v0, nv, VCAP);

  const Src<T> none{nullptr, 0, 0, nullptr};
  const Src<T> hsrc{a.h, H, H, nullptr}, x0src{a.x0, E, E, nullptr};

  for (int b0 = 0; b0 < a.B; b0 += BMAX) {
    const int M = min(BMAX, a.B - b0);
    if (blk < M) {  // the attended row's feats, resident for the chunk
      const uint4* src = reinterpret_cast<const uint4*>(a.feats + (size_t)(b0 + blk) * L * E);
      for (int i = tid; i < (int)(L * E * sizeof(T) / 16); i += THREADS)
        reinterpret_cast<uint4*>(feats_s)[i] = src[i];
    }
    for (int i = tid; i < BMAX * HCAP; i += THREADS) cst[i] = 0.f;
    if (tid == 0) {
      tok_s = TOK_START;
      done_s = 0;
    }
    __syncthreads();

    for (int t = 0; t <= steps; ++t) {
      // 1. products of h(t-1) (zero at t = 0): logits(t-1) and a partial
      //    argmax a row; hp(t) and the recurrent part
      if (t > 0) {
        const View<T> A = operand(hsrc, none, M, act);
        __syncthreads();
        product(A, M, ow, ldH, nv, ls, VCAP, part);
        for (int m = warp; m < M; m += WARPS) {
          float best = -INFINITY;
          int bi = V;
          if (lane < nv) {
            float x = ls[m * VCAP + lane] + a.out_b[v0 + lane];
            if (a.temperature != 1.f) x = x / a.temperature;
            best = x;
            bi = v0 + lane;
          }
          lanes_argmax(&best, &bi, 32);
          if (lane == 0) a.best[m * nblk + blk] = pack_best(best, bi);
        }
        if (t < steps) {
          product(A, M, hh, ldH, GATE_ROWS, rec, GATE_ROWS, part);
          product_fma(A, M, wa, ldH, ECAP, es, ECAP);
        }
      } else {
        for (int i = tid; i < BMAX * GATE_ROWS; i += THREADS) rec[i] = 0.f;
        for (int i = tid; i < BMAX * ECAP; i += THREADS) es[i] = 0.f;
        __syncthreads();
      }
      if (t < steps)
        for (int i = tid; i < M * ne; i += THREADS) {
          const int m = i / ne, c = i % ne, e = e0 + c;
          a.hp[m * E + e] = es[m * ECAP + c] + a.b_attn[e];
        }
      grid_barrier(a.bar, nblk);

      // 2. the row this block owns: token(t-1) from the blocks' partial
      //    argmaxes, then the attention of step t -> x0(t)
      if (blk < M) {
        if (t > 0 && warp == 0) {
          const unsigned long long* row = a.best + (size_t)blk * nblk;
          unsigned long long p[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)  // all loads first: one round trip
            p[r] = lane + 32 * r < nblk ? __ldcg(row + lane + 32 * r) : 0ull;
          float best = -INFINITY;
          int bi = V;
          auto consider = [&](unsigned long long pr) {
            if (beats(best_value(pr), best_index(pr), best, bi)) {
              best = best_value(pr);
              bi = best_index(pr);
            }
          };
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (lane + 32 * r < nblk) consider(p[r]);
          for (int j = lane + 256; j < nblk; j += 32) consider(__ldcg(row + j));
          lanes_argmax(&best, &bi, 32);
          if (lane == 0) emit_token(bi, a.out + (size_t)(b0 + blk) * steps + t - 1, &tok_s,
                                    &done_s);
        }
        __syncthreads();
        if (t < steps)
          attend_dot_row<T>(feats_s, a.hp + (size_t)blk * E, a.emb + (size_t)tok_s * E, L, E,
                            hp_s, w_s, a.x0 + (size_t)blk * E, nullptr);
      }
      if (t == steps) break;
      grid_barrier(a.bar, nblk);

      // 3. gates and cell for the owned units -> h(t)
      const View<T> Ax = operand(x0src, none, M, act);
      __syncthreads();
      product(Ax, M, ih, ldE, GATE_ROWS, gs, GATE_ROWS, part);
      for (int i = tid; i < M * nh; i += THREADS) {
        const int m = i / nh, c = i % nh, j = h0 + c;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m * GATE_ROWS + q * HCAP + c;
          g[q] = gs[r] + rec[r] + a.b[q * H + j];
        }
        a.h[m * H + j] = from_f<T>(lstm_cell(g[0], g[1], g[2], g[3], cst + m * HCAP + c));
      }
      grid_barrier(a.bar, nblk);
    }
  }
}

template <typename T>
int blocks(int L, int E, int H, long long* smem) {
  *smem = (long long)smem_bytes<T>(L, E, H);
  return chain_grid(greedy_compact_kernel<T>, THREADS, smem_bytes<T>(L, E, H));
}

template <typename T>
int launch(const void* const* p, int32_t* out, void* ws, int nblk, int B, int L, int E,
           int H, int V, int T_, float temperature, cudaStream_t stream) {
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
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto take = [&](size_t bytes) {
    unsigned char* r = w;
    w += align16(bytes);
    return r;
  };
  a.h = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.x0 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.hp = reinterpret_cast<float*>(take(4 * (size_t)BMAX * E));
  a.best = reinterpret_cast<unsigned long long*>(take(8 * (size_t)nblk * BMAX));
  a.bar = reinterpret_cast<unsigned*>(take(16));
  a.B = B; a.L = L; a.E = E; a.H = H; a.V = V; a.steps = T_;
  a.temperature = temperature;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)greedy_compact_kernel<T>, dim3(nblk),
                                          dim3(THREADS), params, smem_bytes<T>(L, E, H), stream);
}

}  // namespace

// Blocks the cooperative compact greedy kernel runs on for this dtype and
// these sizes on the current device (0 if it does not fit; negative: a CUDA
// error code), and its dynamic shared memory in bytes through smem.
extern "C" int ic_greedy_compact_blocks(int dtype, int L, int E, int H, long long* smem) {
  if (dtype == 0) return blocks<float>(L, E, H, smem);
  if (dtype == 1) return blocks<bf16>(L, E, H, smem);
  return -(int)cudaErrorInvalidValue;
}

// Bytes of the workspace a launch on nblk blocks needs.  The caller zeroes
// it once and may hand it to every later launch on the same stream: the
// barrier's words are back at zero after every barrier, and h, x0, hp and
// the partial argmaxes are written before they are read.
extern "C" long long ic_greedy_compact_workspace_bytes(int dtype, int E, int H, int nblk) {
  return (long long)(dtype == 0 ? workspace_bytes<float>(E, H, nblk)
                                : workspace_bytes<bf16>(E, H, nblk));
}

// dtype: 0 = float32, 1 = bfloat16 (table, feats and weights; biases are
// float32).  ptrs: the 9 operands in the order of Args; ws: the workspace of
// ic_greedy_compact_workspace_bytes; nblk: from ic_greedy_compact_blocks
// (each block may own at most 4 hidden units, 2 of E and 24 of V, and nblk
// >= min(B, 32): a block attends to one row).  Returns a cudaError_t.
extern "C" int ic_greedy_decode_compact(int dtype, const void* const* ptrs, int32_t* out,
                                        void* ws, int nblk, int B, int L, int E, int H, int V,
                                        int T, float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ptrs, out, ws, nblk, B, L, E, H, V, T, temperature, s);
  if (dtype == 1) return launch<bf16>(ptrs, out, ws, nblk, B, L, E, H, V, T, temperature, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
