// Whole-loop greedy decode for the full student (2-layer LSTM, Bahdanau
// attention), all max_length steps in one cooperative launch.
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
// What bounds it on the H100: every step is a chain of small products
// (B <= 32 rows) over 9.7 MB of bf16 weights with a strict dependency from
// one step to the next; the arithmetic and the bytes are microseconds, the
// chain's latency is what costs.  Design (chain.cuh): one persistent
// cooperative launch, one block per SM.  Block k owns
//   - a run of <= HCAP = 4 hidden units, with all four gate rows of W_ih0,
//     W_hh0, W_ih1 and W_hh1, so both cells' updates and c0, c1 stay in the
//     block;
//   - a run of <= ECAP = 2 of the E outputs of W_h, [W_e | W_c] and fc1;
//   - a run of <= VCAP = 24 of the V columns of fc2;
// and keeps those weight rows resident in shared memory for all steps
// (77 KB a block in bf16, 155 KB in float32).  The activations that cross
// blocks (h0, h1, hw, ctx, x0, hid, each (B, H or E) in the rounding type;
// the per-block partial argmaxes) go through L2 behind a grid barrier; a
// phase stages its A operand into shared memory with one round of 16-byte
// loads (bf16; float32 reads it from L2 in place: its weights leave no
// room), and the block that attends to a batch row keeps that row's feats
// and f_proj in shared memory (bf16).  Step t runs five phases, each ended
// by the barrier:
//   1. hw(t) = h1(t-1)·W_hᵀ and hid(t-1) = relu(h1(t-1)·fc1ᵀ + b) for the
//      owned E outputs; the recurrent parts h1(t-1)·W_hh1ᵀ, h0(t-1)·W_hh0ᵀ
//      of the owned gates, kept in the block;
//   2. logits(t-1) over the owned fc2 columns and a partial argmax a row;
//      the Bahdanau attention of step t, one block a batch row -> ctx(t);
//   3. every block reduces the partial argmaxes to token(t-1) (block 0
//      stores it); x0(t) for the owned E outputs;
//   4. layer 0's gates and cell for the owned units -> h0(t);
//   5. layer 1's gates and cell -> h1(t).
// A tail (phases 1-3 at t = steps) emits the last token.  The bf16 gate and
// logit products (16 and 24 output rows a block) run on tensor cores
// (mma.sync m16n8k16, float32 accumulation); the E-side products (<= 2
// output rows a block: W_h, fc1, [W_e | W_c]) and the float32 instance run
// on CUDA cores in float32 FMAs.  Every sum is in a fixed order and no
// atomics touch data, so runs repeat bit for bit.  Batches above BMAX = 32
// rows run as consecutive chunks inside the launch.  No library kernel is
// called.

#include "chain.cuh"

namespace {

constexpr int ECAP = 2;    // most E outputs a block owns
constexpr int VCAP = 24;   // most fc2 columns a block owns (< 32: a lane each)
constexpr int BMAX = 32;   // batch rows a chunk

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
  // workspace, crossing blocks through L2
  T *h0, *h1;        // (BMAX, H)
  T *hid, *ctx, *x0; // (BMAX, E)
  float* hw;         // (BMAX, E)
  unsigned long long* best;  // (BMAX, nblk) partial argmaxes: index << 32 | value bits
  unsigned* bar;     // two zeroed words
  int B, L, E, H, V, steps;  // steps = max_length
  float temperature;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of one block: the resident weight rows; for bf16 two staged
// operands (BMAX x (max(H, 2E) + PAD)) and a batch row's feats and f_proj;
// float32 scratch.
template <typename T>
struct Layout {
  int ldE, ldH, ld2E, ldA;
  size_t weights, acts, feats, floats;
  __host__ __device__ Layout(int L, int E, int H) {
    ldE = E + PAD;
    ldH = H + PAD;
    ld2E = 2 * E + PAD;
    ldA = (H > 2 * E ? H : 2 * E) + PAD;
    weights = (size_t)GATE_ROWS * ldE + 3 * (size_t)GATE_ROWS * ldH + 2 * (size_t)ECAP * ldH +
              (size_t)ECAP * ld2E + (size_t)VCAP * ldE;
    acts = sizeof(T) == 2 ? 2 * (size_t)BMAX * ldA : 0;
    feats = sizeof(T) == 2 ? 2 * (size_t)L * E : 0;
    floats = PART_FLOATS + BMAX * (2 * GATE_ROWS + 2 * ECAP + VCAP + 2 * HCAP) + E + round4(L);
  }
  __host__ __device__ size_t bytes() const {
    return align16(sizeof(T) * (weights + acts + feats)) + 4 * floats + 4 * 2 * BMAX;
  }
};

template <typename T>
size_t smem_bytes(int L, int E, int H) {
  return Layout<T>(L, E, H).bytes();
}

template <typename T>
size_t workspace_bytes(int E, int H, int nblk) {
  return 2 * align16(sizeof(T) * BMAX * H) + 3 * align16(sizeof(T) * BMAX * E) +
         align16(4 * (size_t)BMAX * E) + align16(8 * (size_t)nblk * BMAX) + 16;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) greedy_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, E = a.E, H = a.H, V = a.V, steps = a.steps;
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = span_lo(blk, nblk, H), nh = span_lo(blk + 1, nblk, H) - h0;
  const int e0 = span_lo(blk, nblk, E), ne = span_lo(blk + 1, nblk, E) - e0;
  const int v0 = span_lo(blk, nblk, V), nv = span_lo(blk + 1, nblk, V) - v0;
  const Layout<T> lay(L, E, H);
  const int ldE = lay.ldE, ldH = lay.ldH, ld2E = lay.ld2E;

  T* ih0 = reinterpret_cast<T*>(smem);       // GATE_ROWS x ldE
  T* hh0 = ih0 + GATE_ROWS * ldE;            // GATE_ROWS x ldH
  T* ih1 = hh0 + GATE_ROWS * ldH;            // GATE_ROWS x ldH
  T* hh1 = ih1 + GATE_ROWS * ldH;            // GATE_ROWS x ldH
  T* eh = hh1 + GATE_ROWS * ldH;             // 2 ECAP x ldH: W_h rows, then fc1 rows
  T* comb = eh + 2 * ECAP * ldH;             // ECAP x ld2E: [W_e | W_c]
  T* fc2 = comb + ECAP * ld2E;               // VCAP x ldE
  T* act0 = fc2 + VCAP * ldE;                // bf16: BMAX x ldA staged operands
  T* act1 = act0 + lay.acts / 2;
  T* feats_s = act0 + lay.acts;              // bf16: L x E, the attended row
  T* fproj_s = feats_s + lay.feats / 2;
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) * (lay.weights + lay.acts +
                                                                     lay.feats)));
  float* rec0 = part + PART_FLOATS;          // BMAX x GATE_ROWS: h0(t-1)·W_hh0ᵀ
  float* rec1 = rec0 + BMAX * GATE_ROWS;     // BMAX x GATE_ROWS: h1(t-1)·W_hh1ᵀ
  float* es = rec1 + BMAX * GATE_ROWS;       // BMAX x 2 ECAP: h1(t-1)·[W_h | fc1]ᵀ
  float* gs = es + BMAX * 2 * ECAP;          // BMAX x VCAP: a phase's product
  float* c0s = gs + BMAX * VCAP;             // BMAX x HCAP
  float* c1s = c0s + BMAX * HCAP;
  float* hw_s = c1s + BMAX * HCAP;           // E
  float* w_s = hw_s + E;                     // L
  int* tok_s = reinterpret_cast<int*>(w_s + round4(L));  // BMAX
  int* done_s = tok_s + BMAX;

  stage_gate_rows(ih0, ldE, a.w_ih0, E, H, h0, nh);
  stage_gate_rows(hh0, ldH, a.w_hh0, H, H, h0, nh);
  stage_gate_rows(ih1, ldH, a.w_ih1, H, H, h0, nh);
  stage_gate_rows(hh1, ldH, a.w_hh1, H, H, h0, nh);
  stage_rows(eh, ldH, a.w_attn, H + E, H, e0, ne, ECAP);
  stage_rows(eh + ECAP * ldH, ldH, a.fc1_w, H, H, e0, ne, ECAP);
  stage_rows(comb, ld2E, a.w_comb, 2 * E, 2 * E, e0, ne, ECAP);
  stage_rows(fc2, ldE, a.fc2_w, E, E, v0, nv, VCAP);

  const Src<T> none{nullptr, 0, 0, nullptr};
  const Src<T> h0src{a.h0, H, H, nullptr}, h1src{a.h1, H, H, nullptr};
  const Src<T> hidsrc{a.hid, E, E, nullptr}, x0src{a.x0, E, E, nullptr};
  const Src<T> embsrc{a.emb, E, E, tok_s}, ctxsrc{a.ctx, E, E, nullptr};

  for (int b0 = 0; b0 < a.B; b0 += BMAX) {
    const int M = min(BMAX, a.B - b0);
    // bf16, at most a row a block: the attended row's feats stay resident
    const bool resident = lay.feats > 0 && M <= nblk;
    if (resident && blk < M)
      for (int i = tid; i < L * E / 8; i += THREADS) {
        const size_t o = (size_t)(b0 + blk) * L * E + 8 * (size_t)i;
        reinterpret_cast<uint4*>(feats_s)[i] = *reinterpret_cast<const uint4*>(a.feats + o);
        reinterpret_cast<uint4*>(fproj_s)[i] = *reinterpret_cast<const uint4*>(a.f_proj + o);
      }
    for (int i = tid; i < BMAX * HCAP; i += THREADS) c0s[i] = c1s[i] = 0.f;
    for (int i = tid; i < BMAX; i += THREADS) {
      tok_s[i] = TOK_START;
      done_s[i] = 0;
    }
    __syncthreads();

    for (int t = 0; t <= steps; ++t) {
      // 1. products of h1(t-1) and h0(t-1) (zero at t = 0)
      if (t > 0) {
        const View<T> A1 = operand(h1src, none, M, act0);
        const View<T> A0 = operand(h0src, none, M, act1);
        __syncthreads();
        product(A1, M, hh1, ldH, GATE_ROWS, rec1, GATE_ROWS, part);
        product_fma(A1, M, eh, ldH, 2 * ECAP, es, 2 * ECAP);
        if (t < steps) product(A0, M, hh0, ldH, GATE_ROWS, rec0, GATE_ROWS, part);
      } else {
        for (int i = tid; i < BMAX * GATE_ROWS; i += THREADS) rec0[i] = rec1[i] = 0.f;
        for (int i = tid; i < BMAX * 2 * ECAP; i += THREADS) es[i] = 0.f;
        __syncthreads();
      }
      for (int i = tid; i < M * ne; i += THREADS) {
        const int m = i / ne, c = i % ne, e = e0 + c;
        if (t < steps) a.hw[m * E + e] = es[m * 2 * ECAP + c];
        if (t > 0)
          a.hid[m * E + e] = from_f<T>(fmaxf(es[m * 2 * ECAP + ECAP + c] + a.fc1_b[e], 0.f));
      }
      grid_barrier(a.bar, nblk);

      // 2. logits(t-1) over the owned columns, a partial argmax a row;
      //    attention of step t for the rows this block owns
      if (t > 0) {
        const View<T> Ah = operand(hidsrc, none, M, act0);
        __syncthreads();
        product(Ah, M, fc2, ldE, nv, gs, VCAP, part);
        for (int m = warp; m < M; m += WARPS) {
          float best = -INFINITY;
          int bi = V;
          if (lane < nv) {
            float x = gs[m * VCAP + lane] + a.fc2_b[v0 + lane];
            if (a.temperature != 1.f) x = x / a.temperature;
            best = x;
            bi = v0 + lane;
          }
          lanes_argmax(&best, &bi, 32);
          if (lane == 0)
            a.best[m * nblk + blk] = pack_best(best, bi);
        }
      }
      if (t < steps)
        for (int b = blk; b < M; b += nblk) {
          const size_t o = (size_t)(b0 + b) * L * E;
          attend_row<T>(resident ? fproj_s : a.f_proj + o, resident ? feats_s : a.feats + o,
                        a.hw + (size_t)b * E, L, E, hw_s, w_s, a.ctx + (size_t)b * E, nullptr);
        }
      grid_barrier(a.bar, nblk);

      // 3. token of step t-1 (every block, the same reduction, 16 threads a
      //    row over its nblk contiguous partials); x0(t)
      if (t > 0) {
        const int m = tid / 16, sub = tid % 16;
        float best = -INFINITY;
        int bi = V;
        if (m < M) {
          const unsigned long long* row = a.best + (size_t)m * nblk;
          unsigned long long p[16];
#pragma unroll
          for (int r = 0; r < 16; ++r)  // all loads first: one round trip
            p[r] = sub + 16 * r < nblk ? __ldcg(row + sub + 16 * r) : 0ull;
          auto consider = [&](unsigned long long pr) {
            const float v = best_value(pr);
            const int vi = best_index(pr);
            if (beats(v, vi, best, bi)) {
              best = v;
              bi = vi;
            }
          };
#pragma unroll
          for (int r = 0; r < 16; ++r)
            if (sub + 16 * r < nblk) consider(p[r]);
          for (int j = sub + 256; j < nblk; j += 16) consider(__ldcg(row + j));
        }
        lanes_argmax(&best, &bi, 16);
        if (sub == 0 && m < M) {
          int o;
          emit_token(bi, &o, tok_s + m, done_s + m);
          if (blk == 0) a.out[(size_t)(b0 + m) * steps + t - 1] = o;
        }
        __syncthreads();
      }
      if (t == steps) break;
      const View<T> Ax = operand(embsrc, ctxsrc, M, act0);
      __syncthreads();
      product_fma(Ax, M, comb, ld2E, ECAP, gs, ECAP);
      for (int i = tid; i < M * ne; i += THREADS) {
        const int m = i / ne, c = i % ne;
        a.x0[m * E + e0 + c] = from_f<T>(gs[m * ECAP + c] + a.b_comb[e0 + c]);
      }
      grid_barrier(a.bar, nblk);

      // 4. layer 0 for the owned units
      const View<T> Ax0 = operand(x0src, none, M, act0);
      __syncthreads();
      product(Ax0, M, ih0, ldE, GATE_ROWS, gs, GATE_ROWS, part);
      for (int i = tid; i < M * nh; i += THREADS) {
        const int m = i / nh, c = i % nh, j = h0 + c;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m * GATE_ROWS + q * HCAP + c;
          g[q] = gs[r] + rec0[r] + a.b0[q * H + j];
        }
        const float h = lstm_cell(g[0], g[1], g[2], g[3], c0s + m * HCAP + c);
        a.h0[m * H + j] = from_f<T>(h);
      }
      grid_barrier(a.bar, nblk);

      // 5. layer 1: input the new h0, recurrent part from phase 1
      const View<T> Ah0 = operand(h0src, none, M, act0);
      __syncthreads();
      product(Ah0, M, ih1, ldH, GATE_ROWS, gs, GATE_ROWS, part);
      for (int i = tid; i < M * nh; i += THREADS) {
        const int m = i / nh, c = i % nh, j = h0 + c;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = m * GATE_ROWS + q * HCAP + c;
          g[q] = gs[r] + rec1[r] + a.b1[q * H + j];
        }
        const float h = lstm_cell(g[0], g[1], g[2], g[3], c1s + m * HCAP + c);
        a.h1[m * H + j] = from_f<T>(h);
      }
      grid_barrier(a.bar, nblk);
    }
  }
}

template <typename T>
int blocks(int L, int E, int H, long long* smem) {
  *smem = (long long)smem_bytes<T>(L, E, H);
  return chain_grid(greedy_kernel<T>, THREADS, smem_bytes<T>(L, E, H));
}

template <typename T>
int launch(const void* const* p, int32_t* out, void* ws, int nblk, int B, int L, int E,
           int H, int V, int T_, float temperature, cudaStream_t stream) {
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
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto take = [&](size_t bytes) {
    unsigned char* r = w;
    w += align16(bytes);
    return r;
  };
  a.h0 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.h1 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * H));
  a.hid = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.ctx = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.x0 = reinterpret_cast<T*>(take(sizeof(T) * BMAX * E));
  a.hw = reinterpret_cast<float*>(take(4 * (size_t)BMAX * E));
  a.best = reinterpret_cast<unsigned long long*>(take(8 * (size_t)nblk * BMAX));
  a.bar = reinterpret_cast<unsigned*>(take(16));
  a.B = B; a.L = L; a.E = E; a.H = H; a.V = V; a.steps = T_;
  a.temperature = temperature;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)greedy_kernel<T>, dim3(nblk), dim3(THREADS),
                                          params, smem_bytes<T>(L, E, H), stream);
}

}  // namespace

// Blocks the cooperative greedy kernel runs on for this dtype and these
// sizes on the current device (0 if it does not fit; negative: a CUDA
// error code), and its dynamic shared memory in bytes through smem.
extern "C" int ic_greedy_blocks(int dtype, int L, int E, int H, long long* smem) {
  if (dtype == 0) return blocks<float>(L, E, H, smem);
  if (dtype == 1) return blocks<bf16>(L, E, H, smem);
  return -(int)cudaErrorInvalidValue;
}

// Bytes of the workspace a launch on nblk blocks needs; the caller zeroes it.
extern "C" long long ic_greedy_workspace_bytes(int dtype, int E, int H, int nblk) {
  return (long long)(dtype == 0 ? workspace_bytes<float>(E, H, nblk)
                                : workspace_bytes<bf16>(E, H, nblk));
}

// dtype: 0 = float32, 1 = bfloat16 (weights, feats and f_proj; biases are
// float32).  ptrs: the 16 operands in the order of Args; ws: a zeroed
// workspace of ic_greedy_workspace_bytes; nblk: from ic_greedy_blocks (each
// block may own at most 4 hidden units, 2 of E and 24 of V).  Returns a
// cudaError_t.
extern "C" int ic_greedy_decode(int dtype, const void* const* ptrs, int32_t* out, void* ws,
                                int nblk, int B, int L, int E, int H, int V, int T,
                                float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(ptrs, out, ws, nblk, B, L, E, H, V, T, temperature, s);
  if (dtype == 1) return launch<bf16>(ptrs, out, ws, nblk, B, L, E, H, V, T, temperature, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
