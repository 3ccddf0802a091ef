// Cooperative step chains, shared by greedy_decode.cu, decoder_scan.cu,
// decoder_scan_bwd.cu, enhanced_scan.cu, greedy_decode_compact.cu and
// compact_scan.cu.
//
// A recurrence whose steps depend on one another runs as one persistent
// cooperative launch over the whole card.  Each block owns a slice of the
// output columns of every product, keeps the matching weight rows (or
// columns) resident in shared memory for all steps, and the small vectors
// that cross blocks (h, x0, ctx, ...) go through L2 behind a grid barrier:
// written with ordinary stores, read with __ldcg (L2, never this SM's
// incoherent L1).

#pragma once

#include "recurrent.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// A load of data written earlier in the same kernel by another block.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }

// First of the n items that block blk of nblk owns; it owns [lo(blk), lo(blk + 1)).
__host__ __device__ inline int span_lo(int blk, int nblk, int n) {
  return (int)((long long)blk * n / nblk);
}

// What block `blk` of `nblk` owns in the reverse chain of decoder_scan_bwd.cu:
// columns [h0, h1) of H, [e0, e1) of E, (row, token) pairs [p0, p1) of B·L,
// (row, column) pairs [q0, q1) of B·E.
struct Owned {
  int h0, h1, e0, e1, p0, p1, q0, q1;
  __device__ Owned(int blk, int nblk, int B, int L, int E, int H)
      : h0(span_lo(blk, nblk, H)), h1(span_lo(blk + 1, nblk, H)),
        e0(span_lo(blk, nblk, E)), e1(span_lo(blk + 1, nblk, E)),
        p0(span_lo(blk, nblk, B * L)), p1(span_lo(blk + 1, nblk, B * L)),
        q0(span_lo(blk, nblk, B * E)), q1(span_lo(blk + 1, nblk, B * E)) {}
};

// Sense-reversing grid barrier over co-resident blocks (a cooperative
// launch guarantees residency).  bar: two zeroed words, arrivals and
// generation; arrivals are back at 0 when the barrier opens.  Writes before
// it are visible after it to loads that bypass L1 (__ldcg).
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Stage a (rows x nc) column slice of W (row stride ld, first column c0)
// into shared memory with row stride cmax; columns >= nc are zero.
template <typename T>
__device__ void stage_slice(T* dst, const T* W, int ld, int c0, int rows, int nc, int cmax) {
  for (int i = threadIdx.x; i < rows * cmax; i += blockDim.x) {
    const int k = i / cmax, c = i % cmax;
    dst[i] = c < nc ? W[(size_t)k * ld + c0 + c] : T(0.f);
  }
}

// Stage rows [r0, r0 + nr) of W (row stride ld, K wide) into dst with row
// stride ldd; rows nr..alloc-1 of dst are zero.
template <typename T>
__device__ void stage_rows(T* dst, int ldd, const T* W, int ld, int K, int r0, int nr,
                           int alloc) {
  for (int i = threadIdx.x; i < alloc * K; i += blockDim.x) {
    const int r = i / K, k = i % K;
    dst[(size_t)r * ldd + k] = r < nr ? W[(size_t)(r0 + r) * ld + k] : T(0.f);
  }
}

// The four gate rows (torch order i, f, g, o) of hidden units [h0, h0 + nh)
// of a (4H, K) LSTM weight, as rows gate * HCAP + c of dst (row stride ldd);
// units nh..HCAP-1 are zero.
constexpr int HCAP = 4;            // most hidden units a block owns
constexpr int GATE_ROWS = 4 * HCAP;
template <typename T>
__device__ void stage_gate_rows(T* dst, int ldd, const T* W, int K, int H, int h0, int nh) {
  for (int i = threadIdx.x; i < GATE_ROWS * K; i += blockDim.x) {
    const int r = i / K, k = i % K, gate = r / HCAP, c = r % HCAP;
    dst[(size_t)r * ldd + k] = c < nh ? W[(size_t)(gate * H + h0 + c) * K + k] : T(0.f);
  }
}

// One LSTM cell update from the four gate pre-activations (torch order i,
// f, g, o; bias included): updates *cst, returns h.
__device__ __forceinline__ float lstm_cell(float i, float f, float g, float o, float* cst) {
  const float cn = sigmoid(f) * *cst + sigmoid(i) * tanhf(g);
  *cst = cn;
  return sigmoid(o) * tanhf(cn);
}

// ---------------------------------------------------------------------------
// Products of the batch's activations with a block's resident weight rows
// ---------------------------------------------------------------------------

constexpr int PAD = 8;  // row padding (elements) of staged rows: spreads smem banks

// An activation in L2: row m (< M) at p + row(m) * ld, K columns, where
// row(m) = idx ? idx[m] : m.  K is a multiple of 16.
template <typename T>
struct Src {
  const T* p;
  int ld, K;
  const int* idx;
  __device__ const T* row(int m) const { return p + (size_t)(idx ? idx[m] : m) * ld; }
};

__device__ __forceinline__ float ld_cg_elem(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg_elem(const bf16* p) {
  return __uint_as_float((uint32_t)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The A operand of a phase's products: [A1 | A2] (M rows, K1 + K2 columns),
// staged in this block's shared memory (bf16) or read from L2 in place
// (float32, whose resident weights leave no room to stage it).
template <typename T>
struct View {
  Src<T> a1, a2;
  bool shared;
  __device__ const T* at(int m, int k) const {
    return k < a1.K ? a1.row(m) + k : a2.row(m) + (k - a1.K);
  }
  __device__ float get(int m, int k) const {
    const T* p = at(m, k);
    return shared ? to_f(*p) : ld_cg_elem(p);
  }
};

// The View of [A1 | A2] for a phase.  bf16: all threads copy the M rows into
// buf (row stride K + PAD) with 16-byte L2 loads, one round trip for the
// whole operand; the caller synchronises the block before using it.
// float32: the operand in place.
template <typename T>
__device__ View<T> operand(const Src<T>& a1, const Src<T>& a2, int M, T* buf) {
  if constexpr (sizeof(T) == 2) {
    const int K = a1.K + a2.K, ld = K + PAD, chunks = K / 8;
    for (int i = threadIdx.x; i < M * chunks; i += THREADS) {
      const int m = i / chunks, k = (i % chunks) * 8;
      const T* src = k < a1.K ? a1.row(m) + k : a2.row(m) + (k - a1.K);
      *reinterpret_cast<uint4*>(buf + (size_t)m * ld + k) =
          __ldcg(reinterpret_cast<const uint4*>(src));
    }
    return View<T>{Src<T>{buf, ld, K, nullptr}, Src<T>{nullptr, 0, 0, nullptr}, true};
  } else {
    return View<T>{a1, a2, false};
  }
}

constexpr int PART_FLOATS = WARPS * 128;  // one 16x8 float tile per warp

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[m * ldo + n] = sum_k A[m, k] · W[n, k] for m < M, n < N, with A a
// staged bf16 View and W's rows resident in shared memory (row stride ldw).
// Tensor cores: mma.sync m16n8k16 with float32 accumulation, over 16-row
// tiles of M (padded with zero rows) and 8-row tiles of N.  The k-steps of a
// tile are split over the block's warps; each warp keeps its partial tile in
// `part` and the partials are added in warp order, so the result repeats
// bit for bit.  At most WARPS tiles.  Ends synchronised.
__device__ void product_mma(const View<bf16>& A, int M, const bf16* W, int ldw, int N,
                            float* out, int ldo, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int nt = (N + 7) / 8, units = (M + 15) / 16 * nt;
  const int split = units >= WARPS || units == 0 ? 1 : WARPS / units;
  const int steps = A.a1.K / 16;
  const int lda = A.a1.ld;
  for (int w = warp; w < units * split; w += WARPS) {
    const int u = w % units, s = w / units;
    const int r0 = (u / nt) * 16 + g, r1 = r0 + 8, n = (u % nt) * 8 + g;
    const bf16* ar0 = A.a1.p + (size_t)r0 * lda + 2 * q;
    const bf16* ar1 = ar0 + 8 * (size_t)lda;
    const bf16* wr = W + (size_t)n * ldw + 2 * q;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const int k_lo = steps * s / split * 16, k_hi = steps * (s + 1) / split * 16;
#pragma unroll 4
    for (int k = k_lo; k < k_hi; k += 16) {
      uint32_t av[4] = {0u, 0u, 0u, 0u}, bv[2] = {0u, 0u};
      if (r0 < M) {
        av[0] = *reinterpret_cast<const uint32_t*>(ar0 + k);
        av[2] = *reinterpret_cast<const uint32_t*>(ar0 + k + 8);
      }
      if (r1 < M) {
        av[1] = *reinterpret_cast<const uint32_t*>(ar1 + k);
        av[3] = *reinterpret_cast<const uint32_t*>(ar1 + k + 8);
      }
      if (n < N) {
        bv[0] = *reinterpret_cast<const uint32_t*>(wr + k);
        bv[1] = *reinterpret_cast<const uint32_t*>(wr + k + 8);
      }
      mma_bf16(c, av, bv);
    }
    float* pt = part + w * 128;
    pt[g * 8 + 2 * q] = c[0];
    pt[g * 8 + 2 * q + 1] = c[1];
    pt[(g + 8) * 8 + 2 * q] = c[2];
    pt[(g + 8) * 8 + 2 * q + 1] = c[3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * N; i += THREADS) {
    const int m = i / N, n = i % N, u = (m / 16) * nt + n / 8;
    const int at = (m % 16) * 8 + n % 8;
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += part[(s * units + u) * 128 + at];
    out[m * ldo + n] = v;
  }
  __syncthreads();
}

// The same product on CUDA cores in float32 FMAs, for any View.  A warp
// takes (row m, 8 columns of N); its lanes split k and a shuffle tree adds
// the lanes in a fixed order.  Ends synchronised.
template <typename T>
__device__ void product_fma(const View<T>& A, int M, const T* W, int ldw, int N, float* out,
                            int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (N + 7) / 8, K = A.a1.K + A.a2.K;
  for (int w = warp; w < M * chunks; w += WARPS) {
    const int m = w / chunks, n0 = (w % chunks) * 8, nc = min(8, N - n0);
    const T* wr = W + (size_t)n0 * ldw;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float x = A.get(m, k);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < nc) acc[c] = fmaf(x, to_f(wr[(size_t)c * ldw + k]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nc) {  // nc is the same across the warp
        const float s = warp_sum(acc[c]);
        if (lane == 0) out[m * ldo + n0 + c] = s;
      }
  }
  __syncthreads();
}

// A product whose N fills tensor-core tiles (the gates' 16 rows, fc2's 24
// columns): mma.sync for bf16, FMAs for float32.
__device__ void product(const View<bf16>& A, int M, const bf16* W, int ldw, int N, float* out,
                        int ldo, float* part) {
  product_mma(A, M, W, ldw, N, out, ldo, part);
}
__device__ void product(const View<float>& A, int M, const float* W, int ldw, int N,
                        float* out, int ldo, float*) {
  product_fma(A, M, W, ldw, N, out, ldo);
}

// Bahdanau attention of one batch row: scores[l] = sum_e tanh(f_proj[l, e] +
// hw[e]) (hw float32, written in this kernel), softmax over L in float32
// (also stored to attn_out when given), ctx = sum_l w[l] · feats[l, :]
// rounded to T into ctx_out.  hw_s (E) and w_s (L) are shared scratch.
// Ends synchronised.
template <typename T>
__device__ void attend_row(const T* f_proj, const T* feats, const float* hw, int L, int E,
                           float* hw_s, float* w_s, T* ctx_out, float* attn_out) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < E; e += THREADS) hw_s[e] = ld_cg(hw + e);
  __syncthreads();
  for (int l = warp; l < L; l += WARPS) {
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += tanhf(to_f(f_proj[(size_t)l * E + e]) + hw_s[e]);
    s = warp_sum(s);
    if (lane == 0) w_s[l] = s;
  }
  __syncthreads();
  if (attn_out)
    warp0_softmax<true>(w_s, L, attn_out);
  else
    warp0_softmax<false>(w_s, L, nullptr);
  __syncthreads();
  for (int e = tid; e < E; e += THREADS) {
    float c = 0.f;
    for (int l = 0; l < L; ++l) c = fmaf(w_s[l], to_f(feats[(size_t)l * E + e]), c);
    ctx_out[e] = from_f<T>(c);
  }
  __syncthreads();
}

// Dot attention of one batch row of the compact decoder over its feats (L x
// E, in shared memory): scores[l] = hp·feats[l, :] (hp float32, written in
// this kernel), softmax over L in float32 (also stored to attn_out when
// given), ctx = sum_l w[l] · feats[l, :], and the additive fusion x0 =
// dtype(emb + ctx) into x0_out.  hp_s (E) and w_s (L) are shared scratch.
// Ends synchronised.
template <typename T>
__device__ void attend_dot_row(const T* feats, const float* hp, const T* emb, int L, int E,
                               float* hp_s, float* w_s, T* x0_out, float* attn_out) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < E; e += THREADS) hp_s[e] = ld_cg(hp + e);
  __syncthreads();
  for (int l = warp; l < L; l += WARPS) {
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s = fmaf(hp_s[e], to_f(feats[(size_t)l * E + e]), s);
    s = warp_sum(s);
    if (lane == 0) w_s[l] = s;
  }
  __syncthreads();
  if (attn_out)
    warp0_softmax<true>(w_s, L, attn_out);
  else
    warp0_softmax<false>(w_s, L, nullptr);
  __syncthreads();
  for (int e = tid; e < E; e += THREADS) {
    float c = 0.f;
    for (int l = 0; l < L; ++l) c = fmaf(w_s[l], to_f(feats[(size_t)l * E + e]), c);
    x0_out[e] = from_f<T>(to_f(emb[e]) + c);
  }
  __syncthreads();
}

// (value, index) of the larger under beats(), across groups of `width`
// lanes of a warp.
__device__ __forceinline__ void lanes_argmax(float* best, int* bi, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, *best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, *bi, o);
    if (beats(ov, oi, *best, *bi)) {
      *best = ov;
      *bi = oi;
    }
  }
}

// A partial argmax as one word for the blocks' exchange: index << 32 | the
// value's bits.
__device__ __forceinline__ unsigned long long pack_best(float v, int i) {
  return (unsigned long long)(unsigned)i << 32 | __float_as_uint(v);
}
__device__ __forceinline__ float best_value(unsigned long long p) {
  return __uint_as_float((unsigned)p);
}
__device__ __forceinline__ int best_index(unsigned long long p) { return (int)(p >> 32); }

// Blocks of a cooperative chain kernel on the current device: one per SM
// when at least one block of `threads` threads and `smem` dynamic bytes fits
// an SM, else 0; negative: a CUDA error code.  Raises the kernel's
// shared-memory ceiling on that device to the device's opt-in maximum, so
// one call serves every shape there.
template <typename K>
int chain_grid(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  if (smem > (size_t)optin) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -(int)err;
  return per_sm > 0 ? sms : 0;
}

}  // namespace
