// Attention core forward: out = softmax(q·kᵀ·scale [causal]) · v.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_attention.py
// `fused_attention_core` (`_make_kernel`, `_kernel_call`): one program per
// (batch, head) with the (Lq, Lk) score matrix kept on chip.
//
// Layout: q (BH, Lq, D), k and v (BH, Lk, D), contiguous, 16-byte aligned;
// D = 64, or 48 (the enhanced student's cross refinement, 384 / 8);
// Lk <= 256.  q and k share one type, v may have the other (all four
// pairings of float32 and bfloat16).
// Numerics follow the JAX core: scores accumulate in float32 and are scaled
// after the product, the causal mask sets col > row + q_offset to -inf (query
// row i of a block of rows that starts at position q_offset of the keys'
// sequence, Lq + q_offset <= Lk; 0 with Lq == Lk), softmax runs
// in float32 as exp(s - max) / sum with the max and the sum of the whole
// row, the NORMALISED probabilities are rounded to v's type before the
// product with v, which accumulates in float32; the output has v's type.
//
// What bounds it on the H100: at the main path's shapes (up to 96 heads of
// 197 x 197 at hd 64) it moves a few MB and does about 1 GFLOP, so the
// bound is a few microseconds and the real limits are how many SMs get
// work and how fast a block turns its staged K and V into products.
// Design:
//  * A block takes one (batch, head) and a run of 16-row query tiles; its
//    WARPS warps each own one 16-row tile at a time (the M of an mma.sync).
//    The host picks the run length so that a head's K and V are staged by
//    as few blocks as fill the card's resident slots (occupancy x SMs).
//  * K and V are staged once per block in their storage type with cp.async
//    (16-byte copies, rows zero-filled up to a multiple of 16 keys; rows
//    padded so that every fragment load below is free of bank conflicts).
//  * Scores: bf16 q·kᵀ on tensor cores (mma.sync m16n8k16, float32
//    accumulation); float32 q·kᵀ as 3xTF32 (m16n8k8 on hi/lo tf32 halves:
//    hi·hi + hi·lo + lo·hi), which keeps float32's accuracy (plain TF32
//    does not).  A warp keeps its 16 x Lk scores in registers; the key
//    budget is a template parameter (64 or 256 keys).
//  * Two-pass softmax in registers: pass 1 takes the row max and the row
//    sum over all key tiles (quad shuffles), pass 2 normalises and rounds
//    each probability to v's type, then P·V on tensor cores: bf16 P and V
//    by m16n8k16 with V fragments from ldmatrix.trans, reusing the score
//    registers as A fragments; float32 V by 3xTF32.  No online rescale:
//    the rounding of the normalised probability is the reference's.
// No library kernel (cuBLAS, cuDNN, SDPA) is called.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

// Row padding of a staged array (elements): bf16 rows of D + 8 and float32
// rows of D + 4 put the 8 rows x 4 words of a fragment load in 32 banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<bf16> { static constexpr int value = 8; };

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [0, rows) of a row-major (valid x D) array into shared memory
// with row stride S elements; rows >= valid become zeros.
template <int D, int S, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int valid,
                                           int tid, int nthreads) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int C = D / E;           // chunks per row
  for (int i = tid; i < rows * C; i += nthreads) {
    const int r = i / C, c = i % C;
    const bool ok = r < valid;
    cp_async16(dst + r * S + c * E, src + (size_t)(ok ? r : 0) * D + c * E, ok);
  }
}

// Pure register operations (not volatile): the compiler may interleave
// independent products.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// 3xTF32: a·b in float32 accuracy as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the
// small products first.  The three products of one accumulator depend on
// each other, so callers issue each of the three passes over several
// independent accumulators at once.
struct Tf32x2 {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split4(const float* x, Tf32x2& r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], r.hi[i], r.lo[i]);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Scores of one 16-row tile against NT tiles of 8 keys (nt of them used):
// s[j] is the 16 x 8 accumulator of keys 8j..8j+7 (thread: rows g, g + 8,
// columns 2t, 2t + 1, with g = lane / 4, t = lane % 4).
template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const bf16* Qs, const bf16* Ks,
                                       int nt, int g, int t) {
  constexpr int S = D + Pad<bf16>::value;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[4];
    a[0] = ld32(Qs + g * S + k0 + 2 * t);
    a[1] = ld32(Qs + (g + 8) * S + k0 + 2 * t);
    a[2] = ld32(Qs + g * S + k0 + 8 + 2 * t);
    a[3] = ld32(Qs + (g + 8) * S + k0 + 8 + 2 * t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const bf16* kr = Ks + (j * 8 + g) * S + k0 + 2 * t;
        const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16(s[j], a, b);
      }
    }
  }
}

template <int D, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* Qs, const float* Ks,
                                       int nt, int g, int t) {
  constexpr int S = D + Pad<float>::value, J = 4;  // key tiles a pass covers
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 8) {
    const float av[4] = {Qs[g * S + k0 + t], Qs[(g + 8) * S + k0 + t],
                         Qs[g * S + k0 + t + 4], Qs[(g + 8) * S + k0 + t + 4]};
    Tf32x2 a;
    split4(av, a);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += J) {
      if (j0 < nt) {
        uint32_t bh[J][2], bl[J][2];
#pragma unroll
        for (int u = 0; u < J; ++u) {
          const float* kr = Ks + ((j0 + u) * 8 + g) * S + k0 + t;
          const bool in = j0 + u < nt;  // nt is even, J is not a divisor
          split_tf32(in ? kr[0] : 0.f, bh[u][0], bl[u][0]);
          split_tf32(in ? kr[4] : 0.f, bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < J; ++u)
          if (j0 + u < nt) mma_tf32(s[j0 + u], a.lo, bh[u]);
#pragma unroll
        for (int u = 0; u < J; ++u)
          if (j0 + u < nt) mma_tf32(s[j0 + u], a.hi, bl[u]);
#pragma unroll
        for (int u = 0; u < J; ++u)
          if (j0 + u < nt) mma_tf32(s[j0 + u], a.hi, bh[u]);
      }
    }
  }
}

// o[n] += P·V over nt key tiles, P in s (already rounded to v's type).
template <int D, int NT>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&s)[NT][4],
                                   const bf16* Vs, int nt, int lane) {
  constexpr int S = D + Pad<bf16>::value;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    if (2 * kc < nt) {  // nt is even: keys are staged in runs of 16
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const bf16* vr = Vs + (kc * 16 + (lane & 15)) * S;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vr + n * 8);
        mma_bf16(o[n], a, b);
      }
    }
  }
}

// float32 V: the k index of an m16n8k8 fragment is permuted within each
// tile of 8 keys (k = t is key 2t, k = t + 4 is key 2t + 1), so that the
// score registers serve as A fragments unchanged.
template <int D, int NT>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&s)[NT][4],
                                   const float* Vs, int nt, int lane) {
  constexpr int S = D + Pad<float>::value, N = D / 8;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const float av[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      Tf32x2 a;
      split4(av, a);
      const float* vr = Vs + (j * 8 + 2 * t) * S + g;
      uint32_t bh[N][2], bl[N][2];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        split_tf32(vr[n * 8], bh[n][0], bl[n][0]);
        split_tf32(vr[S + n * 8], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < N; ++n) mma_tf32(o[n], a.lo, bh[n]);
#pragma unroll
      for (int n = 0; n < N; ++n) mma_tf32(o[n], a.hi, bl[n]);
#pragma unroll
      for (int n = 0; n < N; ++n) mma_tf32(o[n], a.hi, bh[n]);
    }
  }
}

template <int D, typename TQ, typename TV>
__host__ __device__ constexpr size_t smem_bytes(int Lkp, int WARPS) {
  return (size_t)Lkp * (D + Pad<TQ>::value) * sizeof(TQ) +
         (size_t)Lkp * (D + Pad<TV>::value) * sizeof(TV) +
         (size_t)WARPS * 16 * (D + Pad<TQ>::value) * sizeof(TQ);
}

// NT: tiles of 8 keys the registers hold (Lk <= 8 NT).  Block: one head
// (blockIdx.x / parts), query tiles [first, first + count) of 16 rows, one
// warp a tile at a time (blockDim.x / 32 warps, at most MAX_WARPS).
constexpr int MAX_WARPS = 8;
constexpr int MAX_DEVICES = 64;  // devices whose set-once state launch keeps

template <int D, typename TQ, typename TV, int NT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
attention_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                 const TV* __restrict__ v, TV* __restrict__ out, int Lq, int Lk,
                 int parts, int tiles_per_part, float scale, int causal,
                 int q_offset) {
  constexpr int KS = D + Pad<TQ>::value, VS = D + Pad<TV>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lkp = (Lk + 15) / 16 * 16;
  TQ* Ks = reinterpret_cast<TQ*>(smem);
  TV* Vs = reinterpret_cast<TV*>(Ks + Lkp * KS);
  TQ* Qall = reinterpret_cast<TQ*>(Vs + Lkp * VS);

  const size_t bh = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int WARPS = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int nt = Lkp / 8;
  stage_rows<D, KS>(Ks, k + bh * Lk * D, Lkp, Lk, tid, blockDim.x);
  stage_rows<D, VS>(Vs, v + bh * Lk * D, Lkp, Lk, tid, blockDim.x);
  cp_async_wait_all();
  __syncthreads();

  TQ* Qs = Qall + warp * 16 * KS;
  const int mtiles = (Lq + 15) / 16;
  const int first = part * tiles_per_part;
  const int last = min(first + tiles_per_part, mtiles);
  for (int tile = first + warp; tile < last; tile += WARPS) {
    const int m0 = tile * 16;
    __syncwarp();
    stage_rows<D, KS>(Qs, q + (bh * Lq + m0) * D, 16, Lq - m0, lane, 32);
    cp_async_wait_all();
    __syncwarp();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    scores<D, NT>(s, Qs, Ks, nt, g, t);

    // pass 1: scale, mask, row max and row sum of exp(s - max)
    const int row_lo = m0 + g, row_hi = row_lo + 8;
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * 8 + 2 * t + (c & 1);
        const int row = c < 2 ? row_lo : row_hi;
        float x = s[j][c] * scale;
        if (col >= Lk || (causal && col > row + q_offset)) x = -INFINITY;
        s[j][c] = x;
      }
      m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
      m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = expf(s[j][c] - (c < 2 ? m_lo : m_hi));
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
    }
    // pass 2: normalise, round to v's type, P·V
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = s[j][c] / (c < 2 ? sum_lo : sum_hi);
        s[j][c] = round_to(s[j][c], TV());
      }

    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    pv<D, NT>(o, s, Vs, nt, lane);

    TV* orow = out + (bh * Lq + m0) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (m0 + g < Lq) store2(orow + g * D + n * 8, o[n][0], o[n][1]);
      if (m0 + g + 8 < Lq) store2(orow + (g + 8) * D + n * 8, o[n][2], o[n][3]);
    }
  }
}

template <int D, typename TQ, typename TV, int NT>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Lq,
           int Lk, float scale, int causal, int q_offset, cudaStream_t stream) {
  auto kern = attention_kernel<D, TQ, TV, NT>;
  const int Lkp = (Lk + 15) / 16 * 16;
  const int mtiles = (Lq + 15) / 16;
  const int warps = mtiles <= 4 ? 4 : MAX_WARPS;
  const size_t smem = smem_bytes<D, TQ, TV>(Lkp, warps);
  // Set once per instance and device: the shared-memory ceiling; and, per
  // staged key count and warp count, the blocks the device holds at once.
  // Threads that race here set and store the same values.
  static std::atomic<bool> ready[MAX_DEVICES];
  static std::atomic<int> resident[MAX_DEVICES][2][NT / 2 + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<D, TQ, TV>(NT * 8, MAX_WARPS));
    if (err != cudaSuccess) return (int)err;
    ready[dev].store(true, std::memory_order_release);
  }
  std::atomic<int>& resident_here = resident[dev][warps == MAX_WARPS][Lkp / 16];
  int slots = resident_here.load(std::memory_order_relaxed);
  if (slots == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    slots = (per_sm > 0 ? per_sm : 1) * sms;
    resident_here.store(slots, std::memory_order_relaxed);
  }
  // Blocks per head: as few as fill the resident slots, at most one query
  // tile per warp.
  const int most = (mtiles + warps - 1) / warps;
  const int want = (slots + BH - 1) / BH;
  const int parts = want < most ? (want > 0 ? want : 1) : most;
  const int per_part = (mtiles + parts - 1) / parts;
  kern<<<BH * parts, warps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k), static_cast<const TV*>(v),
      static_cast<TV*>(out), Lq, Lk, parts, per_part, scale, causal, q_offset);
  return (int)cudaGetLastError();
}

// Two register budgets: up to 64 keys, and up to 256.
template <int D, typename TQ, typename TV>
int by_keys(const void* q, const void* k, const void* v, void* out, int BH, int Lq,
            int Lk, float scale, int causal, int q_offset, cudaStream_t s) {
  if (Lk <= 64)
    return launch<D, TQ, TV, 8>(q, k, v, out, BH, Lq, Lk, scale, causal, q_offset, s);
  if (Lk <= 256)
    return launch<D, TQ, TV, 32>(q, k, v, out, BH, Lq, Lk, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int dispatch(int qk_dtype, int v_dtype, const void* q, const void* k, const void* v,
             void* out, int BH, int Lq, int Lk, float scale, int causal,
             int q_offset, cudaStream_t s) {
  if (qk_dtype == 0 && v_dtype == 0)
    return by_keys<D, float, float>(q, k, v, out, BH, Lq, Lk, scale, causal,
                                   q_offset, s);
  if (qk_dtype == 1 && v_dtype == 1)
    return by_keys<D, bf16, bf16>(q, k, v, out, BH, Lq, Lk, scale, causal,
                                   q_offset, s);
  if (qk_dtype == 0 && v_dtype == 1)
    return by_keys<D, float, bf16>(q, k, v, out, BH, Lq, Lk, scale, causal,
                                   q_offset, s);
  if (qk_dtype == 1 && v_dtype == 0)
    return by_keys<D, bf16, float>(q, k, v, out, BH, Lq, Lk, scale, causal,
                                   q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; D is 64 or 48; 0 < Lk <= 256;
// causal: query row i sees keys <= i + q_offset (Lq + q_offset <= Lk).
// Returns a cudaError_t.
extern "C" int ic_attention_core(int qk_dtype, int v_dtype, const void* q,
                                 const void* k, const void* v, void* out, int BH,
                                 int Lq, int Lk, int D, float scale, int causal,
                                 int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dispatch<64>(qk_dtype, v_dtype, q, k, v, out, BH, Lq, Lk, scale, causal,
                       q_offset, s);
  if (D == 48)
    return dispatch<48>(qk_dtype, v_dtype, q, k, v, out, BH, Lq, Lk, scale, causal,
                       q_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
