// Attention cores of one beam-search decode step.
//
// Replaces the TPU kernels of imagecaptioner_tpu/ops/pallas_beam_attn.py:
// `fused_beam_self_attention` (`_make_self_kernel`) and
// `fused_beam_cross_attention` (`_make_cross_kernel`).
//
// Rows: an image's K beams are the consecutive rows n*K .. n*K+K-1 of q and
// out, each row E = H*64 values with its heads side by side, a row's start
// `q_stride` / `out_stride` elements after the previous one (so q may be a
// column block of a packed q/k/v projection and nothing is transposed or
// copied around the call).  Numerics (the JAX cores'): scores accumulate in
// float32 and are scaled after the dot, softmax runs in float32 as
// exp(s - max) / sum, the weights are rounded to the cache's type before the
// product with v, which accumulates in float32.
//
// Self: the cache k, v is head-major (R, H, S, 64) and is never reordered
// when beams are re-ranked.  anc (N, K, S) int32 names, for the beam now in
// slot i and each position s, the slot whose row holds that position of the
// beam's lineage.  The TPU kernel scores every query against all K slots
// and masks the others to -inf because its compiler wants 2-D tiles;
// exp(-inf) is exactly 0, so the same function is a gather: query (n, i, h)
// attends, at each s <= pos, row n*K + anc[n, i, s].  What bounds it on the
// H100 is bytes (the named rows of k and v, 4.9 MB at N=16, K=5, pos=19,
// float32: 1.5 us at 3.35 TB/s) and, before that, latency: a warp walking
// the lineage one global load at a time waits some 40 round trips to L2.
// So one block takes an image's beams for one head (up to 8 beams, a warp
// each; more run in groups of 8, a block each), and its first act is to
// put every byte in flight: for each of the image's K slots, lane 0 of one
// warp issues one bulk asynchronous copy (cp.async.bulk) of the slot's
// contiguous rows 0..pos of k and one of v, k's on one mbarrier and v's on
// the other, while the lineage is still being read.  This stages the rows
// that no beam names too (1.5x the named rows on a random table, K x on a
// converged one), but it needs no round trip through the ancestry table
// before the copies start, and it issues a few large copies: a copy a
// named row costs the issuing warp one serialised bulk instruction a lane,
// and 16-byte cp.async pieces cost as many instructions as pieces.
// Meanwhile lane l of beam i's warp reads anc[n, i, l] and anc[n, i, l+32]
// into registers.  Once k has landed (v still in flight) lane l scores its
// positions against the staged row of the slot that anc names, the row and
// the beam's q (in shared memory) read 16 bytes at a time from a piece
// rotated by the lane, so a quarter warp hits distinct banks; the warp's
// softmax over positions 0..pos runs in registers; once v has landed, lane
// l sums P*V for values 2l, 2l+1 over the positions in order, reading each
// position's staged row and weight from a table the warp writes to shared
// memory (eight rows' loads in flight at a time).  Where k and v of all
// K slots exceed the shared-memory budget they are staged in chunks of
// positions (of slots too, for a very large K) through the two buffers in
// turn: k's chunks, the softmax, then v's.  The plan (beams a block, slots
// and positions a chunk, shared bytes) depends on K, pos and the type only,
// and ic_beam_self_plan reports it.
//
// Cross: an image's K beams are K query rows over that image's memory K/V
// (N, H, L, 64).  One block per (image, head).  What bounds it on the H100
// is bytes: every (image, head) slice of K and V is read once (12.9 MB at
// the teacher's N=16, L=197, float32: 3.9 µs at 3.35 TB/s), for 2.6 MFLOP.
// So the block's first act is to put all of its bytes in flight: thread 0
// issues one bulk asynchronous copy (cp.async.bulk, the TMA's plain form)
// of the contiguous (L, 64) K slice and one of the V slice into shared
// memory, each completing on its own mbarrier, while the block loads its
// query rows.  The block scores as soon as K has landed, V still in flight:
// thread j takes key j for up to RG query rows at once, reading the key's
// row in an order rotated by j so that the 32 lanes of a warp hit 32
// different banks of the unpadded row.  A warp per query row takes max, sum
// and the normalised weights, rounded to the cache's type; then, once V has
// landed, thread (d, row group) sums P·V over the keys in order.  More than
// RG beams run in groups of RG over the same resident K/V.  The
// shared-memory ceiling is raised once per type and device, not per call.
//
// No library kernel (cuBLAS, cuDNN, SDPA) is called.

#include "recurrent.cuh"

namespace {

constexpr int D = 64;                 // the teacher's head dimension
constexpr int MAX_S = 64;             // cache positions the self kernel takes
constexpr int MAX_L = 256;            // memory tokens the cross kernel takes
constexpr int MAX_KG = 8;             // beams a self block (a warp each)
constexpr size_t SELF_SMEM = 232448;  // the H100's opt-in shared memory a block
constexpr int CROSS_THREADS = MAX_L;  // a key a thread
constexpr int RG = 8;                 // query rows a group (a warp each)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void copy2(float* dst, const float* src) {
  *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ void copy2(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = *reinterpret_cast<const __nv_bfloat162*>(src);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// --- bulk asynchronous copies into shared memory, completing on an mbarrier

// A barrier whose phases each complete after `count` arrivals and the
// bytes that they expect.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on bar and add `bytes` to what its current phase expects.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` from global src to shared dst (both 16-byte aligned, bytes a
// multiple of 16), the bytes counted off bar's current phase as they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0: expect `bytes` on bar and copy them from global src to shared dst
// (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait until the phase of bar with this parity (its copies) has completed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity = 0) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// --- the self kernel

// How a launch of the self kernel is cut: `kg` beams a block (an image's K
// beams in `groups` blocks a head, a warp a beam); its rows staged in
// `chunks` of `slots` slots x `positions` positions (one chunk unless the
// whole lineage of k and v exceeds the budget); `smem` bytes of dynamic
// shared memory: the two buffers' mbarriers, the group's q rows, a table of
// 64 (row, weight) pairs a beam, then two buffers of slots x positions
// rows.
struct SelfPlan {
  int kg, groups, slots, positions, chunks;
  size_t smem;
};

inline SelfPlan self_plan(int K, int len, size_t item) {
  SelfPlan p;
  p.kg = K < MAX_KG ? K : MAX_KG;
  p.groups = (K + p.kg - 1) / p.kg;
  const size_t fixed = 16 + (size_t)p.kg * (D * item + MAX_S * 8);
  const size_t pair = 2 * (size_t)D * item;  // a row of each buffer
  const size_t rows = (SELF_SMEM - fixed) / pair;
  p.slots = (size_t)K <= rows ? K : (int)rows;
  const size_t fit = rows / p.slots;
  p.positions = fit < (size_t)len ? (int)fit : len;
  p.chunks = (K + p.slots - 1) / p.slots * ((len + p.positions - 1) / p.positions);
  p.smem = fixed + pair * p.slots * p.positions;
  return p;
}

// Dot of a staged row with a q row (64 values each) in float32, 16 bytes of
// each at a time starting at piece `rot` of the row, in four running sums.
__device__ __forceinline__ float row_dot(const float* kr, const float* qr, int rot) {
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  const float4* q4 = reinterpret_cast<const float4*>(qr);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const int c = (i + rot) & (D / 4 - 1);
    const float4 k = k4[c], q = q4[c];
    acc.x = fmaf(q.x, k.x, acc.x);
    acc.y = fmaf(q.y, k.y, acc.y);
    acc.z = fmaf(q.z, k.z, acc.z);
    acc.w = fmaf(q.w, k.w, acc.w);
  }
  return (acc.x + acc.y) + (acc.z + acc.w);
}
__device__ __forceinline__ float dot_bf2(uint32_t q, uint32_t k, float acc) {
  acc = fmaf(__uint_as_float(q << 16), __uint_as_float(k << 16), acc);
  return fmaf(__uint_as_float(q & 0xffff0000u), __uint_as_float(k & 0xffff0000u), acc);
}
__device__ __forceinline__ float row_dot(const __nv_bfloat16* kr, const __nv_bfloat16* qr,
                                         int rot) {
  const uint4* k4 = reinterpret_cast<const uint4*>(kr);
  const uint4* q4 = reinterpret_cast<const uint4*>(qr);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = (i + rot) & (D / 8 - 1);
    const uint4 k = k4[c], q = q4[c];
    acc.x = dot_bf2(q.x, k.x, acc.x);
    acc.y = dot_bf2(q.y, k.y, acc.y);
    acc.z = dot_bf2(q.z, k.z, acc.z);
    acc.w = dot_bf2(q.w, k.w, acc.w);
  }
  return (acc.x + acc.y) + (acc.z + acc.w);
}

// The chunk of a stage: slots [j0, j1), positions [s0, s1).  Chunks run
// slot range by slot range, positions in order within each.
struct Chunk {
  int j0, j1, s0, s1;
};
__device__ __forceinline__ Chunk chunk_of(int c, int K, int len, int J, int C) {
  const int per = (len + C - 1) / C;  // position chunks a slot range
  const int j0 = c / per * J, s0 = c % per * C;
  return {j0, min(K, j0 + J), s0, min(len, s0 + C)};
}

template <typename T>
__global__ void __launch_bounds__(MAX_KG * 32)
beam_self_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ anc,
                 T* __restrict__ out, int out_stride, int K, int H, int S, int pos,
                 float scale, int kg, int groups, int J, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PIECES = D * sizeof(T) / 16;
  constexpr uint32_t ROW = D * sizeof(T);
  const int len = pos + 1;
  const int nc = (K + J - 1) / J * ((len + C - 1) / C);
  const int buf_elems = J * C * D;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // buffer 0's, buffer 1's
  T* q_s = reinterpret_cast<T*>(smem + 16);           // a row a beam
  int2* pv_s = reinterpret_cast<int2*>(q_s + kg * D);  // a (row, weight) table a beam
  T* const buf0 = reinterpret_cast<T*>(pv_s + kg * MAX_S);  // buffer 1 follows it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nh = blockIdx.x / groups, n = nh / H, h = nh % H;
  const int g0 = blockIdx.x % groups * kg;
  const bool live = warp < K - g0;  // the last group may have fewer beams than warps

  // Stage t < nc is k's chunk t, stage nc + c is v's chunk c; it goes to
  // buffer t % 2 (slot j's rows of the chunk contiguous, as in the cache)
  // on that buffer's barrier.  Lane 0 of warp w copies the slots j = w mod
  // warps and then arrives expecting the bytes it copied, so what a barrier
  // waits for is always what was issued.
  auto stage = [&](int t) {
    const Chunk ch = chunk_of(t < nc ? t : t - nc, K, len, J, C);
    const T* cache = t < nc ? kc : vc;
    T* buf = buf0 + (t & 1) * buf_elems;
    uint32_t total = 0;
    for (int j = ch.j0 + warp; j < ch.j1; j += kg) {
      const uint32_t bytes = (ch.s1 - ch.s0) * ROW;
      bulk_copy(buf + (j - ch.j0) * C * D,
                cache + ((((size_t)n * K + j) * H + h) * S + ch.s0) * D, bytes, &bar[t & 1]);
      total += bytes;
    }
    mbar_expect(&bar[t & 1], total);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], kg);  // a phase: every warp's arrival and the bytes it expects
    mbar_init(&bar[1], kg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // warp w takes beam g0 + w, lane l its positions l and l + 32: the slot
  // that holds each (its load in flight while the copies are issued), its
  // score, then its weight
  const int r = n * K + g0 + warp;
  int a[2];
  float x[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = lane + 32 * u;
    a[u] = live && s < len ? anc[(size_t)r * S + s] : 0;
    x[u] = -INFINITY;
  }
  __syncthreads();  // the barriers are initialised before any copy
  if (lane == 0) {
    stage(0);
    stage(1);
  }
  if (live) copy2(q_s + warp * D + 2 * lane, q + (size_t)r * q_stride + h * D + 2 * lane);
  __syncthreads();  // every beam's q is in place

  float a0 = 0.f, a1 = 0.f;
  for (int t = 0; t < 2 * nc; ++t) {
    bulk_wait(&bar[t & 1], (t >> 1) & 1);  // stage t has landed
    const Chunk ch = chunk_of(t < nc ? t : t - nc, K, len, J, C);
    const T* buf = buf0 + (t & 1) * buf_elems;
    if (live && t < nc) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        if (s >= ch.s0 && s < ch.s1 && a[u] >= ch.j0 && a[u] < ch.j1)
          x[u] = row_dot(buf + ((a[u] - ch.j0) * C + s - ch.s0) * D, q_s + warp * D,
                         lane & (PIECES - 1)) *
                 scale;
      }
      if (t == nc - 1) {
        // softmax over positions 0..pos in float32, weights rounded
        const float m = warp_max(fmaxf(x[0], x[1]));
        const float e0 = expf(x[0] - m), e1 = expf(x[1] - m);
        const float sum = warp_sum(e0 + e1);
        x[0] = to_f(from_f<T>(e0 / sum));
        x[1] = to_f(from_f<T>(e1 / sum));
      }
    } else if (live) {
      // lane l: values 2l, 2l + 1, summed over the chunk's positions in
      // order, eight positions' rows in flight at a time; each position's
      // staged row and weight first go to the warp's table (a position
      // whose slot is in another chunk weighs 0 and names a staged row)
      int2* pv = pv_s + warp * MAX_S;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        const bool in = a[u] >= ch.j0 && a[u] < ch.j1;
        if (s >= ch.s0 && s < ch.s1)
          pv[s] = make_int2(((in ? a[u] - ch.j0 : 0) * C + s - ch.s0) * D,
                            __float_as_int(in ? x[u] : 0.f));
      }
      __syncwarp();
      for (int s8 = ch.s0; s8 < ch.s1; s8 += 8) {
        float2 v[8];
        float w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int2 e = pv[min(s8 + u, ch.s1 - 1)];
          v[u] = load2(buf + e.x + 2 * lane);
          w[u] = s8 + u < ch.s1 ? __int_as_float(e.y) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          a0 = fmaf(w[u], v[u].x, a0);
          a1 = fmaf(w[u], v[u].y, a1);
        }
      }
      __syncwarp();  // the table is read before the next chunk's is written
    }
    if (t + 2 < 2 * nc) {
      __syncthreads();  // buffer t % 2 is read: stage t + 2 may overwrite it
      if (lane == 0) stage(t + 2);
    }
  }
  if (live) store2(out + (size_t)r * out_stride + h * D + 2 * lane, a0, a1);
}

// Dynamic shared memory of the cross kernel: K and V as they lie in memory
// (L x 64 each), then RG query rows and RG rows of L weights in float32.
template <typename T>
__host__ __device__ inline size_t cross_smem(int L) {
  return align16(2 * (size_t)L * D * sizeof(T)) + 4 * ((size_t)RG * D + (size_t)RG * L);
}

// Score of key row kr (64 values, unpadded) against query rows q_s[0..nr):
// thread j reads the row from word j on, so a warp's lanes hit distinct banks.
template <int NR>
__device__ __forceinline__ void score_key(const float* kr, const float* q_s, int j,
                                          float* acc) {
#pragma unroll 8
  for (int i = 0; i < D; ++i) {
    const int d = (i + j) & (D - 1);
    const float k = kr[d];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = fmaf(q_s[r * D + d], k, acc[r]);
  }
}
template <int NR>
__device__ __forceinline__ void score_key(const __nv_bfloat16* kr, const float* q_s, int j,
                                          float* acc) {
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(kr);  // two keys' values a word
#pragma unroll 8
  for (int i = 0; i < D / 2; ++i) {
    const int w = (i + j) & (D / 2 - 1);
    const uint32_t u = kw[w];
    const float k0 = __uint_as_float(u << 16), k1 = __uint_as_float(u & 0xffff0000u);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float2 qv = *reinterpret_cast<const float2*>(q_s + r * D + 2 * w);
      acc[r] = fmaf(qv.y, k1, fmaf(qv.x, k0, acc[r]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CROSS_THREADS)
beam_cross_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ mk,
                  const T* __restrict__ mv, T* __restrict__ out, int out_stride,
                  int K, int H, int L, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];  // K landed, V landed
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)L * D;
  float* q_s = reinterpret_cast<float*>(smem + align16(2 * (size_t)L * D * sizeof(T)));
  float* p_s = q_s + RG * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t nh = blockIdx.x;  // (image, head)
  const int n = (int)(nh / H), h = (int)(nh % H);
  const uint32_t bytes = (uint32_t)(L * D * sizeof(T));

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(k_s, mk + nh * L * D, bytes, &bar[0]);
    bulk_load(v_s, mv + nh * L * D, bytes, &bar[1]);
  }

  for (int i0 = 0; i0 < K; i0 += RG) {
    const int nr = min(RG, K - i0);
    const size_t r0 = (size_t)n * K + i0;
    for (int i = tid; i < nr * D; i += CROSS_THREADS)
      q_s[i] = to_f(q[(r0 + i / D) * q_stride + h * D + i % D]);
    __syncthreads();  // also: the barriers are initialised before anyone waits

    // scores as soon as K has landed (V may still be in flight)
    bulk_wait(&bar[0]);
    if (tid < L) {
      float acc[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r] = 0.f;
      score_key<RG>(k_s + (size_t)tid * D, q_s, tid, acc);
      for (int r = 0; r < nr; ++r) p_s[r * L + tid] = acc[r] * scale;
    }
    __syncthreads();

    // a warp per query row: softmax, weights rounded to the cache's type
    if (warp < nr) {
      float* pr = p_s + warp * L;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, pr[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(pr[j] - m);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < L; j += 32) pr[j] = to_f(from_f<T>(pr[j] / sum));
    }
    __syncthreads();

    // P·V once V has landed: thread (d, g) sums rows g, g + 4 of the group
    bulk_wait(&bar[1]);
    const int d = tid % D;
    for (int r = tid / D; r < nr; r += CROSS_THREADS / D) {
      const float* pr = p_s + r * L;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(pr[j], to_f(v_s[(size_t)j * D + d]), acc);
      out[(r0 + r) * out_stride + h * D + d] = from_f<T>(acc);
    }
    __syncthreads();  // q_s and p_s are reused by the next group
  }
}

constexpr int MAX_DEVICES = 64;

// Raise `kernel`'s dynamic shared-memory ceiling to `bytes`, once per
// device; `raised` is the kernel's record of the devices done.
template <typename Kernel>
cudaError_t raise_ceiling(Kernel kernel, int bytes, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T>
int launch_self(const void* q, int q_stride, const void* kc, const void* vc,
                const int* anc, void* out, int out_stride, int R, int K, int H,
                int S, int pos, float scale, cudaStream_t stream) {
  static bool raised[MAX_DEVICES];  // the ceiling is the whole budget, whatever the plan
  const cudaError_t err = raise_ceiling(beam_self_kernel<T>, (int)SELF_SMEM, raised);
  if (err != cudaSuccess) return (int)err;
  const SelfPlan p = self_plan(K, pos + 1, sizeof(T));
  beam_self_kernel<T><<<R / K * H * p.groups, p.kg * 32, p.smem, stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(kc),
      static_cast<const T*>(vc), anc, static_cast<T*>(out), out_stride, K, H, S,
      pos, scale, p.kg, p.groups, p.slots, p.positions);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cross(const void* q, int q_stride, const void* mk, const void* mv,
                 void* out, int out_stride, int N, int K, int H, int L,
                 float scale, cudaStream_t stream) {
  static bool raised[MAX_DEVICES];  // the ceiling is what L = MAX_L needs
  const cudaError_t err = raise_ceiling(beam_cross_kernel<T>, (int)cross_smem<T>(MAX_L), raised);
  if (err != cudaSuccess) return (int)err;
  beam_cross_kernel<T><<<N * H, CROSS_THREADS, cross_smem<T>(L), stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(mk),
      static_cast<const T*>(mv), static_cast<T*>(out), out_stride, K, H, L,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, the caches and out share one
// type).  Strides are in elements and must be even, like every pointer's
// offset (two values are loaded at once); the self kernel's cache and the
// cross kernel's memory K and V must be 16-byte aligned (16-byte and bulk
// asynchronous copies).  Both return a cudaError_t.
extern "C" int ic_beam_self_attention(int dtype, const void* q, int q_stride,
                                      const void* kc, const void* vc,
                                      const void* anc, void* out, int out_stride,
                                      int R, int K, int H, int S, int pos,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > MAX_S || pos < 0 || pos >= S || K <= 0 || R % K != 0 ||
      q_stride % 2 != 0 || out_stride % 2 != 0 ||
      reinterpret_cast<uintptr_t>(kc) % 16 || reinterpret_cast<uintptr_t>(vc) % 16)
    return (int)cudaErrorInvalidValue;
  const int* a = static_cast<const int*>(anc);
  if (dtype == 0)
    return launch_self<float>(q, q_stride, kc, vc, a, out, out_stride, R, K, H,
                              S, pos, scale, st);
  if (dtype == 1)
    return launch_self<__nv_bfloat16>(q, q_stride, kc, vc, a, out, out_stride,
                                      R, K, H, S, pos, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The self kernel's plan for K beams at position pos: out[0..5] = beams a
// block, blocks a head and image, slots and positions a chunk, chunks,
// dynamic shared bytes a block.  Returns a cudaError_t.
extern "C" int ic_beam_self_plan(int dtype, int K, int pos, long long* out) {
  if (K <= 0 || pos < 0 || pos >= MAX_S || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const SelfPlan p = self_plan(K, pos + 1, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
  out[0] = p.kg;
  out[1] = p.groups;
  out[2] = p.slots;
  out[3] = p.positions;
  out[4] = p.chunks;
  out[5] = (long long)p.smem;
  return 0;
}

extern "C" int ic_beam_cross_attention(int dtype, const void* q, int q_stride,
                                       const void* mk, const void* mv, void* out,
                                       int out_stride, int N, int K, int H, int L,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || L > MAX_L || K <= 0 || reinterpret_cast<uintptr_t>(mk) % 16 ||
      reinterpret_cast<uintptr_t>(mv) % 16)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_cross<float>(q, q_stride, mk, mv, out, out_stride, N, K, H, L,
                               scale, st);
  if (dtype == 1)
    return launch_cross<__nv_bfloat16>(q, q_stride, mk, mv, out, out_stride, N,
                                       K, H, L, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
