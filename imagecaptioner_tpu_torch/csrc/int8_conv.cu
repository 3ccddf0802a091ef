// int8 convolution with exact int32 accumulation, and its epilogue.
//
// Replaces no Pallas kernel.  The JAX package's int8 serving
// (imagecaptioner_tpu/ops/quant.py:289 conv2d_int8 and :313 dense_int8)
// hands an int8 x int8 convolution with an int32 result to XLA; on the H100
// PyTorch has no such product (F.conv2d refuses int8, torch._int_mm takes
// no groups and no windows) and a float emulation is not the same function:
// a 3x3x512 window sums 4,608 products of up to 127^2, above float32's
// 2^24.  So this kernel computes what JAX's XLA call computes:
//
//   acc[m, o] = sum_k x_q[m, k] * w_q[o, k]          exactly, in int32
//   y         = float(acc) * (s_x[m / rows_per_scale] * w_scale[o])
//   y         = y + bias[o]                           (when there is a bias)
//   out       = y rounded once to bfloat16 or float32
//
// in that order, each operation rounded on its own (__fmul_rn, __fadd_rn:
// no fused multiply-add), so its output is bit for bit the plain version's
// in ops/int8.py.  Integer sums are exact in any order, so the tensor
// cores' order cannot change a bit.
//
// Layouts: x_q is NHWC (N, H, W, C) int8; the weight is (O, Kp) int8, row o
// holding the window of output channel o in (kh, kw, C / groups) order,
// zero from K = kh * kw * C / groups up to Kp, a multiple of 128 (ops/int8.py
// packs it once); out is (N, Ho, Wo, O) = (M, O).  A dense layer is the 1x1
// case over an (M, 1, 1, K) map.
//
// What bounds it on the H100: int8 operations at large M (ResNet-50 at B=32
// is 131 G multiply-adds, 0.13 ms at the tensor cores' 1,979 TOPS), bytes at
// small M (a beam step's dense layer reads its weight once) and, for most
// ResNet layers, the bf16 output.  The design, for Hopper:
//
//   * wgmma.mma_async m64nNk32 s32.s8.s8 (N = 64 or 128, the tile's width),
//     both operands K-major in shared memory with the 128-byte swizzle: the
//     window is contiguous along C in NHWC and the packed rows along
//     (kh, kw, C / g), which is the only layout wgmma takes for 8-bit types.
//   * A ring of 4-6 stages (as many as shared memory holds beside the
//     output staging) of BK = 128 bytes of K in dynamic shared memory, with
//     a "full" and an "empty" mbarrier a stage and no block-wide barrier in
//     the main loop.  Block = one producer warpgroup and two consumer
//     warpgroups on a 128 x N tile; persistent, a block an SM walking over
//     the tiles, the ring running on from one tile to the next, so the next
//     tiles' loads overlap this one's epilogue (one block an SM is all the
//     registers allow).
//   * The producer: thread 0 keeps TMA loads of the weight tile in flight
//     (a 2-D tensor map over the packed (O, Kp) rows, 128-byte swizzle,
//     built once per weight by ic_int8_weight_map); all 128 threads gather
//     A, each thread one 16-byte column of the 128-byte slab for 8 rows, so
//     that 8 neighbouring threads read a row's 128 contiguous bytes.  The
//     window index (tap, channel) is computed once a stage per thread (two
//     divisions), not per chunk and row.  Chunks go by 16-, 8- or 4-byte
//     cp.async (the widest that divides C / groups; zero-filled outside the
//     image) into the swizzled slot; C = 3 (the ResNet stem, the ViT patch
//     embedding) goes by bytes, a thread a row, walking each kernel row's
//     kw * C bytes as one contiguous run of NHWC (21 and 48).  A stage of
//     cp.async chunks is signalled full STAGES - 2 stages late, after
//     cp.async.wait_group and fence.proxy.async, so that the tensor cores
//     (the async proxy) see the generic-proxy writes while the stages
//     between stay in flight; a stage of bytes, written by plain stores, is
//     signalled at once.
//   * The consumers wait on "full", issue four wgmma k32 steps, keep one
//     group in flight and release the previous stage on "empty".
//   * Epilogue: the row scale once a row, w_scale and bias once a column, no
//     division an element; each consumer warpgroup stages its 64 rows in
//     shared memory beside the ring (its own named barrier, so one
//     warpgroup's epilogue overlaps the other's products) and they leave as
//     16-byte coalesced stores.
//   * Small M (the beam step's dense layers, the projection, ResNet's last
//     stage): tiles 64 wide where 128-wide ones would leave SMs idle.  K is
//     not split: a split whose int32 partial sums met in a workspace by
//     atomics was built and measured slower at every such shape (PERF.md).
//
// Depthwise convolutions (C / groups = O / groups = 1) have no product for
// the tensor cores: a block stages an 8 x 8 tile of output pixels' input
// window (with its halo) for 64 channels in shared memory, with 16-byte
// loads; a thread computes one pixel's 16 channels from 16-byte reads of
// window and weights, exact int32 sums, the same epilogue and 16-byte
// stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;                 // output pixels (rows of A) a block
constexpr int BK = 128;                 // bytes of K a stage
constexpr int PRODUCERS = 128;          // warpgroup 0
constexpr int CONSUMERS = 256;          // warpgroups 1 and 2, 64 rows each
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int A_STAGE = BM * BK;        // bytes

struct Conv {
  const int8_t* x;
  const float* sx;
  const float* ws;
  const float* bias;
  void* out;
  int N, H, W, C, Ho, Wo, O, kh, kw, stride, pad, groups, Cg, Og, K, Kp, M;
  int rows_per_scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- copies ----------------------------------------------------------------

// the weight tile: 128 bytes of K of rows [row, row + N) through the tensor map
__device__ __forceinline__ void tma_load_b(uint32_t dst, const CUtensorMap* map,
                                           int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// VEC bytes from src, or zeros when n = 0
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int n);
template <>
__device__ __forceinline__ void cp_async<16>(uint32_t dst, const void* src,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
template <>
__device__ __forceinline__ void cp_async<8>(uint32_t dst, const void* src,
                                            int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
template <>
__device__ __forceinline__ void cp_async<4>(uint32_t dst, const void* src,
                                            int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// generic-proxy writes of this thread before, async-proxy reads after
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

// K-major operand of 8-row groups of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // leading offset: unused when swizzled
  d |= (uint64_t)(1024 >> 4) << 32;   // 8 rows x 128 bytes to the next group
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across wgmma's waits
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int BN> struct Mma;
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    wgmma_n64(d, a, b);
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    wgmma_n128(d, a, b);
  }
};

// ---- epilogue --------------------------------------------------------------

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// JAX's epilogue order: float(acc) * (s_x * w_scale), then + bias
__device__ __forceinline__ float epilogue(int acc, float s_row, float w_col,
                                          const float* bias, float b_col) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(s_row, w_col));
  if (bias != nullptr) y = __fadd_rn(y, b_col);
  return y;
}

// the 128 threads of consumer warpgroup wg only (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// ---- the product -----------------------------------------------------------

template <int BN, typename OUT>
struct Ring {
  static constexpr int B_STAGE = BN * BK;
  static constexpr int PITCH = BN + 16 / (int)sizeof(OUT);  // staged row
  static constexpr int STAGED_BYTES = BM * PITCH * (int)sizeof(OUT);
  // as deep as 227 KB hold beside the staging (and 1 KB of alignment)
  static constexpr int SPARE = 232448 - 1024 - 256 - STAGED_BYTES - 16 * BN;
  static constexpr int STAGES =
      SPARE / (A_STAGE + B_STAGE) > 6 ? 6 : SPARE / (A_STAGE + B_STAGE);
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  static constexpr int COLUMNS = RING + STAGED_BYTES;   // 2 x (w, b) x BN
  static constexpr int BARS = COLUMNS + 2 * 2 * BN * 4;
  static constexpr size_t BYTES = BARS + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "the ring needs three stages");
  uint8_t* base;
  uint32_t s;
  __device__ uint32_t a(int i) const { return s + i * A_STAGE; }
  __device__ uint32_t b(int i) const {
    return s + STAGES * A_STAGE + i * B_STAGE;
  }
  // the output tile on its way out, apart from the ring so that the
  // producer loads the next tiles' stages meanwhile
  __device__ OUT* staged() const { return reinterpret_cast<OUT*>(base + RING); }
  __device__ float* columns(int wg) const {
    return reinterpret_cast<float*>(base + COLUMNS) + wg * 2 * BN;
  }
  __device__ uint32_t full(int i) const { return s + BARS + 8 * i; }
  __device__ uint32_t empty(int i) const {
    return s + BARS + 8 * (STAGES + i);
  }
};

// the stages of K a tile's products take, the same for producer and
// consumers
__device__ __forceinline__ int ring_stages(const Conv& c) {
  return c.Kp / BK;
}

// one unit of work: the 128 x BN output tile u (column tiles fastest, then
// groups, then row tiles, so that blocks at work together share A rows)
struct Unit {
  int m0, n0, g;
  __device__ Unit(const Conv& c, int bn, int u) {
    const int tiles_n = (c.Og + bn - 1) / bn;
    const int tm = u / (tiles_n * c.groups);
    const int tn = u - tm * (tiles_n * c.groups);
    m0 = tm * BM;
    g = tn / tiles_n;
    n0 = (tn - g * tiles_n) * bn;
  }
};

// the 8 rows of A a producer thread gathers: rows rb + 16 i of the tile
struct Rows {
  int hb[8], wb[8];          // window origin; hb far negative off the end
  const int8_t* xn[8];       // the image (and the group's first channel)
};

// chunks of VEC = 16, 8 or 4 bytes (VEC divides C / groups, so a chunk never
// crosses a tap) by cp.async into the 16-byte column cc of rows rb + 16 i
template <int VEC>
__device__ __forceinline__ void gather_vec(const Conv& c, const Rows& r,
                                           int kt, uint32_t a, int rb,
                                           int cc) {
  const int k0 = kt * BK + cc * 16;
  const uint32_t col = (uint32_t)((cc ^ (rb & 7)) << 4);   // the swizzle
#pragma unroll
  for (int j = 0; j < 16 / VEC; ++j) {
    const int k = k0 + j * VEC;
    const bool kin = k < c.K;
    int dr = 0, ds = 0, ch = 0;
    if (kin) {
      const int tap = k / c.Cg;
      ch = k - tap * c.Cg;
      dr = tap / c.kw;
      ds = tap - dr * c.kw;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hi = r.hb[i] + dr, wi = r.wb[i] + ds;
      const bool ok = kin && (unsigned)hi < (unsigned)c.H &&
                      (unsigned)wi < (unsigned)c.W;
      const int8_t* src =
          ok ? r.xn[i] + ((size_t)hi * c.W + wi) * c.C + ch : c.x;
      cp_async<VEC>(a + (uint32_t)((rb + 16 * i) * BK) + col + j * VEC, src,
                    ok ? VEC : 0);
    }
  }
}

// any C / groups (C = 3): thread p gathers row p of the tile, byte by
// byte.  The stage's 128 bytes of K walk the window kernel row by kernel
// row, each row a run of kw * C / groups bytes from the window's first
// column (one contiguous run of NHWC when groups = 1): the window index
// (kernel row, tap, channel) and the source offset advance with the byte,
// no division but the three that place the stage's first byte.  Each
// 16-byte chunk is straight-line code: its 16 offsets and predicates
// first, then 16 independent loads in flight together, then the packing.
__device__ __forceinline__ void gather_row(const Conv& c, int hb, int wb,
                                           const int8_t* xn, int kt,
                                           uint8_t* a, int p) {
  int k = kt * BK;
  const int run = c.kw * c.Cg;
  int dr = k / run, s = (k - dr * run) / c.Cg;
  int ch = k - dr * run - s * c.Cg;
  int off = hb > -(1 << 29) ? ((hb + dr) * c.W + wb + s) * c.C + ch : 0;
  const int s_lo = wb < 0 ? -wb : 0;                  // taps inside the image
  const int s_hi = c.W - wb < c.kw ? c.W - wb : c.kw;
  const int tap_step = c.C - c.Cg, row_step = (c.W - c.kw) * c.C;
  uint8_t* row = a + p * BK;
#pragma unroll 1
  for (int cc = 0; cc < BK / 16; ++cc) {
    int where[16];
    bool ok[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int hi = hb + dr;
      ok[b] = k < c.K && (unsigned)hi < (unsigned)c.H && s >= s_lo &&
              s < s_hi;
      where[b] = off;
      ++k;
      ++off;
      const bool next_tap = ++ch == c.Cg;
      ch = next_tap ? 0 : ch;
      off += next_tap ? tap_step : 0;
      s += next_tap;
      const bool next_row = s == c.kw;
      s = next_row ? 0 : s;
      dr += next_row;
      off += next_row ? row_step : 0;
    }
    uint32_t v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b)
      v[b] = ok[b] ? (uint32_t)(uint8_t)__ldg(xn + where[b]) : 0u;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = v[4 * q] | v[4 * q + 1] << 8 | v[4 * q + 2] << 16 |
             v[4 * q + 3] << 24;
    *reinterpret_cast<uint4*>(row + ((cc ^ (p & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int BN, int VEC, typename OUT>
__device__ __forceinline__ void producer(const Conv& c, const CUtensorMap* map,
                                         const Ring<BN, OUT>& ring,
                                         int units) {
  constexpr int S = Ring<BN, OUT>::STAGES;
  constexpr int LAG = VEC == 1 ? 0 : S - 2;  // stages signalled late
  const int p = threadIdx.x, rb = p >> 3, cc = p & 7;
  const int hw = c.Ho * c.Wo;
  const int n_stages = ring_stages(c);
  int it = 0;              // stages through the ring, over all units
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w(c, BN, u);
    Rows r;                // VEC > 1: rows rb + 16 i; VEC = 1: row p
#pragma unroll
    for (int i = 0; i < (VEC == 1 ? 1 : 8); ++i) {
      const int m = w.m0 + (VEC == 1 ? p : rb + 16 * i);
      r.hb[i] = -(1 << 30);
      r.wb[i] = 0;
      r.xn[i] = c.x;
      if (m < c.M) {
        const int img = m / hw, rem = m - img * hw;
        const int ho = rem / c.Wo, wo = rem - ho * c.Wo;
        r.hb[i] = ho * c.stride - c.pad;
        r.wb[i] = wo * c.stride - c.pad;
        r.xn[i] = c.x + (size_t)img * c.H * c.W * c.C + (size_t)w.g * c.Cg;
      }
    }
    for (int kt = 0; kt < n_stages; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(ring.empty(s), ((uint32_t)(it / S) & 1u) ^ 1u);
      if (p == 0) {
        mbar_arrive_tx(ring.full(s), Ring<BN, OUT>::B_STAGE);
        tma_load_b(ring.b(s), map, kt * BK, w.g * c.Og + w.n0, ring.full(s));
      }
      if (VEC == 1)
        gather_row(c, r.hb[0], r.wb[0], r.xn[0], kt, ring.base + s * A_STAGE,
                   p);
      else
        gather_vec<(VEC > 1 ? VEC : 16)>(c, r, kt, ring.a(s), rb, cc);
      cp_async_commit();
      if (it >= LAG) {  // stage it - LAG has landed: signal it
        cp_async_wait<LAG>();
        fence_proxy_async();
        mbar_arrive(ring.full((it - LAG) % S));
      }
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  for (int j = it - LAG < 0 ? 0 : it - LAG; j < it; ++j)
    mbar_arrive(ring.full(j % S));
}

// acc[4 j + 2 h + e] holds (row rin + 8 h, column 8 j + cin + e) of the
// tile; warpgroup wg stages and stores rows 64 wg .. 64 wg + 63
// the scales and bias a tile's epilogue needs, loaded before its main loop
// so that their latency hides behind the products: thread lt of a
// warpgroup holds column lt's w_scale and bias (BN <= 128), and the scales
// of its own two rows
struct TileConsts {
  float w_col, b_col, s_row[2];
  __device__ TileConsts(const Conv& c, const Unit& w, int lt, int rin) {
    const int col = w.n0 + lt;
    const bool ok = col < c.Og;
    w_col = ok ? __ldg(c.ws + w.g * c.Og + col) : 0.f;
    b_col = ok && c.bias != nullptr ? __ldg(c.bias + w.g * c.Og + col) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = w.m0 + rin + 8 * h;
      s_row[h] = m < c.M ? __ldg(c.sx + m / c.rows_per_scale) : 0.f;
    }
  }
};

// warpgroup wg's rows of the tile, rows 64 wg .. 64 wg + 63: staged, then
// out by 16-byte stores, a row's neighbouring pieces from neighbouring
// threads
template <int BN, typename OUT>
__device__ __forceinline__ void epilogue_tile(const Conv& c,
                                              const Ring<BN, OUT>& ring,
                                              const Unit& w, const int* acc,
                                              const TileConsts& k, int wg,
                                              int lt, int rin, int cin) {
  constexpr int PITCH = Ring<BN, OUT>::PITCH;
  constexpr int PER = 16 / (int)sizeof(OUT);   // elements a 16-byte store
  constexpr int UNITS = BN / PER;              // 16-byte stores a row
  OUT* staged = ring.staged();
  float* w_cols = ring.columns(wg);
  float* b_cols = w_cols + BN;
  if (lt < BN) {           // the previous tile's staging, which read them,
    w_cols[lt] = k.w_col;  // ended at its barrier
    b_cols[lt] = k.b_col;
  }
  warpgroup_sync(wg);      // and its rows have left: the staging area is free
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float* wc = w_cols + 8 * j + cin;
    const float* bc = b_cols + 8 * j + cin;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair(staged + (rin + 8 * h) * PITCH + 8 * j + cin,
                 epilogue(acc[4 * j + 2 * h], k.s_row[h], wc[0], c.bias,
                          bc[0]),
                 epilogue(acc[4 * j + 2 * h + 1], k.s_row[h], wc[1], c.bias,
                          bc[1]));
  }
  warpgroup_sync(wg);
  const bool vec = c.O % PER == 0 && c.Og % PER == 0;
  OUT* out = static_cast<OUT*>(c.out);
  for (int u = lt; u < (BM / 2) * UNITS; u += 128) {
    const int row = wg * (BM / 2) + u / UNITS;
    const int col = w.n0 + (u % UNITS) * PER;
    const int m = w.m0 + row;
    if (m >= c.M || col >= c.Og) continue;
    OUT* dst = out + (size_t)m * c.O + w.g * c.Og + col;
    const OUT* src = staged + row * PITCH + (u % UNITS) * PER;
    if (vec && col + PER <= c.Og) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < PER && col + e < c.Og; ++e) dst[e] = src[e];
    }
  }
}

template <int BN, typename OUT>
__device__ __forceinline__ void consumer(const Conv& c,
                                         const Ring<BN, OUT>& ring,
                                         int units) {
  constexpr int S = Ring<BN, OUT>::STAGES;
  const int t = threadIdx.x - PRODUCERS;
  const int wg = t >> 7, lt = t & 127, warp = lt >> 5, lane = t & 31;
  const int rin = wg * 64 + warp * 16 + (lane >> 2), cin = 2 * (lane & 3);
  const int n_stages = ring_stages(c);
  int it = 0;              // stages through the ring, over all units
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w(c, BN, u);
    const TileConsts consts(c, w, lt, rin);
    int acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) fence_operand(acc[e]);
    for (int kt = 0; kt < n_stages; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(ring.full(s), (uint32_t)(it / S) & 1u);
      __syncwarp();         // wgmma is .aligned: the warp issues it together
      const uint64_t da = smem_desc(ring.a(s) + wg * 64 * BK);
      const uint64_t db = smem_desc(ring.b(s));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)    // 32 bytes = 2 descriptor units
        Mma<BN>::run(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(ring.empty((it - 1) % S));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) fence_operand(acc[e]);
    mbar_arrive(ring.empty((it - 1) % S));
    epilogue_tile(c, ring, w, acc, consts, wg, lt, rin, cin);
  }
}

// persistent: block b takes tiles b, b + gridDim.x, ...
template <int BN, int VEC, typename OUT>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_kernel(const Conv c, const __grid_constant__ CUtensorMap map,
                 int units) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Ring<BN, OUT> ring;
  ring.base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  ring.s = smem_u32(ring.base);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ring<BN, OUT>::STAGES; ++s) {
      mbar_init(ring.full(s), PRODUCERS + 1);  // + the TMA's expect_tx
      mbar_init(ring.empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < PRODUCERS)
    producer<BN, VEC, OUT>(c, &map, ring, units);
  else
    consumer<BN, OUT>(c, ring, units);
}

// ---- depthwise -------------------------------------------------------------

constexpr int DW_T = 8;                              // output tile side
constexpr int DW_CB = 64;                            // channels a block
constexpr int DW_THREADS = DW_T * DW_T * DW_CB / 16; // a pixel's 16 channels

__device__ __forceinline__ void mac4(int* acc, int x, int w) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc[b] += (int)(int8_t)(x >> (8 * b)) * (int)(int8_t)(w >> (8 * b));
}

// VEC: C % 16 == 0, every staged and stored piece 16 bytes
template <typename OUT, bool VEC>
__global__ void __launch_bounds__(DW_THREADS)
int8_depthwise_kernel(const Conv c, const int8_t* w) {
  extern __shared__ __align__(16) uint8_t dsm[];
  const int IH = (DW_T - 1) * c.stride + c.kh;
  const int IW = (DW_T - 1) * c.stride + c.kw;
  int8_t* xs = reinterpret_cast<int8_t*>(dsm);    // (IH, IW, DW_CB)
  int8_t* wsm = xs + IH * IW * DW_CB;             // (kh * kw, DW_CB)
  const int tiles_w = (c.Wo + DW_T - 1) / DW_T;
  const int ho0 = (blockIdx.x / tiles_w) * DW_T;
  const int wo0 = (blockIdx.x % tiles_w) * DW_T;
  const int c0 = blockIdx.y * DW_CB, img = blockIdx.z;
  const int hi0 = ho0 * c.stride - c.pad, wi0 = wo0 * c.stride - c.pad;
  const int8_t* xn = c.x + (size_t)img * c.H * c.W * c.C;
  if (VEC) {
    for (int u = threadIdx.x; u < IH * IW * (DW_CB / 16); u += DW_THREADS) {
      const int pos = u >> 2, ch = c0 + (u & 3) * 16;
      const int iy = pos / IW, ix = pos - iy * IW;
      const int hi = hi0 + iy, wi = wi0 + ix;
      int4 v = make_int4(0, 0, 0, 0);
      if ((unsigned)hi < (unsigned)c.H && (unsigned)wi < (unsigned)c.W &&
          ch < c.C)
        v = __ldg(reinterpret_cast<const int4*>(
            xn + ((size_t)hi * c.W + wi) * c.C + ch));
      reinterpret_cast<int4*>(xs)[u] = v;
    }
  } else {
    for (int u = threadIdx.x; u < IH * IW * DW_CB; u += DW_THREADS) {
      const int pos = u / DW_CB, ch = c0 + u % DW_CB;
      const int iy = pos / IW, ix = pos - iy * IW;
      const int hi = hi0 + iy, wi = wi0 + ix;
      xs[u] = (unsigned)hi < (unsigned)c.H && (unsigned)wi < (unsigned)c.W &&
                      ch < c.C
                  ? __ldg(xn + ((size_t)hi * c.W + wi) * c.C + ch)
                  : (int8_t)0;
    }
  }
  for (int u = threadIdx.x; u < c.kh * c.kw * DW_CB; u += DW_THREADS) {
    const int tap = u / DW_CB, ch = c0 + u % DW_CB;
    wsm[u] = ch < c.C ? __ldg(w + (size_t)ch * c.Kp + tap) : (int8_t)0;
  }
  __syncthreads();
  const int pix = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int ho = ho0 + (pix >> 3), wo = wo0 + (pix & 7);
  const int ch0 = c0 + q * 16;
  if (ho >= c.Ho || wo >= c.Wo || ch0 >= c.C) return;
  int acc[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) acc[b] = 0;
  for (int r = 0; r < c.kh; ++r)
    for (int s = 0; s < c.kw; ++s) {
      const int4 xv = *reinterpret_cast<const int4*>(
          xs + (((pix >> 3) * c.stride + r) * IW + (pix & 7) * c.stride + s) *
                   DW_CB + q * 16);
      const int4 wv = *reinterpret_cast<const int4*>(
          wsm + (r * c.kw + s) * DW_CB + q * 16);
      mac4(acc, xv.x, wv.x);
      mac4(acc + 4, xv.y, wv.y);
      mac4(acc + 8, xv.z, wv.z);
      mac4(acc + 12, xv.w, wv.w);
    }
  const int m = (img * c.Ho + ho) * c.Wo + wo;
  const float s_row = c.sx[m / c.rows_per_scale];
  OUT* dst = static_cast<OUT*>(c.out) + (size_t)m * c.C + ch0;
  float y[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int ch = VEC || ch0 + b < c.C ? ch0 + b : ch0;
    y[b] = epilogue(acc[b], s_row, __ldg(c.ws + ch), c.bias,
                    c.bias != nullptr ? __ldg(c.bias + ch) : 0.f);
  }
  if (VEC) {
    __align__(16) OUT staged[16];
#pragma unroll
    for (int b = 0; b < 16; b += 2) store_pair(staged + b, y[b], y[b + 1]);
#pragma unroll
    for (int v = 0; v < 16 * (int)sizeof(OUT) / 16; ++v)
      reinterpret_cast<int4*>(dst)[v] = reinterpret_cast<const int4*>(staged)[v];
  } else {
    for (int b = 0; b < 16 && ch0 + b < c.C; ++b) store_out(dst + b, y[b]);
  }
}

// ---- launches --------------------------------------------------------------

template <int BN, int VEC, typename OUT>
cudaError_t gemm_launch(const Conv& c, const CUtensorMap& map,
                        cudaStream_t s) {
  const size_t smem = Ring<BN, OUT>::BYTES + 1024;  // + 1024-byte alignment
  auto kernel = int8_gemm_kernel<BN, VEC, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long units =
      (long long)((c.M + BM - 1) / BM) * ((c.Og + BN - 1) / BN) * c.groups;
  if (units >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = (int)(units < sms ? units : sms);
  kernel<<<grid, THREADS, smem, s>>>(c, map, (int)units);
  return cudaGetLastError();
}

template <int BN, typename OUT>
cudaError_t gemm_by_vec(const Conv& c, const CUtensorMap& map,
                        cudaStream_t s) {
  if (c.Cg % 16 == 0) return gemm_launch<BN, 16, OUT>(c, map, s);
  if (c.Cg % 8 == 0) return gemm_launch<BN, 8, OUT>(c, map, s);
  if (c.Cg % 4 == 0) return gemm_launch<BN, 4, OUT>(c, map, s);
  return gemm_launch<BN, 1, OUT>(c, map, s);
}

template <typename OUT>
cudaError_t launch(const Conv& c, const int8_t* w, const void* wmap, int bn,
                   cudaStream_t s) {
  if (c.Cg == 1 && c.Og == 1) {
    const int IH = (DW_T - 1) * c.stride + c.kh;
    const int IW = (DW_T - 1) * c.stride + c.kw;
    const size_t smem = (size_t)(IH * IW + c.kh * c.kw) * DW_CB;
    const bool vec = c.C % 16 == 0;
    auto kernel = vec ? int8_depthwise_kernel<OUT, true>
                      : int8_depthwise_kernel<OUT, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(((c.Ho + DW_T - 1) / DW_T) * ((c.Wo + DW_T - 1) / DW_T),
                    (c.C + DW_CB - 1) / DW_CB, c.N);
    kernel<<<grid, DW_THREADS, smem, s>>>(c, w);
    return cudaGetLastError();
  }
  if (wmap == nullptr) return cudaErrorInvalidValue;
  CUtensorMap map;
  memcpy(&map, wmap, sizeof map);
  if (bn == 64) return gemm_by_vec<64, OUT>(c, map, s);
  if (bn == 128) return gemm_by_vec<128, OUT>(c, map, s);
  return cudaErrorInvalidValue;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

}  // namespace

// The TMA descriptor of a packed weight (O rows of Kp bytes at w on the
// card) for tiles of bn rows x 128 bytes with the 128-byte swizzle, written
// to map (128 bytes of host memory).  Returns 0, -1 when libcuda's
// cuTensorMapEncodeTiled cannot be found, else its CUresult.
extern "C" int ic_int8_weight_map(const void* w, int O, int Kp, int bn,
                                  void* map) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return -1;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  CUtensorMap m;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)O};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                      const_cast<void*>(w), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  memcpy(map, &m, sizeof m);
  return 0;
}

// x (N, H, W, C) int8 NHWC; w (O, Kp) int8 packed and wmap its tensor map
// (ic_int8_weight_map with the same bn; unused by depthwise convolutions,
// which read w); sx float32, one scale per rows_per_scale output rows; ws
// (O,) float32; bias (O,) float32 or null; out (N, Ho, Wo, O) in bfloat16
// (out_bf16 = 1) or float32.  bn (64 or 128) is the tile's width.
// Returns the launch's CUDA error code.
extern "C" int ic_int8_conv(const void* x, const void* w, const void* wmap,
                            const void* sx, const void* ws, const void* bias,
                            void* out, int out_bf16, int N, int H, int W,
                            int C, int O, int kh, int kw, int stride, int pad,
                            int groups, int Kp, int rows_per_scale, int bn,
                            void* stream) {
  Conv c;
  c.x = static_cast<const int8_t*>(x);
  c.sx = static_cast<const float*>(sx);
  c.ws = static_cast<const float*>(ws);
  c.bias = static_cast<const float*>(bias);
  c.out = out;
  c.N = N; c.H = H; c.W = W; c.C = C; c.O = O;
  c.kh = kh; c.kw = kw; c.stride = stride; c.pad = pad; c.groups = groups;
  c.Ho = (H + 2 * pad - kh) / stride + 1;
  c.Wo = (W + 2 * pad - kw) / stride + 1;
  c.Cg = C / groups;
  c.Og = O / groups;
  c.K = kh * kw * c.Cg;
  c.Kp = Kp;
  c.M = N * c.Ho * c.Wo;
  c.rows_per_scale = rows_per_scale;
  if (c.M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  cudaError_t err = out_bf16 ? launch<__nv_bfloat16>(c, wp, wmap, bn, s)
                             : launch<float>(c, wp, wmap, bn, s);
  return static_cast<int>(err);
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
