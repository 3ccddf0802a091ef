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
// in that order, each operation rounded on its own (no fused multiply-add),
// so its output is bit for bit the plain version's in ops/int8.py.
//
// Layouts: x_q is NHWC (N, H, W, C) int8; the weight is (O, Kp) int8, row o
// holding the window of output channel o in (kh, kw, C / groups) order,
// zero from K = kh * kw * C / groups up to Kp, a multiple of 32 (ops/int8.py
// packs it once at quantization time); out is (N, Ho, Wo, O) = (M, O).  A
// dense layer is the 1x1 case over an (M, 1, 1, K) map.
//
// What bounds it on the H100 is operations at large M (ResNet-50 at B=32 is
// 131 G multiply-adds, 0.13 ms at the int8 tensor-core peak of 1,979 TOPS)
// and bytes at small M (a beam step's dense layer reads its weight once).
// The design is the simple one: an implicit GEMM over (M, O / groups) tiles
// of 128 x 64 per block of four warps, each warp 64 x 32 as 4 x 4
// mma.sync.m16n8k32 int8 products with int32 accumulators in registers.
// The block stages a 32-deep slice of K of both operands in shared memory
// (rows of 48 bytes, so the fragment loads hit distinct banks) and loads
// the next slice into registers while the tensor cores work on this one.
// Each row of A (an output pixel) gathers its window from x_q in chunks of
// 16, 8, 4 or 1 bytes, the widest that divides C / groups: a chunk never
// crosses a tap of the window, so the 7x7 stem's C = 3 takes bytes.
// Depthwise convolutions (C / groups = O / groups = 1) have no product to
// give the tensor cores; a thread computes one output there, its window's
// taps read along the contiguous channels of NHWC.
// wgmma, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output pixels (rows of A) a block
constexpr int BN = 64;         // output channels a block
constexpr int BK = 32;         // depth of one staged slice, bytes
constexpr int THREADS = 128;   // four warps, 2 (rows) x 2 (channels)
constexpr int LDS = BK + 16;   // bytes a shared row

struct Conv {
  const int8_t* x;
  const int8_t* w;
  const float* sx;
  const float* ws;
  const float* bias;
  void* out;
  int N, H, W, C, Ho, Wo, O, kh, kw, stride, pad, groups, Cg, Og, K, Kp, M;
  int rows_per_scale;
};

template <int VEC> struct Chunk;
template <> struct Chunk<16> { using T = int4; };
template <> struct Chunk<8> { using T = int2; };
template <> struct Chunk<4> { using T = int; };
template <> struct Chunk<1> { using T = int8_t; };

template <typename T> __device__ __forceinline__ T zero_chunk();
template <> __device__ __forceinline__ int4 zero_chunk<int4>() {
  return make_int4(0, 0, 0, 0);
}
template <> __device__ __forceinline__ int2 zero_chunk<int2>() {
  return make_int2(0, 0);
}
template <> __device__ __forceinline__ int zero_chunk<int>() { return 0; }
template <> __device__ __forceinline__ int8_t zero_chunk<int8_t>() {
  return 0;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// JAX's epilogue order: float(acc) * (s_x * w_scale), then + bias.
__device__ __forceinline__ float epilogue(const Conv& c, int acc, int m,
                                          int o) {
  float s = __fmul_rn(c.sx[m / c.rows_per_scale], c.ws[o]);
  float y = __fmul_rn(__int2float_rn(acc), s);
  if (c.bias != nullptr) y = __fadd_rn(y, c.bias[o]);
  return y;
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int VEC, typename OUT>
__global__ void __launch_bounds__(THREADS)
conv_gemm_kernel(Conv c) {
  using T = typename Chunk<VEC>::T;
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread stages row `tid` of A: output pixel m0 + tid
  const int m = m0 + tid;
  const bool row_ok = m < c.M;
  int hbase = 0, wbase = 0;
  const int8_t* xn = c.x;
  if (row_ok) {
    const int hw = c.Ho * c.Wo;
    const int img = m / hw, rem = m - img * hw;
    const int ho = rem / c.Wo, wo = rem - ho * c.Wo;
    hbase = ho * c.stride - c.pad;
    wbase = wo * c.stride - c.pad;
    xn = c.x + (size_t)img * c.H * c.W * c.C + (size_t)g * c.Cg;
  }
  // ... and 16 bytes of row tid / 2 of B
  const int bn = n0 + (tid >> 1), bhalf = (tid & 1) * 16;
  const int8_t* wrow = c.w + (size_t)(g * c.Og + bn) * c.Kp + bhalf;

  T areg[BK / VEC];
  int4 breg;
  auto load = [&](int kt) {
#pragma unroll
    for (int j = 0; j < BK / VEC; ++j) {
      const int k = kt * BK + j * VEC;
      T v = zero_chunk<T>();
      if (row_ok && k < c.K) {
        const int tap = k / c.Cg, ch = k - tap * c.Cg;
        const int r = tap / c.kw, s = tap - r * c.kw;
        const int hi = hbase + r, wi = wbase + s;
        if (hi >= 0 && hi < c.H && wi >= 0 && wi < c.W)
          v = *reinterpret_cast<const T*>(
              xn + ((size_t)hi * c.W + wi) * c.C + ch);
      }
      areg[j] = v;
    }
    breg = bn < c.Og ? *reinterpret_cast<const int4*>(wrow + kt * BK)
                     : make_int4(0, 0, 0, 0);
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < BK / VEC; ++j)
      *reinterpret_cast<T*>(&As[tid * LDS + j * VEC]) = areg[j];
    *reinterpret_cast<int4*>(&Bs[(tid >> 1) * LDS + bhalf]) = breg;
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int nk = c.Kp / BK;

  load(0);
  stage();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1);
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int8_t* p = &As[(wm + mt * 16 + gid) * LDS + tig * 4];
      a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* p = &Bs[(wn + nt * 8 + gid) * LDS + tig * 4];
      b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    __syncthreads();
    if (kt + 1 < nk) {
      stage();
      __syncthreads();
    }
  }

  OUT* out = static_cast<OUT*>(c.out);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + gid + half * 8;
      if (row >= c.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + nt * 8 + tig * 2 + e;
          if (col >= c.Og) continue;
          const int o = g * c.Og + col;
          store_out(out + (size_t)row * c.O + o,
                    epilogue(c, acc[mt][nt][half * 2 + e], row, o));
        }
      }
    }
  }
}

// One output (pixel m, channel ch) a thread; channels fastest, so a warp
// reads each tap along 32 contiguous channels of NHWC.
template <typename OUT>
__global__ void __launch_bounds__(256) depthwise_kernel(Conv c) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)c.M * c.C) return;
  const int ch = (int)(idx % c.C);
  const int m = (int)(idx / c.C);
  const int hw = c.Ho * c.Wo;
  const int img = m / hw, rem = m - img * hw;
  const int ho = rem / c.Wo, wo = rem - ho * c.Wo;
  const int8_t* xn = c.x + (size_t)img * c.H * c.W * c.C + ch;
  const int8_t* wr = c.w + (size_t)ch * c.Kp;
  int acc = 0;
  for (int r = 0; r < c.kh; ++r) {
    const int hi = ho * c.stride - c.pad + r;
    if (hi < 0 || hi >= c.H) continue;
    for (int s = 0; s < c.kw; ++s) {
      const int wi = wo * c.stride - c.pad + s;
      if (wi < 0 || wi >= c.W) continue;
      acc += (int)xn[((size_t)hi * c.W + wi) * c.C] * (int)wr[r * c.kw + s];
    }
  }
  store_out(static_cast<OUT*>(c.out) + idx, epilogue(c, acc, m, ch));
}

template <typename OUT>
void launch(const Conv& c, cudaStream_t stream) {
  if (c.Cg == 1 && c.Og == 1) {
    const size_t total = (size_t)c.M * c.C;
    depthwise_kernel<OUT><<<(unsigned)((total + 255) / 256), 256, 0,
                            stream>>>(c);
    return;
  }
  const dim3 grid((c.M + BM - 1) / BM, (c.Og + BN - 1) / BN, c.groups);
  if (c.Cg % 16 == 0)
    conv_gemm_kernel<16, OUT><<<grid, THREADS, 0, stream>>>(c);
  else if (c.Cg % 8 == 0)
    conv_gemm_kernel<8, OUT><<<grid, THREADS, 0, stream>>>(c);
  else if (c.Cg % 4 == 0)
    conv_gemm_kernel<4, OUT><<<grid, THREADS, 0, stream>>>(c);
  else
    conv_gemm_kernel<1, OUT><<<grid, THREADS, 0, stream>>>(c);
}

}  // namespace

// x (N, H, W, C) int8 NHWC; w (O, Kp) int8 packed; sx float32, one scale
// per rows_per_scale output rows; ws (O,) float32; bias (O,) float32 or
// null; out (N, Ho, Wo, O) in bfloat16 (out_bf16 = 1) or float32.  Returns
// the launch's CUDA error code.
extern "C" int ic_int8_conv(const void* x, const void* w, const void* sx,
                            const void* ws, const void* bias, void* out,
                            int out_bf16, int N, int H, int W, int C, int O,
                            int kh, int kw, int stride, int pad, int groups,
                            int Kp, int rows_per_scale, void* stream) {
  Conv c;
  c.x = static_cast<const int8_t*>(x);
  c.w = static_cast<const int8_t*>(w);
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
  if (out_bf16)
    launch<__nv_bfloat16>(c, s);
  else
    launch<float>(c, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
