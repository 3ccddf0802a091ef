// Activation quantization of int8 serving: per-example amax, then the codes.
//
// Replaces no Pallas kernel.  The JAX package quantizes an activation in
// XLA (imagecaptioner_tpu/ops/quant.py:78 quantize_activation_int8 and :91
// _quantize_activation); the port's plain version is ops/quant.py
// quantize_activation_int8 and the static branch of _quantize_activation.
// Both compute, for a tensor of N examples of E elements each,
//
//   amax[e]  = max |x| over example e          (NaN wins, as in torch.amax)
//   scale[e] = amax[e] > 0 ? amax[e] / 127 : 1  (one IEEE division)
//   q        = clamp(round_half_even(x / scale[e]), -127, 127) as int8
//
// or, under a calibrated static scale, only the last line with that scale.
// This file computes exactly that: __fdiv_rn is the IEEE division (the
// build has no --use_fast_math, and a multiply by the reciprocal would move
// codes), rintf rounds half to even as torch.round and jnp.round do
// (roundf would round half away from zero).
//
// What bounds it on the H100 is bytes: a bf16 activation is read twice (2 +
// 2 bytes an element) and its codes written once (1 byte); the plain
// version's float32 copy, abs, amax, divide, round, clamp and cast passes
// move about 47 bytes an element in about 11 launches.  Two kernels:
//
//   int8_amax_kernel      16-byte loads, |x| reduced as the bits of the
//                         float taken as unsigned ints (|x| is never
//                         negative, so their order is the floats' order and
//                         a NaN's bits beat +inf's); each block's maximum
//                         folds into its example's slot by atomicMax, exact
//                         in any order, so one pass suffices.
//   int8_quantize_kernel  16 elements a thread: 16-byte loads, one 16-byte
//                         store of codes; the dynamic scale is computed from
//                         the slot by every block, block 0 of an example
//                         writes it out for the product's epilogue.
//
// Each has a scalar form for tensors whose examples are not a whole number
// of 16-element pieces or whose base is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |v| as the bits of a non-negative float
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// the 16-byte piece's largest |x| bits: 4 float32 or 8 bf16 values
__device__ __forceinline__ unsigned piece_max(int4 v, const float*) {
  unsigned m = abs_bits(__int_as_float(v.x));
  m = max(m, abs_bits(__int_as_float(v.y)));
  m = max(m, abs_bits(__int_as_float(v.z)));
  return max(m, abs_bits(__int_as_float(v.w)));
}
__device__ __forceinline__ unsigned piece_max(int4 v, const __nv_bfloat16*) {
  unsigned m = 0;
  const unsigned w[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                         (unsigned)v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the top half of its float
    m = max(m, (w[i] << 16) & 0x7fff0000u);
    m = max(m, w[i] & 0x7fff0000u);
  }
  return m;
}

__device__ __forceinline__ int8_t code(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_amax_kernel(const T* x, long long E, unsigned* amax) {
  const T* xe = x + (size_t)blockIdx.y * E;
  const long long stride = (long long)gridDim.x * THREADS;
  unsigned m = 0;
  if (VEC) {
    constexpr int PER = 16 / sizeof(T);
    const int4* p = reinterpret_cast<const int4*>(xe);
    const long long n = E / PER;
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    for (; i + 3 * stride < n; i += 4 * stride) {   // four loads in flight
      const int4 a = __ldg(p + i), b = __ldg(p + i + stride);
      const int4 c = __ldg(p + i + 2 * stride), d = __ldg(p + i + 3 * stride);
      m = max(max(m, piece_max(a, xe)), piece_max(b, xe));
      m = max(max(m, piece_max(c, xe)), piece_max(d, xe));
    }
    for (; i < n; i += stride) m = max(m, piece_max(__ldg(p + i), xe));
  } else {
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < E;
         i += stride)
      m = max(m, abs_bits(to_float(xe[i])));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(amax + blockIdx.y, m);
  }
}

// 16 values from x at p into 16 codes
__device__ __forceinline__ int4 codes16(const float* p, float scale) {
  const int4* v = reinterpret_cast<const int4*>(p);
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int4 a = __ldg(v + j);
    const float f[4] = {__int_as_float(a.x), __int_as_float(a.y),
                        __int_as_float(a.z), __int_as_float(a.w)};
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w |= (uint32_t)(uint8_t)code(f[i], scale) << (8 * i);
    out[j] = w;
  }
  return make_int4(out[0], out[1], out[2], out[3]);
}
__device__ __forceinline__ int4 codes16(const __nv_bfloat16* p, float scale) {
  const int4* v = reinterpret_cast<const int4*>(p);
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 a = __ldg(v + j);
    const uint32_t w[4] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z,
                           (uint32_t)a.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t o = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t u = w[2 * h + i];
        o |= (uint32_t)(uint8_t)code(__uint_as_float(u << 16), scale)
             << (16 * i);
        o |= (uint32_t)(uint8_t)code(__uint_as_float(u & 0xffff0000u), scale)
             << (16 * i + 8);
      }
      out[2 * j + h] = o;
    }
  }
  return make_int4(out[0], out[1], out[2], out[3]);
}

// static_scale non-null: that one scale for every example; else example
// e's scale from amax[e], written to s_out[e] by block 0 of the example.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_quantize_kernel(const T* x, long long E, const unsigned* amax,
                     const float* static_scale, int8_t* q, float* s_out) {
  float scale;
  if (static_scale != nullptr) {
    scale = *static_scale;
  } else {
    const float a = __uint_as_float(amax[blockIdx.y]);
    scale = a > 0.f ? __fdiv_rn(a, 127.f) : 1.f;
    if (blockIdx.x == 0 && threadIdx.x == 0) s_out[blockIdx.y] = scale;
  }
  const T* xe = x + (size_t)blockIdx.y * E;
  int8_t* qe = q + (size_t)blockIdx.y * E;
  const long long stride = (long long)gridDim.x * THREADS;
  if (VEC) {
    int4* out = reinterpret_cast<int4*>(qe);
    const long long n = E / 16;
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    for (; i + stride < n; i += 2 * stride) {       // two pieces in flight
      const int4 a = codes16(xe + 16 * i, scale);
      const int4 b = codes16(xe + 16 * (i + stride), scale);
      out[i] = a;
      out[i + stride] = b;
    }
    for (; i < n; i += stride) out[i] = codes16(xe + 16 * i, scale);
  } else {
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < E;
         i += stride)
      qe[i] = code(to_float(xe[i]), scale);
  }
}

// blocks an example: enough for about eight blocks an SM over the tensor,
// at most one a piece of THREADS units
unsigned blocks_per_example(long long units, long long n_examples) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  long long want = (8LL * sms + n_examples - 1) / n_examples;
  long long most = (units + THREADS - 1) / THREADS;
  long long b = want < most ? want : most;
  return (unsigned)(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
void amax_launch(const T* x, long long N, long long E, unsigned* amax,
                 cudaStream_t s) {
  constexpr int PER = 16 / sizeof(T);
  const bool vec = E % PER == 0 && aligned(x);
  const dim3 grid(blocks_per_example(vec ? E / PER : E, N), (unsigned)N);
  if (vec)
    int8_amax_kernel<T, true><<<grid, THREADS, 0, s>>>(x, E, amax);
  else
    int8_amax_kernel<T, false><<<grid, THREADS, 0, s>>>(x, E, amax);
}

template <typename T>
void quantize_launch(const T* x, long long N, long long E,
                     const unsigned* amax, const float* static_scale,
                     int8_t* q, float* s_out, cudaStream_t s) {
  const bool vec = E % 16 == 0 && aligned(x) && aligned(q);
  const dim3 grid(blocks_per_example(vec ? E / 16 : E, N), (unsigned)N);
  if (vec)
    int8_quantize_kernel<T, true><<<grid, THREADS, 0, s>>>(
        x, E, amax, static_scale, q, s_out);
  else
    int8_quantize_kernel<T, false><<<grid, THREADS, 0, s>>>(
        x, E, amax, static_scale, q, s_out);
}

}  // namespace

// x: N examples of E contiguous elements, bfloat16 (x_bf16 = 1) or
// float32 -> q (N * E int8).  With static_scale (one float32 on the card)
// one launch, the quantizing pass under that scale.  Without: an async
// memset of slots (N unsigned ints), the amax pass folding each example's
// max |x| bits into them, and the quantizing pass, which writes each
// example's scale to s_out (N float32): two kernels on the stream.
// Returns the launches' CUDA error code.
extern "C" int ic_int8_quantize(const void* x, int x_bf16, long long N,
                                long long E, void* slots,
                                const void* static_scale, void* q,
                                void* s_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0 || E == 0) return 0;
  const float* st = static_cast<const float*>(static_scale);
  unsigned* amax = static_cast<unsigned*>(slots);
  int8_t* out = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s_out);
  if (st == nullptr) {
    cudaError_t err = cudaMemsetAsync(amax, 0, N * sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (x_bf16)
      amax_launch(static_cast<const __nv_bfloat16*>(x), N, E, amax, s);
    else
      amax_launch(static_cast<const float*>(x), N, E, amax, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {                       // one scale: the tensor is one example
    E *= N;
    N = 1;
  }
  if (x_bf16)
    quantize_launch(static_cast<const __nv_bfloat16*>(x), N, E, amax, st, out,
                    so, s);
  else
    quantize_launch(static_cast<const float*>(x), N, E, amax, st, out, so, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
