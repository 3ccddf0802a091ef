// Teacher-forced recurrence of the enhanced student's decoder, all T steps in
// one cooperative launch: multi-head image attention with a learned query
// projection, gated word/context fusion, three LSTM cells each followed by
// LayerNorm and dropout, and a highway output gate.
//
// Replaces the TPU kernel imagecaptioner_tpu/ops/pallas_enhanced.py
// `_fused_enhanced_core_fwd_call` (`_kernel_enhanced_train`).  Per step t and
// batch row (h0, h1, h2 are the layers' states after LayerNorm and dropout,
// float32 between steps; every matrix product reads its input rounded to
// the weight dtype and accumulates in float32):
//   q      = h2·W_qp + b_qp                                  (H -> E)
//   qh     = q·W_q + b_q, split into nh heads of hd = E / nh
//   per head: s = qh·K_h / sqrt(hd);  w = softmax_L(s);  wd = w · amask[t]
//             ctx_h = sum_L wd · V_h
//   ctx    = concat(ctx_h)·W_o + b_o;  attn = mean over heads of wd
//   gate   = sigmoid(gate_w[t] + ctx·W_gc);  fused = gate·embp[t] + (1-gate)·ctx
//   layer i: cell(x, h_i, c_i), then LayerNorm over H (biased variance, eps
//            1e-5, float32), then · lmask[i, t]; x is fused, then h0, then h1
//   ctxh   = ctx·W_cp + b_cp;  g = sigmoid(h2·W_hh' + ctx·W_hc + b_hw)
//   enh    = g·h2 + (1-g)·ctxh
// It writes h_tops (= h2), enh, h0s, h1s (T,B,H) in the compute dtype, attn
// (T,B,L) float32 and c0s, c1s, c2s (T,B,H) float32: the residuals of the
// reverse-time backward.  embp, gate_w (the word half of the gate with its
// bias) and the per-head K and V are computed outside, as in
// pallas_enhanced.py; the weights come in their torch (out, in) layout and
// are not split per head: a head is a run of hd consecutive rows or columns.
// amask and lmask may be null (all ones).
//
// What bounds it on the H100: a step multiplies 14.9 M weight elements (six
// LSTM matrices 13.0 M, highway 1.2 M, attention projections 0.7 M) with the
// batch's rows, and every step depends on the last; the bytes and the
// arithmetic are microseconds, the chain's latency is what costs.  Design
// (chain.cuh, as decoder_scan.cu): one persistent cooperative launch, one
// block per SM; the B <= 16 rows of a chunk are the M side of every bf16
// mma.sync m16n8k16 tile.  Block k owns
//   * hidden units [h0, h0 + nu), nu <= HC = 6 (768 / 132 at full width):
//     all four gate rows of those units in each of the three layers, their
//     c, the LayerNorm partials of their cell outputs, and the highway's
//     rows for those units;
//   * E outputs [e0, e0 + ne), ne <= EC = 3, of W_qp, W_q, W_o and W_gc;
//   * one (row, head) attention job of the 16 x 8 = 128, whose K and V slice
//     (2 x 64 x 48) stays in shared memory for all T steps (a grid of fewer
//     blocks than a chunk's rows x heads is refused).
// Shared memory at full width, bf16 (187 KB of 227): resident W_ih rows of
// the three layers (24 a layer, 93 KB), W_qp/W_q/W_o/W_gc rows (12 KB), the
// highway rows (19 KB), K/V (13 KB, rows padded to an odd word stride), an
// H-wide and an E-wide staged operand (16 x 776 and 16 x 392, 37 KB),
// float32 scratch (18 KB).  The three W_hh slices (24 rows each, 110 KB a
// block, 14 MB in all, which the 50 MB L2 keeps) do not fit beside the
// rest: they stream from L2 on every step, the tensor-core product reading
// their fragments in place.  Their products depend only on the previous
// step's h, so they sit in the light phases 1-3 of the attention chain.
// (Bringing each slice into shared memory ahead of its product with
// cp.async, the operands cut to make room, measured no faster: PERF.md.)
// Step t runs eight phases, each ended by the grid barrier:
//   1. [tail of step t-1] layer 2's LayerNorm from the partials -> h2(t-1)
//      staged, h_tops[t-1], the highway -> enh[t-1]; then q(t) for the owned
//      E outputs and h2(t-1)·W_hh2ᵀ for the owned gates;
//   2. qh(t) for the owned E outputs; h0(t-1)·W_hh0ᵀ;
//   3. the (row, head) attention -> wd, the head's context; h1(t-1)·W_hh1ᵀ;
//   4. ctx(t) for the owned E outputs; attn[t] = head mean of wd;
//   5. the gate and the fused input x0(t) for the owned E outputs; the
//      highway's ctx products for the owned units;
//   6. layer 0's gates and cell -> raw h (before LayerNorm), c0s, partials;
//   7. layer 0's LayerNorm from the partials -> h0(t) staged, h0s; layer 1;
//   8. the same for layer 1 -> h1(t), h1s; layer 2.
// A LayerNorm's statistics: each block publishes, per row, the mean and the
// sum of squared deviations of its own units' cell outputs; every consumer
// combines the 132 partials in block order (mean = sum n_k mean_k / H,
// M2 = sum (M2_k + n_k (mean_k - mean)^2)) and normalises the raw h while it
// stages it.  The float32 instance keeps no weights resident (60 MB): it
// reads them, and the operands that cross blocks, in place, and multiplies
// on CUDA cores; only the normalised layer outputs are staged.  Every sum
// is in a fixed order and no atomics touch data, so runs repeat bit for bit;
// rows are independent, so batches above MT = 16 rows run as consecutive
// chunks inside the launch and equal a launch per chunk.  No library kernel
// (cuBLAS, cuDNN) is called.

#include "chain.cuh"

namespace {

constexpr int HC = 6;             // most hidden units a block owns
constexpr int GR = 4 * HC;        // their gate rows in one layer
constexpr int EC = 3;             // most E outputs a block owns
constexpr int MT = 16;            // batch rows a chunk: the M side of the mma tile
constexpr int NL = 3;             // LSTM layers
constexpr int MAX_BLOCKS = 256;   // partials a LayerNorm combines, 8 a lane
constexpr float LN_EPS = 1e-5f;

template <typename T>
struct Args {
  const T* embp;        // (T, B, E)
  const float* gate_w;  // (T, B, E)
  const T* k;           // (B, nh, L, hd)
  const T* v;           // (B, nh, L, hd)
  const float* amask;   // (T, B, nh, L) or null
  const float* lmask;   // (3, T, B, H) or null
  const T* wqp;         // (E, H)
  const float* bqp;     // (E,)
  const T* wq;          // (E, E)
  const float* bq;      // (E,)
  const T* wo;          // (E, E)
  const float* bo;      // (E,)
  const T* wg_c;        // (E, E)
  const T* wih[NL];     // (4H, E), (4H, H), (4H, H)
  const T* whh[NL];     // (4H, H)
  const float* bl[NL];  // (4H,)
  const float* ln_g;    // (3, H)
  const float* ln_b;    // (3, H)
  const T* whg_h;       // (H, H)
  const T* whg_c;       // (H, E)
  const float* bhw;     // (H,)
  const T* wcp;         // (H, E)
  const float* bcp;     // (H,)
  T* h_tops;            // (T, B, H)
  T* enh;               // (T, B, H)
  float* attn;          // (T, B, L)
  T* hs[2];             // h0s, h1s (T, B, H)
  float* cs[NL];        // c0s, c1s, c2s (T, B, H)
  // workspace, crossing blocks through L2 (rows of the current chunk)
  T *q, *cat, *ctx_r, *x0;  // (MT, E)
  float *qh, *ctx;          // (MT, E)
  float* wd;                // (MT, nh, L) dropped attention weights
  float* rh[NL];            // (MT, H) cell outputs before LayerNorm
  float* part[NL];          // (MT, nblk) x (mean, M2) of a block's units
  T* hst[2];                // (MT, H) h0, h1 after LayerNorm and dropout
  unsigned* bar;            // two zeroed words
  int steps, B, L, E, H, nh;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t round8(size_t n) { return (n + 7) / 8 * 8; }

// Shared memory of one block: for bf16 the resident weight rows and one
// W_hh slice in flight; K and V of the attention job (rows padded to an odd
// number of 32-bit words, so that a warp's lanes, one key each, read
// distinct banks); an H-wide and an E-wide staged operand (MT x (H + PAD),
// MT x (E + PAD)); float32 scratch.
template <typename T>
struct Layout {
  int ldE, ldH, KS;
  size_t weights, kv, acts, floats;
  __host__ __device__ Layout(int L, int E, int H, int hd) {
    ldE = E + PAD;
    ldH = H + PAD;
    KS = hd + (sizeof(T) == 2 ? 2 : 1);
    weights = sizeof(T) == 2 ? round8((size_t)GR * ldE + 2 * (size_t)GR * ldH +
                                      (size_t)EC * (ldH + 3 * ldE) +
                                      (size_t)HC * (ldH + 2 * ldE))
                             : 0;
    kv = round8(2 * (size_t)L * KS);  // 16-byte aligned operands after it
    acts = (size_t)MT * (ldH + ldE);
    floats = PART_FLOATS + 4 * MT * GR + MT * EC + 7 * MT * HC + 2 * MT + round4(L) +
             round4(hd);
  }
  __host__ __device__ size_t bytes() const {
    return align16(sizeof(T) * (weights + kv + acts)) + 4 * floats;
  }
};

template <typename T>
size_t smem_bytes(int L, int E, int H, int nh) {
  return Layout<T>(L, E, H, E / nh).bytes();
}

template <typename T>
size_t workspace_bytes(int L, int E, int H, int nh, int nblk) {
  return 4 * align16(sizeof(T) * MT * E) + 2 * align16(sizeof(T) * MT * H) +
         2 * align16(4 * (size_t)MT * E) + align16(4 * (size_t)MT * nh * L) +
         NL * align16(4 * (size_t)MT * H) + NL * align16(8 * (size_t)MT * nblk) + 16;
}

// The four gate rows (i, f, g, o) of hidden units [h0, h0 + nu) of a (4H, K)
// weight, as rows gate * HC + c of dst (row stride ldd); units nu..HC-1 zero.
template <typename T>
__device__ void stage_gates(T* dst, int ldd, const T* W, int K, int H, int h0, int nu) {
  for (int i = threadIdx.x; i < GR * K; i += THREADS) {
    const int r = i / K, k = i % K, gate = r / HC, c = r % HC;
    dst[(size_t)r * ldd + k] = c < nu ? W[(size_t)(gate * H + h0 + c) * K + k] : T(0.f);
  }
}

// out[m * GR + gate * HC + c] = A[m, :]·W[gate * H + h0 + c, :] for the owned
// units, W_hh streamed from L2 (bf16): product_mma with its B fragments read
// straight from the weight rows.  Ends synchronised.
__device__ void gates_mma_l2(const View<bf16>& A, int M, const bf16* W, int K, int H, int h0,
                             int nu, float* out, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  constexpr int nt = GR / 8, units = nt;  // M <= 16: one tile of rows
  constexpr int split = WARPS / units;
  const int steps = K / 16, lda = A.a1.ld;
  for (int w = warp; w < units * split; w += WARPS) {
    const int u = w % units, s = w / units;
    const int r0 = g, r1 = g + 8, n = u * 8 + g, gate = n / HC, c = n % HC;
    const bf16* ar0 = A.a1.p + (size_t)r0 * lda + 2 * q;
    const bf16* ar1 = ar0 + 8 * (size_t)lda;
    const bf16* wr = c < nu ? W + (size_t)(gate * H + h0 + c) * K + 2 * q : nullptr;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int k_lo = steps * s / split * 16, k_hi = steps * (s + 1) / split * 16;
#pragma unroll 8
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
      if (wr) {
        bv[0] = __ldg(reinterpret_cast<const unsigned*>(wr + k));
        bv[1] = __ldg(reinterpret_cast<const unsigned*>(wr + k + 8));
      }
      mma_bf16(acc, av, bv);
    }
    float* pt = part + w * 128;
    pt[g * 8 + 2 * q] = acc[0];
    pt[g * 8 + 2 * q + 1] = acc[1];
    pt[(g + 8) * 8 + 2 * q] = acc[2];
    pt[(g + 8) * 8 + 2 * q + 1] = acc[3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * GR; i += THREADS) {
    const int m = i / GR, n = i % GR, u = n / 8, at = (m % 16) * 8 + n % 8;
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += part[(s * units + u) * 128 + at];
    out[m * GR + n] = v;
  }
  __syncthreads();
}

// The owned gate rows of a (4H, K) weight read in place, on CUDA cores: one
// product of nu rows per gate.  Ends synchronised.
template <typename T>
__device__ void gates_fma(const View<T>& A, int M, const T* W, int K, int H, int h0, int nu,
                          float* out) {
  for (int gate = 0; gate < 4; ++gate)
    product_fma(A, M, W + (size_t)(gate * H + h0) * K, K, nu, out + gate * HC, GR);
}

// LayerNorm statistics of the M rows of a layer from the nblk blocks'
// partials (mean, M2 of their units), combined in block order: a warp a
// row, the lanes taking blocks lane, lane + 32, ..., then a fixed shuffle
// tree.  Ends synchronised.
__device__ void ln_stats(const float* part, int M, int nblk, int H, float* mu, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int PER_LANE = MAX_BLOCKS / 32;
  for (int m = warp; m < M; m += WARPS) {
    float2 p[PER_LANE];
    float n[PER_LANE], s = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int k = lane + 32 * i;
      const bool in = k < nblk;
      p[i] = in ? __ldcg(reinterpret_cast<const float2*>(part) + (size_t)m * nblk + k)
                : make_float2(0.f, 0.f);
      n[i] = in ? (float)(span_lo(k + 1, nblk, H) - span_lo(k, nblk, H)) : 0.f;
      s = fmaf(n[i], p[i].x, s);
    }
    const float mean = warp_sum(s) / (float)H;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const float d = p[i].x - mean;
      m2 += p[i].y + n[i] * d * d;
    }
    const float var = warp_sum(m2) / (float)H;
    if (lane == 0) {
      mu[m] = mean;
      rstd[m] = rsqrtf(var + LN_EPS);
    }
  }
  __syncthreads();
}

// A layer's output from its raw cell output x: LayerNorm, affine, dropout.
__device__ __forceinline__ float ln_value(float x, float mu, float rstd, float g, float b,
                                          float keep) {
  return ((x - mu) * rstd * g + b) * keep;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 v[2] = {__floats2bfloat162_rn(a, b), __floats2bfloat162_rn(c, d)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
}

// Stage the layer's output (M x H) from its raw cell outputs rh in L2, the
// statistics mu/rstd, the affine g/b and the dropout rows lm (null: none),
// rounded to T, into buf (row stride H + PAD).  With own, the float32
// values of the units [h0, h0 + nu) also go to own (MT x HC).  The caller
// synchronises.
template <typename T>
__device__ View<T> ln_operand(const float* rh, const float* mu, const float* rstd,
                              const float* g, const float* b, const float* lm, int M, int H,
                              T* buf, float* own = nullptr, int h0 = 0, int nu = 0) {
  const int ld = H + PAD;
  for (int i = threadIdx.x; i < M * H / 4; i += THREADS) {
    const int m = 4 * i / H, k = 4 * i % H;
    const float4 x = __ldcg(reinterpret_cast<const float4*>(rh) + i);
    const float4 kk = lm ? __ldg(reinterpret_cast<const float4*>(lm) + i)
                         : make_float4(1.f, 1.f, 1.f, 1.f);
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + k));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + k));
    const float v[4] = {ln_value(x.x, mu[m], rstd[m], gg.x, bb.x, kk.x),
                        ln_value(x.y, mu[m], rstd[m], gg.y, bb.y, kk.y),
                        ln_value(x.z, mu[m], rstd[m], gg.z, bb.z, kk.z),
                        ln_value(x.w, mu[m], rstd[m], gg.w, bb.w, kk.w)};
    store4(buf + (size_t)m * ld + k, v[0], v[1], v[2], v[3]);
    if (own)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j >= h0 && k + j < h0 + nu) own[m * HC + k + j - h0] = v[j];
  }
  return View<T>{Src<T>{buf, ld, H, nullptr}, Src<T>{nullptr, 0, 0, nullptr}, true};
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) enhanced_scan_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool BF16 = sizeof(T) == 2;
  const int L = a.L, E = a.E, H = a.H, B = a.B, nh = a.nh, hd = E / nh, steps = a.steps;
  const int nblk = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int h0 = span_lo(blk, nblk, H), nu = span_lo(blk + 1, nblk, H) - h0;
  const int e0 = span_lo(blk, nblk, E), ne = span_lo(blk + 1, nblk, E) - e0;
  const Layout<T> lay(L, E, H, hd);
  const int ldE = lay.ldE, ldH = lay.ldH, KS = lay.KS;
  const float scale = 1.f / sqrtf((float)hd);

  T* ih[NL];
  ih[0] = reinterpret_cast<T*>(smem);        // GR x ldE (bf16 only, as all weights)
  ih[1] = ih[0] + GR * ldE;                  // GR x ldH
  ih[2] = ih[1] + GR * ldH;                  // GR x ldH
  T* wqp_s = ih[2] + GR * ldH;               // EC x ldH
  T* wq_s = wqp_s + EC * ldH;                // EC x ldE
  T* wo_s = wq_s + EC * ldE;                 // EC x ldE
  T* wgc_s = wo_s + EC * ldE;                // EC x ldE
  T* whgh_s = wgc_s + EC * ldE;              // HC x ldH
  T* whgc_s = whgh_s + HC * ldH;             // HC x ldE
  T* wcp_s = whgc_s + HC * ldE;              // HC x ldE
  T* k_s = reinterpret_cast<T*>(smem) + lay.weights;  // L x KS
  T* v_s = k_s + L * KS;                     // L x KS
  T* actH = k_s + lay.kv;                    // MT x ldH: staged operands
  T* actE = actH + MT * ldH;                 // MT x ldE
  float* part = reinterpret_cast<float*>(smem + align16(sizeof(T) *
                                                        (lay.weights + lay.kv + lay.acts)));
  float* rec[NL];
  rec[0] = part + PART_FLOATS;               // MT x GR: h_i(t-1)·W_hh_iᵀ
  rec[1] = rec[0] + MT * GR;
  rec[2] = rec[1] + MT * GR;
  float* gs = rec[2] + MT * GR;              // MT x GR: a layer's input product
  float* es = gs + MT * GR;                  // MT x EC: an E-side product
  float* cst = es + MT * EC;                 // NL x MT x HC: c of the owned units
  float* h2f = cst + NL * MT * HC;           // MT x HC: h2(t-1), float32
  float* hwc = h2f + MT * HC;                // MT x HC: ctx·W_hcᵀ
  float* ctxh = hwc + MT * HC;               // MT x HC: ctx·W_cpᵀ + b_cp
  float* rhs = ctxh + MT * HC;               // MT x HC: a layer's raw outputs
  float* mu = rhs + MT * HC;                 // MT
  float* rstd = mu + MT;                     // MT
  float* sc = rstd + MT;                     // L: scores, then dropped weights
  float* qv = sc + round4(L);                // hd: the job's query

  if constexpr (BF16) {
    stage_gates(ih[0], ldE, a.wih[0], E, H, h0, nu);
    stage_gates(ih[1], ldH, a.wih[1], H, H, h0, nu);
    stage_gates(ih[2], ldH, a.wih[2], H, H, h0, nu);
    stage_rows(wqp_s, ldH, a.wqp, H, H, e0, ne, EC);
    stage_rows(wq_s, ldE, a.wq, E, E, e0, ne, EC);
    stage_rows(wo_s, ldE, a.wo, E, E, e0, ne, EC);
    stage_rows(wgc_s, ldE, a.wg_c, E, E, e0, ne, EC);
    stage_rows(whgh_s, ldH, a.whg_h, H, H, h0, nu, HC);
    stage_rows(whgc_s, ldE, a.whg_c, E, E, h0, nu, HC);
    stage_rows(wcp_s, ldE, a.wcp, E, E, h0, nu, HC);
  }

  // products of a staged operand: layer li's input gates (resident for
  // bf16), its recurrent gates (streamed from L2), an E-side weight's owned
  // rows, a highway weight's owned rows (K = the operand's width); float32
  // reads its weights in place
  auto gates_in = [&](const View<T>& A, int M, int li) {
    if constexpr (BF16)
      product_mma(A, M, ih[li], li ? ldH : ldE, GR, gs, GR, part);
    else
      gates_fma(A, M, a.wih[li], li ? H : E, H, h0, nu, gs);
  };
  auto gates_rec = [&](const View<T>& A, int M, int li) {
    if constexpr (BF16) {
      gates_mma_l2(A, M, a.whh[li], H, H, h0, nu, rec[li], part);
    } else {
      gates_fma(A, M, a.whh[li], H, H, h0, nu, rec[li]);
    }
  };
  auto rows_of = [&](const View<T>& A, int M, const T* resident, const T* W, int r0, int nr,
                     int cap, float* out) {
    const int K = A.a1.K;
    if constexpr (BF16)
      product_fma(A, M, resident, K + PAD, nr, out, cap);
    else
      product_fma(A, M, W + (size_t)r0 * K, K, nr, out, cap);
  };

  const Src<T> none{nullptr, 0, 0, nullptr};
  const Src<T> qsrc{a.q, E, E, nullptr}, catsrc{a.cat, E, E, nullptr};
  const Src<T> ctxsrc{a.ctx_r, E, E, nullptr}, x0src{a.x0, E, E, nullptr};
  const Src<T> h0src{a.hst[0], H, H, nullptr}, h1src{a.hst[1], H, H, nullptr};

  for (int b0 = 0; b0 < B; b0 += MT) {
    const int M = min(MT, B - b0), jobs = M * nh;  // jobs <= nblk: the entry point checks
    if (blk < jobs) {  // this block's (row, head) K/V, resident for the chunk
      const size_t o = ((size_t)(b0 + blk / nh) * nh + blk % nh) * L * hd;
      for (int i = tid; i < L * hd; i += THREADS) {
        const int l = i / hd, d = i % hd;
        k_s[l * KS + d] = a.k[o + i];
        v_s[l * KS + d] = a.v[o + i];
      }
    }
    for (int i = tid; i < NL * MT * HC; i += THREADS) cst[i] = 0.f;
    for (int i = tid; i < M * nu; i += THREADS) {  // the states before step 0
      const int m = i / nu, j = h0 + i % nu;
      a.hst[0][m * H + j] = a.hst[1][m * H + j] = from_f<T>(0.f);
    }
    __syncthreads();

    for (int t = 0; t <= steps; ++t) {
      const size_t tb = (size_t)t * B + b0;  // row (t, b0) of the (T, B, ...) streams

      // 1. h2(t-1) from layer 2's partials, its outputs and the highway of
      //    step t-1; then q(t) and h2(t-1)·W_hh2ᵀ
      View<T> A2;
      if (t > 0) {
        ln_stats(a.part[2], M, nblk, H, mu, rstd);
        const float* lm = a.lmask ? a.lmask + ((size_t)(2 * steps + t - 1) * B + b0) * H
                                  : nullptr;
        A2 = ln_operand(a.rh[2], mu, rstd, a.ln_g + 2 * H, a.ln_b + 2 * H, lm, M, H, actH,
                        h2f, h0, nu);
        __syncthreads();
        for (int i = tid; i < M * nu; i += THREADS) {
          const int m = i / nu, c = i % nu;
          a.h_tops[(tb - B + m) * H + h0 + c] = from_f<T>(h2f[m * HC + c]);
        }
        rows_of(A2, M, whgh_s, a.whg_h, h0, nu, HC, gs);
        for (int i = tid; i < M * nu; i += THREADS) {
          const int m = i / nu, c = i % nu, j = h0 + c, r = m * HC + c;
          const float g = sigmoid(gs[r] + hwc[r] + a.bhw[j]);
          a.enh[(tb - B + m) * H + j] = from_f<T>(g * h2f[r] + (1.f - g) * ctxh[r]);
        }
      } else {
        for (int i = tid; i < MT * ldH; i += THREADS) actH[i] = from_f<T>(0.f);
        A2 = View<T>{Src<T>{actH, ldH, H, nullptr}, none, true};
        __syncthreads();
      }
      if (t == steps) break;
      rows_of(A2, M, wqp_s, a.wqp, e0, ne, EC, es);
      for (int i = tid; i < M * ne; i += THREADS) {
        const int m = i / ne, c = i % ne, e = e0 + c;
        a.q[m * E + e] = from_f<T>(es[m * EC + c] + a.bqp[e]);
      }
      gates_rec(A2, M, 2);
      grid_barrier(a.bar, nblk);

      // 2. qh(t) for the owned E outputs; h0(t-1)·W_hh0ᵀ
      {
        const View<T> Aq = operand(qsrc, none, M, actE);
        const View<T> A0 = operand(h0src, none, M, actH);
        __syncthreads();
        rows_of(Aq, M, wq_s, a.wq, e0, ne, EC, es);
        for (int i = tid; i < M * ne; i += THREADS) {
          const int m = i / ne, c = i % ne, e = e0 + c;
          a.qh[m * E + e] = es[m * EC + c] + a.bq[e];
        }
        gates_rec(A0, M, 0);
      }
      grid_barrier(a.bar, nblk);

      // 3. the (row, head) attention; h1(t-1)·W_hh1ᵀ
      {
        const View<T> A1 = operand(h1src, none, M, actH);
        if (blk < jobs) {
          const int b = blk / nh, hh = blk % nh;
          if (tid < hd) qv[tid] = __ldcg(a.qh + (size_t)b * E + hh * hd + tid);
          __syncthreads();
          if (tid < L) {
            float s = 0.f;
            for (int d = 0; d < hd; ++d) s = fmaf(qv[d], to_f(k_s[tid * KS + d]), s);
            sc[tid] = s * scale;
          }
          __syncthreads();
          if (tid < 32) {
            const int lane = tid;
            const float* am = a.amask ? a.amask + ((tb + b) * nh + hh) * L : nullptr;
            float mx = -INFINITY;
            for (int l = lane; l < L; l += 32) mx = fmaxf(mx, sc[l]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            float sum = 0.f;
            for (int l = lane; l < L; l += 32) {
              const float e = expf(sc[l] - mx);
              sc[l] = e;
              sum += e;
            }
            sum = warp_sum(sum);
            for (int l = lane; l < L; l += 32) {
              sc[l] = sc[l] / sum * (am ? am[l] : 1.f);
              a.wd[((size_t)b * nh + hh) * L + l] = sc[l];
            }
          }
          __syncthreads();
          if (tid < hd) {
            float c = 0.f;
            for (int l = 0; l < L; ++l) c = fmaf(sc[l], to_f(v_s[l * KS + tid]), c);
            a.cat[(size_t)b * E + hh * hd + tid] = from_f<T>(c);
          }
          __syncthreads();
        }
        __syncthreads();
        gates_rec(A1, M, 1);
      }
      grid_barrier(a.bar, nblk);

      // 4. attn[t] for a share of (row, token); ctx(t) for the owned E
      //    outputs
      {
        const int p1 = span_lo(blk + 1, nblk, M * L);
        for (int p = span_lo(blk, nblk, M * L) + tid; p < p1; p += THREADS) {
          const int m = p / L, l = p % L;
          float s = 0.f;
          for (int hh = 0; hh < nh; ++hh) s += __ldcg(a.wd + ((size_t)m * nh + hh) * L + l);
          a.attn[(tb + m) * L + l] = s / (float)nh;
        }
        const View<T> Ac = operand(catsrc, none, M, actE);
        __syncthreads();
        rows_of(Ac, M, wo_s, a.wo, e0, ne, EC, es);
        for (int i = tid; i < M * ne; i += THREADS) {
          const int m = i / ne, c = i % ne, e = e0 + c;
          const float v = es[m * EC + c] + a.bo[e];
          a.ctx[m * E + e] = v;
          a.ctx_r[m * E + e] = from_f<T>(v);
        }
      }
      grid_barrier(a.bar, nblk);

      // 5. the gate and x0(t) for the owned E outputs (their word halves and
      //    ctx loaded first); the highway's ctx products for the owned units
      {
        const bool owner = tid < M * ne;  // thread (row m5, output e0 + c5)
        const int m5 = owner ? tid / ne : 0, c5 = owner ? tid % ne : 0;
        float gw = 0.f, em = 0.f, cx = 0.f;
        if (owner) {
          const size_t n = (tb + m5) * E + e0 + c5;
          gw = a.gate_w[n];
          em = to_f(a.embp[n]);
          cx = __ldcg(a.ctx + m5 * E + e0 + c5);
        }
        const View<T> Ac = operand(ctxsrc, none, M, actE);
        __syncthreads();
        rows_of(Ac, M, wgc_s, a.wg_c, e0, ne, EC, es);
        if (owner) {
          const float g = sigmoid(gw + es[m5 * EC + c5]);
          a.x0[m5 * E + e0 + c5] = from_f<T>(g * em + (1.f - g) * cx);
        }
        rows_of(Ac, M, whgc_s, a.whg_c, h0, nu, HC, hwc);
        rows_of(Ac, M, wcp_s, a.wcp, h0, nu, HC, ctxh);
        for (int i = tid; i < M * nu; i += THREADS)
          ctxh[(i / nu) * HC + i % nu] += a.bcp[h0 + i % nu];
      }
      grid_barrier(a.bar, nblk);

      // 6.-8. the three layers: stage the input (x0, or the last layer's
      // output normalised from its partials), gates, cell, partials
#pragma unroll
      for (int li = 0; li < NL; ++li) {
        View<T> Ax;
        if (li == 0) {
          Ax = operand(x0src, none, M, actE);
        } else {
          ln_stats(a.part[li - 1], M, nblk, H, mu, rstd);
          const float* lm = a.lmask ? a.lmask + ((size_t)((li - 1) * steps + t) * B + b0) * H
                                    : nullptr;
          Ax = ln_operand(a.rh[li - 1], mu, rstd, a.ln_g + (li - 1) * H,
                          a.ln_b + (li - 1) * H, lm, M, H, actH);
        }
        __syncthreads();
        if (li > 0)
          for (int i = tid; i < M * nu; i += THREADS) {  // h_{li-1}(t), owned units
            const int m = i / nu, j = h0 + i % nu;
            const T h = actH[m * ldH + j];
            a.hst[li - 1][m * H + j] = h;
            a.hs[li - 1][(tb + m) * H + j] = h;
          }
        gates_in(Ax, M, li);
        float* c_li = cst + li * MT * HC;
        for (int i = tid; i < M * nu; i += THREADS) {
          const int m = i / nu, c = i % nu, j = h0 + c;
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = m * GR + q * HC + c;
            g[q] = gs[r] + rec[li][r] + a.bl[li][q * H + j];
          }
          const float h = lstm_cell(g[0], g[1], g[2], g[3], c_li + m * HC + c);
          rhs[m * HC + c] = h;
          a.rh[li][(size_t)m * H + j] = h;
          a.cs[li][(tb + m) * H + j] = c_li[m * HC + c];
        }
        __syncthreads();
        if (tid < M) {  // this block's partial of row tid: mean and M2 of its units
          float s = 0.f;
          for (int c = 0; c < nu; ++c) s += rhs[tid * HC + c];
          const float mean = nu > 0 ? s / (float)nu : 0.f;
          float m2 = 0.f;
          for (int c = 0; c < nu; ++c) {
            const float d = rhs[tid * HC + c] - mean;
            m2 = fmaf(d, d, m2);
          }
          float2* mine = reinterpret_cast<float2*>(a.part[li]) + (size_t)tid * nblk + blk;
          *mine = make_float2(mean, m2);
        }
        grid_barrier(a.bar, nblk);
      }
    }
  }
}

template <typename P>
void take(P& dst, const void* src) {
  dst = static_cast<P>(const_cast<void*>(src));
}

template <typename T>
int blocks(int L, int E, int H, int nh, long long* smem) {
  *smem = (long long)smem_bytes<T>(L, E, H, nh);
  const int n = chain_grid(enhanced_scan_kernel<T>, THREADS, smem_bytes<T>(L, E, H, nh));
  return n < MAX_BLOCKS ? n : MAX_BLOCKS;
}

template <typename T>
int launch(const void* const* p, void* ws, int nblk, int steps, int B, int L, int E, int H,
           int nh, cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  auto in = [&](auto& dst) { take(dst, p[i++]); };
  in(a.embp); in(a.gate_w); in(a.k); in(a.v); in(a.amask); in(a.lmask);
  in(a.wqp); in(a.bqp); in(a.wq); in(a.bq); in(a.wo); in(a.bo); in(a.wg_c);
  for (int li = 0; li < NL; ++li) { in(a.wih[li]); in(a.whh[li]); in(a.bl[li]); }
  in(a.ln_g); in(a.ln_b); in(a.whg_h); in(a.whg_c); in(a.bhw); in(a.wcp); in(a.bcp);
  in(a.h_tops); in(a.enh); in(a.attn); in(a.hs[0]); in(a.hs[1]);
  in(a.cs[0]); in(a.cs[1]); in(a.cs[2]);
  unsigned char* w = static_cast<unsigned char*>(ws);
  auto carve = [&](size_t bytes) {
    unsigned char* r = w;
    w += align16(bytes);
    return r;
  };
  a.q = reinterpret_cast<T*>(carve(sizeof(T) * MT * E));
  a.cat = reinterpret_cast<T*>(carve(sizeof(T) * MT * E));
  a.ctx_r = reinterpret_cast<T*>(carve(sizeof(T) * MT * E));
  a.x0 = reinterpret_cast<T*>(carve(sizeof(T) * MT * E));
  a.hst[0] = reinterpret_cast<T*>(carve(sizeof(T) * MT * H));
  a.hst[1] = reinterpret_cast<T*>(carve(sizeof(T) * MT * H));
  a.qh = reinterpret_cast<float*>(carve(4 * (size_t)MT * E));
  a.ctx = reinterpret_cast<float*>(carve(4 * (size_t)MT * E));
  a.wd = reinterpret_cast<float*>(carve(4 * (size_t)MT * nh * L));
  for (int li = 0; li < NL; ++li) a.rh[li] = reinterpret_cast<float*>(carve(4 * (size_t)MT * H));
  for (int li = 0; li < NL; ++li)
    a.part[li] = reinterpret_cast<float*>(carve(8 * (size_t)MT * nblk));
  a.bar = reinterpret_cast<unsigned*>(carve(16));
  a.steps = steps; a.B = B; a.L = L; a.E = E; a.H = H; a.nh = nh;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)enhanced_scan_kernel<T>, dim3(nblk),
                                          dim3(THREADS), params, smem_bytes<T>(L, E, H, nh),
                                          stream);
}

}  // namespace

// Blocks the cooperative kernel runs on for this dtype and these sizes on
// the current device (0 if it does not fit; negative: a CUDA error code), and
// its dynamic shared memory in bytes through smem.
extern "C" int ic_enhanced_scan_blocks(int dtype, int L, int E, int H, int nh, long long* smem) {
  if (nh <= 0 || E % nh != 0) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return blocks<float>(L, E, H, nh, smem);
  if (dtype == 1) return blocks<bf16>(L, E, H, nh, smem);
  return -(int)cudaErrorInvalidValue;
}

// Bytes of the workspace a launch on nblk blocks needs; the caller zeroes it.
extern "C" long long ic_enhanced_scan_workspace_bytes(int dtype, int L, int E, int H, int nh,
                                                      int nblk) {
  return (long long)(dtype == 0 ? workspace_bytes<float>(L, E, H, nh, nblk)
                                : workspace_bytes<bf16>(L, E, H, nh, nblk));
}

// dtype: 0 = float32, 1 = bfloat16 (embp, k, v, the weight matrices and the
// four h outputs; gate_w, the masks, biases, LayerNorm affines, attn and the
// three c outputs are float32).  ptrs: the 29 operands (amask and lmask may
// be null) and 8 outputs in the order of Args.  ws: a zeroed workspace of
// ic_enhanced_scan_workspace_bytes; nblk: from ic_enhanced_scan_blocks (each
// block may own at most 6 hidden units and 3 of E, and one (row, head)
// attention job: min(B, 16) x nh <= nblk).  Returns a cudaError_t.
extern "C" int ic_enhanced_scan(int dtype, const void* const* ptrs, void* ws, int nblk,
                                int steps, int B, int L, int E, int H, int nh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nh <= 0 || E % nh != 0 || nblk > MAX_BLOCKS || (B < MT ? B : MT) * nh > nblk)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(ptrs, ws, nblk, steps, B, L, E, H, nh, s);
  if (dtype == 1) return launch<bf16>(ptrs, ws, nblk, steps, B, L, E, H, nh, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
