// W8A8 post-attention block (eval): the three products int8 x int8 on the
// tensor cores, with per-row activation scales and per-output-channel
// weight scales.
//
// Replaces: vitxtgqa_tpu/ops/pallas_ffn.py:fused_block_w8a8 (the Pallas body
// _block_w8a8_kernel; its quantized math is block_w8a8_reference):
//   c8, cs = q(ctx)                                    per row: amax in the
//            input dtype, scale = max(amax, 1e-6) / 127, rint(v / scale)
//            clipped to +-127 (IEEE division, round half to even)
//   x      = LN1(x_q + (f32(c8 Wo8^T) * cs * wos + bo))           f32
//   h      = gelu_as(f32(q(x) W18^T) * xs * w1s + b1)              f32
//   out    = LN2(x + (f32(q(h) W28^T) * hs * w2s + b2))            bf16
// The weights arrive quantized once per set of weights (int8 [out, in],
// the nn.Linear layout, and f32 scales [out]); gelu_as is the
// Abramowitz-Stegun erf of the Pallas kernel (expf, never __expf).  The
// int32 sums are exact and the epilogues keep the twin's f32 operation
// order, unfused (__fmul_rn / __fadd_rn), so the kernel differs from its
// plain version only in the order of the LayerNorms' f32 sums, which can
// move one element of x or h across a rounding boundary of its int8 step.
//
// What bounds it on the H100: at the main path's serving shape (rows = 8 *
// 1152 = 9216, D = 768, M = 3072) the products are 2 * rows * (D*D + 2*D*M) = 97.8 G
// integer operations against ~48 MB of activations and int8 weights: at
// 1,979 T int8 operations/s the tensor cores bound it (0.049 ms; the bytes
// need 0.014 ms).
//
// Design: every product on gemm_sm90.cuh's wgmma body in its s8 form (128 x
// 128 tiles on two warpgroups, m64n128k32, a 3-stage cp.async ring, two
// blocks an SM, the s32 sums staged as f32 for the epilogue), the
// LayerNorms as row passes (a warp a row, row_ops.cuh), as in the eval block
// (fused_block.cu).  The epilogues, not the products, take most of the time
// (gelu_as is some 30 operations an element), so the gelu runs once.  h's
// per-row amax spans all M columns, several tiles: launch 4 writes h in f32
// and folds each tile's row maxima into hmax by atomicMax on the bits of a
// non-negative float (exact, in any order), and an elementwise pass then
// quantizes h at each row's scale (PERF.md section 6 has the forms of h
// that were measured).  Seven launches:
//  1. rows: c8, cs = q(ctx);
//  2. GEMM c8 Wo8^T, epilogue x32 = x_q + ((acc * cs) * wos + bo)      (f32);
//  3. rows: x32 = LN1(x32) in place, x8, xs = q(x32), hmax = 0;
//  4. GEMM x8 W18^T, epilogue h32 = gelu_as((acc * xs) * w1s + b1), hmax;
//  5. elementwise: h8 = q(h32) at the scale of hmax;
//  6. GEMM h8 W28^T, epilogue x32 += (acc * hs) * w2s + b2 in place (each
//     element is one tile's);
//  7. rows: out = bf16(LN2(x32)).
#include "gemm_sm90.cuh"
#include "row_ops.cuh"

namespace vt {
namespace w8a8 {

constexpr int kRowThreads = 256;  // row passes: a warp a row, 8 rows a block

// erf and gelu of the Pallas kernel, every operation rounded on its own as
// the twin's elementwise tensors are
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  const float t = __frcp_rn(__fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));  // = 1 / x, rounded once
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  return __fmul_rn(s, __fadd_rn(1.0f, -__fmul_rn(poly, expf(-__fmul_rn(a, a)))));
}

__device__ __forceinline__ float gelu_as(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f),
                   __fadd_rn(1.0f, erf_as(__fmul_rn(x, 0.7071067811865476f))));
}

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax, 1e-6f) / 127.0f; }

__device__ __forceinline__ int8_t quant(float v, float scale) {
  return (int8_t)fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
}

// quant(v, scale) with inv = 1 / scale: v * inv is within 2 ulps of v /
// scale (|v / scale| <= 127, so 1.5e-5), so its rint is the quotient's
// unless it lies that close to a tie, where the IEEE division decides
__device__ __forceinline__ int8_t quant_inv(float v, float scale, float inv) {
  const float y = __fmul_rn(v, inv);
  float r = rintf(y);
  if (fabsf(fabsf(y - r) - 0.5f) < 4e-5f) r = rintf(v / scale);
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

// a W8A8 product's f32 value in the twin's order: (acc * row scale) *
// channel scale + bias
__device__ __forceinline__ float dequant(float acc, float as, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(acc, as), ws), b);
}

// h of eight columns from col of one row: gelu_as(dequant(acc))
__device__ __forceinline__ void gelu8(float (&v)[8], float as, const float* ws, const float* b) {
  float w[8], bv[8];
  g90::load8(ws, w);
  g90::load8(b, bv);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = gelu_as(dequant(v[e], as, w[e], bv[e]));
}

// ---- 1: q(ctx), a warp per row ---------------------------------------------
// cols % 8 == 0; the row is read twice (amax, then the values), the
// second time from cache
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                  int rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * cols;
  float amax = 0.f;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    g90::unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
  }
  const float scale = quant_scale(warp_max(amax));
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    g90::unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = quant(v[t], scale);
    *reinterpret_cast<uint2*>(q + (size_t)row * cols + c) = *reinterpret_cast<const uint2*>(o);
  }
  if (lane == 0) scales[row] = scale;
}

// ---- 2: x32 = x_q + dequant(c8 Wo8^T) ----------------------------------------
struct CtxEpi {
  const float *cs, *ws, *bias;
  const bf16* resid;
  float* out;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      const size_t gi = (size_t)row * t.N + col;
      const float as = cs[row];
      float w[8], b[8], r[8];
      g90::load8(ws + col, w);
      g90::load8(bias + col, b);
      g90::unpack8(*reinterpret_cast<const uint4*>(resid + gi), r);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(r[e], dequant(v[e], as, w[e], b[e]));
      g90::store8(out + gi, v);
    });
  }
};

// ---- 3: x32 = LN1(x32) in place, x8, xs = q(x32), hmax = 0 -------------------
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln1_quant_rows(float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ g,
               int8_t* __restrict__ x8, float* __restrict__ xs, float* __restrict__ hmax, int M,
               float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float y[G][4];
    gemm::row_xhat<G>(x + rb, lane, eps, y);
    float amax = 0.f;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      gemm::ln_affine(y[q], s, g, c, y[q]);
      gemm::store4(x + rb + c, y[q]);
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(y[q][e]));
    }
    const float scale = quant_scale(warp_max(amax));
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      *reinterpret_cast<char4*>(x8 + rb + c) = make_char4(
          quant(y[q][0], scale), quant(y[q][1], scale), quant(y[q][2], scale), quant(y[q][3], scale));
    }
    if (lane == 0) {
      xs[row] = scale;
      hmax[row] = 0.f;
    }
  }
}

// ---- 4: h32 = gelu_as(...) in f32 and hmax = max(hmax, |h|) over the
// tile's columns of each row: tile_rows' walk with every thread on every
// pass (a row's kPer threads are lanes of one warp, which reduce by
// shuffles), then one atomicMax a row and tile (on the bits of a
// non-negative float: exact, in any order)
struct HstoreMaxEpi {
  const float *xs, *ws, *bias;
  float *h32, *hmax;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    constexpr int kPer = T::kBN / 8, kRows = g90::kThreads / kPer;
    const int c = (threadIdx.x % kPer) * 8;
    for (int r = threadIdx.x / kPer; r < g90::kBM; r += kRows) {
      const int row = t.m0 + r;
      float m = 0.f;
      if (row < t.M) {
        float v[8];
        g90::load8(t.c + r * t.ld + c, v);
        gelu8(v, xs[row], ws + t.n0 + c, bias + t.n0 + c);
        g90::store8(h32 + (size_t)row * t.N + t.n0 + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
      }
#pragma unroll
      for (int o = kPer / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (threadIdx.x % kPer == 0 && row < t.M)
        atomicMax(reinterpret_cast<int*>(hmax + row), __float_as_int(m));
    }
  }
};

// ---- 5: h8 = q(h32) at each row's scale, eight elements a thread ----------
__global__ void __launch_bounds__(kRowThreads)
quant_h(const float* __restrict__ h32, const float* __restrict__ hmax, int8_t* __restrict__ h8,
        int rows, int cols) {
  const size_t n = (size_t)rows * cols;
  for (size_t i = ((size_t)blockIdx.x * kRowThreads + threadIdx.x) * 8; i < n;
       i += (size_t)gridDim.x * kRowThreads * 8) {
    const float scale = quant_scale(hmax[i / cols]), inv = __frcp_rn(scale);
    float v[8];
    g90::load8(h32 + i, v);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = quant_inv(v[t], scale, inv);
    *reinterpret_cast<uint2*>(h8 + i) = *reinterpret_cast<const uint2*>(o);
  }
}

// ---- 6: x32 += dequant(h8 W28^T), in place -----------------------------------
struct ResidAddEpi {
  const float *hmax, *ws, *bias;
  float* x;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      float* p = x + (size_t)row * t.N + col;
      const float hs = quant_scale(hmax[row]);
      float w[8], b[8], u[8];
      g90::load8(ws + col, w);
      g90::load8(bias + col, b);
      g90::load8(p, u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(u[e], dequant(v[e], hs, w[e], b[e]));
      g90::store8(p, v);
    });
  }
};

// ---- 7: out = bf16(LN2(x32)) -------------------------------------------------
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln2_rows(const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ g,
         bf16* __restrict__ out, int M, float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float y[G][4];
    gemm::row_xhat<G>(x + rb, lane, eps, y);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      gemm::ln_affine(y[q], s, g, c, y[q]);
      gemm::store4(out + rb + c, y[q]);
    }
  }
}

}  // namespace w8a8
}  // namespace vt

// ptrs (void*, in this order): x_q, ctx [rows, d] bf16; wo8 [d, d], wos [d];
// bo, s1, g1 [d]; w18 [m, d], w1s [m], b1 [m]; w28 [d, m], w2s [d]; b2, s2,
// g2 [d] (int8 weights, f32 vectors); scratch c8 [rows, d] int8, cs [rows],
// x32 [rows, d] f32, x8 [rows, d] int8, xs [rows], hmax [rows] f32, h32
// [rows, m] f32, h8 [rows, m] int8; out [rows, d] bf16.  d a multiple of
// 128 up to 2,048 (the row passes; 768 on the main path), m a multiple of
// 128 (the S8 tile, and the K step of h8 W28^T).
extern "C" int vt_fused_block_w8a8(void* const* ptrs, int rows, int d, int m, float eps,
                                   void* stream) {
  using namespace vt;
  using namespace vt::w8a8;
  if (!gemm::row_width_ok(d) || m <= 0 || m % g90::Narrow::kBN != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const bf16* x_q = (const bf16*)ptrs[0];
  const bf16* ctx = (const bf16*)ptrs[1];
  const int8_t* wo8 = (const int8_t*)ptrs[2];
  const float *wos = (const float*)ptrs[3], *bo = (const float*)ptrs[4];
  const float *s1 = (const float*)ptrs[5], *g1 = (const float*)ptrs[6];
  const int8_t* w18 = (const int8_t*)ptrs[7];
  const float *w1s = (const float*)ptrs[8], *b1 = (const float*)ptrs[9];
  const int8_t* w28 = (const int8_t*)ptrs[10];
  const float *w2s = (const float*)ptrs[11], *b2 = (const float*)ptrs[12];
  const float *s2 = (const float*)ptrs[13], *g2 = (const float*)ptrs[14];
  int8_t* c8 = (int8_t*)ptrs[15];
  float* cs = (float*)ptrs[16];
  float* x32 = (float*)ptrs[17];
  int8_t* x8 = (int8_t*)ptrs[18];
  float* xs = (float*)ptrs[19];
  float* hmax = (float*)ptrs[20];
  float* h32 = (float*)ptrs[21];
  int8_t* h8 = (int8_t*)ptrs[22];
  bf16* out = (bf16*)ptrs[23];
  cudaStream_t st = (cudaStream_t)stream;
  const int per = kRowThreads / 32;
  const int quant_blocks = (rows + per - 1) / per;
  const int row_blocks = min(quant_blocks, 2 * g90::kSMs);

  quant_rows_kernel<<<quant_blocks, kRowThreads, 0, st>>>(ctx, c8, cs, rows, d);
  VT_TRY(cudaGetLastError());
  VT_TRY((g90::launch_gemm_s8(g90::one(c8, d, wo8, d, rows, d, d),
                                                  CtxEpi{cs, wos, bo, x_q, x32}, st)));
  VT_TRY(gemm::by_row_groups(d, [&](auto g) {
    ln1_quant_rows<decltype(g)::value><<<row_blocks, kRowThreads, 0, st>>>(x32, s1, g1, x8, xs,
                                                                           hmax, rows, eps);
    return cudaGetLastError();
  }));
  const g90::GemmArgs ffn1 = g90::one(x8, d, w18, d, rows, m, d);
  VT_TRY((g90::launch_gemm_s8(ffn1, HstoreMaxEpi{xs, w1s, b1, h32, hmax}, st)));
  quant_h<<<8 * g90::kSMs, kRowThreads, 0, st>>>(h32, hmax, h8, rows, m);
  VT_TRY(cudaGetLastError());
  VT_TRY((g90::launch_gemm_s8(g90::one(h8, m, w28, m, rows, d, m),
                                                  ResidAddEpi{hmax, w2s, b2, x32}, st)));
  return (int)gemm::by_row_groups(d, [&](auto g) {
    ln2_rows<decltype(g)::value><<<row_blocks, kRowThreads, 0, st>>>(x32, s2, g2, out, rows, eps);
    return cudaGetLastError();
  });
}

namespace vt {
namespace w8a8 {

// the s8 products alone: c = f32(a8 b8^T), the body's staged tile as it is
struct StoreEpi {
  float* c;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      g90::store8(c + (size_t)row * t.N + col, v);
    });
  }
};

}  // namespace w8a8
}  // namespace vt

// a8 [M, K], b8 [N, K] int8, c [M, N] f32 (the check of the body's s8 form
// against exact integer sums); N a multiple of 128, K of 128
extern "C" int vt_gemm_s8(const void* a8, const void* b8, void* c, int M, int N, int K,
                          void* stream) {
  using namespace vt;
  return (int)g90::launch_gemm_s8(g90::one(a8, K, b8, K, M, N, K),
                                                     w8a8::StoreEpi{(float*)c},
                                                     (cudaStream_t)stream);
}
