// Post-attention transformer block (eval), optionally with the T2S QTV
// tanh-residual epilogue.
//
// Replaces: vitxtgqa_tpu/ops/pallas_ffn.py:fused_block (_block_kernel) and
// pallas_ffn.py:fused_block_tanh (_block_tanh_kernel):
//   x   = LN1(x_q + ctx Wo^T + bo)                      (f32)
//   h   = gelu_erf(bf16(x) W1^T + b1)                   (bf16)
//   out = LN2(x + h W2^T + b2)
//   tanh form: out = res + tanh(bf16(out))
// Weights arrive in torch nn.Linear layout ([out, in], bf16); biases and
// LayerNorm scale/shift in f32.  The gelu is the exact-erf form (erff) of
// the f32 pre-activation; the Pallas kernel approximated erf with A&S
// 7.1.26 because Mosaic has none.  x stays f32 for the second residual.
//
// What bounds it on the H100: at the main path's serving shape (rows =
// 8*1152 = 9216, D = 768, M = 3072) the three products are 2*rows*(D*D + 2*D*M) = 98 GFLOP
// against ~16 MB of weights and 3*rows*D*2 = 42 MB of activations — far
// above the bf16 ridge, so the tensor cores bound it (0.099 ms).
//
// Design: the training block's (block_train.cu, #9a): every product on
// gemm_sm90.cuh's wgmma body (128-row tiles on two warpgroups, a cp.async
// ring), its epilogue on the tile staged in shared memory, and the
// LayerNorms, which need whole rows of the hidden width (768 on the main
// path, any multiple of 128 up to 2,048), as light row passes (a warp a
// row, row_ops.cuh, one instantiation a width) over f32 pre-norm values
// that the GEMM epilogues write; so no block holds a full output row and
// the weights are read once per 128 rows.  Five launches:
//  1. GEMM ctx Wo^T, epilogue x32 = x_q + (acc + bo)        (f32);
//  2. rows: x32 = LN1(x32) in place, xb = bf16(x32);
//  3. GEMM xb W1^T, epilogue h = bf16(gelu_erf(acc + b1))   (ffn_epi.cuh);
//  4. GEMM h W2^T, epilogue x32 += acc + b2, in place (each element is one
//     tile's);
//  5. rows: out = bf16(LN2(x32)), or bf16(res + tanh(bf16(LN2(x32)))).
// The f32 round trips of x32 cost ~0.03 ms at the serving shape; h's
// 2 * rows * M * 2 bytes (113 MB, ~0.03 ms).
//
// Tensor parallelism (the split forms, ops/fused_block.fused_block_tp and
// fused_block_tanh_tp): a rank holds Wo's columns of its heads (wo_l [d,
// dl]), W1's rows and b1 of its FFN share (w1_l [ml, d]) and W2's columns
// (w2_l [d, ml]).  The same five launches run with the model group's
// all-reduce of an f32 partial after launches 1 and 4, which then store
// the bare product (vt_gemm_f32, also the training block's split
// forward's); the row passes add the bias and the residual to the sum
// (vt_fused_block_tp_ln1, vt_fused_block_tp_ln2), so the biases of the
// row-parallel products are added once; launch 3 runs on the rank's share
// (vt_fused_block_tp_ffn_in).
#include "ffn_epi.cuh"

namespace vt {
namespace eval_block {

using gemm::load4;
using gemm::store4;

constexpr int kRowThreads = 256;  // row passes: a warp a row, 8 rows a block

// the row passes' grid: a block per 8 rows, at most two blocks an SM
inline int row_blocks(int rows) {
  const int per = kRowThreads / 32;
  return min((rows + per - 1) / per, 2 * 132);
}

// launch 1: out = resid + (acc + bias), f32
struct ResidEpi {
  const float* bias;
  const bf16* resid;
  float* out;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      const size_t gi = (size_t)row * t.N + col;
      float b[8], r[8];
      g90::load8(bias + col, b);
      g90::unpack8(*reinterpret_cast<const uint4*>(resid + gi), r);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = r[e] + (v[e] + b[e]);
      g90::store8(out + gi, v);
    });
  }
};

// launch 4: x = x + (acc + bias), f32, in place
struct AddEpi {
  const float* bias;
  float* x;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      float* p = x + (size_t)row * t.N + col;
      float b[8], u[8];
      g90::load8(bias + col, b);
      g90::load8(p, u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = u[e] + (v[e] + b[e]);
      g90::store8(p, v);
    });
  }
};

// the split forms' row-parallel products: out = acc (f32)
struct StoreF32Epi {
  float* out;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      g90::store8(out + (size_t)row * t.N + col, v);
    });
  }
};

// the split form's launch 2: x = LN1(resid + (sum + bias)) (f32, launch
// 1's epilogue on the summed partial) and xb = bf16(x)
template <int G>
__global__ void __launch_bounds__(kRowThreads)
tp_ln1_rows(const float* __restrict__ sum, const float* __restrict__ bias,
            const bf16* __restrict__ resid, const float* __restrict__ s,
            const float* __restrict__ g, float* __restrict__ x, bf16* __restrict__ xb, int M,
            float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float v[G][4];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      float a[4], b[4], r[4];
      load4(sum + rb + c, a);
      load4(bias + c, b);
      load4(resid + rb + c, r);
#pragma unroll
      for (int t = 0; t < 4; ++t) v[q][t] = r[t] + (a[t] + b[t]);
    }
    const gemm::RowStats st = gemm::row_stats<G>(v, eps);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      float xh[4], y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) xh[t] = (v[q][t] - st.mu) * st.inv;
      gemm::ln_affine(xh, s, g, c, y);
      store4(x + rb + c, y);
      store4(xb + rb + c, y);
    }
  }
}

// the split form's launch 5: out = bf16(LN2(x + (sum + bias))), or with res
// bf16(res + tanh(bf16(LN2(...))))
template <int G>
__global__ void __launch_bounds__(kRowThreads)
tp_ln2_rows(const float* __restrict__ x, const float* __restrict__ sum,
            const float* __restrict__ bias, const float* __restrict__ s,
            const float* __restrict__ g, const bf16* __restrict__ res, bf16* __restrict__ out,
            int M, float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float v[G][4];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      float u[4], a[4], b[4];
      load4(x + rb + c, u);
      load4(sum + rb + c, a);
      load4(bias + c, b);
#pragma unroll
      for (int t = 0; t < 4; ++t) v[q][t] = u[t] + (a[t] + b[t]);
    }
    const gemm::RowStats st = gemm::row_stats<G>(v, eps);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      float xh[4], y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) xh[t] = (v[q][t] - st.mu) * st.inv;
      gemm::ln_affine(xh, s, g, c, y);
      if (res != nullptr) {
        float r[4];
        load4(res + rb + c, r);
#pragma unroll
        for (int t = 0; t < 4; ++t) y[t] = r[t] + tanhf(round_bf16(y[t]));
      }
      store4(out + rb + c, y);
    }
  }
}

// launch 2: x = LN1(x) in place (f32) and xb = bf16(x)
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln1_rows(float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ g,
         bf16* __restrict__ xb, int M, float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float xhat[G][4];
    gemm::row_xhat<G>(x + rb, lane, eps, xhat);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      float y[4];
      gemm::ln_affine(xhat[q], s, g, c, y);
      store4(x + rb + c, y);
      store4(xb + rb + c, y);
    }
  }
}

// launch 5: out = bf16(LN2(x)), or with res bf16(res + tanh(bf16(LN2(x))))
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln2_rows(const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ g,
         const bf16* __restrict__ res, bf16* __restrict__ out, int M, float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float xhat[G][4];
    gemm::row_xhat<G>(x + rb, lane, eps, xhat);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      float y[4];
      gemm::ln_affine(xhat[q], s, g, c, y);
      if (res != nullptr) {
        float r[4];
        load4(res + rb + c, r);
#pragma unroll
        for (int t = 0; t < 4; ++t) y[t] = r[t] + tanhf(round_bf16(y[t]));
      }
      store4(out + rb + c, y);
    }
  }
}

}  // namespace eval_block
}  // namespace vt

// x_q, ctx, res: [rows, d] bf16 (res nullable: plain block without the tanh
// epilogue); wo [d, d], w1 [m, d], w2 [d, m] bf16 in nn.Linear layout;
// bo, s1, g1, b1, b2, s2, g2 f32.  Scratch from the caller: x32 [rows, d]
// f32, xb [rows, d] bf16, h [rows, m] bf16.  out [rows, d] bf16.  d a
// multiple of 128 up to 2,048 (the row passes; 768 on the main path), m a
// multiple of 128 (the narrow tile).
extern "C" int vt_fused_block(const void* x_q, const void* ctx, const void* wo, const void* bo,
                              const void* s1, const void* g1, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* s2, const void* g2,
                              const void* res, void* x32, void* xb, void* h, void* out, int rows,
                              int d, int m, float eps, void* stream) {
  using namespace vt;
  using namespace vt::eval_block;
  if (!gemm::row_width_ok(d) || m <= 0 || m % g90::Narrow::kBN != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = row_blocks(rows);

  VT_TRY((g90::launch_gemm<false, false>(
      g90::one((const bf16*)ctx, d, (const bf16*)wo, d, rows, d, d),
      ResidEpi{(const float*)bo, (const bf16*)x_q, (float*)x32}, st)));
  VT_TRY(gemm::by_row_groups(d, [&](auto g) {
    ln1_rows<decltype(g)::value><<<blocks, kRowThreads, 0, st>>>(
        (float*)x32, (const float*)s1, (const float*)g1, (bf16*)xb, rows, eps);
    return cudaGetLastError();
  }));
  VT_TRY((g90::launch_gemm<false, false>(
      g90::one((const bf16*)xb, d, (const bf16*)w1, d, rows, m, d),
      ffn::GeluBiasEpi{(const float*)b1, (bf16*)h}, st)));
  VT_TRY((g90::launch_gemm<false, false>(
      g90::one((const bf16*)h, m, (const bf16*)w2, m, rows, d, m),
      AddEpi{(const float*)b2, (float*)x32}, st)));
  return (int)gemm::by_row_groups(d, [&](auto g) {
    ln2_rows<decltype(g)::value><<<blocks, kRowThreads, 0, st>>>(
        (const float*)x32, (const float*)s2, (const float*)g2, (const bf16*)res, (bf16*)out,
        rows, eps);
    return cudaGetLastError();
  });
}

// The row-parallel product of a split form: c = a b^T [M, N] f32 of a
// [M, K] and b [N, K] bf16 (nn.Linear layout), leading dims lda / ldb; N a
// multiple of 64 (the thin tile), K of 64.  The eval block's launches 1 and 4 and the
// training block's F1 and F4 on a rank's shares.
extern "C" int vt_gemm_f32(const void* a, int lda, const void* b, int ldb, void* c, int M,
                           int N, int K, void* stream) {
  using namespace vt;
  return (int)g90::launch_gemm<false, false>(g90::one((const bf16*)a, lda, (const bf16*)b, ldb,
                                                      M, N, K),
                                             eval_block::StoreF32Epi{(float*)c},
                                             (cudaStream_t)stream);
}

// The split form's launch 2 (x32 [rows, d] f32 and xb [rows, d] bf16 from
// the summed partial sum [rows, d] f32, bo, s1, g1 [d] f32 and x_q [rows,
// d] bf16) and launch 5 (out [rows, d] bf16 from x32, the summed partial,
// b2, s2, g2 and res, nullable); d as vt_fused_block's.
extern "C" int vt_fused_block_tp_ln1(const void* sum, const void* bo, const void* x_q,
                                     const void* s1, const void* g1, void* x32, void* xb,
                                     int rows, int d, float eps, void* stream) {
  using namespace vt::eval_block;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  return (int)vt::gemm::by_row_groups(d, [&](auto g) {
    tp_ln1_rows<decltype(g)::value><<<row_blocks(rows), kRowThreads, 0, (cudaStream_t)stream>>>(
        (const float*)sum, (const float*)bo, (const vt::bf16*)x_q, (const float*)s1,
        (const float*)g1, (float*)x32, (vt::bf16*)xb, rows, eps);
    return cudaGetLastError();
  });
}

extern "C" int vt_fused_block_tp_ln2(const void* x32, const void* sum, const void* b2,
                                     const void* s2, const void* g2, const void* res, void* out,
                                     int rows, int d, float eps, void* stream) {
  using namespace vt::eval_block;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  return (int)vt::gemm::by_row_groups(d, [&](auto g) {
    tp_ln2_rows<decltype(g)::value><<<row_blocks(rows), kRowThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x32, (const float*)sum, (const float*)b2, (const float*)s2,
        (const float*)g2, (const vt::bf16*)res, (vt::bf16*)out, rows, eps);
    return cudaGetLastError();
  });
}

// The split form's launch 3 on this rank's FFN share: h = bf16(gelu_erf(xb
// W1^T + b1)) [rows, m] bf16 from xb [rows, d] bf16, w1 [m, d] bf16, b1
// [m] f32; m a multiple of 64 (the thin tile).
extern "C" int vt_fused_block_tp_ffn_in(const void* xb, const void* w1, const void* b1, void* h,
                                        int rows, int d, int m, void* stream) {
  using namespace vt;
  if (!gemm::row_width_ok(d) || m <= 0 || m % g90::Thin::kBN != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)g90::launch_gemm<false, false>(
      g90::one((const bf16*)xb, d, (const bf16*)w1, d, rows, m, d),
      ffn::GeluBiasEpi{(const float*)b1, (bf16*)h}, (cudaStream_t)stream);
}
