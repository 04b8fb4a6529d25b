// Training post-attention block: the recompute forward (#9a) and the
// backward (#9b), with the two hidden dropouts drawn in-kernel.
//
// Replaces: vitxtgqa_tpu/ops/pallas_block_bwd.py:block_train — its
// forward kernel (_fwd_impl / _fwd_kernel) and its one-pass backward
// (_bwd_impl / _block_bwd_kernel).  With nn.Linear weights (wo [d, d], w1
// [m, d], w2 [d, m] bf16), f32 bias and LayerNorm vectors, and the keep
// masks K_a, K_f over 1 - rate:
//   x1h = bf16(x_q + K_a (ctx Wo^T + bo))     x = bf16(LN1(x1h))
//   pre1 = bf16(x W1^T + b1)                  h = bf16(gelu(pre1))
//   x2h = bf16(x + K_f (h W2^T + b2))         y = bf16(LN2(x2h))
// The forward emits y and the residuals x1h, pre1, h, x2h; the backward
// takes the cotangent g of y and returns dx_q, dctx (bf16) and dWo, dbo,
// ds1, dg1, dW1, db1, dW2, db2, ds2, dg2 (f32; weight gradients in
// nn.Linear layout), with gelu' recomputed from pre1 and both LayerNorm
// backwards from the statistics of x1h / x2h, as the Pallas kernel does.
// The masks are the Philox bits of element (row, col) of the [R, 768]
// mask in streams 1 and 2 (philox.cuh, ops/dropout.py), so the forward, a
// remat recompute and the backward draw the same ones; the forward can
// write out the masks it drew.
//
// What bounds it on the H100: at the training shape (R = 48 * 1152 = 55,296
// rows, d = 768, m = 3072) the forward is 2R(d^2 + 2dm) = 587 GFLOP and the
// backward twice that, against ~0.9 GB (forward) and ~2 GB (backward) of
// activations: the tensor cores bound both.
//
// Design.  The TPU backward keeps all weight-gradient accumulators (9.4 MB
// each for dW1 / dW2) resident in VMEM across its sequential row grid; a
// Hopper block has 227 KB of shared memory and blocks run in no order.  So
// the backward is a row-local pass plus products that reduce over the rows:
//  A. ln2_bwd_kernel (a warp per row): du2 = LN2'(g), dlin2 = K_f du2,
//     column sums ds2, dg2, db2;
//  B. tile GEMM dh = dlin2 W2, epilogue dpre = dh gelu'(pre1), sums db1;
//  C. row GEMM dx = du2 + dpre W1, epilogue: LN1 backward (dx_q = du1),
//     dlin1 = K_a du1, x = bf16(LN1(x1h)) for dW1, sums ds1, dg1, dbo;
//  D. tile GEMM dctx = dlin1 Wo;
//  E. three tile GEMMs over the rows, split over R with f32 atomics:
//     dWo = dlin1^T ctx, dW1 = dpre^T x, dW2 = dlin2^T h.
// Column sums reduce in registers over a warp's rows, then in shared
// memory, then with one f32 atomic per column and block.  Every product is
// one of the GEMM tiles of block_gemm.cuh (shared with fused_block.cu);
// no library GEMM.  The forward is three launches: row GEMM (Wo, dropout,
// LN1), tile GEMM (W1, gelu), row GEMM (W2, dropout, LN2).
#include <initializer_list>

#include "block_gemm.cuh"

namespace vt {
namespace gemm {

// ---- backward epilogues ----------------------------------------------------

// dpre = acc * gelu'(pre1), bf16; column sums of the f32 dpre are db1
struct GeluGradEpi {
  static constexpr bool kColSum = true;
  const bf16* pre1;
  bf16* dpre;
  float* db1;
  int ld;
  __device__ void operator()(int row, int col, const float v[8], float* colsum) const {
    const size_t g = (size_t)row * ld + col;
    const uint4 raw = *reinterpret_cast<const uint4*>(pre1 + g);
    const bf16* p = reinterpret_cast<const bf16*>(&raw);
    __align__(16) bf16 out[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float dp = v[t] * gelu_erf_grad(__bfloat162float(p[t]));
      out[t] = __float2bfloat16(dp);
      atomicAdd(colsum + t, dp);
    }
    *reinterpret_cast<uint4*>(dpre + g) = *reinterpret_cast<const uint4*>(out);
  }
  __device__ void flush(float sum, int col) const { atomicAdd(db1 + col, sum); }
};

struct StoreEpi {
  static constexpr bool kColSum = false;
  bf16* out;
  int ld;
  __device__ void operator()(int row, int col, const float v[8], float*) const {
    __align__(16) bf16 o[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = __float2bfloat16(v[t]);
    *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) = *reinterpret_cast<const uint4*>(o);
  }
  __device__ void flush(float, int) const {}
};

// split-K partial products of a weight gradient, added into f32 out
struct AtomicEpi {
  static constexpr bool kColSum = false;
  float* out;
  int ld;
  __device__ void operator()(int row, int col, const float v[8], float*) const {
    float* o = out + (size_t)row * ld + col;
#pragma unroll
    for (int t = 0; t < 8; ++t) atomicAdd(o + t, v[t]);
  }
  __device__ void flush(float, int) const {}
};

// LayerNorm backward through y = xhat * s + b: du = inv (g s - mean(g s) -
// xhat mean(g s xhat)), per row of RGROUPS x 4 lane values
__device__ __forceinline__ void ln_bwd_row(const float g[RGROUPS][4], const float xhat[RGROUPS][4],
                                           const float s[RGROUPS][4], float inv,
                                           float du[RGROUPS][4]) {
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int q = 0; q < RGROUPS; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float dxh = g[q][t] * s[q][t];
      m1 += dxh;
      m2 += dxh * xhat[q][t];
    }
  m1 = warp_sum(m1) / RN;
  m2 = warp_sum(m2) / RN;
#pragma unroll
  for (int q = 0; q < RGROUPS; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) du[q][t] = inv * (g[q][t] * s[q][t] - m1 - xhat[q][t] * m2);
}

// the row's x values (bf16 in memory) and their LayerNorm xhat
__device__ __forceinline__ float row_xhat(const bf16* x, int lane, float eps,
                                          float xhat[RGROUPS][4]) {
#pragma unroll
  for (int q = 0; q < RGROUPS; ++q) load4(x + q * 128 + lane * 4, xhat[q]);
  const RowStats st = row_stats(xhat, eps);
#pragma unroll
  for (int q = 0; q < RGROUPS; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) xhat[q][t] = (xhat[q][t] - st.mu) * st.inv;
  return st.inv;
}

// add a warp's register column sums into the block's shared sums
__device__ __forceinline__ void add_colsums(float* red, const float cs[RGROUPS][4], int lane) {
#pragma unroll
  for (int q = 0; q < RGROUPS; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) atomicAdd(red + q * 128 + lane * 4 + t, cs[q][t]);
}

// Step C: dx = acc + du2; LN1 backward
struct LnBwdEpi {
  static constexpr bool kColSum = true;
  const float* du2;
  const bf16* x1h;
  const float* s1;
  const float* g1;
  bf16* xb;     // bf16(LN1(x1h)): the dW1 operand
  bf16* dxq;
  bf16* dlin1;
  float* ds1;
  float* dg1;
  float* dbo;
  Drop drop;
  float eps;

  __device__ void operator()(const float* Cs, int m0, int M, float* red) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool dropout = drop_on(drop);
    const uint32_t seed = drop_seed(drop);
    float cs_s[RGROUPS][4] = {}, cs_g[RGROUPS][4] = {}, cs_b[RGROUPS][4] = {};
    for (int r = warp; r < RBM; r += NT / 32) {
      const int row = m0 + r;
      if (row >= M) continue;
      const size_t rb = (size_t)row * RN;
      float dx[RGROUPS][4], xhat[RGROUPS][4], s[RGROUPS][4], du[RGROUPS][4];
      const float inv = row_xhat(x1h + rb, lane, eps, xhat);
#pragma unroll
      for (int q = 0; q < RGROUPS; ++q) {
        const int c = q * 128 + lane * 4;
        float cv[4], dv[4], gv[4], xv[4];
        load4(&Cs[r * RLDC + c], cv);
        load4(du2 + rb + c, dv);
        load4(s1 + c, s[q]);
        load4(g1 + c, gv);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          dx[q][t] = cv[t] + dv[t];
          xv[t] = xhat[q][t] * s[q][t] + gv[t];
          cs_s[q][t] += dx[q][t] * xhat[q][t];
          cs_g[q][t] += dx[q][t];
        }
        store4(xb + rb + c, xv);
      }
      ln_bwd_row(dx, xhat, s, inv, du);
#pragma unroll
      for (int q = 0; q < RGROUPS; ++q) {
        const int c = q * 128 + lane * 4;
        store4(dxq + rb + c, du[q]);
        bool keep[4] = {true, true, true, true};
        if (dropout) drop_keep4(drop, seed, row, c, RN, keep);
        float dl[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          dl[t] = dropout ? (keep[t] ? du[q][t] * drop.keep_scale : 0.f) : du[q][t];
          cs_b[q][t] += dl[t];
        }
        store4(dlin1 + rb + c, dl);
      }
    }
    add_colsums(red, cs_s, lane);
    add_colsums(red + RN, cs_g, lane);
    add_colsums(red + 2 * RN, cs_b, lane);
    float* const outs[3] = {ds1, dg1, dbo};
    flush_colsums(red, outs, 3);
  }
};

// Step A: a warp per row; du2 = LN2'(g), dlin2 = K_f du2
__global__ void __launch_bounds__(NT)
ln2_bwd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x2h,
               const float* __restrict__ s2, float* __restrict__ du2, bf16* __restrict__ dlin2,
               float* ds2, float* dg2, float* db2, Drop drop, int M, float eps) {
  __shared__ __align__(16) float red[3 * RN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * RBM;
  for (int i = threadIdx.x; i < 3 * RN; i += NT) red[i] = 0.f;
  const bool dropout = drop_on(drop);
  const uint32_t seed = drop_seed(drop);
  float cs_s[RGROUPS][4] = {}, cs_g[RGROUPS][4] = {}, cs_b[RGROUPS][4] = {};
  for (int r = warp; r < RBM; r += NT / 32) {
    const int row = m0 + r;
    if (row >= M) continue;
    const size_t rb = (size_t)row * RN;
    float gv[RGROUPS][4], xhat[RGROUPS][4], s[RGROUPS][4], du[RGROUPS][4];
    const float inv = row_xhat(x2h + rb, lane, eps, xhat);
#pragma unroll
    for (int q = 0; q < RGROUPS; ++q) {
      const int c = q * 128 + lane * 4;
      load4(g + rb + c, gv[q]);
      load4(s2 + c, s[q]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        cs_s[q][t] += gv[q][t] * xhat[q][t];
        cs_g[q][t] += gv[q][t];
      }
    }
    ln_bwd_row(gv, xhat, s, inv, du);
#pragma unroll
    for (int q = 0; q < RGROUPS; ++q) {
      const int c = q * 128 + lane * 4;
      store4(du2 + rb + c, du[q]);
      bool keep[4] = {true, true, true, true};
      if (dropout) drop_keep4(drop, seed, row, c, RN, keep);
      float dl[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        dl[t] = dropout ? (keep[t] ? du[q][t] * drop.keep_scale : 0.f) : du[q][t];
        cs_b[q][t] += dl[t];
      }
      store4(dlin2 + rb + c, dl);
    }
  }
  __syncthreads();
  add_colsums(red, cs_s, lane);
  add_colsums(red + RN, cs_g, lane);
  add_colsums(red + 2 * RN, cs_b, lane);
  float* const outs[3] = {ds2, dg2, db2};
  flush_colsums(red, outs, 3);
}

}  // namespace gemm
}  // namespace vt

using namespace vt::gemm;
using vt::bf16;

namespace {

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the split of the R rows for a weight-gradient product with `tiles`
// output tiles: about four waves of 132 SMs, chunks a multiple of GBK
int row_chunk(int rows, int tiles) {
  const int splits = max(1, min((rows + 255) / 256, (4 * 132 + tiles - 1) / tiles));
  const int chunk = (rows + splits - 1) / splits;
  return (chunk + GBK - 1) / GBK * GBK;
}

// dW [n_out, n_in] += A^T B, A [rows, n_out], B [rows, n_in]
cudaError_t weight_grad(const bf16* a, const bf16* b, float* dw, int rows, int n_out, int n_in,
                        cudaStream_t st) {
  auto kernel = tile_gemm_kernel<true, true, AtomicEpi>;
  cudaError_t err = allow_smem(kernel, kTileSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (n_out / GBM) * (n_in / GBN);
  const int chunk = row_chunk(rows, tiles);
  const dim3 grid(n_in / GBN, n_out / GBM, (rows + chunk - 1) / chunk);
  kernel<<<grid, NT, kTileSmem, st>>>(a, b, n_out, n_in, rows, chunk, AtomicEpi{dw, n_in});
  return cudaGetLastError();
}

}  // namespace

// #9a.  x_q, ctx [rows, d] bf16; wo [d, d], w1 [m, d], w2 [d, m] bf16;
// bo, s1, g1, b1, b2, s2, g2 f32.  Dropout: seed (int64 [1] on the device),
// or null (rate 0); mask_a_out / mask_f_out (nullable) receive the drawn
// int8 keep masks [rows, d].  Outputs y, x1h, x2h [rows, d], pre1, h [rows, m] bf16; scratch
// xb [rows, d] bf16.
extern "C" int vt_block_train_fwd(const void* x_q, const void* ctx, const void* wo,
                                  const void* bo, const void* s1, const void* g1, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* s2,
                                  const void* g2, const void* seed, void* mask_a_out,
                                  void* mask_f_out,
                                  void* y, void* x1h, void* pre1, void* h, void* x2h, void* xb,
                                  int rows, int d, int m, unsigned int threshold,
                                  float keep_scale, float eps, void* stream) {
  if (d != RN || m % GBN != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto row_kernel = row_gemm_kernel<false, LnFwdEpi>;
  auto gelu_kernel = tile_gemm_kernel<false, false, GeluEpi>;
  constexpr int row_bytes = row_smem<LnFwdEpi>();
  cudaError_t err = allow_smem(row_kernel, row_bytes);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(gelu_kernel, kTileSmem);
  if (err != cudaSuccess) return (int)err;
  const Drop drop_a = {(const int64_t*)seed, (int8_t*)mask_a_out, 1u, threshold, keep_scale};
  const Drop drop_f = {(const int64_t*)seed, (int8_t*)mask_f_out, 2u, threshold, keep_scale};
  const int row_blocks = (rows + RBM - 1) / RBM;

  LnFwdEpi ln1 = {(const float*)bo, (const bf16*)x_q, nullptr, (const float*)s1,
                  (const float*)g1, nullptr, nullptr, (bf16*)xb, (bf16*)x1h, drop_a, eps};
  row_kernel<<<row_blocks, NT, row_bytes, st>>>((const bf16*)ctx, (const bf16*)wo, rows, d, ln1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 ggrid(m / GBN, (rows + GBM - 1) / GBM, 1);
  GeluEpi gelu = {(const float*)b1, (bf16*)pre1, (bf16*)h, m};
  gelu_kernel<<<ggrid, NT, kTileSmem, st>>>((const bf16*)xb, (const bf16*)w1, rows, m, d, d, gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  LnFwdEpi ln2 = {(const float*)b2, (const bf16*)xb, nullptr, (const float*)s2,
                  (const float*)g2, nullptr, nullptr, (bf16*)y, (bf16*)x2h, drop_f, eps};
  row_kernel<<<row_blocks, NT, row_bytes, st>>>((const bf16*)h, (const bf16*)w2, rows, m, ln2);
  return (int)cudaGetLastError();
}

// #9b.  g, ctx, x1h, x2h [rows, d], pre1, h [rows, m] bf16; weights and
// LayerNorm vectors as in the forward; the dropout seed as in the forward.  Outputs dxq, dctx [rows, d] bf16; dwo [d, d], dw1 [m, d],
// dw2 [d, m], dbo, ds1, dg1, db2, ds2, dg2 [d], db1 [m] f32 (zeroed here).
// Scratch: du2 [rows, d] f32; dlin2, xb, dlin1 [rows, d] and dpre
// [rows, m] bf16.
extern "C" int vt_block_train_bwd(const void* g, const void* ctx, const void* x1h,
                                  const void* pre1, const void* h, const void* x2h,
                                  const void* wo, const void* w1, const void* w2, const void* s1,
                                  const void* g1, const void* s2, const void* seed, void* dxq,
                                  void* dctx,
                                  void* dwo, void* dbo, void* ds1, void* dg1, void* dw1,
                                  void* db1, void* dw2, void* db2, void* ds2, void* dg2,
                                  void* du2, void* dlin2, void* dpre, void* xb, void* dlin1,
                                  int rows, int d, int m, unsigned int threshold,
                                  float keep_scale, float eps, void* stream) {
  if (d != RN || m % GBN != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const size_t fd = sizeof(float) * d;
  for (void* p : {dbo, ds1, dg1, db2, ds2, dg2}) {
    err = cudaMemsetAsync(p, 0, fd, st);
    if (err != cudaSuccess) return (int)err;
  }
  if ((err = cudaMemsetAsync(db1, 0, sizeof(float) * m, st)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(dwo, 0, fd * d, st)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(dw1, 0, fd * m, st)) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(dw2, 0, fd * m, st)) != cudaSuccess) return (int)err;
  const Drop drop_a = {(const int64_t*)seed, nullptr, 1u, threshold, keep_scale};
  const Drop drop_f = {(const int64_t*)seed, nullptr, 2u, threshold, keep_scale};
  const int row_blocks = (rows + RBM - 1) / RBM;

  // A. LN2 backward and the FFN dropout
  ln2_bwd_kernel<<<row_blocks, NT, 0, st>>>((const bf16*)g, (const bf16*)x2h, (const float*)s2,
                                            (float*)du2, (bf16*)dlin2, (float*)ds2, (float*)dg2,
                                            (float*)db2, drop_f, rows, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // B. dpre = (dlin2 W2) * gelu'(pre1); db1
  auto dh_kernel = tile_gemm_kernel<false, true, GeluGradEpi>;
  if ((err = allow_smem(dh_kernel, kTileSmem)) != cudaSuccess) return (int)err;
  const dim3 gm(m / GBN, (rows + GBM - 1) / GBM, 1);
  dh_kernel<<<gm, NT, kTileSmem, st>>>((const bf16*)dlin2, (const bf16*)w2, rows, m, d, d,
                                       GeluGradEpi{(const bf16*)pre1, (bf16*)dpre, (float*)db1, m});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // C. dx = du2 + dpre W1; LN1 backward, the attention-output dropout
  auto dx_kernel = row_gemm_kernel<true, LnBwdEpi>;
  constexpr int dx_bytes = row_smem<LnBwdEpi>();
  if ((err = allow_smem(dx_kernel, dx_bytes)) != cudaSuccess) return (int)err;
  LnBwdEpi ln1 = {(const float*)du2, (const bf16*)x1h, (const float*)s1, (const float*)g1,
                  (bf16*)xb, (bf16*)dxq, (bf16*)dlin1, (float*)ds1, (float*)dg1, (float*)dbo,
                  drop_a, eps};
  dx_kernel<<<row_blocks, NT, dx_bytes, st>>>((const bf16*)dpre, (const bf16*)w1, rows, m, ln1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // D. dctx = dlin1 Wo
  auto dctx_kernel = tile_gemm_kernel<false, true, StoreEpi>;
  if ((err = allow_smem(dctx_kernel, kTileSmem)) != cudaSuccess) return (int)err;
  const dim3 gd(d / GBN, (rows + GBM - 1) / GBM, 1);
  dctx_kernel<<<gd, NT, kTileSmem, st>>>((const bf16*)dlin1, (const bf16*)wo, rows, d, d, d,
                                         StoreEpi{(bf16*)dctx, d});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // E. weight gradients, reduced over the rows
  if ((err = weight_grad((const bf16*)dlin1, (const bf16*)ctx, (float*)dwo, rows, d, d, st)) !=
      cudaSuccess)
    return (int)err;
  if ((err = weight_grad((const bf16*)dpre, (const bf16*)xb, (float*)dw1, rows, m, d, st)) !=
      cudaSuccess)
    return (int)err;
  return (int)weight_grad((const bf16*)dlin2, (const bf16*)h, (float*)dw2, rows, d, m, st);
}
