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
// The masks are the Philox bits of element (row, col) of the [R, d] mask
// in streams 1 and 2 (philox.cuh, ops/dropout.py): the counter is the
// element's coordinates, never a flat index, so a mask's bits do not
// depend on d, and the forward, a remat recompute and the backward draw
// the same ones; the forward can write out the masks it drew.
//
// What bounds it on the H100: at the main path's training shape (R = 48 *
// 1152 = 55,296 rows, d = 768, m = 3072) the forward is 2R(d^2 + 2dm) =
// 587 GFLOP and the backward twice that, against ~0.9 GB (forward) and ~2 GB (backward) of
// activations: the tensor cores bound both (0.59 / 1.19 ms at 989 TFLOP/s).
//
// Design.  Every product is gemm_sm90.cuh's wgmma body (128-row tiles on
// two warpgroups, a cp.async ring), its epilogue on the register
// accumulator; the LayerNorms, which need whole rows of the hidden width d
// (768 on the main path, any multiple of 128 up to 2,048), are light row
// passes (a warp a row, row_ops.cuh, one instantiation a width) over the
// pre-norm values that the GEMM epilogues write, so no block holds a full
// row of the output and the weights are read once per 128 rows.  The TPU backward keeps its weight
// gradient accumulators resident across a sequential row grid; here the
// reductions over the rows are split-K products whose f32 partials, like
// the blocks' column sums, go to scratch and are added in a fixed order:
// no atomics, so two calls give the same bits.
//  Forward (5 launches):
//   F1 GEMM ctx Wo^T, epilogue x1h = bf16(x_q + K_a (acc + bo)) (+ mask);
//   F2 rows: xb = bf16(LN1(x1h));
//   F3 GEMM xb W1^T, epilogue pre1 = bf16(acc + b1), h = bf16(gelu(pre1));
//   F4 GEMM h W2^T, epilogue x2h = bf16(xb + K_f (acc + b2)) (+ mask);
//   F5 rows: y = bf16(LN2(x2h)).
//  Backward (7 launches):
//   B1 rows: du2 = LN2'(g) (f32), dlin2 = K_f du2, partial sums ds2, dg2, db2;
//   B2 GEMM dlin2 W2, epilogue dpre = bf16(acc gelu'(pre1)), partial sums db1;
//   B3 GEMM dpre W1, epilogue dx = du2 + acc (f32, over du2);
//   B4 rows: LN1 backward: dx_q = du1, dlin1 = K_a du1, xb = bf16(LN1(x1h)),
//      partial sums ds1, dg1, dbo;
//   B5 GEMM dlin1 Wo -> dctx;
//   B6 one launch of the three weight gradients over the rows, split in K
//      (both operands MN-major): dWo = dlin1^T ctx, dW1 = dpre^T xb, dW2 =
//      dlin2^T h, into f32 partials (into the outputs with one split);
//   B7 the partials summed in order into the 10 f32 outputs.
// The row passes' grid (row_blocks) and the split (k_chunk) come from the
// wrapper's plan (ops/block_train.launch_plan), which sizes the scratch.
//
// Tensor parallelism (the split forms, ops/block_train.block_train_fwd_tp
// and block_train_bwd_tp): a rank holds Wo's columns of its heads (wo_l
// [d, dl]), W1's rows and b1 of its FFN share (w1_l [ml, d]) and W2's
// columns (w2_l [d, ml]); the d-wide rows between the products are whole
// on every rank.  The same launches run with the model group's
// all-reduce of an f32 partial between them:
//  forward: F1 ctx_l Wo_l^T -> f32 partial (vt_gemm_f32, fused_block.cu);
//   sum; F2' rows: x1h = bf16(x_q + K_a (sum + bo)), xb = bf16(LN1(x1h))
//   (vt_block_train_tp_rows); F3 xb W1_l^T (vt_block_train_tp_ffn_in);
//   F4 h_l W2_l^T -> f32 partial; sum; F5' rows: x2h, y as F2'.
//  backward: B1-B3 with B3 storing the f32 partial dpre_l W1_l
//   (vt_block_train_tp_bwd_head); sum; B4 with dx = sum + du2, B5 dctx_l,
//   B6, B7 (vt_block_train_tp_bwd_tail).
// The masks are drawn over the whole rows from the one seed, so every
// rank draws the same ones; the biases of the row-parallel products are
// added once, after the sum.  A share is a multiple of 64 columns: at
// model 4 a rank's dl = 192 takes the GEMM body's thin tiles in B5 and B6.
//
// Sources: this header holds the kernels and the shared helpers; the
// forward's entry points (#9a and its split form's, with the remat
// recompute) compile in block_train.cu, the backward's (#9b and its split
// form's) in block_train_bwd.cu, so that the build compiles the two in
// parallel.
#pragma once

#include "gemm_sm90.cuh"
#include "philox.cuh"
#include "row_ops.cuh"

namespace vt {
namespace bt {

using gemm::load4;
using gemm::row_xhat;
using gemm::store4;
using g90::launch_gemm;
using g90::one;

constexpr int kRowThreads = 256;  // row passes: a warp a row, 8 rows a block

// ---- dropout -------------------------------------------------------------
struct Drop {
  const int64_t* seed;  // null: no dropout
  int8_t* mask_out;     // the drawn mask [R, d], or null
  uint32_t stream;
  uint32_t threshold;
  float keep_scale;     // 1 / (1 - rate)
};

__device__ __forceinline__ uint32_t seed_of(const Drop& d) {
  return d.seed != nullptr ? (uint32_t)(*d.seed) : 0u;
}

// keep flags of columns col .. col + 3 (col % 4 == 0) of one row
__device__ __forceinline__ void row_keep4(const Drop& d, uint32_t seed, int row, int col,
                                          bool keep[4]) {
  const uint4 w = philox_group(seed, d.stream, (uint32_t)col, (uint32_t)row, 0u, 0u);
  keep[0] = w.x >= d.threshold;
  keep[1] = w.y >= d.threshold;
  keep[2] = w.z >= d.threshold;
  keep[3] = w.w >= d.threshold;
}

// ---- GEMM epilogues (on the staged tile, eight columns of a row at a time)

// the keep flags of columns col .. col + 7 (col % 8 == 0) of one row, and
// the drawn mask's eight bytes
__device__ __forceinline__ void row_keep8(const Drop& d, uint32_t seed, int row, int col,
                                          size_t gi, bool keep[8]) {
  row_keep4(d, seed, row, col, keep);
  row_keep4(d, seed, row, col + 4, keep + 4);
  if (d.mask_out != nullptr) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e / 4] |= (uint32_t)keep[e] << (8 * (e % 4));
    *reinterpret_cast<uint2*>(d.mask_out + gi) = make_uint2(w[0], w[1]);
  }
}

// F1 / F4: out = bf16(resid + K (acc + bias)), the drawn mask to mask_out
struct ResidDropEpi {
  const float* bias;
  const bf16* resid;
  bf16* out;
  Drop drop;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    const bool dropout = drop.seed != nullptr;
    const uint32_t seed = seed_of(drop);
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      const size_t gi = (size_t)row * t.N + col;
      float b[8], r[8];
      bool keep[8];
      g90::load8(bias + col, b);
      g90::unpack8(*reinterpret_cast<const uint4*>(resid + gi), r);
      if (dropout) row_keep8(drop, seed, row, col, gi, keep);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = v[e] + b[e];
        if (dropout) a = keep[e] ? a * drop.keep_scale : 0.f;
        v[e] = r[e] + a;
      }
      *reinterpret_cast<uint4*>(out + gi) = g90::pack8(v);
    });
  }
};

// F3: pre = bf16(acc + bias), h = bf16(gelu(pre))
struct GeluEpi {
  const float* bias;
  bf16* pre;
  bf16* h;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      const size_t gi = (size_t)row * t.N + col;
      float b[8];
      g90::load8(bias + col, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += b[e];
      const uint4 p = g90::pack8(v);
      *reinterpret_cast<uint4*>(pre + gi) = p;
      g90::unpack8(p, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gemm::gelu_erf(v[e]);
      *reinterpret_cast<uint4*>(h + gi) = g90::pack8(v);
    });
  }
};

// B2: dp = acc gelu'(pre1); dpre = bf16(dp); the tile's column sums of
// the f32 dp to db1_part[m_tile][N]
struct GeluGradEpi {
  const bf16* pre1;
  bf16* dpre;
  float* db1_part;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      const size_t gi = (size_t)row * t.N + col;
      float p[8];
      g90::unpack8(*reinterpret_cast<const uint4*>(pre1 + gi), p);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] *= gemm::gelu_erf_grad(p[e]);
        cs[e] += v[e];
      }
      *reinterpret_cast<uint4*>(dpre + gi) = g90::pack8(v);
    });
    g90::tile_colsum(t, cs, db1_part + (size_t)t.m_tile * t.N + t.n0);
  }
};

// B3: dx = du2 + acc, f32, in place over du2
struct AddF32Epi {
  float* dx;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      float* p = dx + (size_t)row * t.N + col;
      float u[8];
      g90::load8(p, u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += u[e];
      g90::store8(p, v);
    });
  }
};

// B5: out = bf16(acc)
struct StoreEpi {
  bf16* out;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      *reinterpret_cast<uint4*>(out + (size_t)row * t.N + col) = g90::pack8(v);
    });
  }
};

// the split forms' row-parallel products: out = acc (f32), the rank's
// partial of the model group's sum
struct StoreF32Epi {
  float* out;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      g90::store8(out + (size_t)row * t.N + col, v);
    });
  }
};

// B6: problem p's split s stores its f32 partial at out[p] + s * stride[p]
// (stride 0 with one split: the output itself)
struct PartialEpi {
  float* out[g90::kMaxProblems];
  size_t stride[g90::kMaxProblems];
  template <class T>
  __device__ void operator()(const T& t, int p) const {
    float* o = (p == 0 ? out[0] : p == 1 ? out[1] : out[2]) +
               t.split * (p == 0 ? stride[0] : p == 1 ? stride[1] : stride[2]);
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      g90::store8(o + (size_t)row * t.N + col, v);
    });
  }
};

// ---- LayerNorm row passes (a warp a row, a lane on four consecutive
// columns in each of the row's G 128-column groups) ------------------------

// out = bf16(xhat * s + g): the forward's LN1 / LN2 and the backward's xb
template <int G>
__device__ __forceinline__ void ln_store(bf16* out, const float xhat[G][4], const float* s,
                                         const float* g, int lane) {
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int c = q * 128 + lane * 4;
    float y[4];
    gemm::ln_affine(xhat[q], s, g, c, y);
    store4(out + c, y);
  }
}

// LayerNorm backward through y = xhat * s + b: du = inv (g s - mean(g s) -
// xhat mean(g s xhat)), in place over g (s is read twice, from L1, so that
// a wide row keeps no third array in registers)
template <int G>
__device__ __forceinline__ void ln_bwd_row(float g[G][4], const float xhat[G][4], const float* s,
                                           float inv) {
  const int lane = threadIdx.x % 32;
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    float sv[4];
    load4(s + q * 128 + lane * 4, sv);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float dxh = g[q][t] * sv[t];
      m1 += dxh;
      m2 += dxh * xhat[q][t];
    }
  }
  m1 = warp_sum(m1) / (G * 128);
  m2 = warp_sum(m2) / (G * 128);
#pragma unroll
  for (int q = 0; q < G; ++q) {
    float sv[4];
    load4(s + q * 128 + lane * 4, sv);
#pragma unroll
    for (int t = 0; t < 4; ++t) g[q][t] = inv * (g[q][t] * sv[t] - m1 - xhat[q][t] * m2);
  }
}

// the block's three column sums in a fixed order (warp 0's, then warp
// 1's added, ...) into part[blockIdx.x][3][G * 128]
template <int G>
__device__ __forceinline__ void row_colsums(float* red, const float cs[3][G][4], float* part) {
  constexpr int RN = G * 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = 0; w < kRowThreads / 32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float* r = red + n * RN + q * 128 + lane * 4 + t;
            *r = (w == 0 ? 0.f : *r) + cs[n][q][t];
          }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * 3 * RN;
  for (int i = threadIdx.x; i < 3 * RN; i += kRowThreads) out[i] = red[i];
}

// F2 / F5: out = bf16(LN(x))
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_rows(const bf16* __restrict__ x, const float* __restrict__ s, const float* __restrict__ g,
            bf16* __restrict__ out, int M, float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    float xhat[G][4];
    row_xhat<G>(x + (size_t)row * (G * 128), lane, eps, xhat);
    ln_store<G>(out + (size_t)row * (G * 128), xhat, s, g, lane);
  }
}

// B1: du2 = LN2'(g), dlin2 = K_f du2; partial sums of g xhat, g, dlin2
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln2_bwd_rows(const bf16* __restrict__ g, const bf16* __restrict__ x2h,
             const float* __restrict__ s2, float* __restrict__ du2, bf16* __restrict__ dlin2,
             float* __restrict__ part, Drop drop, int M, float eps) {
  __shared__ __align__(16) float red[3 * G * 128];
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  const bool dropout = drop.seed != nullptr;
  const uint32_t seed = seed_of(drop);
  float cs[3][G][4] = {};
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float du[G][4], xhat[G][4];  // du: g, then LN2'(g) in place
    const float inv = row_xhat<G>(x2h + rb, lane, eps, xhat);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      load4(g + rb + q * 128 + lane * 4, du[q]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        cs[0][q][t] += du[q][t] * xhat[q][t];
        cs[1][q][t] += du[q][t];
      }
    }
    ln_bwd_row<G>(du, xhat, s2, inv);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      store4(du2 + rb + c, du[q]);
      bool keep[4] = {true, true, true, true};
      if (dropout) row_keep4(drop, seed, row, c, keep);
      float dl[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        dl[t] = dropout ? (keep[t] ? du[q][t] * drop.keep_scale : 0.f) : du[q][t];
        cs[2][q][t] += dl[t];
      }
      store4(dlin2 + rb + c, dl);
    }
  }
  row_colsums<G>(red, cs, part);
}

// B4: LN1 backward from dx (f32; + dx_add where given: the split form's
// summed partial plus du2): dx_q = du1, dlin1 = K_a du1, xb =
// bf16(LN1(x1h)); partial sums of dx xhat, dx, dlin1
template <int G>
__global__ void __launch_bounds__(kRowThreads)
ln1_bwd_rows(const float* __restrict__ dx, const float* __restrict__ dx_add,
             const bf16* __restrict__ x1h,
             const float* __restrict__ s1, const float* __restrict__ g1, bf16* __restrict__ xb,
             bf16* __restrict__ dxq, bf16* __restrict__ dlin1, float* __restrict__ part,
             Drop drop, int M, float eps) {
  __shared__ __align__(16) float red[3 * G * 128];
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  const bool dropout = drop.seed != nullptr;
  const uint32_t seed = seed_of(drop);
  float cs[3][G][4] = {};
  for (int row = blockIdx.x * per + threadIdx.x / 32; row < M; row += gridDim.x * per) {
    const size_t rb = (size_t)row * (G * 128);
    float du[G][4], xhat[G][4];  // du: dx, then LN1'(dx) in place
    const float inv = row_xhat<G>(x1h + rb, lane, eps, xhat);
    ln_store<G>(xb + rb, xhat, s1, g1, lane);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      load4(dx + rb + q * 128 + lane * 4, du[q]);
      if (dx_add != nullptr) {
        float a[4];
        load4(dx_add + rb + q * 128 + lane * 4, a);
#pragma unroll
        for (int t = 0; t < 4; ++t) du[q][t] += a[t];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        cs[0][q][t] += du[q][t] * xhat[q][t];
        cs[1][q][t] += du[q][t];
      }
    }
    ln_bwd_row<G>(du, xhat, s1, inv);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = q * 128 + lane * 4;
      store4(dxq + rb + c, du[q]);
      bool keep[4] = {true, true, true, true};
      if (dropout) row_keep4(drop, seed, row, c, keep);
      float dl[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        dl[t] = dropout ? (keep[t] ? du[q][t] * drop.keep_scale : 0.f) : du[q][t];
        cs[2][q][t] += dl[t];
      }
      store4(dlin1 + rb + c, dl);
    }
  }
  row_colsums<G>(red, cs, part);
}

// the split forward's F2' / F5': xh = bf16(resid + K (sum + bias)) (the
// F1 / F4 epilogue on the summed partial), out = bf16(LN(xh)); the drawn
// mask to drop.mask_out
template <int G>
__global__ void __launch_bounds__(kRowThreads)
resid_ln_rows(const float* __restrict__ sum, const float* __restrict__ bias,
              const bf16* __restrict__ resid, const float* __restrict__ s,
              const float* __restrict__ g, bf16* __restrict__ xh, bf16* __restrict__ out,
              Drop drop, int M, float eps) {
  const int lane = threadIdx.x % 32, per = kRowThreads / 32;
  const bool dropout = drop.seed != nullptr;
  const uint32_t seed = seed_of(drop);
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
      bool keep[4] = {true, true, true, true};
      if (dropout) row_keep4(drop, seed, row, c, keep);
      if (drop.mask_out != nullptr) {
        uint32_t w = 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) w |= (uint32_t)keep[t] << (8 * t);
        *reinterpret_cast<uint32_t*>(drop.mask_out + rb + c) = w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float x = a[t] + b[t];
        if (dropout) x = keep[t] ? x * drop.keep_scale : 0.f;
        v[q][t] = round_bf16(r[t] + x);
      }
      store4(xh + rb + c, v[q]);
    }
    const gemm::RowStats st = gemm::row_stats<G>(v, eps);
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) v[q][t] = (v[q][t] - st.mu) * st.inv;
    ln_store<G>(out + rb, v, s, g, lane);
  }
}

// ---- B7: partials summed in a fixed order ------------------------------------
// dst[i] = sum over s < count of src[s * stride + i], i < n (n, stride and
// the pointers' offsets multiples of 4 floats)
struct SumJob {
  const float* src;
  float* dst;
  int n, count;
  long long stride;
};
constexpr int kMaxJobs = 10;
struct SumJobs {
  SumJob j[kMaxJobs];
  int n_jobs;
};

static __global__ void __launch_bounds__(256) sum_partials(const SumJobs jobs) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // a float4 of one job
#pragma unroll
  for (int k = 0; k < kMaxJobs; ++k) {
    if (k >= jobs.n_jobs) return;
    const SumJob& jb = jobs.j[k];
    const int units = jb.n / 4;
    if (idx < units) {
      const float4* src = reinterpret_cast<const float4*>(jb.src) + idx;
      float4 s = src[0];
#pragma unroll 8
      for (int c = 1; c < jb.count; ++c) {  // the loads issued ahead, the adds in order
        const float4 v = src[c * (jb.stride / 4)];
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      reinterpret_cast<float4*>(jb.dst)[idx] = s;
      return;
    }
    idx -= units;
  }
}

}  // namespace bt
}  // namespace vt

using namespace vt::bt;
using vt::bf16;

namespace {

// d the LayerNorm rows' width, a multiple of 128 up to 2,048 (768 on the
// main path); m any multiple of the narrow tile's 128 columns (a launch
// over an m that is no multiple of 256 takes narrow tiles)
bool widths_ok(int rows, int d, int m) {
  return vt::gemm::row_width_ok(d) && m > 0 && m % vt::g90::Narrow::kBN == 0 && rows > 0;
}

// the row passes' grid: a block per 8 rows, at most two blocks an SM
int row_grid(int rows) {
  const int per = kRowThreads / 32;
  return min((rows + per - 1) / per, 2 * 132);
}

// out = bf16(LN(x)) over [rows, d] (F2, F5, the split form's recompute)
cudaError_t launch_ln_fwd(const void* x, const void* s, const void* g, void* out, int rows, int d,
                          float eps, cudaStream_t st) {
  return vt::gemm::by_row_groups(d, [&](auto grp) {
    ln_fwd_rows<decltype(grp)::value><<<row_grid(rows), kRowThreads, 0, st>>>(
        (const bf16*)x, (const float*)s, (const float*)g, (bf16*)out, rows, eps);
    return cudaGetLastError();
  });
}

// a split form's share of a width: a multiple of the thin tile's 64 columns
// (a launch over a share that is no multiple of 128 takes thin tiles)
bool share_ok(int w) { return w > 0 && w % vt::g90::Thin::kBN == 0; }

// the split forms' widths: d the rows' (as widths_ok), m this rank's FFN share
bool tp_rows_ok(int rows, int d, int m) {
  return vt::gemm::row_width_ok(d) && share_ok(m) && rows > 0;
}

}  // namespace
