// GEMM tiles of the eval post-attention block (fused_block.cu, #2 / #3)
// and the ViT FFN (fused_ffn.cu, #13); the W8A8 block (fused_block_w8a8.cu,
// #8) shares the row helpers (row_ops.cuh).  The training block (#9a /
// #9b, block_train.cu) runs on gemm_sm90.cuh's wgmma body instead, which
// these may take up later.
//
// Two kernel shapes, each a template over its epilogue:
//  * row_gemm_kernel: a block owns RBM = 32 full rows of a 768-wide
//    output, C = A[32, K] W^T (nvcuda::wmma bf16, f32 accumulate, W the
//    nn.Linear weight [768, K]), stages C in shared memory and hands it to
//    a row epilogue (the LayerNorm forward: a warp per row, a lane on four
//    consecutive columns in each of six 128-column groups).
//  * tile_gemm_kernel: a 128 x 128 output tile per block, C = A W^T (A
//    [M, K], W [N, K] row-major), and an element epilogue handed eight
//    consecutive outputs of a row at a time.
//
// Loads are synchronous 16-byte copies into padded shared-memory tiles;
// cp.async pipelining and wgmma (gemm_sm90.cuh) are later work here.
#pragma once

#include "common.cuh"
#include "row_ops.cuh"

namespace vt {
namespace gemm {

using namespace nvcuda;

constexpr int NT = 256;  // 8 warps

// ---- the row GEMM ----------------------------------------------------------
constexpr int RBM = 32;          // rows per block
constexpr int RBK = 32;          // K step
constexpr int RLDA = RBK + 8;    // bf16 row stride of the A tile
constexpr int RLDW_NT = RBK + 8; // bf16 row stride of a W tile [768][32]
constexpr int RLDC = RN + 4;     // f32 row stride of the staged output
constexpr int RWN = RN / 4;      // columns per warp (warps: 2 along M x 4 along N)
constexpr int RFN = RWN / 16;    // fragments per warp
constexpr int kRowSmem = RBM * RLDC * 4;  // dynamic shared memory: the staged output

// C[32, 768] staged in Cs, then epi(Cs, m0, M) on every thread
template <class Epi>
__global__ void __launch_bounds__(NT)
row_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = As + RBM * RLDA;
  float* Cs = reinterpret_cast<float*>(smem_raw);  // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * RBM;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RFN];
#pragma unroll
  for (int j = 0; j < RFN; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < K; k0 += RBK) {
    for (int i = tid; i < RBM * (RBK / 8); i += NT) {
      const int r = i / (RBK / 8), c = (i % (RBK / 8)) * 8;
      uint4 val = zero;
      if (m0 + r < M) val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&As[r * RLDA + c]) = val;
    }
    for (int i = tid; i < RN * (RBK / 8); i += NT) {  // W [768, K]: columns k0 .. k0 + 31
      const int r = i / (RBK / 8), c = (i % (RBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Ws[r * RLDW_NT + c]) =
          *reinterpret_cast<const uint4*>(W + (size_t)r * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[(wm * 16) * RLDA + kk * 16], RLDA);
#pragma unroll
      for (int j = 0; j < RFN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> wb;
        const int n = wn * RWN + j * 16;
        wmma::load_matrix_sync(wb, &Ws[n * RLDW_NT + kk * 16], RLDW_NT);
        wmma::mma_sync(acc[j], a, wb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RFN; ++j)
    wmma::store_matrix_sync(&Cs[(wm * 16) * RLDC + wn * RWN + j * 16], acc[j], RLDC,
                            wmma::mem_row_major);
  __syncthreads();
  epi(Cs, m0, M);
}

// ---- LayerNorm forward epilogue ---------------------------------------------
// u = resid + C + bias; out = LN(u), with resid_f32 or resid_bf16, out_f32
// and / or out_bf16, optional tanh_res (out = bf16(tanh_res +
// tanh(bf16(LN)))).
struct LnFwdEpi {
  const float* bias;
  const bf16* resid_bf16;
  const float* resid_f32;
  const float* gamma;
  const float* beta;
  const bf16* tanh_res;
  float* out_f32;
  bf16* out_bf16;
  float eps;

  __device__ void operator()(const float* Cs, int m0, int M) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < RBM; r += NT / 32) {
      const int row = m0 + r;
      if (row >= M) continue;
      float x[RGROUPS][4];
#pragma unroll
      for (int g = 0; g < RGROUPS; ++g) {
        const int c = g * 128 + lane * 4;
        const size_t gi = (size_t)row * RN + c;
        float cv[4], bv[4], rv[4];
        load4(&Cs[r * RLDC + c], cv);
        load4(bias + c, bv);
        if (resid_f32 != nullptr) load4(resid_f32 + gi, rv);
        else load4(resid_bf16 + gi, rv);
#pragma unroll
        for (int t = 0; t < 4; ++t) x[g][t] = rv[t] + (cv[t] + bv[t]);
      }
      const RowStats st = row_stats(x, eps);
#pragma unroll
      for (int g = 0; g < RGROUPS; ++g) {
        const int c = g * 128 + lane * 4;
        const size_t gi = (size_t)row * RN + c;
        float gm[4], bt[4], y[4];
        load4(gamma + c, gm);
        load4(beta + c, bt);
#pragma unroll
        for (int t = 0; t < 4; ++t) y[t] = (x[g][t] - st.mu) * st.inv * gm[t] + bt[t];
        if (out_f32 != nullptr) store4(out_f32 + gi, y);
        if (tanh_res != nullptr) {
          float tr[4];
          load4(tanh_res + gi, tr);
#pragma unroll
          for (int t = 0; t < 4; ++t) y[t] = tr[t] + tanhf(round_bf16(y[t]));
        }
        if (out_bf16 != nullptr) store4(out_bf16 + gi, y);
      }
    }
  }
};

// ---- the tile GEMM ---------------------------------------------------------
constexpr int GBM = 128, GBN = 128, GBK = 32;
constexpr int GLD = GBK + 8;   // bf16 row stride of a [128][32] tile
constexpr int GLDE = 16 + 4;   // f32 row stride of a warp's epilogue fragment
constexpr int GWM = GBM / 4;   // warps: 4 along M x 2 along N -> 32 x 64 each
constexpr int GWN = GBN / 2;
constexpr int kTileA = GBM * GLD * 2;
constexpr int kTileW = GBN * GLD * 2;
constexpr int kTileSmem = kTileA + kTileW + (NT / 32) * 16 * GLDE * 4;

// C[M, N] = A W^T (K a multiple of GBK); the element epilogue sees (row,
// col, eight consecutive outputs)
template <class Epi>
__global__ void __launch_bounds__(NT)
tile_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N, int K,
                 Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw + kTileA);
  float* Es = reinterpret_cast<float*>(smem_raw + kTileA + kTileW);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[GWM / 16][GWN / 16];
#pragma unroll
  for (int i = 0; i < GWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < GWN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GBK) {
    // A [M, K]: rows m0 .. m0 + 127, columns k0 .. k0 + 31
    for (int i = tid; i < GBM * (GBK / 8); i += NT) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      uint4 val = zero;
      if (m0 + r < M) val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&As[r * GLD + c]) = val;
    }
    // W [N, K]: rows n0 .. n0 + 127, columns k0 .. k0 + 31
    for (int i = tid; i < GBN * (GBK / 8); i += NT) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Ws[r * GLD + c]) =
          *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[GWM / 16];
#pragma unroll
      for (int i = 0; i < GWM / 16; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * GWM + i * 16) * GLD + kk * 16], GLD);
#pragma unroll
      for (int j = 0; j < GWN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> wb;
        wmma::load_matrix_sync(wb, &Ws[(wn * GWN + j * 16) * GLD + kk * 16], GLD);
#pragma unroll
        for (int i = 0; i < GWM / 16; ++i) wmma::mma_sync(acc[i][j], a[i], wb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue through a warp-private 16x16 staging tile: lane handles 8
  // consecutive outputs of row lane / 2
  float* E = Es + warp * 16 * GLDE;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < GWM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < GWN / 16; ++j) {
      wmma::store_matrix_sync(E, acc[i][j], GLDE, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * GWM + i * 16 + er;
      const int col = n0 + wn * GWN + j * 16 + ec;
      if (row < M) {
        float vals[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) vals[t] = E[er * GLDE + ec + t];
        epi(row, col, vals);
      }
      __syncwarp();
    }
  }
}

// gelu epilogue of x W1^T + b1: h = bf16(gelu(acc + b1))
struct GeluEpi {
  const float* bias;
  bf16* h;
  int ld;
  __device__ void operator()(int row, int col, const float v[8]) const {
    __align__(16) bf16 hv[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) hv[t] = __float2bfloat16(gelu_erf(v[t] + bias[col + t]));
    *reinterpret_cast<uint4*>(h + (size_t)row * ld + col) = *reinterpret_cast<const uint4*>(hv);
  }
};

// bias epilogue of h W2^T + b2 (the fused FFN's second product): out =
// bf16(acc + b2)
struct BiasEpi {
  const float* bias;
  bf16* out;
  int ld;
  __device__ void operator()(int row, int col, const float v[8]) const {
    __align__(16) bf16 ov[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) ov[t] = __float2bfloat16(v[t] + bias[col + t]);
    *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) = *reinterpret_cast<const uint4*>(ov);
  }
};

}  // namespace gemm
}  // namespace vt
