// GEMM tiles of the post-attention block kernels, shared by the eval
// fused block (fused_block.cu) and the training block forward and
// backward (block_train.cu).
//
// Two kernel shapes, each a template over its operand layouts and its
// epilogue:
//  * row_gemm_kernel: a block owns RBM = 32 full rows of a 768-wide
//    output, C = A[32, K] B (nvcuda::wmma bf16, f32 accumulate), stages C
//    in shared memory and hands it to a row epilogue (LayerNorm forward or
//    backward: a warp per row, a lane on four consecutive columns in each
//    of six 128-column groups).
//  * tile_gemm_kernel: a 128 x 128 output tile per block, C = A B over a
//    range of K (a split of K accumulates with atomics), and an element
//    epilogue handed eight consecutive outputs of a row at a time.
// Operand layouts: A row-major [M, K], or "transposed" (kAT): stored
// [K, M] row-major, as for the weight gradients dW = X^T dY whose
// reduction runs over the rows; B either "nt" (W [N, K] row-major, the
// nn.Linear weight of an x W^T product) or "nn" (W [K, N] row-major, the
// same weight in the dx = dy W product of a backward).
//
// Loads are synchronous 16-byte copies into padded shared-memory tiles;
// cp.async/TMA pipelining and wgmma are later work.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace vt {
namespace gemm {

using namespace nvcuda;

constexpr int NT = 256;  // 8 warps

// ---- dropout of a [rows, 768] activation --------------------------------
// The Philox bits of element (row, col) of the [R, 768] mask (counter
// (col / 4, row, 0, 0), key (seed, stream): ops/dropout.py).  mask_out
// (nullable) receives the drawn mask.
struct Drop {
  const int64_t* seed;  // null: no dropout
  int8_t* mask_out;     // the drawn mask, or null
  uint32_t stream;
  uint32_t threshold;
  float keep_scale;     // 1 / (1 - rate)
};

__device__ __forceinline__ bool drop_on(const Drop& d) { return d.seed != nullptr; }

// keep flags of columns col .. col + 3 (col % 4 == 0) of one row
__device__ __forceinline__ void drop_keep4(const Drop& d, uint32_t seed, int row, int col, int n,
                                           bool keep[4]) {
  const uint4 w = philox_group(seed, d.stream, (uint32_t)col, (uint32_t)row, 0u, 0u);
  keep[0] = w.x >= d.threshold;
  keep[1] = w.y >= d.threshold;
  keep[2] = w.z >= d.threshold;
  keep[3] = w.w >= d.threshold;
  if (d.mask_out != nullptr) {
    const char4 m = make_char4(keep[0], keep[1], keep[2], keep[3]);
    *reinterpret_cast<char4*>(d.mask_out + (size_t)row * n + col) = m;
  }
}

__device__ __forceinline__ uint32_t drop_seed(const Drop& d) {
  return d.seed != nullptr ? (uint32_t)(*d.seed) : 0u;
}

// ---- small vector helpers -------------------------------------------------
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = __bfloat162float(b[t]);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  __align__(8) bf16 b[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) b[t] = __float2bfloat16(v[t]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(b);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

// d/dx gelu(x) = Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.0f + erff(x * 0.7071067811865476f)) +
         x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

// ---- the row GEMM ----------------------------------------------------------
constexpr int RN = 768;          // output width (the hidden size)
constexpr int RBM = 32;          // rows per block
constexpr int RBK = 32;          // K step
constexpr int RLDA = RBK + 8;    // bf16 row stride of the A tile
constexpr int RLDW_NT = RBK + 8; // bf16 row stride of an nt W tile [768][32]
constexpr int RLDW_NN = RN + 8;  // bf16 row stride of an nn W tile [32][768]
constexpr int RLDC = RN + 4;     // f32 row stride of the staged output
constexpr int RWN = RN / 4;      // columns per warp (warps: 2 along M x 4 along N)
constexpr int RFN = RWN / 16;    // fragments per warp
constexpr int RGROUPS = RN / 128;  // a lane's four-column groups per row
constexpr int kRowCs = RBM * RLDC * 4;
constexpr int kRowRed = 3 * RN * 4;  // column sums of a row epilogue

// dynamic shared memory of row_gemm_kernel<., Epi>: the staged output, and
// the column-sum scratch only for an epilogue that keeps column sums
template <class Epi>
constexpr int row_smem() {
  return kRowCs + (Epi::kColSum ? kRowRed : 0);
}

// C[32, 768] staged in Cs, then epi(Cs, m0, M, red) on every thread (red:
// zeroed [3 * 768] f32 scratch if Epi::kColSum, else null).
template <bool kNN, class Epi>
__global__ void __launch_bounds__(NT)
row_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int K, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = As + RBM * RLDA;
  float* Cs = reinterpret_cast<float*>(smem_raw);  // reused after the K loop
  float* red = Epi::kColSum ? reinterpret_cast<float*>(smem_raw + kRowCs) : nullptr;

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * RBM;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  using WLayout = typename std::conditional<kNN, wmma::row_major, wmma::col_major>::type;

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
    if (kNN) {  // W [K, 768]: rows k0 .. k0 + 31
      for (int i = tid; i < RBK * (RN / 8); i += NT) {
        const int r = i / (RN / 8), c = (i % (RN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Ws[r * RLDW_NN + c]) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * RN + c);
      }
    } else {  // W [768, K]: columns k0 .. k0 + 31 of every row
      for (int i = tid; i < RN * (RBK / 8); i += NT) {
        const int r = i / (RBK / 8), c = (i % (RBK / 8)) * 8;
        *reinterpret_cast<uint4*>(&Ws[r * RLDW_NT + c]) =
            *reinterpret_cast<const uint4*>(W + (size_t)r * K + k0 + c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[(wm * 16) * RLDA + kk * 16], RLDA);
#pragma unroll
      for (int j = 0; j < RFN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, WLayout> wb;
        const int n = wn * RWN + j * 16;
        if (kNN)
          wmma::load_matrix_sync(wb, &Ws[(kk * 16) * RLDW_NN + n], RLDW_NN);
        else
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
  if (Epi::kColSum)
    for (int i = tid; i < 3 * RN; i += NT) red[i] = 0.f;
  __syncthreads();
  epi(Cs, m0, M, red);
}

// flush the block's column sums (red[n * RN + c] for n < count) into
// global f32 accumulators with one atomic add per column
__device__ __forceinline__ void flush_colsums(const float* red, float* const* outs, int count) {
  __syncthreads();
  for (int i = threadIdx.x; i < count * RN; i += NT) atomicAdd(outs[i / RN] + i % RN, red[i]);
}

// LayerNorm statistics of one row held as RGROUPS x 4 values per lane
struct RowStats {
  float mu, inv;
};

__device__ __forceinline__ RowStats row_stats(const float x[RGROUPS][4], float eps) {
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < RGROUPS; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) s += x[g][t];
  const float mu = warp_sum(s) / RN;
  float v = 0.f;
#pragma unroll
  for (int g = 0; g < RGROUPS; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float d = x[g][t] - mu;
      v += d * d;
    }
  return {mu, rsqrtf(warp_sum(v) / RN + eps)};
}

// ---- LayerNorm forward epilogue ---------------------------------------------
// u = resid + dropout(C + bias); out = LN(u).  Eval fused block: resid_f32
// or resid_bf16, out_f32 and / or out_bf16, optional tanh_res (out =
// bf16(tanh_res + tanh(bf16(LN)))).  Training (out_pre set): u is rounded
// to bf16 and stored (the block's x1h / x2h residual), and the LayerNorm
// is taken of the rounded value, so the backward recomputes it exactly.
struct LnFwdEpi {
  static constexpr bool kColSum = false;
  const float* bias;
  const bf16* resid_bf16;
  const float* resid_f32;
  const float* gamma;
  const float* beta;
  const bf16* tanh_res;
  float* out_f32;
  bf16* out_bf16;
  bf16* out_pre;
  Drop drop;
  float eps;

  __device__ void operator()(const float* Cs, int m0, int M, float*) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool dropout = drop_on(drop);
    const uint32_t seed = drop_seed(drop);
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
        bool keep[4] = {true, true, true, true};
        if (dropout) drop_keep4(drop, seed, row, c, RN, keep);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float a = cv[t] + bv[t];
          if (dropout) a = keep[t] ? a * drop.keep_scale : 0.f;
          x[g][t] = rv[t] + a;
          if (out_pre != nullptr) x[g][t] = round_bf16(x[g][t]);
        }
        if (out_pre != nullptr) store4(out_pre + gi, x[g]);
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
constexpr int GLDT = GBM + 8;  // bf16 row stride of a [32][128] tile
constexpr int GLDE = 16 + 4;   // f32 row stride of a warp's epilogue fragment
constexpr int GWM = GBM / 4;   // warps: 4 along M x 2 along N -> 32 x 64 each
constexpr int GWN = GBN / 2;
constexpr int kTileA = GBM * GLD * 2;  // >= GBK * GLDT * 2
constexpr int kTileW = GBN * GLD * 2;  // >= GBK * GLDT * 2
constexpr int kTileSmem = kTileA + kTileW + (NT / 32) * 16 * GLDE * 4 + GBN * 4;

// C[M, N] = A B over k in [blockIdx.z * k_chunk, min(K, ...)); the element
// epilogue sees (row, col, eight consecutive outputs, the block's f32
// column-sum scratch [128] at local column col - n0); column sums, when
// the epilogue keeps them (Epi::kColSum), go out through
// epi.flush(sum, column), one call per column of the tile.
template <bool kAT, bool kNN, class Epi>
__global__ void __launch_bounds__(NT)
tile_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N, int K,
                 int k_chunk, Epi epi) {
  static_assert(kNN || !kAT, "a reduction over the rows takes W as [K, N]");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw + kTileA);
  float* Es = reinterpret_cast<float*>(smem_raw + kTileA + kTileW);
  float* colsum = Es + (NT / 32) * 16 * GLDE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  using ALayout = typename std::conditional<kAT, wmma::col_major, wmma::row_major>::type;
  using WLayout = typename std::conditional<kNN, wmma::row_major, wmma::col_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[GWM / 16][GWN / 16];
#pragma unroll
  for (int i = 0; i < GWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < GWN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  if (Epi::kColSum && tid < GBN) colsum[tid] = 0.f;

  // K is a multiple of GBK unless the rows are the reduction (kAT: the
  // weight gradients over R rows), so only then is the K tail masked
  for (int k0 = kb; k0 < ke; k0 += GBK) {
    if (kAT) {  // A stored [K, M]: rows k0 .. k0 + 31, columns m0 .. m0 + 127
      for (int i = tid; i < GBK * (GBM / 8); i += NT) {
        const int r = i / (GBM / 8), c = (i % (GBM / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < ke && m0 + c < M)
          val = *reinterpret_cast<const uint4*>(A + (size_t)(k0 + r) * M + m0 + c);
        *reinterpret_cast<uint4*>(&As[r * GLDT + c]) = val;
      }
    } else {  // A [M, K]: rows m0 .. m0 + 127, columns k0 .. k0 + 31
      for (int i = tid; i < GBM * (GBK / 8); i += NT) {
        const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
        uint4 val = zero;
        if (m0 + r < M) val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
        *reinterpret_cast<uint4*>(&As[r * GLD + c]) = val;
      }
    }
    if (kNN) {  // W [K, N]: rows k0 .. k0 + 31, columns n0 .. n0 + 127
      for (int i = tid; i < GBK * (GBN / 8); i += NT) {
        const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
        uint4 val = zero;
        if (!kAT || k0 + r < ke)
          val = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
        *reinterpret_cast<uint4*>(&Ws[r * GLDT + c]) = val;
      }
    } else {  // W [N, K]: rows n0 .. n0 + 127, columns k0 .. k0 + 31
      for (int i = tid; i < GBN * (GBK / 8); i += NT) {
        const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
        *reinterpret_cast<uint4*>(&Ws[r * GLD + c]) =
            *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[GWM / 16];
#pragma unroll
      for (int i = 0; i < GWM / 16; ++i) {
        const int m = wm * GWM + i * 16;
        if (kAT)
          wmma::load_matrix_sync(a[i], &As[(kk * 16) * GLDT + m], GLDT);
        else
          wmma::load_matrix_sync(a[i], &As[m * GLD + kk * 16], GLD);
      }
#pragma unroll
      for (int j = 0; j < GWN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, WLayout> wb;
        const int n = wn * GWN + j * 16;
        if (kNN)
          wmma::load_matrix_sync(wb, &Ws[(kk * 16) * GLDT + n], GLDT);
        else
          wmma::load_matrix_sync(wb, &Ws[n * GLD + kk * 16], GLD);
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
        epi(row, col, vals, colsum + (col - n0));
      }
      __syncwarp();
    }
  }
  if (Epi::kColSum) {
    __syncthreads();
    if (tid < GBN) epi.flush(colsum[tid], n0 + tid);
  }
}

// gelu epilogue of x W1^T + b1: eval h = bf16(gelu(acc + b1)); training
// (pre set) pre = bf16(acc + b1) stored, h = bf16(gelu(pre))
struct GeluEpi {
  static constexpr bool kColSum = false;
  const float* bias;
  bf16* pre;
  bf16* h;
  int ld;
  __device__ void operator()(int row, int col, const float v[8], float*) const {
    __align__(16) bf16 hv[8], pv[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float a = v[t] + bias[col + t];
      if (pre != nullptr) {
        pv[t] = __float2bfloat16(a);
        a = __bfloat162float(pv[t]);
      }
      hv[t] = __float2bfloat16(gelu_erf(a));
    }
    const size_t g = (size_t)row * ld + col;
    *reinterpret_cast<uint4*>(h + g) = *reinterpret_cast<const uint4*>(hv);
    if (pre != nullptr) *reinterpret_cast<uint4*>(pre + g) = *reinterpret_cast<const uint4*>(pv);
  }
  __device__ void flush(float, int) const {}
};

// bias epilogue of h W2^T + b2 (the fused FFN's second product): out =
// bf16(acc + b2)
struct BiasEpi {
  static constexpr bool kColSum = false;
  const float* bias;
  bf16* out;
  int ld;
  __device__ void operator()(int row, int col, const float v[8], float*) const {
    __align__(16) bf16 ov[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) ov[t] = __float2bfloat16(v[t] + bias[col + t]);
    *reinterpret_cast<uint4*>(out + (size_t)row * ld + col) = *reinterpret_cast<const uint4*>(ov);
  }
  __device__ void flush(float, int) const {}
};

}  // namespace gemm
}  // namespace vt
