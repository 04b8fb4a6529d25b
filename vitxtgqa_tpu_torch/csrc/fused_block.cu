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
// LayerNorm scale/shift in f32.  The gelu is the exact-erf form (erff); the
// Pallas kernel approximated erf with A&S 7.1.26 because Mosaic has none.
//
// What bounds it on the H100: at the serving shape (rows = 8*1152 = 9216,
// D = 768, M = 3072) the three products are 2*rows*(D*D + 2*D*M) = 98 GFLOP
// against ~16 MB of weights and 3*rows*D*2 = 42 MB of activations — far
// above the bf16 ridge, so the tensor cores bound it.
//
// Design (first version): three launches of this file's own kernels.
//  1. row_gemm_ln: a block owns 32 full rows of the 768-wide output, runs
//     ctx Wo^T with nvcuda::wmma bf16 (f32 accumulate), then adds bias and
//     residual and applies LayerNorm in the epilogue from shared memory;
//     writes x in f32 (kept for the second residual) and in bf16.
//  2. gemm_gelu: a 128x128-tile GEMM for x W1^T whose epilogue adds b1 and
//     applies the erf gelu, writing h [rows, 3072] bf16 to device memory.
//  3. row_gemm_ln again for h W2^T + b2 + x, LayerNorm, and the optional
//     res + tanh(bf16(.)) epilogue.
// The gelu intermediate does round-trip device memory (2 * 56.6 MB at the
// serving shape); keeping it on-chip (chunk over M with an f32 [tile, 768]
// accumulator) is the next step, as are cp.async/TMA pipelining and wgmma.
#include "common.cuh"

namespace vt {
namespace block {

using namespace nvcuda;

constexpr int NT = 256;  // 8 warps

// ---- row_gemm_ln: C[BM, N] = A[BM, K] W[N, K]^T, then the row epilogue ----
constexpr int RN = 768;          // output width (the hidden size)
constexpr int RBM = 32;          // rows per block
constexpr int RBK = 32;          // K step
constexpr int RLDA = RBK + 8;    // bf16 row stride of the A / W tiles
constexpr int RLDC = RN + 4;     // f32 row stride of the staged output
constexpr int RWN = RN / 4;      // columns per warp (warps: 2 along M x 4 along N)
constexpr int RFN = RWN / 16;    // fragments per warp
constexpr int kRowSmem =
    (RBM * RLDC * 4) > ((RBM + RN) * RLDA * 2) ? (RBM * RLDC * 4) : ((RBM + RN) * RLDA * 2);

// residual: resid_bf16 (bf16) or resid_f32 (f32), exactly one non-null.
// Outputs: out_f32 (nullable) = LN(...); out_bf16 = bf16(LN(...)), or with
// tanh_res non-null, bf16(tanh_res + tanh(bf16(LN(...)))).
__global__ void __launch_bounds__(NT)
row_gemm_ln_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                   const float* __restrict__ bias, const bf16* __restrict__ resid_bf16,
                   const float* __restrict__ resid_f32, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ tanh_res,
                   float* __restrict__ out_f32, bf16* __restrict__ out_bf16, int M, int K,
                   float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = As + RBM * RLDA;
  float* Cs = reinterpret_cast<float*>(smem_raw);  // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
    for (int i = tid; i < RN * (RBK / 8); i += NT) {
      const int r = i / (RBK / 8), c = (i % (RBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Ws[r * RLDA + c]) =
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
        wmma::load_matrix_sync(wb, &Ws[(wn * RWN + j * 16) * RLDA + kk * 16], RLDA);
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

  // row epilogue: each warp owns RBM / 8 rows; lane owns columns lane + 32 t
  constexpr int PER = RN / 32;
  for (int r = warp; r < RBM; r += NT / 32) {
    const int row = m0 + r;
    if (row >= M) continue;
    float x[PER];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int c = lane + 32 * t;
      const size_t g = (size_t)row * RN + c;
      const float res = resid_f32 ? resid_f32[g] : __bfloat162float(resid_bf16[g]);
      x[t] = res + (Cs[r * RLDC + c] + bias[c]);
      s += x[t];
    }
    const float mu = warp_sum(s) / RN;
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const float d = x[t] - mu;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / RN + eps);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int c = lane + 32 * t;
      const size_t g = (size_t)row * RN + c;
      const float y = (x[t] - mu) * inv * gamma[c] + beta[c];
      if (out_f32) out_f32[g] = y;
      if (tanh_res) {
        const float th = tanhf(round_bf16(y));
        out_bf16[g] = __float2bfloat16(__bfloat162float(tanh_res[g]) + th);
      } else {
        out_bf16[g] = __float2bfloat16(y);
      }
    }
  }
}

// ---- gemm_gelu: H[M, N] = gelu(A[M, K] W[N, K]^T + b), bf16 out ----------
constexpr int GBM = 128, GBN = 128, GBK = 32;
constexpr int GLD = GBK + 8;   // bf16 row stride of the A / W tiles
constexpr int GLDE = 16 + 4;   // f32 row stride of a warp's epilogue fragment
constexpr int GWM = GBM / 4;   // warps: 4 along M x 2 along N -> 32 x 64 each
constexpr int GWN = GBN / 2;
constexpr int kGemmSmem = (GBM + GBN) * GLD * 2 + (NT / 32) * 16 * GLDE * 4;

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

__global__ void __launch_bounds__(NT)
gemm_gelu_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, bf16* __restrict__ H, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = As + GBM * GLD;
  float* Es = reinterpret_cast<float*>(Ws + GBN * GLD);

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
    for (int i = tid; i < GBM * (GBK / 8); i += NT) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      uint4 val = zero;
      if (m0 + r < M) val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&As[r * GLD + c]) = val;
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

  // epilogue through a warp-private 16x16 staging tile: lane writes 8
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
        __align__(16) bf16 vals[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) vals[t] = __float2bfloat16(gelu_erf(E[er * GLDE + ec + t] + bias[col + t]));
        *reinterpret_cast<uint4*>(H + (size_t)row * N + col) = *reinterpret_cast<const uint4*>(vals);
      }
      __syncwarp();
    }
  }
}

}  // namespace block
}  // namespace vt

// x_q, ctx, res: [rows, d] bf16 (res nullable: plain block without the tanh
// epilogue); wo [d, d], w1 [m, d], w2 [d, m] bf16 in nn.Linear layout;
// bo, s1, g1, b1, b2, s2, g2 f32.  Scratch from the caller: x32 [rows, d]
// f32, xb [rows, d] bf16, h [rows, m] bf16.  out [rows, d] bf16.
extern "C" int vt_fused_block(const void* x_q, const void* ctx, const void* wo, const void* bo,
                              const void* s1, const void* g1, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* s2, const void* g2,
                              const void* res, void* x32, void* xb, void* h, void* out, int rows,
                              int d, int m, float eps, void* stream) {
  using namespace vt::block;
  using vt::bf16;
  if (d != RN || m % GBN != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(row_gemm_ln_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gemm_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGemmSmem);
  if (err != cudaSuccess) return (int)err;

  const int row_blocks = (rows + RBM - 1) / RBM;
  row_gemm_ln_kernel<<<row_blocks, NT, kRowSmem, st>>>(
      (const bf16*)ctx, (const bf16*)wo, (const float*)bo, (const bf16*)x_q, nullptr,
      (const float*)s1, (const float*)g1, nullptr, (float*)x32, (bf16*)xb, rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 ggrid(m / GBN, (rows + GBM - 1) / GBM);
  gemm_gelu_kernel<<<ggrid, NT, kGemmSmem, st>>>((const bf16*)xb, (const bf16*)w1,
                                                  (const float*)b1, (bf16*)h, rows, m, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  row_gemm_ln_kernel<<<row_blocks, NT, kRowSmem, st>>>(
      (const bf16*)h, (const bf16*)w2, (const float*)b2, nullptr, (const float*)x32,
      (const float*)s2, (const float*)g2, (const bf16*)res, nullptr, (bf16*)out, rows, m, eps);
  return (int)cudaGetLastError();
}
