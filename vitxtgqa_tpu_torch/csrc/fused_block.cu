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
// Design (first version): three launches of the GEMM tiles in
// block_gemm.cuh (shared with the ViT FFN, fused_ffn.cu).
//  1. row_gemm_kernel: a block owns 32 full rows of the 768-wide output,
//     runs ctx Wo^T with nvcuda::wmma bf16 (f32 accumulate), then adds bias
//     and residual and applies LayerNorm in the epilogue from shared
//     memory; writes x in f32 (kept for the second residual) and in bf16.
//  2. tile_gemm_kernel: a 128x128-tile GEMM for x W1^T whose epilogue adds
//     b1 and applies the erf gelu, writing h [rows, 3072] bf16.
//  3. row_gemm_kernel again for h W2^T + b2 + x, LayerNorm, and the
//     optional res + tanh(bf16(.)) epilogue.
// The gelu intermediate does round-trip device memory (2 * 56.6 MB at the
// serving shape); keeping it on-chip (chunk over M with an f32 [tile, 768]
// accumulator) is the next step, as is moving the products to the wgmma
// body of gemm_sm90.cuh (the training block's).
#include "block_gemm.cuh"

// x_q, ctx, res: [rows, d] bf16 (res nullable: plain block without the tanh
// epilogue); wo [d, d], w1 [m, d], w2 [d, m] bf16 in nn.Linear layout;
// bo, s1, g1, b1, b2, s2, g2 f32.  Scratch from the caller: x32 [rows, d]
// f32, xb [rows, d] bf16, h [rows, m] bf16.  out [rows, d] bf16.
extern "C" int vt_fused_block(const void* x_q, const void* ctx, const void* wo, const void* bo,
                              const void* s1, const void* g1, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* s2, const void* g2,
                              const void* res, void* x32, void* xb, void* h, void* out, int rows,
                              int d, int m, float eps, void* stream) {
  using namespace vt::gemm;
  using vt::bf16;
  if (d != RN || m % GBN != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto row_kernel = row_gemm_kernel<LnFwdEpi>;
  auto gelu_kernel = tile_gemm_kernel<GeluEpi>;
  constexpr int row_bytes = kRowSmem;
  cudaError_t err =
      cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, row_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return (int)err;

  const int row_blocks = (rows + RBM - 1) / RBM;
  LnFwdEpi ln1 = {(const float*)bo, (const bf16*)x_q, nullptr, (const float*)s1,
                  (const float*)g1, nullptr, (float*)x32, (bf16*)xb, eps};
  row_kernel<<<row_blocks, NT, row_bytes, st>>>((const bf16*)ctx, (const bf16*)wo, rows, d, ln1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 ggrid(m / GBN, (rows + GBM - 1) / GBM, 1);
  GeluEpi gelu = {(const float*)b1, (bf16*)h, m};
  gelu_kernel<<<ggrid, NT, kTileSmem, st>>>((const bf16*)xb, (const bf16*)w1, rows, m, d, gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  LnFwdEpi ln2 = {(const float*)b2, nullptr, (const float*)x32, (const float*)s2,
                  (const float*)g2, (const bf16*)res, nullptr, (bf16*)out, eps};
  row_kernel<<<row_blocks, NT, row_bytes, st>>>((const bf16*)h, (const bf16*)w2, rows, m, ln2);
  return (int)cudaGetLastError();
}
