// Transformer FFN (eval): out = gelu(x W1^T + b1) W2^T + b2.
//
// Replaces: vitxtgqa_tpu/ops/pallas_ffn.py:fused_ffn (_ffn_kernel), the
// ViT's MLP (vitxtgqa_tpu/models/vit.py:ViTEncoderLayer._mlp).  x, W1, W2
// bf16 ([rows, d], [m, d], [d2, m]: nn.Linear layout), b1 and b2 f32,
// f32 accumulation; the gelu (exact erf, erff) is taken of the f32
// pre-activation and rounded to bf16 before the second product, as the
// Pallas kernel does (its erf is the Abramowitz-Stegun form because Mosaic
// has none); out bf16.
//
// What bounds it on the H100: at the ViT-L/16 extractor's chunk (64 frames
// x 197 tokens = 12,608 rows, d 1024, m 4096) the two products are
// 2 * rows * m * (d + d2) = 211.5 GFLOP against 68 MB of x, weights and
// out: ~3,100 FLOP per byte, far above the bf16 ridge (~295), so the
// tensor cores bound it (0.214 ms at 989 TFLOP/s).
//
// Design (first version): the TPU kernel keeps both weights and a
// [512, m] f32 intermediate in VMEM; an SM's 227 KB of shared memory holds
// neither (a [64, 1024] f32 output accumulator alone is 256 KB).  So two
// launches of block_gemm.cuh's 128 x 128 tile GEMM (nvcuda::wmma bf16,
// f32 accumulate; shared with the eval block, fused_block.cu): x W1^T with
// GeluEpi (+ b1, gelu, round to bf16) into h [rows, m] bf16 in device
// memory, then h W2^T with BiasEpi (+ b2).  h's
// round trip is 2 * rows * m * 2 bytes (206 MB at 12,608 rows, ~0.06 ms at
// 3.35 TB/s).  Keeping h on chip (a loop over m chunks into an f32 [tile,
// d2] accumulator) and moving the products to the wgmma body of
// gemm_sm90.cuh (the training block's, with its cp.async ring) are later
// work.
#include "block_gemm.cuh"

// x [rows, d], w1 [m, d], w2 [d2, m] bf16; b1 [m], b2 [d2] f32; scratch h
// [rows, m] bf16; out [rows, d2] bf16.  d and m multiples of 32, m and d2
// multiples of 128.
extern "C" int vt_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* h, void* out, int rows, int d, int m, int d2,
                            void* stream) {
  using namespace vt::gemm;
  using vt::bf16;
  if (rows <= 0 || d % GBK != 0 || m % GBN != 0 || d2 % GBN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto gelu_kernel = tile_gemm_kernel<GeluEpi>;
  auto bias_kernel = tile_gemm_kernel<BiasEpi>;
  cudaError_t err =
      cudaFuncSetAttribute(gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bias_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return (int)err;

  const int row_tiles = (rows + GBM - 1) / GBM;
  const GeluEpi gelu = {(const float*)b1, (bf16*)h, m};
  gelu_kernel<<<dim3(m / GBN, row_tiles, 1), NT, kTileSmem, st>>>(
      (const bf16*)x, (const bf16*)w1, rows, m, d, gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const BiasEpi bias = {(const float*)b2, (bf16*)out, d2};
  bias_kernel<<<dim3(d2 / GBN, row_tiles, 1), NT, kTileSmem, st>>>(
      (const bf16*)h, (const bf16*)w2, rows, d2, m, bias);
  return (int)cudaGetLastError();
}
