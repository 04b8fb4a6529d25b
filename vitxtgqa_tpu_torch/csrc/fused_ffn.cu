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
// Design: the TPU kernel keeps both weights and a [512, m] f32
// intermediate in VMEM; an SM's 227 KB of shared memory holds neither (a
// [64, 1024] f32 output accumulator alone is 256 KB).  So two launches of
// gemm_sm90.cuh's wgmma body (128-row tiles on two warpgroups, a cp.async
// ring; 256 columns, or 128 where a width is no multiple of 256 or the
// wide tiles would not fill the card): x W1^T with ffn_epi.cuh's
// GeluBiasEpi (+ b1, gelu, round to bf16) into h [rows, m] bf16 in device
// memory, then h W2^T with BiasEpi (+ b2).  h's round trip is 2 * rows * m
// * 2 bytes (206 MB at 12,608 rows, ~0.06 ms at 3.35 TB/s).
#include "ffn_epi.cuh"

namespace vt {
namespace ffn {

// out = bf16(acc + bias)
struct BiasEpi {
  const float* bias;
  bf16* out;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      float b[8];
      g90::load8(bias + col, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += b[e];
      *reinterpret_cast<uint4*>(out + (size_t)row * t.N + col) = g90::pack8(v);
    });
  }
};

}  // namespace ffn
}  // namespace vt

// x [rows, d], w1 [m, d], w2 [d2, m] bf16; b1 [m], b2 [d2] f32; scratch h
// [rows, m] bf16; out [rows, d2] bf16.  d a multiple of 64 (the K step),
// m and d2 multiples of 128 (the narrow tile).
extern "C" int vt_fused_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* h, void* out, int rows, int d, int m, int d2,
                            void* stream) {
  using namespace vt;
  constexpr int kN = g90::Narrow::kBN;
  if (rows <= 0 || d <= 0 || d % g90::kBK != 0 || m % kN != 0 || d2 % kN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  VT_TRY((g90::launch_gemm<false, false>(g90::one((const bf16*)x, d, (const bf16*)w1, d, rows, m, d),
                                         ffn::GeluBiasEpi{(const float*)b1, (bf16*)h}, st)));
  return (int)g90::launch_gemm<false, false>(
      g90::one((const bf16*)h, m, (const bf16*)w2, m, rows, d2, m),
      ffn::BiasEpi{(const float*)b2, (bf16*)out}, st);
}
