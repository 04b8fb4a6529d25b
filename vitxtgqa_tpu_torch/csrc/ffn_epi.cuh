// The gelu epilogue of an eval FFN's first product, shared by the ViT FFN
// (fused_ffn.cu, #13) and the eval block (fused_block.cu, #2 / #3):
// h = bf16(gelu_erf(acc + b1)), the exact-erf gelu of the f32
// pre-activation, as the Pallas kernels take it (pallas_ffn._ffn_kernel,
// _block_kernel).  The training block's gelu (block_train.cu GeluEpi)
// rounds the pre-activation to bf16 first, as its Pallas kernel does.
#pragma once

#include "gemm_sm90.cuh"
#include "row_ops.cuh"

namespace vt {
namespace ffn {

struct GeluBiasEpi {
  const float* bias;
  bf16* h;
  template <class T>
  __device__ void operator()(const T& t, int) const {
    g90::tile_rows(t, [&](int row, int col, float (&v)[8]) {
      float b[8];
      g90::load8(bias + col, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gemm::gelu_erf(v[e] + b[e]);
      *reinterpret_cast<uint4*>(h + (size_t)row * t.N + col) = g90::pack8(v);
    });
  }
};

}  // namespace ffn
}  // namespace vt
