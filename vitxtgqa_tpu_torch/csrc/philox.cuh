// Philox4x32-10 dropout bits, the CUDA twin of vitxtgqa_tpu_torch/ops/dropout.py.
//
// The bits of element (i3, i2, i1, i0) of a mask are word i0 % 4 of
// Philox(counter = (i0 / 4, i1, i2, i3), key = (seed, stream)): a function
// of the element's coordinates only, so every kernel that regenerates a
// mask (forward, backward, remat recompute) draws the same one as the plain
// PyTorch version.  Keep where bits >= threshold (threshold = min(rate *
// 2^32, 2^32 - 1), computed by the caller), as the TPU kernels do.
#pragma once

#include <stdint.h>

namespace vt {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the four words of the group that holds elements i0 .. i0 + 3 (i0 % 4 == 0)
__device__ __forceinline__ uint4 philox_group(uint32_t seed, uint32_t stream, uint32_t i0,
                                              uint32_t i1, uint32_t i2, uint32_t i3) {
  return philox4x32_10(make_uint4(i0 >> 2, i1, i2, i3), seed, stream);
}

__device__ __forceinline__ uint32_t philox_word(uint4 w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// keep bit of one element
__device__ __forceinline__ bool philox_keep(uint32_t seed, uint32_t stream, uint32_t i0,
                                            uint32_t i1, uint32_t i2, uint32_t i3,
                                            uint32_t threshold) {
  return philox_word(philox_group(seed, stream, i0, i1, i2, i3), i0 & 3) >= threshold;
}

}  // namespace vt
