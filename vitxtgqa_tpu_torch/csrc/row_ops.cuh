// Row helpers shared by the post-attention block kernels' row passes: the
// eval block (fused_block.cu), the W8A8 block (fused_block_w8a8.cu, its
// LayerNorms and x's quantization) and the training block (block_train.cu):
// four-wide vector loads and stores, the erf gelu and its derivative, and
// the LayerNorm of a row of G x 128 columns held by one warp in registers
// (a lane on four consecutive columns in each of G 128-column groups; the
// main path's 768 is G = 6).  Every row pass is a template on G, and its
// entry point picks the instantiation of the hidden width (by_row_groups):
// any multiple of 128 up to kMaxRowGroups x 128 = 2,048.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace vt {
namespace gemm {

constexpr int kMaxRowGroups = 16;  // rows up to 2,048 wide

// f(std::integral_constant<int, G>{}) with G = d / 128, d a multiple of 128
// up to kMaxRowGroups x 128; an invalid value for any other d
template <class F>
inline cudaError_t by_row_groups(int d, F&& f) {
  if (d <= 0 || d % 128 != 0 || d > 128 * kMaxRowGroups) return cudaErrorInvalidValue;
  switch (d / 128) {
#define VT_ROW_GROUPS(g) \
  case g:                \
    return f(std::integral_constant<int, g>{});
    VT_ROW_GROUPS(1) VT_ROW_GROUPS(2) VT_ROW_GROUPS(3) VT_ROW_GROUPS(4)
    VT_ROW_GROUPS(5) VT_ROW_GROUPS(6) VT_ROW_GROUPS(7) VT_ROW_GROUPS(8)
    VT_ROW_GROUPS(9) VT_ROW_GROUPS(10) VT_ROW_GROUPS(11) VT_ROW_GROUPS(12)
    VT_ROW_GROUPS(13) VT_ROW_GROUPS(14) VT_ROW_GROUPS(15) VT_ROW_GROUPS(16)
#undef VT_ROW_GROUPS
  }
  return cudaErrorInvalidValue;
}

// a hidden width that the row passes take
__host__ __device__ constexpr bool row_width_ok(int d) {
  return d > 0 && d % 128 == 0 && d <= 128 * kMaxRowGroups;
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

// LayerNorm statistics of one row held as G x 4 values per lane
struct RowStats {
  float mu, inv;
};

template <int G>
__device__ __forceinline__ RowStats row_stats(const float x[G][4], float eps) {
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) s += x[g][t];
  const float mu = warp_sum(s) / (G * 128);
  float v = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float d = x[g][t] - mu;
      v += d * d;
    }
  return {mu, rsqrtf(warp_sum(v) / (G * 128) + eps)};
}

// the row's values (f32 or bf16 in memory) and their LayerNorm xhat, a
// warp on the row; returns 1 / std
template <int G, class T>
__device__ __forceinline__ float row_xhat(const T* x, int lane, float eps, float xhat[G][4]) {
#pragma unroll
  for (int q = 0; q < G; ++q) load4(x + q * 128 + lane * 4, xhat[q]);
  const RowStats st = row_stats<G>(xhat, eps);
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) xhat[q][t] = (xhat[q][t] - st.mu) * st.inv;
  return st.inv;
}

// y = xhat * s + g on the four columns c .. c + 3
__device__ __forceinline__ void ln_affine(const float xhat[4], const float* s, const float* g,
                                          int c, float y[4]) {
  float sv[4], gv[4];
  load4(s + c, sv);
  load4(g + c, gv);
#pragma unroll
  for (int t = 0; t < 4; ++t) y[t] = xhat[t] * sv[t] + gv[t];
}

}  // namespace gemm
}  // namespace vt
