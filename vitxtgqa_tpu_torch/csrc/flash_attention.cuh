// Pieces shared by the flash attention forward body (flash_fwd.cuh: #1,
// #10, #11, #14) and backward (flash_attention_bwd.cu: #1b, #10b): the
// operands' strides (Geom); and the backward's tile geometry, tile loads,
// mask predicate and the dropout keep bits of a row's four consecutive
// keys.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace vt {
namespace flash {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // query rows per tile: 4 warps x 16 rows
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // threads per block
constexpr int LDB = HD + 8;   // bf16 row stride of the q/k/v/dO tiles
constexpr int LDP = BK + 8;   // bf16 row stride of probability / dS tiles
constexpr int LDS = BK + 4;   // f32 row stride of score tiles

// Where one flash call's operands live: the element strides (batch, head,
// row) of each operand, the last dimension contiguous.  The merged [B, L,
// H*64] layout (#1 / #1b) is the strides (L*H*64, 64, H*64); the split-head
// views [B, H, L, 64] (#10 / #10b) are read through their own strides, so
// split_heads is never copied.  Lq query rows attend Lk keys, and query row
// i is row row_offset + i of the sequence the keys span (a sequence-
// parallel shard's first row; 0 for a whole sequence): the mask and the
// dropout bits are functions of that global row.
struct Geom {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
  int Lq, Lk, row_offset;
};

__device__ __forceinline__ size_t head_base(const long long s[3], int b, int h) {
  return (size_t)(b * s[0] + h * s[1]);
}

inline Geom merged_geom(int L, int H) {
  Geom g;
  const long long s[3] = {(long long)L * H * HD, HD, (long long)H * HD};
  long long* all[8] = {g.q, g.k, g.v, g.o, g.dout, g.dq, g.dk, g.dv};
  for (long long* t : all)
    for (int i = 0; i < 3; ++i) t[i] = s[i];
  g.Lq = g.Lk = L;
  g.row_offset = 0;
  return g;
}

// the strides of the C entry points: n operands x (batch, head, row) int64
inline void read_strides(Geom& g, const long long* s, int n) {
  long long* all[8] = {g.q, g.k, g.v, g.o, g.dout, g.dq, g.dk, g.dv};
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 3; ++i) all[t][i] = s[3 * t + i];
}

// The mask of pallas_attention._allowed: query row r (global) may attend
// key c when key_mask[c] > 0, or when both lie in the trailing causal
// decoder block of dec_len rows and c <= r.
__device__ __forceinline__ bool allowed(float kmask, int row, int col, int l_enc, int dec_len) {
  return kmask > 0.f || (dec_len > 0 && col >= l_enc && row >= l_enc && col <= row);
}

// rows [r0, r0 + 64) of one head's [L, 64] slice at element offset base
// with row stride row_stride (16-byte aligned rows), zero past L; the
// stride an int (the merged layout) or a long long (a Geom's)
template <typename Stride>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t base,
                                          int r0, int L, Stride row_stride) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < 64 * (HD / 8); i += NT) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 val = zero;
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + base + (size_t)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r * LDB + c]) = val;
  }
}

// Dropout keep flags of keys col0 .. col0 + 3 (col0 % 4 == 0) for global
// query row `row` of head h, batch b: element (b, h, row, col) of the [B,
// H, L, L] probability mask, stream 0 (ops/dropout.py STREAM_ATTN).
__device__ __forceinline__ void keep4(bool keep[4], uint32_t seed, uint32_t threshold, int col0,
                                      int row, int h, int b) {
  const uint4 w = philox_group(seed, 0u, (uint32_t)col0, (uint32_t)row, (uint32_t)h, (uint32_t)b);
  keep[0] = w.x >= threshold;
  keep[1] = w.y >= threshold;
  keep[2] = w.z >= threshold;
  keep[3] = w.w >= threshold;
}

}  // namespace flash
}  // namespace vt
