// Pieces shared by the flash attention forward body (flash_fwd.cuh: #1,
// #10, #11, #14) and backward body (flash_bwd.cuh: #1b, #10b): the
// operands' strides (Geom), log2(e).
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace vt {
namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

// Where one flash call's operands live: the element strides (batch, head,
// row) of each operand, the last dimension contiguous.  The merged [B, L,
// H*D] layout (#1 / #1b) is the strides (L*H*D, D, H*D); the split-head
// views [B, H, L, D] (#10 / #10b) are read through their own strides, so
// split_heads is never copied.  Lq query rows attend Lk keys, and query row
// i is row row_offset + i of the sequence the keys span (a sequence-
// parallel shard's first row; 0 for a whole sequence): the mask and the
// dropout bits are functions of that global row.
struct Geom {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
  int Lq, Lk, row_offset;
  int head_offset;  // the global head of head 0: a tensor-parallel rank's heads in the
                    // dropout mask's coordinates
};

__device__ __forceinline__ size_t head_base(const long long s[3], int b, int h) {
  return (size_t)(b * s[0] + h * s[1]);
}

inline Geom merged_geom(int L, int H, int D) {
  Geom g;
  const long long s[3] = {(long long)L * H * D, D, (long long)H * D};
  long long* all[8] = {g.q, g.k, g.v, g.o, g.dout, g.dq, g.dk, g.dv};
  for (long long* t : all)
    for (int i = 0; i < 3; ++i) t[i] = s[i];
  g.Lq = g.Lk = L;
  g.row_offset = 0;
  g.head_offset = 0;
  return g;
}

// the strides of the C entry points: n operands x (batch, head, row) int64
inline void read_strides(Geom& g, const long long* s, int n) {
  long long* all[8] = {g.q, g.k, g.v, g.o, g.dout, g.dq, g.dk, g.dv};
  for (int t = 0; t < n; ++t)
    for (int i = 0; i < 3; ++i) all[t][i] = s[3 * t + i];
}

}  // namespace flash
}  // namespace vt
