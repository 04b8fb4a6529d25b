// Split-head attention with an additive bias tensor (eval).
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:fused_attention (the
// Pallas body _kernel), which the split-head mha takes for an array bias
// or none at >= 256 keys, more than one query row and no dropout: the
// ViT's self-attention (vitxtgqa_tpu/models/vit.py, mha(q, k, v) with no
// bias) once its token count reaches 256.  Computes per (batch b, head h)
//   out = softmax(Q K^T / sqrt(D) + bias) V
// on bf16 q [B, H, Lq, D], k / v [B, H, Lk, D] given by element strides
// (the split-head views of a [B, L, H*D] projection need no copy), any head
// width D a multiple of 8 up to 128 (flash_fwd.cuh's tiers: ViT-H/14's 80
// on the 128-wide tier, zero-filled past D as the Pallas wrapper pads D to
// 128 lanes, so the result is the padded kernel's), with an
// f32 bias broadcast over the query rows ([B, 1, 1, Lk]: row stride 0) or
// per row ([B, 1, Lq, Lk]), or none.  Scores are f32 (s * scale + bias,
// as the Pallas kernel adds its bias after the scale); the Pallas wrapper
// pads the keys to round_up(Lk, 128) with zero k / v and bias -1e9, so the
// softmax counts those keys at -1e9 too (a row of -1e9 biases averages V
// over round_up(Lk, 128) keys, the padded ones included); the probabilities are
// rounded to bf16 for the P V product, as the Pallas kernel feeds bf16
// weights to its second matmul; out bf16, written through its own strides.
//
// What bounds it on the H100: at [8, 12, 1152, 64] the two products are
// 4 * B * H * Lq * Lk * 64 = 32.6 GFLOP against 57 MB of q/k/v/out and
// the key-mask bias: ~570 FLOP per byte, above the bf16 ridge (~295), so
// the tensor cores bound it (0.033 ms at 989 TFLOP/s); with a per-row
// bias its [B, Lq, Lk] f32 read (42 MB) is of the same order.
//
// Design: the TPU kernel holds a whole head's K and V next to a 128-query
// block (295 KB at 1,152 keys, more than an SM's shared memory).  Here the
// key loop is flash_fwd.cuh's under its bias policy: wgmma from a cp.async
// ring of K / V stages with the bias tile in the same stage, S and O in
// registers, no tile skipped (the bias is arbitrary).  A row whose running
// max is still -inf (a bias of -inf on every key seen so far) takes its
// exponentials against 0, so it gets no NaN.  This file holds the entry
// point only.
#include "flash_fwd.cuh"

// q [B, H, Lq, D], k / v [B, H, Lk, D], out [B, H, Lq, D] bf16, each
// through its (batch, head, row) element strides, the last dimension
// contiguous and every row 16-byte aligned; bias f32 through its (batch,
// row) strides (row stride 0: one row for all queries), or null.
// strides: 14 int64: q, k, v, out as (batch, head, row), the bias as
// (batch, row).
extern "C" int vt_fused_attention(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, const void* strides, int batch, int num_heads,
                                  int len_q, int len_k, int head_dim, void* stream) {
  using namespace vt::flash;
  if (!head_width_ok(head_dim) || batch <= 0 || num_heads <= 0 || len_q <= 0 || len_k <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* s = (const long long*)strides;
  FwdParams p = {};
  p.q = (const vt::bf16*)q;
  p.k = (const vt::bf16*)k;
  p.v = (const vt::bf16*)v;
  p.out = (vt::bf16*)out;
  p.g = merged_geom(len_k, num_heads, head_dim);
  read_strides(p.g, s, 4);
  p.g.Lq = len_q;
  p.heads = num_heads;
  p.l_pad = (len_k + 127) / 128 * 128;
  p.keep_scale = 1.0f;
  p.dch = head_dim / 8;
  p.scale = 1.0f / sqrtf((float)head_dim);
  p.bias = (const float*)bias;
  p.bias_b = s[12];
  p.bias_r = s[13];
  p.bias_vec16 = ((uintptr_t)bias % 16 == 0 && p.bias_b % 4 == 0 && p.bias_r % 4 == 0) ? 1 : 0;
  return by_head_tier(head_dim, [&](auto na, auto full) {
    return launch_flash_fwd<false, false, false, decltype(na)::value, decltype(full)::value>(
        p, batch, stream);
  });
}
