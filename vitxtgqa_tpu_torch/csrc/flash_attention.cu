// Flash attention, forward, with optional in-kernel dropout of the
// attention probabilities and the row log-sum-exp for the backward.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged
// (the Pallas body _flash_merged_kernel / _merged_heads_attend), and, as
// its split-head form (#10), pallas_attention.py:flash_attention
// (_flash_impl / _flash_kernel): q [B, H, Lq, D] and k / v [B, H, Lk, D]
// read through their strides (the split-head views of the merged
// projections, not copied), Lq != Lk (a sequence-parallel query shard
// against the whole key range), and row_offset, the global row of query
// row 0, which enters the mask and the dropout coordinates, so a shard's
// rows are the unsharded call's rows.  The output is written [B, Lq, H,
// 64]-major, so merge_heads and the ranks' row gather work on contiguous
// row blocks.  Any head width D a multiple of 8 up to 128 (flash_fwd.cuh's
// tiers); the D == 64 forms are compiled here, the others in
// flash_fwd_narrow.cu and flash_fwd_wide.cu.
//
// Computes, per head h, softmax(Q_h K_h^T / sqrt(d) + mask) V_h on bf16
// operands, with the mask built in-kernel from key_mask [B, Lk] plus a
// trailing causal decoder block of dec_len rows (pallas_attention.py
// _allowed): global query row r may attend key c when key_mask[c] > 0, or
// when both lie in the decoder block and c <= r.  Masked scores take -1e9;
// a row with no allowed key averages V over round_up(Lk, 128) keys, as the
// JAX wrappers' key padding has it (flash_fwd.cuh).  Training (rate > 0): the normalised probabilities are dropped where the
// Philox bits of element (b, h, r, c) fall below the threshold
// (philox.cuh) and the kept ones divided by 1 - rate, as
// _merged_heads_attend does; lse [B, H, Lq] f32 receives m + log(l).
//
// What bounds it on the H100: at the training shape (B=48, L=1152, H=12,
// D=64) one call is 4*B*L*L*H*D = 196 GFLOP against 4*B*L*H*D*2 bytes =
// 340 MB of q/k/v/out, i.e. ~575 FLOP/byte, above the card's ~295 bf16
// ridge: the tensor cores bound it, and the [L, L] score matrix must never
// reach device memory.  With dropout every probability also costs a
// quarter of a Philox4x32-10 evaluation (four keys per evaluation, ~30
// integer instructions each), which the integer units do beside the
// tensor cores.
//
// #10 at its serving shape (q [8, 12, 576, 64] against [8, 12, 1152, 64])
// is half of #1's work per rank: ~287 FLOP per byte, at the bf16 ridge.
//
// Design: the key loop is flash_fwd.cuh's (wgmma from a cp.async ring of
// K / V stages, S and O in registers, P passed to the second product in
// registers, the dead key tiles of the key mask skipped), under its mask
// policy; this file holds the entry points only.  The split form reads its
// operands through the strides of a Geom and the merged form through the
// merged layout's, one instantiation for both.
//
// The int8-cache form (kEmit) also replaces pallas_attention.py:
// flash_attention_merged_q8 (_flash_merged_q8_kernel): the same forward,
// plus the quantize_kv layout of this layer's K and V (k8 / v8 [B, L, H*D]
// int8, ks / vs [B, L] f32 per-token scales), bit for bit: the amax of a
// token's H*D bf16 values, scale = max(amax, 1e-6) / 127, rint(v / scale)
// (IEEE division, round half to even) clipped to +-127.  The TPU kernel
// quantizes at its first q block from a batch-resident K/V block; here a
// block sees one head, but a token's scale spans all H heads, so the
// q-tile-0 block of each (head h, batch b) quantizes tokens [h * ceil(L /
// H), (h + 1) * ceil(L / H)) of batch b across all H*D columns, a warp per
// token, before its own attention: the other q tiles run unchanged.  The
// emission reads each K / V token once more (while the other blocks of the
// batch stream the same K / V, so mostly from L2) and writes its int8 row
// and scale: 3 bytes an element over q/k/v/out's 8, in place of the
// separate quantize_kv pass and its launch.  kEmit is a template flag, so
// the eval and training forms do not carry it.
#include "flash_fwd.cuh"

namespace vt {
namespace flash {

// the mask-policy launch at head width d: emission, dropout (seed given)
// or neither
inline int launch_masked(FwdParams& p, int batch, int d, bool emit, void* stream) {
  p.l_pad = (p.g.Lk + 127) / 128 * 128;
  p.bias = nullptr;
  p.dch = d / 8;
  p.scale = 1.0f / sqrtf((float)d);
  return by_head_tier(d, [&](auto na, auto full) {
    constexpr int NA = decltype(na)::value;
    constexpr bool F = decltype(full)::value;
    if (emit) return launch_flash_fwd<true, false, true, NA, F>(p, batch, stream);
    if (p.seed != nullptr) return launch_flash_fwd<true, true, false, NA, F>(p, batch, stream);
    return launch_flash_fwd<true, false, false, NA, F>(p, batch, stream);
  });
}

}  // namespace flash
}  // namespace vt

// q, k, v, out [B, L, H*D] bf16 (D = head_dim, a multiple of 8 up to 128);
// key_mask [B, L] f32; lse [B, H, L] f32
// or null (eval); seed: int64 [1] on the device, or null for no dropout;
// k8, ks, v8, vs: the int8 cache of k and v ([B, L, H*D] int8, [B, L] f32),
// or all null; threshold / keep_scale: the dropout keep test and 1 / (1 -
// rate).
extern "C" int vt_flash_attention_merged(const void* q, const void* k, const void* v,
                                         const void* key_mask, void* out, void* lse,
                                         const void* seed, void* k8, void* ks, void* v8,
                                         void* vs, int batch, int seq_len, int num_heads,
                                         int head_dim, int dec_len, int head_offset,
                                         unsigned int threshold,
                                         float keep_scale, void* stream) {
  using namespace vt::flash;
  if (!head_width_ok(head_dim) || batch <= 0 || num_heads <= 0 || seq_len <= 0 ||
      dec_len < 0 || dec_len > seq_len || head_offset < 0)
    return (int)cudaErrorInvalidValue;
  const bool emit = k8 != nullptr;
  if (emit && (ks == nullptr || v8 == nullptr || vs == nullptr || seed != nullptr))
    return (int)cudaErrorInvalidValue;
  FwdParams p = {};
  p.q = (const vt::bf16*)q;
  p.k = (const vt::bf16*)k;
  p.v = (const vt::bf16*)v;
  p.out = (vt::bf16*)out;
  p.g = merged_geom(seq_len, num_heads, head_dim);
  p.g.head_offset = head_offset;
  p.heads = num_heads;
  p.key_mask = (const float*)key_mask;
  p.dec_len = dec_len;
  p.lse = (float*)lse;
  p.seed = (const int64_t*)seed;
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  p.emit = {(int8_t*)k8, (float*)ks, (int8_t*)v8, (float*)vs};
  return launch_masked(p, batch, head_dim, emit, stream);
}

// The split-head form (#10): q [B, H, Lq, D], k / v [B, H, Lk, D], out
// [B, H, Lq, D] bf16, each through its (batch, head, row) element strides
// (strides: 12 int64, q, k, v, out), the last dimension contiguous and
// every row 16-byte aligned; key_mask [B, Lk] f32; lse [B, H, Lq] f32 or
// null; row_offset: the global row of query row 0; seed / threshold /
// keep_scale as above.
extern "C" int vt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* out, void* lse, const void* seed,
                                  const void* strides, int batch, int num_heads, int len_q,
                                  int len_k, int head_dim, int dec_len, int row_offset,
                                  unsigned int threshold, float keep_scale, void* stream) {
  using namespace vt::flash;
  if (!head_width_ok(head_dim) || batch <= 0 || num_heads <= 0 || len_q <= 0 ||
      len_k <= 0 || dec_len < 0 || dec_len > len_k || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  FwdParams p = {};
  p.q = (const vt::bf16*)q;
  p.k = (const vt::bf16*)k;
  p.v = (const vt::bf16*)v;
  p.out = (vt::bf16*)out;
  p.g = merged_geom(len_k, num_heads, head_dim);
  read_strides(p.g, (const long long*)strides, 4);
  p.g.Lq = len_q;
  p.g.row_offset = row_offset;
  p.heads = num_heads;
  p.key_mask = (const float*)key_mask;
  p.dec_len = dec_len;
  p.lse = (float*)lse;
  p.seed = (const int64_t*)seed;
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  return launch_masked(p, batch, head_dim, false, stream);
}
