// Flash attention, backward (#1b, and its split-head form #10b): the entry
// points of the backward body in flash_bwd.cuh, which holds the note (what
// it replaces, its bound and its design).  The merged form reads its
// operands through the merged layout's strides, the split form through a
// Geom's, one instantiation for both; dk / dv are bf16 (#1b) or the f32
// partial sums of a query shard (#10b).  Any head width D a multiple of 8
// up to 128: the D == 64 forms compile here, the others in
// flash_bwd_narrow.cu and flash_bwd_wide.cu.
#include "flash_bwd.cuh"

// q, k, v, out, dout, dq, dk, dv [B, L, H*D] bf16 (D = head_dim); key_mask
// [B, L] f32; lse [B, H, L] f32 from the forward; scratch: f32 of B * H *
// round_up(L, 64) * (64 * na * parts + 2), na = 1 (D <= 64) or 2, parts =
// bwd_parts(L, ordered)
// (bwd_params); seed: int64 [1] on the device, or null for no dropout;
// ordered: dq summed over the key blocks in a fixed order (1) or by
// atomics (0).
extern "C" int vt_flash_attention_merged_bwd(const void* q, const void* k, const void* v,
                                             const void* key_mask, const void* out,
                                             const void* dout, const void* lse, void* scratch,
                                             void* dq, void* dk, void* dv, const void* seed,
                                             int batch, int seq_len, int num_heads,
                                             int head_dim, int dec_len, int head_offset,
                                             int ordered, unsigned int threshold,
                                             float keep_scale, void* stream) {
  using namespace vt::flash;
  if (!head_width_ok(head_dim) || batch <= 0 || num_heads <= 0 || seq_len <= 0 ||
      dec_len < 0 || dec_len > seq_len || head_offset < 0 || (ordered != 0 && ordered != 1))
    return (int)cudaErrorInvalidValue;
  Geom g = merged_geom(seq_len, num_heads, head_dim);
  g.head_offset = head_offset;
  const BwdParams p = bwd_params(q, k, v, key_mask, out, dout, lse, scratch, dq, dk, dv, seed,
                                 g, batch, num_heads, head_dim, dec_len, ordered, threshold,
                                 keep_scale);
  return launch_flash_bwd_d<vt::bf16>(p, batch, head_dim, stream);
}

// The split-head form (#10b): q, out, dout, dq [B, H, Lq, D] bf16; k, v
// [B, H, Lk, D] bf16; dk, dv [B, H, Lk, D] f32; each through its (batch,
// head, row) element strides (strides: 24 int64, q, k, v, out, dout, dq,
// dk, dv), the last dimension contiguous and the rows 16-byte aligned;
// key_mask [B, Lk] f32; lse [B, H, Lq] f32 from the forward; scratch: f32
// of B * H * round_up(Lq, 64) * (64 * na * bwd_parts(Lk, ordered) + 2);
// row_offset, seed, threshold, keep_scale as the forward's; ordered as the
// merged form's.
extern "C" int vt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* out, const void* dout,
                                      const void* lse, void* scratch, void* dq, void* dk,
                                      void* dv, const void* seed, const void* strides, int batch,
                                      int num_heads, int len_q, int len_k, int head_dim,
                                      int dec_len, int row_offset, int ordered,
                                      unsigned int threshold,
                                      float keep_scale, void* stream) {
  using namespace vt::flash;
  if (!head_width_ok(head_dim) || batch <= 0 || num_heads <= 0 || len_q <= 0 ||
      len_k <= 0 || dec_len < 0 || dec_len > len_k || row_offset < 0 ||
      (ordered != 0 && ordered != 1))
    return (int)cudaErrorInvalidValue;
  Geom g = merged_geom(len_k, num_heads, head_dim);
  read_strides(g, (const long long*)strides, 8);
  g.Lq = len_q;
  g.row_offset = row_offset;
  const BwdParams p = bwd_params(q, k, v, key_mask, out, dout, lse, scratch, dq, dk, dv, seed, g,
                                 batch, num_heads, head_dim, dec_len, ordered, threshold,
                                 keep_scale);
  return launch_flash_bwd_d<float>(p, batch, head_dim, stream);
}
