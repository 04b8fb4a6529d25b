// One greedy-decode step through every MMT layer in ONE launch (#5): the
// entry point and the main path's form.  The kernel, its note (what it
// replaces, its bound, its design) and its forms are in
// fused_decode_step.cuh; the main path's MMT (768 / 3,072, 12 heads of 64,
// at most 1,152 slots) compiles here with its widths as constants (read at
// run time they cost its batch-1 step 57% on the H100: PERF.md section 6),
// the run-time forms in fused_decode_step_{b2,b8}_{h64,h128}.cu.
#include "fused_decode_step.cuh"

namespace vt {
namespace step {

// the main path's form: its widths and cache bound at compile time
inline bool main_form(const Params& p) {
  return p.D == 768 && p.M == 3072 && p.H == 12 && p.Lp <= kMainLp;
}

// the instantiation of batch bound MB that fits the launch
template <int MB>
cudaError_t launch_forms(const Params& p, int smem, cudaStream_t stream) {
  if (main_form(p)) return launch<MB, Rows4, Rows1, 768, 3072, 2>(p, smem, stream);
  return p.Dh <= 64 ? launch_runtime<MB, 2>(p, smem, stream)
                    : launch_runtime<MB, 4>(p, smem, stream);
}

}  // namespace step
}  // namespace vt

// One launch over `batch` rows (at most 8: a group of a larger batch) of a
// batch of `batch_stride` rows.  ptrs, in order: x, wq, bq, wk, bk, wv, bv,
// wo, bo, s1, g1, w1, b1, w2, b2, s2, g2, kv8, kvs, mask, y, row8, rowsc,
// each at the group's first row (kv8, kvs, row8 and rowsc keep the whole
// batch's layer stride), then the scratch of one launch: qkv, pre, h,
// opart [H, batch, D] f32, apart [batch * H * 16, d / num_heads] f32,
// arrive [batch * H] int32 (zero before the first launch; each launch
// leaves it zero) (29).  d = num_heads x the head width, a multiple of 8 up
// to 128, and a multiple of 128 up to 2,048; m a multiple of 128 up to
// 8,192; cache_len at most 4,096.
extern "C" int vt_fused_decode_step(void* const* ptrs, int n_layers, int batch, int batch_stride,
                                    int cache_len, int d, int m, int num_heads, int step,
                                    int write_offset, float eps, void* stream) {
  using namespace vt::step;
  using vt::bf16;
  const int dh = num_heads > 0 ? d / num_heads : 0;
  if (num_heads <= 0 || d != num_heads * dh || dh % 8 != 0 || dh > kMaxHd || d % 128 != 0 ||
      d > kMaxD || m <= 0 || m % 128 != 0 || m > kMaxM || batch < 1 || batch > MAXB ||
      batch_stride < batch || cache_len > kMaxLp || write_offset + step >= cache_len)
    return (int)cudaErrorInvalidValue;
  Params p;
  int i = 0;
  p.x = (const bf16*)ptrs[i++];
  p.wq = (const bf16*)ptrs[i++];
  p.bq = (const float*)ptrs[i++];
  p.wk = (const bf16*)ptrs[i++];
  p.bk = (const float*)ptrs[i++];
  p.wv = (const bf16*)ptrs[i++];
  p.bv = (const float*)ptrs[i++];
  p.wo = (const bf16*)ptrs[i++];
  p.bo = (const float*)ptrs[i++];
  p.s1 = (const float*)ptrs[i++];
  p.g1 = (const float*)ptrs[i++];
  p.w1 = (const bf16*)ptrs[i++];
  p.b1 = (const float*)ptrs[i++];
  p.w2 = (const bf16*)ptrs[i++];
  p.b2 = (const float*)ptrs[i++];
  p.s2 = (const float*)ptrs[i++];
  p.g2 = (const float*)ptrs[i++];
  p.kv8 = (const int8_t*)ptrs[i++];
  p.kvs = (const float*)ptrs[i++];
  p.mask = (const float*)ptrs[i++];
  p.y = (bf16*)ptrs[i++];
  p.row8 = (int8_t*)ptrs[i++];
  p.rowsc = (float*)ptrs[i++];
  p.qkv = (bf16*)ptrs[i++];
  p.pre = (float*)ptrs[i++];
  p.h = (bf16*)ptrs[i++];
  p.opart = (float*)ptrs[i++];
  p.apart = (float*)ptrs[i++];
  p.arrive = (int*)ptrs[i++];
  p.L = n_layers;
  p.B = batch;
  p.BS = batch_stride;
  p.Lp = cache_len;
  p.step = step;
  p.write_offset = write_offset;
  p.D = d;
  p.M = m;
  p.H = num_heads;
  p.Dh = dh;
  p.spans = 1;  // set by launch from the grid
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)dh);
  // the score slots of the attention scratch: the main path's form keeps
  // its 1,152, a run-time form the launch's cache rounded to 4 slots
  p.scap = main_form(p) ? kMainLp : (cache_len + 3) / 4 * 4;
  const int smem = smem_bytes(batch, d, m, 4 * attn_floats(p.scap, dh <= 64 ? 64 : 128));
  const cudaStream_t st = (cudaStream_t)stream;
  // the instantiation of the group's rows: 1-2, else 3-8
  return (int)(batch <= 2 ? launch_forms<2>(p, smem, st) : launch_forms<MAXB>(p, smem, st));
}
