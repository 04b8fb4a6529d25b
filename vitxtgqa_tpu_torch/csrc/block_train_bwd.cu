// The training block's backward entry points: #9b (vt_block_train_bwd)
// and its split form's head (B1-B3) and tail (B4-B7).  The kernels and the
// note (what they replace, their bound and design) are in
// block_train.cuh; the forward's entry points in block_train.cu.
#include "block_train.cuh"

namespace {

// B1-B3: du2, dlin2, dpre, the LN2 and db1 column-sum partials, and dx:
// du2 + dpre W1 in place over du2 (dx_part null), or the f32 partial
// dpre W1 into dx_part (the split form).  m: the FFN width this rank
// holds (w2 [d, m], w1 [m, d], pre1 [rows, m]).
int bwd_head(const void* g, const void* x2h, const void* pre1, const void* w2, const void* w1,
             const void* s2, const Drop& drop_f, void* du2, void* dlin2, void* dpre,
             void* dx_part, float* ln2_part, float* db1_part, int row_blocks, int rows, int d,
             int m, float eps, cudaStream_t st) {
  // B1. LN2 backward and the FFN dropout
  VT_TRY(vt::gemm::by_row_groups(d, [&](auto grp) {
    ln2_bwd_rows<decltype(grp)::value><<<row_blocks, kRowThreads, 0, st>>>(
        (const bf16*)g, (const bf16*)x2h, (const float*)s2, (float*)du2, (bf16*)dlin2, ln2_part,
        drop_f, rows, eps);
    return cudaGetLastError();
  }));
  // B2. dpre = (dlin2 W2) gelu'(pre1); db1's partials
  VT_TRY((launch_gemm<false, true>(one((const bf16*)dlin2, d, (const bf16*)w2, m, rows, m, d),
                            GeluGradEpi{(const bf16*)pre1, (bf16*)dpre, db1_part}, st)));
  // B3. dx = du2 + dpre W1 (or its partial dpre W1)
  if (dx_part == nullptr)
    VT_TRY((launch_gemm<false, true>(one((const bf16*)dpre, m, (const bf16*)w1, d, rows, d, m),
                              AddF32Epi{(float*)du2}, st)));
  else
    VT_TRY((launch_gemm<false, true>(one((const bf16*)dpre, m, (const bf16*)w1, d, rows, d, m),
                              StoreF32Epi{(float*)dx_part}, st)));
  return 0;
}

// B4-B7 from dx (+ dx_add where given): dx_q, dctx [rows, dl], the weight
// gradients (dwo [d, dl], dw1 [m, d], dw2 [d, m]) and the column sums.
// dl: the attention width this rank holds (ctx [rows, dl], wo [d, dl]).
int bwd_tail(const void* dx, const void* dx_add, const void* ctx, const void* x1h,
             const void* h, const void* wo, const void* s1, const void* g1, const Drop& drop_a,
             void* dxq, void* dctx, void* dwo, void* dbo, void* ds1, void* dg1, void* dw1,
             void* db1, void* dw2, void* db2, void* ds2, void* dg2, void* dlin2, void* dpre,
             void* xb, void* dlin1, const float* ln2_part, float* ln1_part,
             const float* db1_part, void* w_part, int row_blocks, int k_chunk, int rows, int d,
             int dl, int m, float eps, cudaStream_t st) {
  const int m_tiles = (rows + vt::g90::kBM - 1) / vt::g90::kBM;
  // B4. LN1 backward and the attention-output dropout
  VT_TRY(vt::gemm::by_row_groups(d, [&](auto grp) {
    ln1_bwd_rows<decltype(grp)::value><<<row_blocks, kRowThreads, 0, st>>>(
        (const float*)dx, (const float*)dx_add, (const bf16*)x1h, (const float*)s1,
        (const float*)g1, (bf16*)xb, (bf16*)dxq, (bf16*)dlin1, ln1_part, drop_a, rows, eps);
    return cudaGetLastError();
  }));
  // B5. dctx = dlin1 Wo
  VT_TRY((launch_gemm<false, true>(one((const bf16*)dlin1, d, (const bf16*)wo, dl, rows, dl, d),
                            StoreEpi{(bf16*)dctx}, st)));

  // B6. the weight gradients, reduced over the rows in splits of k_chunk
  const int splits = (rows + k_chunk - 1) / k_chunk;
  const size_t n_o = (size_t)d * dl, n_1 = (size_t)m * d, n_2 = (size_t)d * m;
  float* part_o = splits > 1 ? (float*)w_part : (float*)dwo;
  float* part_1 = splits > 1 ? part_o + splits * n_o : (float*)dw1;
  float* part_2 = splits > 1 ? part_1 + splits * n_1 : (float*)dw2;
  vt::g90::GemmArgs wg = {};
  const bf16* a_of[3] = {(const bf16*)dlin1, (const bf16*)dpre, (const bf16*)dlin2};
  const bf16* b_of[3] = {(const bf16*)ctx, (const bf16*)xb, (const bf16*)h};
  const int out_of[3] = {d, m, d}, in_of[3] = {dl, d, m};
  for (int p = 0; p < 3; ++p)
    wg.p[p] = vt::g90::make_problem({a_of[p], out_of[p]}, {b_of[p], in_of[p]}, out_of[p],
                                    in_of[p], rows, k_chunk);
  wg.n_problems = 3;
  const size_t stride = splits > 1 ? 1 : 0;
  VT_TRY((launch_gemm<true, true>(
      wg, PartialEpi{{part_o, part_1, part_2}, {stride * n_o, stride * n_1, stride * n_2}}, st)));

  // B7. every partial summed in order
  SumJobs jobs = {};
  auto add = [&](const float* src, void* dst, int n, int count, long long stride_) {
    jobs.j[jobs.n_jobs++] = {src, (float*)dst, n, count, stride_};
  };
  if (splits > 1) {
    add(part_o, dwo, (int)n_o, splits, (long long)n_o);
    add(part_1, dw1, (int)n_1, splits, (long long)n_1);
    add(part_2, dw2, (int)n_2, splits, (long long)n_2);
  }
  void* const ln2_out[3] = {ds2, dg2, db2};
  void* const ln1_out[3] = {ds1, dg1, dbo};
  for (int n = 0; n < 3; ++n) {
    add(ln2_part + n * d, ln2_out[n], d, row_blocks, 3LL * d);
    add(ln1_part + n * d, ln1_out[n], d, row_blocks, 3LL * d);
  }
  add(db1_part, db1, m, m_tiles, m);
  long long units = 0;
  for (int k = 0; k < jobs.n_jobs; ++k) units += jobs.j[k].n / 4;
  sum_partials<<<(unsigned)((units + 255) / 256), 256, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}

// the split forms' widths: d the rows', dl and m this rank's shares
bool tp_widths_ok(int rows, int d, int dl, int m) {
  return tp_rows_ok(rows, d, m) && share_ok(dl);
}

}  // namespace

// #9b.  g, ctx, x1h, x2h [rows, d], pre1, h [rows, m] bf16; weights and
// LayerNorm vectors as in the forward; the dropout seed as in the forward.
// Outputs dxq, dctx [rows, d] bf16; dwo [d, d], dw1 [m, d], dw2 [d, m],
// dbo, ds1, dg1, db2, ds2, dg2 [d], db1 [m] f32 (every element written).
// Scratch: du2 [rows, d] f32; dlin2, xb, dlin1 [rows, d] and dpre
// [rows, m] bf16; col_part f32 [2 * row_blocks * 3 * d + m_tiles * m]
// (the column sums' partials); w_part f32 [splits * (d * d + 2 * m * d)]
// (the weight gradients' partials; unused with one split).  The plan
// (ops/block_train.launch_plan): row_blocks, the row passes' grid, and
// k_chunk, the rows of one split of the weight gradients (a multiple of 64).
extern "C" int vt_block_train_bwd(const void* g, const void* ctx, const void* x1h,
                                  const void* pre1, const void* h, const void* x2h,
                                  const void* wo, const void* w1, const void* w2, const void* s1,
                                  const void* g1, const void* s2, const void* seed, void* dxq,
                                  void* dctx,
                                  void* dwo, void* dbo, void* ds1, void* dg1, void* dw1,
                                  void* db1, void* dw2, void* db2, void* ds2, void* dg2,
                                  void* du2, void* dlin2, void* dpre, void* xb, void* dlin1,
                                  void* col_part, void* w_part, int row_blocks, int k_chunk,
                                  int rows, int d, int m, unsigned int threshold,
                                  float keep_scale, float eps, void* stream) {
  if (!widths_ok(rows, d, m) || row_blocks <= 0 || k_chunk <= 0 || k_chunk % vt::g90::kBK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop_a = {(const int64_t*)seed, nullptr, 1u, threshold, keep_scale};
  const Drop drop_f = {(const int64_t*)seed, nullptr, 2u, threshold, keep_scale};
  float* ln2_part = (float*)col_part;
  float* ln1_part = ln2_part + (size_t)row_blocks * 3 * d;
  float* db1_part = ln1_part + (size_t)row_blocks * 3 * d;
  const int err = bwd_head(g, x2h, pre1, w2, w1, s2, drop_f, du2, dlin2, dpre, nullptr, ln2_part,
                           db1_part, row_blocks, rows, d, m, eps, st);
  if (err) return err;
  return bwd_tail(du2, nullptr, ctx, x1h, h, wo, s1, g1, drop_a, dxq, dctx, dwo, dbo, ds1, dg1,
                  dw1, db1, dw2, db2, ds2, dg2, dlin2, dpre, xb, dlin1, ln2_part, ln1_part,
                  db1_part, w_part, row_blocks, k_chunk, rows, d, d, m, eps, st);
}

// The split backward's B1-B3 on this rank's FFN share (w2 [d, m], w1
// [m, d], pre1 [rows, m]): du2 [rows, d] f32, dlin2 [rows, d] and dpre
// [rows, m] bf16, the f32 partial dx_part = dpre W1 [rows, d] (summed over
// the model group before the tail), and into col_part (laid out as
// vt_block_train_bwd's) the LN2 and db1 column-sum partials.
extern "C" int vt_block_train_tp_bwd_head(const void* g, const void* x2h, const void* pre1,
                                          const void* w2, const void* w1, const void* s2,
                                          const void* seed, void* du2, void* dlin2, void* dpre,
                                          void* dx_part, void* col_part, int row_blocks,
                                          int rows, int d, int m, unsigned int threshold,
                                          float keep_scale, float eps, void* stream) {
  if (!tp_rows_ok(rows, d, m) || row_blocks <= 0 || dx_part == nullptr)
    return (int)cudaErrorInvalidValue;
  const Drop drop_f = {(const int64_t*)seed, nullptr, 2u, threshold, keep_scale};
  float* ln2_part = (float*)col_part;
  float* db1_part = ln2_part + 2 * (size_t)row_blocks * 3 * d;
  return bwd_head(g, x2h, pre1, w2, w1, s2, drop_f, du2, dlin2, dpre, dx_part, ln2_part,
                  db1_part, row_blocks, rows, d, m, eps, (cudaStream_t)stream);
}

// The split backward's B4-B7: dx = dx_sum + du2 (the summed partial and
// the head's du2); ctx [rows, dl] and wo [d, dl] this rank's heads', h
// [rows, m] its FFN share.  Outputs dxq [rows, d] and dctx [rows, dl]
// bf16; dwo [d, dl], dw1 [m, d], dw2 [d, m] and the vectors f32 as
// vt_block_train_bwd's; col_part the head's; w_part f32 [splits * (d * dl
// + 2 * m * d)].
extern "C" int vt_block_train_tp_bwd_tail(
    const void* dx_sum, const void* du2, const void* ctx, const void* x1h, const void* h,
    const void* wo, const void* s1, const void* g1, const void* seed, void* dxq, void* dctx,
    void* dwo, void* dbo, void* ds1, void* dg1, void* dw1, void* db1, void* dw2, void* db2,
    void* ds2, void* dg2, void* dlin2, void* dpre, void* xb, void* dlin1, void* col_part,
    void* w_part, int row_blocks, int k_chunk, int rows, int d, int dl, int m,
    unsigned int threshold, float keep_scale, float eps, void* stream) {
  if (!tp_widths_ok(rows, d, dl, m) || row_blocks <= 0 || k_chunk <= 0 ||
      k_chunk % vt::g90::kBK)
    return (int)cudaErrorInvalidValue;
  const Drop drop_a = {(const int64_t*)seed, nullptr, 1u, threshold, keep_scale};
  float* ln2_part = (float*)col_part;
  float* ln1_part = ln2_part + (size_t)row_blocks * 3 * d;
  float* db1_part = ln1_part + (size_t)row_blocks * 3 * d;
  return bwd_tail(dx_sum, du2, ctx, x1h, h, wo, s1, g1, drop_a, dxq, dctx, dwo, dbo, ds1, dg1,
                  dw1, db1, dw2, db2, ds2, dg2, dlin2, dpre, xb, dlin1, ln2_part, ln1_part,
                  db1_part, w_part, row_blocks, k_chunk, rows, d, dl, m, eps,
                  (cudaStream_t)stream);
}

