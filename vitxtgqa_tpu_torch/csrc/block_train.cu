// The training block's forward entry points: #9a (vt_block_train_fwd) and
// its split form's row pass, FFN-in product and remat recompute.  The
// kernels and the note (what they replace, their bound and design) are in
// block_train.cuh; the backward's entry points in block_train_bwd.cu.
#include "block_train.cuh"

// #9a.  x_q, ctx [rows, d] bf16; wo [d, d], w1 [m, d], w2 [d, m] bf16;
// bo, s1, g1, b1, b2, s2, g2 f32.  Dropout: seed (int64 [1] on the device),
// or null (rate 0); mask_a_out / mask_f_out (nullable) receive the drawn
// int8 keep masks [rows, d].  Outputs y, x1h, x2h [rows, d], pre1, h
// [rows, m] bf16; scratch xb [rows, d] bf16 (bf16(LN1(x1h))).
extern "C" int vt_block_train_fwd(const void* x_q, const void* ctx, const void* wo,
                                  const void* bo, const void* s1, const void* g1, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* s2,
                                  const void* g2, const void* seed, void* mask_a_out,
                                  void* mask_f_out,
                                  void* y, void* x1h, void* pre1, void* h, void* x2h, void* xb,
                                  int rows, int d, int m, unsigned int threshold,
                                  float keep_scale, float eps, void* stream) {
  if (!widths_ok(rows, d, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop_a = {(const int64_t*)seed, (int8_t*)mask_a_out, 1u, threshold, keep_scale};
  const Drop drop_f = {(const int64_t*)seed, (int8_t*)mask_f_out, 2u, threshold, keep_scale};

  VT_TRY((launch_gemm<false, false>(one((const bf16*)ctx, d, (const bf16*)wo, d, rows, d, d),
                             ResidDropEpi{(const float*)bo, (const bf16*)x_q, (bf16*)x1h, drop_a},
                             st)));
  VT_TRY(launch_ln_fwd(x1h, s1, g1, xb, rows, d, eps, st));
  VT_TRY((launch_gemm<false, false>(one((const bf16*)xb, d, (const bf16*)w1, d, rows, m, d),
                             GeluEpi{(const float*)b1, (bf16*)pre1, (bf16*)h}, st)));
  VT_TRY((launch_gemm<false, false>(one((const bf16*)h, m, (const bf16*)w2, m, rows, d, m),
                             ResidDropEpi{(const float*)b2, (const bf16*)xb, (bf16*)x2h, drop_f},
                             st)));
  return (int)launch_ln_fwd(x2h, s2, g2, y, rows, d, eps, st);
}

// The split forward's row pass (F2' / F5'): sum [rows, d] f32 (the model
// group's summed partial), bias, s, g [d] f32, resid [rows, d] bf16 ->
// xh = bf16(resid + K (sum + bias)), out = bf16(LN(xh)) [rows, d] bf16.
// Dropout: seed (int64 [1] on the device, or null), stream (1: the
// attention output's mask, 2: the FFN's), mask_out (nullable) the drawn
// int8 keep mask [rows, d].
extern "C" int vt_block_train_tp_rows(const void* sum, const void* bias, const void* resid,
                                      const void* s, const void* g, const void* seed,
                                      void* mask_out, void* xh, void* out, int rows, int d,
                                      int stream_id, unsigned int threshold, float keep_scale,
                                      float eps, void* stream) {
  if (rows <= 0 || (stream_id != 1 && stream_id != 2)) return (int)cudaErrorInvalidValue;
  const Drop drop = {(const int64_t*)seed, (int8_t*)mask_out, (uint32_t)stream_id, threshold,
                     keep_scale};
  return (int)vt::gemm::by_row_groups(d, [&](auto grp) {
    resid_ln_rows<decltype(grp)::value><<<row_grid(rows), kRowThreads, 0, (cudaStream_t)stream>>>(
        (const float*)sum, (const float*)bias, (const bf16*)resid, (const float*)s,
        (const float*)g, (bf16*)xh, (bf16*)out, drop, rows, eps);
    return cudaGetLastError();
  });
}

// The split forward's F3 on this rank's FFN share: xb [rows, d] bf16, w1
// [m, d] bf16, b1 [m] f32 -> pre1 = bf16(xb W1^T + b1), h = bf16(gelu(pre1))
// [rows, m] bf16.
extern "C" int vt_block_train_tp_ffn_in(const void* xb, const void* w1, const void* b1,
                                        void* pre1, void* h, int rows, int d, int m,
                                        void* stream) {
  if (!tp_rows_ok(rows, d, m)) return (int)cudaErrorInvalidValue;
  return (int)launch_gemm<false, false>(one((const bf16*)xb, d, (const bf16*)w1, d, rows, m, d),
                                        GeluEpi{(const float*)b1, (bf16*)pre1, (bf16*)h},
                                        (cudaStream_t)stream);
}

// The split form's recompute under remat: from the saved x1h [rows, d]
// bf16 (the summed pre-norm rows), xb = bf16(LN1(x1h)) and F3 on this
// rank's FFN share (pre1, h [rows, m] bf16): the forward's residuals with
// no collective.
extern "C" int vt_block_train_tp_recompute(const void* x1h, const void* s1, const void* g1,
                                           const void* w1, const void* b1, void* xb, void* pre1,
                                           void* h, int rows, int d, int m, float eps,
                                           void* stream) {
  if (!tp_rows_ok(rows, d, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  VT_TRY(launch_ln_fwd(x1h, s1, g1, xb, rows, d, eps, st));
  return (int)launch_gemm<false, false>(one((const bf16*)xb, d, (const bf16*)w1, d, rows, m, d),
                                        GeluEpi{(const float*)b1, (bf16*)pre1, (bf16*)h}, st);
}
