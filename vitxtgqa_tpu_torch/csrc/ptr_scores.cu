// OCR pointer-net scores of one decode step over int8 per-token-scaled keys.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:ptr_scores_int8 (the Pallas
// body _ptr_scores_int8_kernel):
//   out[b, 0, n] = (q[b] . k8[b, n]) * (ks[b, n] * scale) + mask[b, n]
// q [B, 1, D] f32 (the pointer net computes in f32), k8 [B, N, D] int8 and
// ks [B, N] f32 in the ops/attention.quantize_kv layout, mask [B, N] the raw
// 0/1 OCR mask, ADDED (the reference OcrPtrNet quirk), scale = 1 / sqrt(D);
// f32 out [B, 1, N].
//
// What bounds it on the H100: one call reads the keys once, B*N*D bytes
// (5.9 MB at B = 8, N = 960, D = 768) for 2*B*N*D operations: 2 per byte,
// so device-memory bandwidth (1.8 us at 3.35 TB/s); at these sizes the
// launch itself is of the same order.
//
// Design: a block of 8 warps per (32 keys, batch row); a half warp per key,
// its 16 lanes reading 16-byte runs of the key row (neighbouring lanes on
// neighbouring addresses) against the lane's own slice of q, held in
// registers for all the block's keys; the dot reduces over the half warp.
#include "common.cuh"

namespace vt {
namespace ptr {

constexpr int NT = 256;
constexpr int KPB = 32;        // keys per block: 8 warps x 2 keys x 2 passes
constexpr int MAX_CHUNKS = 4;  // D <= 16 lanes x 16 bytes x 4 = 1024

__global__ void __launch_bounds__(NT)
ptr_scores_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                       const float* __restrict__ ks, const float* __restrict__ mask,
                       float* __restrict__ out, int N, int D, float scale) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hl = lane & 15;
  float qr[MAX_CHUNKS][16];
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int c = hl * 16 + i * 256;
#pragma unroll
    for (int t = 0; t < 16; t += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < D) v = *reinterpret_cast<const float4*>(q + (size_t)b * D + c + t);
      qr[i][t] = v.x, qr[i][t + 1] = v.y, qr[i][t + 2] = v.z, qr[i][t + 3] = v.w;
    }
  }
  for (int p = 0; p < KPB / 16; ++p) {
    const int n = blockIdx.x * KPB + p * 16 + warp * 2 + (lane >> 4);
    const size_t row = (size_t)b * N + n;
    float acc = 0.f;
    if (n < N) {
#pragma unroll
      for (int i = 0; i < MAX_CHUNKS; ++i) {
        const int c = hl * 16 + i * 256;
        if (c < D) {
          const int4 w = *reinterpret_cast<const int4*>(k8 + row * D + c);
          const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
          for (int t = 0; t < 16; ++t) acc += qr[i][t] * (float)e[t];
        }
      }
    }
    for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (hl == 0 && n < N) out[row] = acc * (ks[row] * scale) + mask[row];
  }
}

}  // namespace ptr
}  // namespace vt

// q [B, D] f32; k8 [B, N, D] int8; ks, mask [B, N] f32; out [B, N] f32;
// D % 16 == 0 and D <= 1024; scale: 1 / sqrt(D) as the caller rounds it.
extern "C" int vt_ptr_scores_int8(const void* q, const void* k8, const void* ks, const void* mask,
                                  void* out, int batch, int n, int d, float scale, void* stream) {
  using namespace vt::ptr;
  if (d % 16 != 0 || d > 16 * 16 * MAX_CHUNKS || batch <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + KPB - 1) / KPB, batch);
  ptr_scores_int8_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)k8, (const float*)ks, (const float*)mask, (float*)out, n, d,
      scale);
  return (int)cudaGetLastError();
}
