// Greedy-decode epilogue of one step in ONE launch: classifier scores,
// OcrPtrNet copy scores, argmax and the next step's decoder-slot embedding.
//
// Replaces: vitxtgqa_tpu/ops/pallas_decode_step.py:fused_epilogue (the
// Pallas body _fused_epilogue_kernel).  Per batch row, with y the decode
// step's output (bf16, taken in f32):
//   fixed = y cls_w^T + cls_b                      [Vp]   (pad lanes -1e30)
//   q     = y ptr_w^T + ptr_b                      [QK]
//   dyn_n = (q . keys_n) * qk_scale + mask_n       [N]    (raw 0/1 mask ADDED)
//   scores = [fixed | dyn];  idx = argmax(scores), ties to the lowest index
//   next  = bf16(row + bf16(emb_rows[2 * min(step + 1, dec_len - 1) + is_ocr]))
// where row is answer-table row idx, or OCR-table row idx - Vp when idx >= Vp.
// cls_w [Vp, D] and ptr_w [QK, D] arrive in torch nn.Linear layout, f32 (the
// classifier and the pointer net stay float32); keys [B, N, QK] f32; the
// answer table [Vp, D] and the OCR table [B, N, D] in bf16.
//
// What bounds it on the H100: the f32 classifier weight, 15.7 MB per step
// at Vp = 5120, D = 768 (~5 us at 3.35 TB/s), then 2.4 MB of pointer weight
// and 2.9 MB of keys per batch row.  FLOPs are 2 per 4 bytes read.
//
// Design: a persistent cooperative kernel in three phases separated by
// grid.sync(): (1) a warp per output row of [cls_w | ptr_w] dots it with
// every batch row of y (float4 loads, contiguous across the warp);
// (2) a warp per (row, OCR slot) for the copy scores; (3) a block per batch
// row reduces (max, index) pairs over all Vp + N scores and gathers the
// embedding.  Scratch written in the launch is read back with __ldcg.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace vt {
namespace epilogue {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAXB = 8;
constexpr int kMaxBlocksPerSM = 2;

struct Params {
  const bf16* y;        // [B, D]
  const float* cls_w;   // [Vp, D]
  const float* cls_b;   // [Vp]
  const float* ptr_w;   // [QK, D]
  const float* ptr_b;   // [QK]
  const float* keys;    // [B, N, QK]
  const float* mask;    // [B, N]
  const bf16* ans;      // [Vp, D]
  const bf16* ocr;      // [B, N, D]
  const float* emb;     // [S2, D]
  float* scores;        // [B, Vp + N]
  int* tok;             // [B]
  bf16* emb_out;        // [B, D]
  float* q;             // [B, QK] scratch
  int B, D, Vp, N, QK, S2, step, dec_len;
  float qk_scale;
};

__global__ void __launch_bounds__(NT) fused_epilogue_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, D = p.D, QK = p.QK, W = p.Vp + p.N;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gw = blockIdx.x * NW + warp, nw = gridDim.x * NW;
  cg::grid_group grid = cg::this_grid();
  float* ys = smem;  // [B][D], then q [B][QK]

  // 1. classifier rows and pointer-query rows
  for (int i = tid; i < B * D; i += NT) ys[i] = __bfloat162float(p.y[i]);
  __syncthreads();
  for (int n = gw; n < p.Vp + QK; n += nw) {
    const float* wr = n < p.Vp ? p.cls_w + (size_t)n * D : p.ptr_w + (size_t)(n - p.Vp) * D;
    float acc[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
    for (int k0 = lane * 4; k0 < D; k0 += 128) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wr + k0));
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          const float4 a = *reinterpret_cast<const float4*>(ys + b * D + k0);
          acc[b] += a.x * w.x + a.y * w.y + a.z * w.z + a.w * w.w;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const float s = warp_sum(acc[b]);
        if (lane == 0) {
          if (n < p.Vp) p.scores[(size_t)b * W + n] = s + p.cls_b[n];
          else p.q[(size_t)b * QK + n - p.Vp] = s + p.ptr_b[n - p.Vp];
        }
      }
    }
  }
  grid.sync();

  // 2. copy scores: a warp per (row, OCR slot)
  float* qs = smem;
  for (int i = tid; i < B * QK; i += NT) qs[i] = __ldcg(p.q + i);
  __syncthreads();
  for (int u = gw; u < B * p.N; u += nw) {
    const int b = u / p.N, n = u % p.N;
    const float* kr = p.keys + ((size_t)b * p.N + n) * QK;
    float acc = 0.f;
    for (int k0 = lane * 4; k0 < QK; k0 += 128) {
      const float4 k = __ldg(reinterpret_cast<const float4*>(kr + k0));
      const float4 a = *reinterpret_cast<const float4*>(qs + b * QK + k0);
      acc += a.x * k.x + a.y * k.y + a.z * k.z + a.w * k.w;
    }
    acc = warp_sum(acc);
    if (lane == 0) p.scores[(size_t)b * W + p.Vp + n] = acc * p.qk_scale + p.mask[(size_t)b * p.N + n];
  }
  grid.sync();

  // 3. argmax (ties to the lowest index) and the next embedding
  __shared__ float rv[NW];
  __shared__ int ri[NW];
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const float* row = p.scores + (size_t)b * W;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < W; j += NT) {
      const float v = __ldcg(row + j);
      if (v > bv) {  // j increases, so a tie keeps the lower index
        bv = v;
        bi = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      rv[warp] = bv;
      ri[warp] = bi;
    }
    __syncthreads();
    float mv = rv[0];
    int idx = ri[0];
    for (int w = 1; w < NW; ++w) {
      if (rv[w] > mv || (rv[w] == mv && ri[w] < idx)) {
        mv = rv[w];
        idx = ri[w];
      }
    }
    if (tid == 0) p.tok[b] = idx;
    const bool is_ocr = idx >= p.Vp;
    const bf16* src = is_ocr ? p.ocr + ((size_t)b * p.N + (idx - p.Vp)) * D : p.ans + (size_t)idx * D;
    const int t_next = p.step + 1 < p.dec_len - 1 ? p.step + 1 : p.dec_len - 1;
    const float* er = p.emb + (size_t)(2 * t_next + (is_ocr ? 1 : 0)) * D;
    for (int c = tid; c < D; c += NT)
      p.emb_out[(size_t)b * D + c] = __float2bfloat16(__bfloat162float(src[c]) + round_bf16(er[c]));
    __syncthreads();  // rv / ri are reused by the next row
  }
}

}  // namespace epilogue
}  // namespace vt

// ptrs, in order: y, cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans, ocr, emb,
// scores, tok, emb_out, q (14).
extern "C" int vt_fused_epilogue(void* const* ptrs, int batch, int d, int vp, int n, int qk,
                                 int s2, int step, int dec_len, float qk_scale, void* stream) {
  using namespace vt::epilogue;
  using vt::bf16;
  if (batch < 1 || batch > MAXB || d % 128 || qk % 128 || s2 < 2 * dec_len || dec_len < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  int i = 0;
  p.y = (const bf16*)ptrs[i++];
  p.cls_w = (const float*)ptrs[i++];
  p.cls_b = (const float*)ptrs[i++];
  p.ptr_w = (const float*)ptrs[i++];
  p.ptr_b = (const float*)ptrs[i++];
  p.keys = (const float*)ptrs[i++];
  p.mask = (const float*)ptrs[i++];
  p.ans = (const bf16*)ptrs[i++];
  p.ocr = (const bf16*)ptrs[i++];
  p.emb = (const float*)ptrs[i++];
  p.scores = (float*)ptrs[i++];
  p.tok = (int*)ptrs[i++];
  p.emb_out = (bf16*)ptrs[i++];
  p.q = (float*)ptrs[i++];
  p.B = batch;
  p.D = d;
  p.Vp = vp;
  p.N = n;
  p.QK = qk;
  p.S2 = s2;
  p.step = step;
  p.dec_len = dec_len;
  p.qk_scale = qk_scale;

  const int smem = batch * (d > qk ? d : qk) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_epilogue_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_epilogue_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM) * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_epilogue_kernel, grid, NT, args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
