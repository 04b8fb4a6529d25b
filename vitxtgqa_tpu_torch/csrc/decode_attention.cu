// One greedy-decode step of attention over the unified int8 KV cache.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:decode_attention_int8
// (the Pallas body _decode_int8_kernel).  One query row per batch, in
// merged [B, 1, H*D] layout, over k8/v8 [B, L, H*D] int8 with per-token f32
// scales ks/vs [B, L] (ops/attention.quantize_kv layout).  The query may
// attend key j when key_mask[j] > 0 (a valid encoder key) or when
// write_offset <= j <= write_offset + step (decoder slots written so far);
// other scores take -1e9.  The dequantization folds into the scores and the
// weights exactly as pallas_attention.py:984-989 does:
//   s_j = (q . k8_j) * (ks_j / sqrt(D));  w_j = bf16(softmax(s)_j * vs_j);
//   out = sum_j w_j v8_j.
//
// What bounds it on the H100: one call at the serving shape (B=8,
// L=1152, H*D=768) reads 2*B*L*H*D = 14.2 MB of int8 cache for 28 MFLOP:
// 2 FLOP/byte, deep under the ridge, so device-memory bandwidth bounds it
// (4.2 us at 3.35 TB/s).
//
// Design: one block of 128 threads per (head, batch).  Scores: a thread
// per key reads that key's 64 int8 values of this head as four 16-byte
// loads and converts them in registers; the scores live in shared memory.
// Block reductions give the softmax max and sum.  Weights: a thread per
// (d, half of the keys) walks the keys so that neighbouring threads read
// neighbouring bytes of a cache row.  B*H = 96 blocks leave part of the
// card idle at batch 8; splitting the keys across blocks (a split-K
// softmax) is later work.
#include "common.cuh"

namespace vt {
namespace decode {

constexpr int HD = 64;
constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
decode_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k8,
                   const float* __restrict__ ks, const int8_t* __restrict__ v8,
                   const float* __restrict__ vs, const float* __restrict__ key_mask,
                   bf16* __restrict__ out, int L, int H, int step, int write_offset,
                   float scale) {
  extern __shared__ float sh[];
  float* s = sh;             // [L] scores, then weights
  float* qs = s + L;         // [HD] query of this head
  float* part = qs + HD;     // [2 * HD] partial outputs
  float* red = part + 2 * HD;  // [32] reduction scratch

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int row_stride = H * HD;
  const size_t row0 = (size_t)b * L;

  if (tid < HD) qs[tid] = __bfloat162float(q[(size_t)b * row_stride + h * HD + tid]);
  __syncthreads();

  float lmax = -INFINITY;
  for (int j = tid; j < L; j += NT) {
    const int8_t* kr = k8 + (row0 + j) * row_stride + h * HD;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < HD; c += 16) {
      const int4 w = *reinterpret_cast<const int4*>(kr + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int t = 0; t < 16; ++t) acc += qs[c + t] * (float)e[t];
    }
    const bool ok = key_mask[row0 + j] > 0.f || (j >= write_offset && j <= write_offset + step);
    const float sc = ok ? acc * (ks[row0 + j] * scale) : kNeg;
    s[j] = sc;
    lmax = fmaxf(lmax, sc);
  }
  const float mx = block_max(lmax, red);

  float lsum = 0.f;
  for (int j = tid; j < L; j += NT) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    lsum += e;
  }
  const float total = block_sum(lsum, red);
  for (int j = tid; j < L; j += NT) s[j] = round_bf16((s[j] / total) * vs[row0 + j]);
  __syncthreads();

  const int d = tid % HD, half = tid / HD;
  float acc = 0.f;
  for (int j = half; j < L; j += NT / HD)
    acc += s[j] * (float)v8[(row0 + j) * row_stride + h * HD + d];
  part[half * HD + d] = acc;
  __syncthreads();
  if (tid < HD) out[(size_t)b * row_stride + h * HD + tid] = __float2bfloat16(part[tid] + part[HD + tid]);
}

}  // namespace decode
}  // namespace vt

extern "C" int vt_decode_attention_int8(const void* q, const void* k8, const void* ks,
                                        const void* v8, const void* vs, const void* key_mask,
                                        void* out, int batch, int cache_len, int num_heads,
                                        int head_dim, int step, int write_offset, void* stream) {
  using namespace vt::decode;
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  const int smem = (cache_len + HD + 2 * HD + 32) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_heads, batch);
  decode_int8_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const vt::bf16*)q, (const int8_t*)k8, (const float*)ks, (const int8_t*)v8,
      (const float*)vs, (const float*)key_mask, (vt::bf16*)out, cache_len, num_heads, step,
      write_offset, 1.0f / sqrtf((float)head_dim));
  return (int)cudaGetLastError();
}
