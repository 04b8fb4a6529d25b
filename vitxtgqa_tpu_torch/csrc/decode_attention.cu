// One greedy-decode step of attention over the unified KV cache, int8 or
// bf16.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:decode_attention_int8
// (the Pallas body _decode_int8_kernel) and pallas_attention.py:
// decode_attention (_decode_kernel).  One query row per batch, in merged
// [B, 1, H*D] layout, over k/v [B, L, H*D] (int8 with per-token f32 scales
// ks/vs [B, L] in the ops/attention.quantize_kv layout, or bf16 without
// scales).  The query may attend key j when key_mask[j] > 0 (a valid
// encoder key) or when write_offset <= j <= write_offset + step (decoder
// slots written so far); other scores take -1e9.  As the Pallas kernels:
//   int8: s_j = (q . k8_j) * (ks_j / sqrt(D));  w_j = bf16(softmax(s)_j * vs_j)
//   bf16: s_j = (q . k_j) / sqrt(D);            w_j = bf16(softmax(s)_j)
//   out = sum_j w_j v_j, f32 accumulation.
//
// What bounds it on the H100: one call at the serving shape (B=8,
// L=1152, H*D=768) reads 2*B*L*H*D bytes of cache (14.2 MB int8, 28.3 MB
// bf16) for 28 MFLOP: 1-2 FLOP/byte, deep under the ridge, so device-memory
// bandwidth bounds it (4.2 / 8.5 us at 3.35 TB/s).  In practice the grid
// bounds it first: B*H blocks (96 at batch 8, 12 at batch 1) cannot keep
// enough loads in flight to approach the card's bandwidth.
//
// Design: one template for both cache types; one block of 128 threads per
// (head, batch).  Scores: a thread per key reads that key's 64 values of
// this head as 16-byte loads (4 for int8, 8 for bf16) and converts them in
// registers; the scores live in shared memory.  Block reductions give the
// softmax max and sum.  Weights: a thread per (d, half of the keys) walks
// the keys so that neighbouring threads read neighbouring elements of a
// cache row.  Splitting the keys across blocks (a split-K softmax) is the
// next step for both.
#include "common.cuh"

namespace vt {
namespace decode {

constexpr int HD = 64;
constexpr int NT = 128;

__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// T = int8_t: ks / vs are the per-token scales; T = bf16: both null
template <typename T>
__global__ void __launch_bounds__(NT)
decode_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
              const float* __restrict__ ks, const T* __restrict__ v,
              const float* __restrict__ vs, const float* __restrict__ key_mask,
              bf16* __restrict__ out, int L, int H, int step, int write_offset, float scale) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float sh[];
  float* s = sh;               // [L] scores, then weights
  float* qs = s + L;           // [HD] query of this head
  float* part = qs + HD;       // [2 * HD] partial outputs
  float* red = part + 2 * HD;  // [32] reduction scratch

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int row_stride = H * HD;
  const size_t row0 = (size_t)b * L;

  if (tid < HD) qs[tid] = __bfloat162float(q[(size_t)b * row_stride + h * HD + tid]);
  __syncthreads();

  float lmax = -INFINITY;
  for (int j = tid; j < L; j += NT) {
    const T* kr = k + (row0 + j) * row_stride + h * HD;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < HD; c += kPer) {
      const int4 w = *reinterpret_cast<const int4*>(kr + c);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int t = 0; t < kPer; ++t) acc += qs[c + t] * to_float(e[t]);
    }
    const bool ok = key_mask[row0 + j] > 0.f || (j >= write_offset && j <= write_offset + step);
    const float sc = ks ? acc * (ks[row0 + j] * scale) : acc * scale;
    s[j] = ok ? sc : kNeg;
    lmax = fmaxf(lmax, s[j]);
  }
  const float mx = block_max(lmax, red);

  float lsum = 0.f;
  for (int j = tid; j < L; j += NT) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    lsum += e;
  }
  const float total = block_sum(lsum, red);
  for (int j = tid; j < L; j += NT) {
    const float p = s[j] / total;
    s[j] = round_bf16(vs ? p * vs[row0 + j] : p);
  }
  __syncthreads();

  const int d = tid % HD, half = tid / HD;
  float acc = 0.f;
  for (int j = half; j < L; j += NT / HD)
    acc += s[j] * to_float(v[(row0 + j) * row_stride + h * HD + d]);
  part[half * HD + d] = acc;
  __syncthreads();
  if (tid < HD) out[(size_t)b * row_stride + h * HD + tid] = __float2bfloat16(part[tid] + part[HD + tid]);
}

template <typename T>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* key_mask, void* out, int batch, int cache_len, int num_heads,
           int head_dim, int step, int write_offset, void* stream) {
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  const int smem = (cache_len + HD + 2 * HD + 32) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_heads, batch);
  decode_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const T*)k, (const float*)ks, (const T*)v, (const float*)vs,
      (const float*)key_mask, (bf16*)out, cache_len, num_heads, step, write_offset,
      1.0f / sqrtf((float)head_dim));
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace vt

extern "C" int vt_decode_attention_int8(const void* q, const void* k8, const void* ks,
                                        const void* v8, const void* vs, const void* key_mask,
                                        void* out, int batch, int cache_len, int num_heads,
                                        int head_dim, int step, int write_offset, void* stream) {
  return vt::decode::launch<int8_t>(q, k8, ks, v8, vs, key_mask, out, batch, cache_len,
                                    num_heads, head_dim, step, write_offset, stream);
}

extern "C" int vt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* key_mask, void* out, int batch, int cache_len,
                                   int num_heads, int head_dim, int step, int write_offset,
                                   void* stream) {
  return vt::decode::launch<vt::bf16>(q, k, nullptr, v, nullptr, key_mask, out, batch,
                                      cache_len, num_heads, head_dim, step, write_offset,
                                      stream);
}
