// One greedy-decode step through every MMT layer in ONE launch.
//
// Replaces: vitxtgqa_tpu/ops/pallas_decode_step.py:fused_decode_step (the
// Pallas body _fused_step_kernel).  Per layer l, for each batch row:
//   q, k_t, v_t = bf16(x Wq^T + bq), bf16(x Wk^T + bk), bf16(x Wv^T + bv)
//   k8_t, k_sc = quantize(k_t)   (bit for bit ops/attention.quantize_kv:
//   v8_t, v_sc = quantize(v_t)    amax over the bf16 values, IEEE divide,
//                                 round half to even, clip to +-127)
//   attention of q over the packed int8 cache kv8 / kvs with the decoder
//   slots write_offset <= j < pos allowed, other masked keys at -1e30, and
//   slot pos = write_offset + step taken from (k8_t, k_sc) / (v8_t, v_sc)
//   in registers instead of the cache: its weight w_cur enters as
//   w_cur * (v8_t * v_sc) in f32, outside the bf16-rounded w * vs product;
//   x1 = LN1(x + ctx Wo^T + bo);  h = bf16(gelu_erf(bf16(x1) W1^T + b1))
//   x  = bf16(LN2(x1 + h W2^T + b2))      -> next layer's input
// Outputs: y (the last layer's x), the quantized rows row8 [L, B, 2*H*D]
// (K | V) and their scales rowsc [L, B, 2].  The caller commits the rows at
// write_offset + step after the launch; the kernel never reads that slot.
// Weights arrive in torch nn.Linear layout ([out, in], bf16, stacked over
// layers); biases and LayerNorm parameters in f32 [L, width].
//
// What bounds it on the H100: at batch 1-2 the weight reads, 14.2 MB per
// layer (42.5 MB per 3-layer step; ~13 us at 3.35 TB/s), plus 3.5 MB of
// int8 cache per row and layer; the FLOPs (2 per weight byte per row) are
// negligible.  The per-layer dependencies (QKV -> attention -> Wo + LN1 ->
// W1 + gelu -> W2 + LN2 -> next QKV) cost one grid-wide barrier each.
//
// Design: a persistent cooperative kernel, one or two blocks of 512
// threads per SM (sized by the occupancy query), with
// cooperative_groups::this_grid().sync() between the five phases of a
// layer.  Each GEMV phase spreads its output rows over every warp of the
// grid: a warp owns one row of the [out, in] weight, reads it as 16-byte
// loads (contiguous across the warp), and dots it with all batch rows held
// in shared memory.  The attention phase gives a block one (row, head)
// unit.  LayerNorms are recomputed by every block that needs their output
// (a B x 768 row each), which costs less than another barrier.  Scratch
// written inside the launch is read back with __ldcg (L2, not the
// non-coherent L1 path).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace vt {
namespace step {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int HD = 64;
constexpr int MAXB = 8;
constexpr int kMaxBlocksPerSM = 2;  // more blocks only make each barrier slower
constexpr float kFill = -1e30f;     // pallas_decode_step.py _NEG
constexpr int kAttnExtra = 3 * HD + NW * HD + 40;  // attention scratch beyond the scores

struct Params {
  const bf16* x;                                                 // [B, D]
  const bf16 *wq, *wk, *wv, *wo, *w1, *w2;                       // [L, out, in]
  const float *bq, *bk, *bv, *bo, *s1, *g1, *b1, *b2, *s2, *g2;  // [L, out]
  const int8_t* kv8;                                             // [L, B, Lp, 2*D]
  const float* kvs;                                              // [L, B, 2, Lp]
  const float* mask;                                             // [B, Lp]
  bf16* y;                                                       // [B, D]
  int8_t* row8;                                                  // [L, B, 2*D]
  float* rowsc;                                                  // [L, B, 2]
  bf16* qkv;                                                     // [B, 3*D] scratch
  bf16* ctx;                                                     // [B, D] scratch
  float* pre;                                                    // [B, D] pre-LN rows
  bf16* h;                                                       // [B, M] scratch
  int L, B, Lp, D, M, H, step, write_offset;
  float eps, scale;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ int8_t quantize(float x, float sc) {
  return (int8_t)fminf(fmaxf(rintf(x / sc), -127.f), 127.f);
}

// out[b][n] = act[b, :] . W[n, :] for n over the grid's warps; act is
// [B][K] f32 in shared memory; epi(b, n, acc) consumes each dot.
template <typename Row, typename Epi>
__device__ __forceinline__ void gemv(Row wrow, const float* act, int K, int N, int B, Epi epi) {
  const int lane = threadIdx.x % 32;
  const int nw = gridDim.x * NW;
  for (int n = blockIdx.x * NW + threadIdx.x / 32; n < N; n += nw) {
    const bf16* wr = wrow(n);
    float acc[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
#pragma unroll 4
    for (int k0 = lane * 8; k0 < K; k0 += 256) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(wr + k0));
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      float w[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) w[t] = __bfloat162float(e[t]);
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          const float4 a0 = *reinterpret_cast<const float4*>(act + b * K + k0);
          const float4 a1 = *reinterpret_cast<const float4*>(act + b * K + k0 + 4);
          acc[b] += a0.x * w[0] + a0.y * w[1] + a0.z * w[2] + a0.w * w[3] + a1.x * w[4] +
                    a1.y * w[5] + a1.z * w[6] + a1.w * w[7];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const float s = warp_sum(acc[b]);
        if (lane == 0) epi(b, n, s);
      }
    }
  }
}

// LayerNorm of the B rows of src (global, written in this launch) with the
// f32 scale / shift; a warp per row.  Each output is nullable: out_f32
// (shared) takes the f32 result, out_bf_f32 (shared) its bf16 rounding as
// f32, out_bf (global) the bf16 values.
__device__ void layer_norm_rows(const float* src, const float* gamma, const float* beta,
                                int B, int D, float eps, float* out_f32, float* out_bf_f32,
                                bf16* out_bf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int b = warp; b < B; b += NW) {
    const float* r = src + (size_t)b * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __ldcg(r + c);
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __ldcg(r + c) - mu;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / D + eps);
    for (int c = lane; c < D; c += 32) {
      const float y = (__ldcg(r + c) - mu) * inv * gamma[c] + beta[c];
      if (out_f32) out_f32[b * D + c] = y;
      if (out_bf_f32) out_bf_f32[b * D + c] = round_bf16(y);
      if (out_bf) out_bf[(size_t)b * D + c] = __float2bfloat16(y);
    }
  }
}

// Attention for one (batch row, head) unit of layer l; `sm` is shared
// scratch of kAttnExtra + Lp floats.
__device__ void attention_unit(const Params& p, int l, int b, int h, float* sm) {
  float* s = sm;                 // [Lp] scores, then weights
  float* qh = s + p.Lp;          // [HD] query of this head
  float* cur = qh + HD;          // [2 * HD] k8_t, v8_t of this head
  float* part = cur + 2 * HD;    // [NW * HD] per-warp partial outputs
  float* red = part + NW * HD;   // [32] reduction scratch
  float* scal = red + 32;        // k_sc, v_sc, w_cur
  const int tid = threadIdx.x, D = p.D;
  const bf16* qkv = p.qkv + (size_t)b * 3 * D;
  const int pos = p.write_offset + p.step;

  // the new row's scales from the amax over all heads (bf16 values)
  float ka = 0.f, va = 0.f;
  for (int c = tid; c < D; c += NT) {
    ka = fmaxf(ka, fabsf(__bfloat162float(__ldcg(qkv + D + c))));
    va = fmaxf(va, fabsf(__bfloat162float(__ldcg(qkv + 2 * D + c))));
  }
  ka = block_max(ka, red);
  va = block_max(va, red);
  const float k_sc = fmaxf(ka, 1e-6f) / 127.f;
  const float v_sc = fmaxf(va, 1e-6f) / 127.f;
  int8_t* r8 = p.row8 + ((size_t)l * p.B + b) * 2 * D;
  if (tid < HD) {
    const int c = h * HD + tid;
    qh[tid] = __bfloat162float(__ldcg(qkv + c));
    const int8_t k8 = quantize(__bfloat162float(__ldcg(qkv + D + c)), k_sc);
    const int8_t v8 = quantize(__bfloat162float(__ldcg(qkv + 2 * D + c)), v_sc);
    cur[tid] = (float)k8;
    cur[HD + tid] = (float)v8;
    r8[c] = k8;
    r8[D + c] = v8;
  }
  if (h == 0 && tid == 0) {
    p.rowsc[((size_t)l * p.B + b) * 2] = k_sc;
    p.rowsc[((size_t)l * p.B + b) * 2 + 1] = v_sc;
  }
  __syncthreads();

  const size_t cache0 = ((size_t)l * p.B + b) * p.Lp;
  const int8_t* kv = p.kv8 + cache0 * 2 * D;
  const float* ks = p.kvs + ((size_t)l * p.B + b) * 2 * p.Lp;
  const float* vs = ks + p.Lp;
  const float* mask = p.mask + (size_t)b * p.Lp;
  float lmax = -INFINITY;
  for (int j = tid; j < p.Lp; j += NT) {
    float sc;
    if (j == pos) {
      float acc = 0.f;
      for (int t = 0; t < HD; ++t) acc += qh[t] * cur[t];
      sc = acc * (k_sc * p.scale);
    } else if (mask[j] > 0.f || (j >= p.write_offset && j < pos)) {
      const int8_t* kr = kv + (size_t)j * 2 * D + h * HD;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 16) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(kr + c));
        const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int t = 0; t < 16; ++t) acc += qh[c + t] * (float)e[t];
      }
      sc = acc * (ks[j] * p.scale);
    } else {
      sc = kFill;
    }
    s[j] = sc;
    lmax = fmaxf(lmax, sc);
  }
  const float mx = block_max(lmax, red);
  float lsum = 0.f;
  for (int j = tid; j < p.Lp; j += NT) {
    const float e = expf(s[j] - mx);
    s[j] = e;
    lsum += e;
  }
  const float total = block_sum(lsum, red);
  for (int j = tid; j < p.Lp; j += NT) {
    const float w = s[j] / total;
    if (j == pos) {
      scal[2] = w;
      s[j] = 0.f;
    } else {
      s[j] = round_bf16(w * vs[j]);
    }
  }
  __syncthreads();

  // weights x V: a lane owns 16 channels of one key (one 16-byte load);
  // a warp covers 8 keys, the block 128 keys per pass; lanes that share
  // channels reduce by shuffles, the warps through shared memory
  const int lane = tid % 32, warp = tid / 32, chunk = lane % 4;
  float acc[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) acc[t] = 0.f;
  for (int j = warp * 8 + lane / 4; j < p.Lp; j += NT / 4) {
    const float w = s[j];
    if (w != 0.f) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(kv + (size_t)j * 2 * D + D + h * HD + chunk * 16));
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int t = 0; t < 16; ++t) acc[t] += w * (float)e[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 4);
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 8);
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int t = 0; t < 16; ++t) part[warp * HD + chunk * 16 + t] = acc[t];
  }
  __syncthreads();
  if (tid < HD) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) o += part[i * HD + tid];
    o += scal[2] * (cur[HD + tid] * v_sc);
    p.ctx[(size_t)b * D + h * HD + tid] = __float2bfloat16(o);
  }
  __syncthreads();  // the unit's scratch is reused by the next unit
}

__global__ void __launch_bounds__(NT, 1) fused_step_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, D = p.D, M = p.M;
  float* xs = smem;          // [B][D] layer input (bf16 values)
  float* x1 = xs + B * D;    // [B][D] LN1 output, f32
  float* act = x1 + B * D;   // [B][max(D, M)] GEMV input; attention scratch
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;

  for (int l = 0; l < p.L; ++l) {
    const size_t wDD = (size_t)l * D * D, wMD = (size_t)l * M * D;
    const size_t vD = (size_t)l * D, vM = (size_t)l * M;
    // A: the layer input, then the Q/K/V rows
    if (l == 0) {
      for (int i = tid; i < B * D; i += NT) xs[i] = __bfloat162float(p.x[i]);
    } else {
      layer_norm_rows(p.pre, p.s2 + vD - D, p.g2 + vD - D, B, D, p.eps, nullptr, xs, nullptr);
    }
    __syncthreads();
    gemv([&](int n) {
           const bf16* w = n < D ? p.wq : (n < 2 * D ? p.wk : p.wv);
           return w + wDD + (size_t)(n % D) * D;
         },
         xs, D, 3 * D, B, [&](int b, int n, float a) {
           const float* bias = n < D ? p.bq : (n < 2 * D ? p.bk : p.bv);
           p.qkv[(size_t)b * 3 * D + n] = __float2bfloat16(a + bias[vD + n % D]);
         });
    grid.sync();

    // B: quantize the new rows, attention over the cache
    for (int u = blockIdx.x; u < B * p.H; u += gridDim.x) attention_unit(p, l, u / p.H, u % p.H, act);
    grid.sync();

    // C: ctx Wo^T + bo + residual -> pre
    for (int i = tid; i < B * D; i += NT) act[i] = __bfloat162float(__ldcg(p.ctx + i));
    __syncthreads();
    gemv([&](int n) { return p.wo + wDD + (size_t)n * D; }, act, D, D, B,
         [&](int b, int n, float a) { p.pre[(size_t)b * D + n] = xs[b * D + n] + (a + p.bo[vD + n]); });
    grid.sync();

    // D: LN1 (in every block), then gelu(bf16(x1) W1^T + b1) -> h
    layer_norm_rows(p.pre, p.s1 + vD, p.g1 + vD, B, D, p.eps, x1, act, nullptr);
    __syncthreads();
    gemv([&](int n) { return p.w1 + wMD + (size_t)n * D; }, act, D, M, B,
         [&](int b, int n, float a) {
           p.h[(size_t)b * M + n] = __float2bfloat16(gelu_erf(a + p.b1[vM + n]));
         });
    grid.sync();

    // E: x1 + h W2^T + b2 -> pre (LN2 runs at the next layer's start)
    for (int i = tid; i < B * M; i += NT) act[i] = __bfloat162float(__ldcg(p.h + i));
    __syncthreads();
    gemv([&](int n) { return p.w2 + wMD + (size_t)n * M; }, act, M, D, B,
         [&](int b, int n, float a) { p.pre[(size_t)b * D + n] = x1[b * D + n] + (a + p.b2[vD + n]); });
    grid.sync();
  }
  if (blockIdx.x == 0) {
    const size_t vD = (size_t)(p.L - 1) * D;
    layer_norm_rows(p.pre, p.s2 + vD, p.g2 + vD, B, D, p.eps, nullptr, nullptr, p.y);
  }
}

}  // namespace step
}  // namespace vt

// ptrs, in order: x, wq, bq, wk, bk, wv, bv, wo, bo, s1, g1, w1, b1, w2,
// b2, s2, g2, kv8, kvs, mask, y, row8, rowsc, qkv, ctx, pre, h (27).
extern "C" int vt_fused_decode_step(void* const* ptrs, int n_layers, int batch, int cache_len,
                                    int d, int m, int num_heads, int step, int write_offset,
                                    float eps, void* stream) {
  using namespace vt::step;
  using vt::bf16;
  if (d != num_heads * HD || d % 256 || m % 256 || batch < 1 || batch > MAXB ||
      write_offset + step >= cache_len)
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
  p.ctx = (bf16*)ptrs[i++];
  p.pre = (float*)ptrs[i++];
  p.h = (bf16*)ptrs[i++];
  p.L = n_layers;
  p.B = batch;
  p.Lp = cache_len;
  p.D = d;
  p.M = m;
  p.H = num_heads;
  p.step = step;
  p.write_offset = write_offset;
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)HD);

  const int act = batch * (m > d ? m : d);
  const int attn = cache_len + kAttnExtra;
  const int smem = (2 * batch * d + (act > attn ? act : attn)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_step_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM) * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)fused_step_kernel, grid, NT, args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
