// Split-head attention with an additive bias tensor (eval).
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:fused_attention (the
// Pallas body _kernel), which the split-head mha takes for an array bias
// or none at >= 256 keys, more than one query row and no dropout: the
// ViT's self-attention (vitxtgqa_tpu/models/vit.py, mha(q, k, v) with no
// bias) once its token count reaches 256.  Computes per (batch b, head h)
//   out = softmax(Q K^T / sqrt(64) + bias) V
// on bf16 q [B, H, Lq, 64], k / v [B, H, Lk, 64] given by element strides
// (the split-head views of a [B, L, H*64] projection need no copy), with an
// f32 bias broadcast over the query rows ([B, 1, 1, Lk]: row stride 0) or
// per row ([B, 1, Lq, Lk]), or none.  Scores are f32 (s * scale + bias,
// as the Pallas kernel adds its bias after the scale); keys past Lk take
// no weight (the Pallas kernel pads them with -1e9); the probabilities are
// rounded to bf16 for the P V product, as the Pallas kernel feeds bf16
// weights to its second matmul; out bf16, written through its own strides.
//
// What bounds it on the H100: at [8, 12, 1152, 64] the two products are
// 4 * B * H * Lq * Lk * 64 = 32.6 GFLOP against 57 MB of q/k/v/out and
// the key-mask bias: ~570 FLOP per byte, above the bf16 ridge (~295), so
// the tensor cores bound it (0.033 ms at 989 TFLOP/s); with a per-row
// bias its [B, Lq, Lk] f32 read (42 MB) is of the same order.
//
// Design: the TPU kernel holds a whole head's K and V next to a 128-query
// block (295 KB at 1,152 keys, more than an SM's shared memory).  Here one
// block of 4 warps per (64-row q tile, head, batch) walks the keys in
// 64-wide tiles with an online softmax, the loop of the merged-head flash
// forward (flash_attention.cu) with the mask replaced by the bias tile:
// S = Q K^T through nvcuda::wmma bf16 m16n16k16 with f32 accumulate, a
// lane on four consecutive keys of two rows at a time, the row max / sum
// in shared memory, O += P V into an f32 accumulator in shared memory.  A
// row whose running max is still -inf (a bias of -inf on every key seen so
// far) takes its exponentials against 0, so it gets no NaN.  Loads are
// synchronous 16-byte copies; cp.async/TMA double buffering and wgmma are
// later work.
#include "flash_attention.cuh"

namespace vt {
namespace flash {

using namespace nvcuda;

// element strides: q, k, v, out as (batch, head, row); the bias as
// (batch, row), its row stride 0 when it broadcasts over the query rows
struct Strides {
  long long q[3], k[3], v[3], o[3], bias[2];
};

struct BiasSmem {
  bf16 q[BQ * LDB];
  bf16 k[BK * LDB];
  bf16 v[BK * LDB];
  bf16 p[BQ * LDP];
  float s[BQ * LDS];
  float o[BQ * LDO];
  float m[BQ];
  float l[BQ];
};

__global__ void __launch_bounds__(NT)
bias_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ out, int Lq, int Lk, float scale, Strides st) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BiasSmem& sm = *reinterpret_cast<BiasSmem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = lane >> 4;       // which of the warp's two rows
  const int c0 = (lane & 15) * 4;   // this lane's four keys / output columns
  const size_t qb = (size_t)(b * st.q[0] + h * st.q[1]);
  const size_t kb = (size_t)(b * st.k[0] + h * st.k[1]);
  const size_t vb = (size_t)(b * st.v[0] + h * st.v[1]);
  const float* brow = bias == nullptr ? nullptr : bias + b * st.bias[0];

  load_tile(sm.q, q, qb, q0, Lq, st.q[2]);
  for (int i = tid; i < BQ * LDO; i += NT) sm.o[i] = 0.f;
  if (tid < BQ) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_tile(sm.k, k, kb, k0, Lk, st.k[2]);
    load_tile(sm.v, v, vb, k0, Lk, st.v[2]);
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &sm.q[(warp * 16) * LDB + kk * 16], LDB);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, &sm.k[(j * 16) * LDB + kk * 16], LDB);
          wmma::mma_sync(acc[j], a, kf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(&sm.s[(warp * 16) * LDS + j * 16], acc[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, two rows at a time; a lane owns keys c0 .. c0 + 3
    for (int rr = 0; rr < 16; rr += 2) {
      const int row = warp * 16 + rr + half;
      const int qrow = q0 + row;
      const float4 s4 = *reinterpret_cast<const float4*>(&sm.s[row * LDS + c0]);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const float* bp = (brow != nullptr && qrow < Lq) ? brow + qrow * st.bias[1] : nullptr;
      float x[4];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = k0 + c0 + t;
        x[t] = -INFINITY;  // past the last key: no weight at all
        if (col < Lk) x[t] = sv[t] * scale + (bp != nullptr ? bp[col] : 0.f);
        mx = fmaxf(mx, x[t]);
      }
      mx = half_max(mx);
      const float m_old = sm.m[row];
      const float m_new = fmaxf(m_old, mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m_old - m_ref);
      float p[4], psum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        p[t] = expf(x[t] - m_ref);
        psum += p[t];
      }
      psum = half_sum(psum);
      __align__(8) bf16 pb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) pb[t] = __float2bfloat16(p[t]);
      *reinterpret_cast<uint2*>(&sm.p[row * LDP + c0]) = *reinterpret_cast<const uint2*>(pb);
      float4* o4 = reinterpret_cast<float4*>(&sm.o[row * LDO + c0]);
      float4 ov = *o4;
      ov.x *= corr;
      ov.y *= corr;
      ov.z *= corr;
      ov.w *= corr;
      *o4 = ov;
      __syncwarp();
      if ((lane & 15) == 0) {
        sm.m[row] = m_new;
        sm.l[row] = sm.l[row] * corr + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's rows
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, &sm.o[(warp * 16) * LDO + j * 16], LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, &sm.p[(warp * 16) * LDP + kk * 16], LDP);
        wmma::load_matrix_sync(vf, &sm.v[(kk * 16) * LDB + j * 16], LDB);
        wmma::mma_sync(oacc, pa, vf, oacc);
      }
      wmma::store_matrix_sync(&sm.o[(warp * 16) * LDO + j * 16], oacc, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  const size_t ob = (size_t)(b * st.o[0] + h * st.o[1]);
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    if (q0 + r < Lq)
      out[ob + (size_t)((q0 + r) * st.o[2]) + c] = __float2bfloat16(sm.o[r * LDO + c] / sm.l[r]);
  }
}

}  // namespace flash
}  // namespace vt

// q [B, H, Lq, 64], k / v [B, H, Lk, 64], out [B, H, Lq, 64] bf16, each
// through its (batch, head, row) element strides, the last dimension
// contiguous and every row 16-byte aligned; bias f32 through its (batch,
// row) strides (row stride 0: one row for all queries), or null.
// strides: 14 int64 in the order of vt::flash::Strides.
extern "C" int vt_fused_attention(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, const void* strides, int batch, int num_heads,
                                  int len_q, int len_k, int head_dim, void* stream) {
  using namespace vt::flash;
  if (head_dim != HD || batch <= 0 || num_heads <= 0 || len_q <= 0 || len_k <= 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  const long long* s = (const long long*)strides;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  st.bias[0] = s[12];
  st.bias[1] = s[13];
  const int smem = (int)sizeof(BiasSmem);
  cudaError_t err = cudaFuncSetAttribute(bias_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((len_q + BQ - 1) / BQ, num_heads, batch);
  bias_attention_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const vt::bf16*)q, (const vt::bf16*)k, (const vt::bf16*)v, (const float*)bias,
      (vt::bf16*)out, len_q, len_k, 1.0f / sqrtf((float)head_dim), st);
  return (int)cudaGetLastError();
}
