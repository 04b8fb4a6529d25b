// Merged-head flash attention, forward, with optional in-kernel dropout of
// the attention probabilities and the row log-sum-exp for the backward.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged
// (the Pallas body _flash_merged_kernel / _merged_heads_attend).  Computes,
// per head h, softmax(Q_h K_h^T / sqrt(d) + mask) V_h on merged [B, L, H*D]
// bf16 operands, with the mask built in-kernel from key_mask [B, L] plus a
// trailing causal decoder block of dec_len rows (pallas_attention.py
// _allowed): query row r may attend key c when key_mask[c] > 0, or when
// both lie in the decoder block and c <= r.  Masked scores take -1e9.
// Training (rate > 0): the normalised probabilities are dropped where the
// Philox bits of element (b, h, r, c) fall below the threshold
// (philox.cuh) and the kept ones divided by 1 - rate, as
// _merged_heads_attend does; lse [B, H, L] f32 receives m + log(l).
//
// What bounds it on the H100: at the training shape (B=48, L=1152, H=12,
// D=64) one call is 4*B*L*L*H*D = 196 GFLOP against 4*B*L*H*D*2 bytes =
// 340 MB of q/k/v/out, i.e. ~575 FLOP/byte, above the card's ~295 bf16
// ridge: the tensor cores bound it, and the [L, L] score matrix must never
// reach device memory.  With dropout every probability also costs a
// quarter of a Philox4x32-10 evaluation (four keys per evaluation, ~30
// integer instructions each), which the integer units do beside the
// tensor cores.
//
// Design: one block of 4 warps per (64-row q tile, head, batch); heads are
// read from the merged layout with a row stride of H*D, so no split/merge
// copies.  The block walks the keys in 64-wide tiles with an online
// softmax: S = Q K^T through nvcuda::wmma bf16 m16n16k16 with f32
// accumulate; each warp then handles two rows at a time, a lane owning four
// consecutive keys (one Philox evaluation gives their four keep bits); the
// row max / sum live in shared memory; the kept probabilities are rounded
// to bf16 for the P V product (as the Pallas kernel feeds bf16 weights to
// its second matmul) into an f32 accumulator in shared memory, rescaled per
// row.  The row sum l counts the dropped entries too; only the numerator
// skips them.  Loads are synchronous 16-byte copies; cp.async/TMA double
// buffering and wgmma are later work.
#include "flash_attention.cuh"

namespace vt {
namespace flash {

using namespace nvcuda;

struct Smem {
  bf16 q[BQ * LDB];
  bf16 k[BK * LDB];
  bf16 v[BK * LDB];
  bf16 p[BQ * LDP];
  float s[BQ * LDS];
  float o[BQ * LDO];
  float m[BQ];
  float l[BQ];
  float kmask[BK];
};

__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ key_mask,
                 bf16* __restrict__ out, float* __restrict__ lse, int L, int H, int dec_len,
                 float scale, const int64_t* __restrict__ seed_ptr, uint32_t threshold,
                 float keep_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = lane >> 4;       // which of the warp's two rows
  const int c0 = (lane & 15) * 4;   // this lane's four keys / output columns
  const int row_stride = H * HD;
  const size_t base = (size_t)b * L * row_stride + (size_t)h * HD;
  const int l_enc = L - dec_len;
  const bool dropout = seed_ptr != nullptr;
  const uint32_t seed = dropout ? (uint32_t)(*seed_ptr) : 0u;

  load_tile(sm.q, q, base, q0, L, row_stride);
  for (int i = tid; i < BQ * LDO; i += NT) sm.o[i] = 0.f;
  if (tid < BQ) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < L; k0 += BK) {
    load_tile(sm.k, k, base, k0, L, row_stride);
    load_tile(sm.v, v, base, k0, L, row_stride);
    if (tid < BK) sm.kmask[tid] = (k0 + tid < L) ? key_mask[(size_t)b * L + k0 + tid] : 0.f;
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
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, &sm.k[(j * 16) * LDB + kk * 16], LDB);
          wmma::mma_sync(acc[j], a, kb, acc[j]);
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
      float x[4];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = k0 + c0 + t;
        x[t] = -INFINITY;  // past the sequence end: no weight at all
        if (col < L) x[t] = allowed(sm.kmask[c0 + t], qrow, col, l_enc, dec_len) ? sv[t] * scale : kNeg;
        mx = fmaxf(mx, x[t]);
      }
      mx = half_max(mx);
      const float m_old = sm.m[row];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      float p[4], psum = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        p[t] = expf(x[t] - m_new);
        psum += p[t];
      }
      psum = half_sum(psum);
      if (dropout) {
        bool keep[4];
        keep4(keep, seed, threshold, k0 + c0, qrow, h, b);
#pragma unroll
        for (int t = 0; t < 4; ++t) p[t] = keep[t] ? p[t] : 0.f;
      }
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
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, &sm.p[(warp * 16) * LDP + kk * 16], LDP);
        wmma::load_matrix_sync(vb, &sm.v[(kk * 16) * LDB + j * 16], LDB);
        wmma::mma_sync(oacc, pa, vb, oacc);
      }
      wmma::store_matrix_sync(&sm.o[(warp * 16) * LDO + j * 16], oacc, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    if (q0 + r < L)
      out[base + (size_t)(q0 + r) * row_stride + c] =
          __float2bfloat16(sm.o[r * LDO + c] / sm.l[r] * keep_scale);
  }
  if (lse != nullptr && tid < BQ && q0 + tid < L)
    lse[((size_t)b * H + h) * L + q0 + tid] = sm.m[tid] + logf(sm.l[tid]);
}

}  // namespace flash
}  // namespace vt

// q, k, v, out [B, L, H*64] bf16; key_mask [B, L] f32; lse [B, H, L] f32
// or null (eval); seed: int64 [1] on the device, or null for no dropout;
// threshold / keep_scale: the dropout keep test and 1 / (1 - rate).
extern "C" int vt_flash_attention_merged(const void* q, const void* k, const void* v,
                                         const void* key_mask, void* out, void* lse,
                                         const void* seed, int batch, int seq_len,
                                         int num_heads, int head_dim, int dec_len,
                                         unsigned int threshold, float keep_scale,
                                         void* stream) {
  using namespace vt::flash;
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_len + BQ - 1) / BQ, num_heads, batch);
  flash_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const vt::bf16*)q, (const vt::bf16*)k, (const vt::bf16*)v, (const float*)key_mask,
      (vt::bf16*)out, (float*)lse, seq_len, num_heads, dec_len,
      1.0f / sqrtf((float)head_dim), (const int64_t*)seed, (uint32_t)threshold, keep_scale);
  return (int)cudaGetLastError();
}
