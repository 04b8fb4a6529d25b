// Merged-head flash attention, forward only.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged
// (the Pallas body _flash_merged_kernel).  Computes, per head h,
// softmax(Q_h K_h^T / sqrt(d) + mask) V_h on merged [B, L, H*D] bf16
// operands, with the mask built in-kernel from key_mask [B, L] plus a
// trailing causal decoder block of dec_len rows (pallas_attention.py
// _allowed): query row r may attend key c when key_mask[c] > 0, or when
// both lie in the decoder block and c <= r.  Masked scores take -1e9.
//
// What bounds it on the H100: at the serving shape (B=8, L=1152, H=12,
// D=64) one call is 4*B*L*L*H*D = 32.6 GFLOP against 4*B*L*H*D*2 bytes =
// 57 MB of q/k/v/out, i.e. ~570 FLOP/byte, above the card's ~295 bf16
// ridge: the tensor cores bound it, and the [L, L] score matrix must never
// reach device memory (the unfused form writes 8*12*1152*1152*4 B =
// 509 MB of f32 scores per call).
//
// Design: one block of 4 warps per (64-row q tile, head, batch); heads are
// read from the merged layout with a row stride of H*D, so no split/merge
// copies.  The block walks the keys in 64-wide tiles with an online
// softmax: S = Q K^T through nvcuda::wmma bf16 m16n16k16 with f32
// accumulate, the row max / sum kept in shared memory, the probabilities
// rounded to bf16 for the P V product (as the Pallas kernel feeds bf16
// weights to its second matmul), and the f32 output accumulator kept in
// shared memory and rescaled per row.  Scores and probabilities live only
// in shared memory.  Loads are synchronous 16-byte copies; cp.async/TMA
// double buffering and wgmma are later work.
#include "common.cuh"

namespace vt {
namespace flash {

using namespace nvcuda;

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // query rows per block: 4 warps x 16 rows
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // threads per block
constexpr int LDB = HD + 8;   // bf16 row stride of the q/k/v tiles
constexpr int LDP = BK + 8;   // bf16 row stride of the probability tile
constexpr int LDS = BK + 4;   // f32 row stride of the score tile
constexpr int LDO = HD + 4;   // f32 row stride of the output accumulator

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
                 bf16* __restrict__ out, int L, int H, int dec_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_stride = H * HD;
  const size_t base = (size_t)b * L * row_stride + (size_t)h * HD;
  const int l_enc = L - dec_len;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * (HD / 8); i += NT) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 val = zero;
    if (q0 + r < L)
      val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&sm.q[r * LDB + c]) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NT) sm.o[i] = 0.f;
  if (tid < BQ) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < L; k0 += BK) {
    for (int i = tid; i < BK * (HD / 8); i += NT) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < L) {
        const size_t off = base + (size_t)(k0 + r) * row_stride + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sm.k[r * LDB + c]) = kv;
      *reinterpret_cast<uint4*>(&sm.v[r * LDB + c]) = vv;
    }
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

    // online softmax, one row at a time; lane owns columns lane, lane + 32
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qrow = q0 + row;
      float sv[2];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int col = k0 + c;
        float x = -INFINITY;  // past the sequence end: no weight at all
        if (col < L) {
          bool ok = sm.kmask[c] > 0.f;
          if (dec_len > 0 && col >= l_enc && qrow >= l_enc && col <= qrow) ok = true;
          x = ok ? sm.s[row * LDS + c] * scale : kNeg;
        }
        sv[t] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = sm.m[row];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      const float p0 = expf(sv[0] - m_new);
      const float p1 = expf(sv[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      sm.p[row * LDP + lane] = __float2bfloat16(p0);
      sm.p[row * LDP + lane + 32] = __float2bfloat16(p1);
      sm.o[row * LDO + lane] *= corr;
      sm.o[row * LDO + lane + 32] *= corr;
      if (lane == 0) {
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
      out[base + (size_t)(q0 + r) * row_stride + c] = __float2bfloat16(sm.o[r * LDO + c] / sm.l[r]);
  }
}

}  // namespace flash
}  // namespace vt

extern "C" int vt_flash_attention_merged(const void* q, const void* k, const void* v,
                                         const void* key_mask, void* out, int batch,
                                         int seq_len, int num_heads, int head_dim,
                                         int dec_len, void* stream) {
  using namespace vt::flash;
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_len + BQ - 1) / BQ, num_heads, batch);
  flash_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const vt::bf16*)q, (const vt::bf16*)k, (const vt::bf16*)v, (const float*)key_mask,
      (vt::bf16*)out, seq_len, num_heads, dec_len, 1.0f / sqrtf((float)head_dim));
  return (int)cudaGetLastError();
}
