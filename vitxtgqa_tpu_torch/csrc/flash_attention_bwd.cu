// Flash attention, backward: dq, dk and dv, with the attention-probs
// dropout regenerated exactly as the forward drew it.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:_flash_merged_bwd_impl
// (the Pallas body _flash_merged_bwd_kernel), and, as its split-head form
// (#10b), pallas_attention.py:_flash_bwd_impl (_flash_bwd_kernel): the
// operands read and written through their strides (flash_attention.cuh
// Geom), an Lq-row query shard at global row row_offset against Lk keys,
// and dk / dv returned in f32, the shard's partial sums that the
// sequence-parallel ranks add up before the cast (the TPU kernel's f32
// accumulator blocks, summed by shard_map's psum).  For each head, with
// P = exp(S * scale - lse) (the forward's mask, lse saved by the forward;
// for a row with no allowed key, whose lse is the -1e9 fill, P = 1 /
// round_up(Lk, 128) on every key, as the TPU kernels' padded keys have it),
// K_r = the forward's keep mask over 1 - rate (or 1 without dropout) and
// D_i = rowsum(dO * O):
//   dV = (P * K_r)^T dO
//   dS = P * (K_r * (dO V^T) - D_i)
//   dQ = dS K * scale,   dK = dS^T Q * scale
// in f32 accumulation from bf16 operands; dq comes back bf16, dk and dv
// bf16 (#1b) or f32 (#10b).
//
// What bounds it on the H100: per allowed (query row, key) pair of a head
// it does five products of 2 * 64 operations (S and dP = dO V^T
// recomputed, dV, dQ, dK), 2.5x the forward's.  A masked key tile is
// skipped, so only the allowed pairs count: at the training shape (B = 48,
// L = 1152) with the MMT mask of a synthetic batch, 446 of the 1152 keys
// of a row on average, that is 190 GFLOP (0.19 ms at 989 TFLOP/s), against
// 0.68 GB that must move (q, k, v, O, dO and the lse read; dq, dk, dv
// written; 0.20 ms at 3.35 TB/s): the bytes bind, by a hair
// (chip_smoke.py, flash_bwd_bound).
//
// #10b at the SP training shape (q [4, 12, 576, 64] against [4, 12, 1152,
// 64]) does half of #1b's work per rank and writes dk / dv in f32.
//
// Design: the TPU kernel walks the q-blocks in order and accumulates dk/dv
// in resident output blocks.  Blocks on a GPU run in no order, so this is
// two launches and no atomics:
//  1. flash_bwd_dq_kernel: a block per (64-row q tile, head, batch) first
//     computes D_i for its rows from dO and O (and writes it out), then
//     walks the key tiles accumulating dQ in wmma fragments;
//  2. flash_bwd_dkv_kernel: a block per (64-key tile, head, batch) walks
//     the (shard's) q tiles and owns dK and dV for its keys (wmma fragments, a warp
//     per 16 keys), reading D_i written by launch 1.
// Both recompute S and dO V^T per tile pair with nvcuda::wmma; the
// elementwise phase has a warp on two rows at a time, a lane on four
// consecutive keys (one Philox evaluation gives their keep bits, the same
// element coordinates as the forward).
#include "flash_attention.cuh"

namespace vt {
namespace flash {

using namespace nvcuda;

struct SmemDq {
  bf16 q[BQ * LDB];
  bf16 dout[BQ * LDB];
  bf16 k[BK * LDB];
  bf16 v[BK * LDB];
  bf16 ds[BQ * LDP];
  float s[BQ * LDS];
  float dp[BQ * LDS];
  float lse[BQ];
  float di[BQ];
  float kmask[BK];
};

struct SmemDkv {
  bf16 k[BK * LDB];
  bf16 v[BK * LDB];
  bf16 q[BQ * LDB];
  bf16 dout[BQ * LDB];
  bf16 pd[BQ * LDP];   // dropped, rescaled probabilities [q][key]
  bf16 ds[BQ * LDP];   // dS [q][key]
  float s[BQ * LDS];
  float dp[BQ * LDS];
  float lse[BQ];
  float di[BQ];
  float kmask[BK];
};

// S = A B^T-style products for one warp's 16 rows: acc[j] = rows x cols
// 16j .. 16j+15 of X Y^T, X [16, 64] and Y [64, 64] bf16 in shared memory
__device__ __forceinline__ void rows_times_t(float* dst, const bf16* x, const bf16* y) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, x + kk * 16, LDB);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> yb;
      wmma::load_matrix_sync(yb, y + (j * 16) * LDB + kk * 16, LDB);
      wmma::mma_sync(acc[j], a, yb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(dst + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// The row's lse as the elementwise phase takes it.  A masked score there
// is kBwdFill, not the forward's -1e9 (exp(kBwdFill - lse) is 0 in f32 for
// any row with an allowed key), so that a row with no allowed key, whose
// lse is the -1e9 fill (flash_fwd.cuh), can take lse = kBwdFill +
// log(round_up(Lk, 128)): P = 1 / round_up(Lk, 128) on each of its keys,
// as the TPU kernels' padded keys have it (to a relative 5e-4 from the
// rounding of that lse, below the bf16 rounding of P and dS).
// Assumed: a row with an allowed key has lse > kBwdFill + 104 (its largest
// allowed scaled score above about -9,900), so that exp(kBwdFill - lse)
// underflows to 0 (the model's scaled scores are in the tens).
constexpr float kBwdFill = -1e4f;

__device__ __forceinline__ float row_lse(float lse, int Lk) {
  return lse <= 0.5f * kNeg ? kBwdFill + logf((float)((Lk + 127) / 128 * 128)) : lse;
}

// the elementwise phase for one (global q row, four keys): P, the dropped
// and rescaled P, and dS
struct Elem {
  float p[4], pd[4], ds[4];
};

__device__ __forceinline__ Elem elementwise(const float* s_row, const float* dp_row, int c0,
                                            int k0, int qrow, const float* kmask, float lse,
                                            float di, int Lk, int l_enc, int dec_len,
                                            float scale, bool dropout, uint32_t seed,
                                            uint32_t threshold, float keep_scale, int h,
                                            int b) {
  Elem e;
  const float4 s4 = *reinterpret_cast<const float4*>(s_row + c0);
  const float4 d4 = *reinterpret_cast<const float4*>(dp_row + c0);
  const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
  const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
  bool keep[4] = {true, true, true, true};
  if (dropout) keep4(keep, seed, threshold, k0 + c0, qrow, h, b);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int col = k0 + c0 + t;
    float p = 0.f;
    if (col < Lk) {
      const bool ok = allowed(kmask[c0 + t], qrow, col, l_enc, dec_len);
      const float x = ok ? sv[t] * scale : kBwdFill;
      p = expf(x - lse);
    }
    const float kr = keep[t] ? keep_scale : 0.f;
    e.p[t] = p;
    e.pd[t] = p * kr;
    e.ds[t] = p * (dv[t] * kr - di);
  }
  return e;
}

__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

__device__ __forceinline__ void store4(bf16* dst, const float v[4]) {
  __align__(8) bf16 vb[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) vb[t] = __float2bfloat16(v[t]);
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(vb);
}

__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ key_mask,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ di_out,
                    bf16* __restrict__ dq, Geom g, int H, int dec_len, float scale,
                    const int64_t* __restrict__ seed_ptr, uint32_t threshold,
                    float keep_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(smem_raw);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = lane >> 4, c0 = (lane & 15) * 4;
  const int Lq = g.Lq, Lk = g.Lk;
  const size_t qb = head_base(g.q, b, h), kb = head_base(g.k, b, h);
  const size_t vb = head_base(g.v, b, h), ob = head_base(g.o, b, h);
  const size_t gb = head_base(g.dout, b, h), dqb = head_base(g.dq, b, h);
  const size_t stat = ((size_t)b * H + h) * Lq;
  const int l_enc = Lk - dec_len;
  const bool dropout = seed_ptr != nullptr;
  const uint32_t seed = dropout ? (uint32_t)(*seed_ptr) : 0u;

  load_tile(sm.q, q, qb, q0, Lq, g.q[2]);
  load_tile(sm.dout, dout, gb, q0, Lq, g.dout[2]);
  // D_i = rowsum(dO * O): a warp per row, two columns a lane
  for (int r = warp; r < BQ; r += NT / 32) {
    float acc = 0.f;
    if (q0 + r < Lq) {
      const bf16* gr = dout + gb + (size_t)((q0 + r) * g.dout[2]);
      const bf16* orow = o + ob + (size_t)((q0 + r) * g.o[2]);
      for (int c = lane; c < HD; c += 32)
        acc += __bfloat162float(gr[c]) * __bfloat162float(orow[c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sm.di[r] = acc;
      if (q0 + r < Lq) di_out[stat + q0 + r] = acc;
    }
  }
  if (tid < BQ) sm.lse[tid] = (q0 + tid < Lq) ? row_lse(lse[stat + q0 + tid], Lk) : 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_tile(sm.k, k, kb, k0, Lk, g.k[2]);
    load_tile(sm.v, v, vb, k0, Lk, g.v[2]);
    if (tid < BK) sm.kmask[tid] = (k0 + tid < Lk) ? key_mask[(size_t)b * Lk + k0 + tid] : 0.f;
    __syncthreads();

    rows_times_t(&sm.s[(warp * 16) * LDS], &sm.q[(warp * 16) * LDB], sm.k);
    rows_times_t(&sm.dp[(warp * 16) * LDS], &sm.dout[(warp * 16) * LDB], sm.v);
    __syncwarp();
    for (int rr = 0; rr < 16; rr += 2) {
      const int row = warp * 16 + rr + half;
      const Elem e = elementwise(&sm.s[row * LDS], &sm.dp[row * LDS], c0, k0,
                                 g.row_offset + q0 + row, sm.kmask, sm.lse[row], sm.di[row],
                                 Lk, l_enc, dec_len, scale,
                                 dropout, seed, threshold, keep_scale, h, b);
      store4(&sm.ds[row * LDP + c0], e.ds);
    }
    __syncwarp();
    // dQ += dS K for this warp's rows
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sm.ds[(warp * 16) * LDP + kk * 16], LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kf;
        wmma::load_matrix_sync(kf, &sm.k[(kk * 16) * LDB + j * 16], LDB);
        wmma::mma_sync(dq_acc[j], a, kf, dq_acc[j]);
      }
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  // stage dQ through the score tile, then write bf16
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(&sm.s[(warp * 16) * LDS + j * 16], dq_acc[j], LDS,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    if (q0 + r < Lq)
      dq[dqb + (size_t)((q0 + r) * g.dq[2]) + c] = __float2bfloat16(sm.s[r * LDS + c] * scale);
  }
}

// TG: the type of dk / dv (bf16 for #1b, f32 for #10b)
template <typename TG>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ key_mask,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, TG* __restrict__ dk,
                     TG* __restrict__ dv, Geom g, int H, int dec_len, float scale,
                     const int64_t* __restrict__ seed_ptr, uint32_t threshold,
                     float keep_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(smem_raw);
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = lane >> 4, c0 = (lane & 15) * 4;
  const int Lq = g.Lq, Lk = g.Lk;
  const size_t qb = head_base(g.q, b, h), kb = head_base(g.k, b, h);
  const size_t vb = head_base(g.v, b, h), gb = head_base(g.dout, b, h);
  const size_t dkb = head_base(g.dk, b, h), dvb = head_base(g.dv, b, h);
  const size_t stat = ((size_t)b * H + h) * Lq;
  const int l_enc = Lk - dec_len;
  const bool dropout = seed_ptr != nullptr;
  const uint32_t seed = dropout ? (uint32_t)(*seed_ptr) : 0u;

  load_tile(sm.k, k, kb, k0, Lk, g.k[2]);
  load_tile(sm.v, v, vb, k0, Lk, g.v[2]);
  if (tid < BK) sm.kmask[tid] = (k0 + tid < Lk) ? key_mask[(size_t)b * Lk + k0 + tid] : 0.f;

  // this warp's 16 keys: dK and dV [16, 64] each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    load_tile(sm.q, q, qb, q0, Lq, g.q[2]);
    load_tile(sm.dout, dout, gb, q0, Lq, g.dout[2]);
    if (tid < BQ) {
      const bool in = q0 + tid < Lq;
      sm.lse[tid] = in ? row_lse(lse[stat + q0 + tid], Lk) : 0.f;
      sm.di[tid] = in ? di[stat + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S and dO V^T for this warp's 16 q rows against the block's 64 keys
    rows_times_t(&sm.s[(warp * 16) * LDS], &sm.q[(warp * 16) * LDB], sm.k);
    rows_times_t(&sm.dp[(warp * 16) * LDS], &sm.dout[(warp * 16) * LDB], sm.v);
    __syncwarp();
    for (int rr = 0; rr < 16; rr += 2) {
      const int row = warp * 16 + rr + half;
      const int qrow = q0 + row;
      Elem e = elementwise(&sm.s[row * LDS], &sm.dp[row * LDS], c0, k0, g.row_offset + qrow,
                           sm.kmask, sm.lse[row], sm.di[row], Lk, l_enc, dec_len, scale,
                           dropout, seed, threshold, keep_scale, h, b);
      if (qrow >= Lq) {  // pad rows of the last q tile contribute nothing
#pragma unroll
        for (int t = 0; t < 4; ++t) e.pd[t] = e.ds[t] = 0.f;
      }
      store4(&sm.pd[row * LDP + c0], e.pd);
      store4(&sm.ds[row * LDP + c0], e.ds);
    }
    __syncthreads();  // every warp reads all 64 q rows below

    // dV += Pd^T dO, dK += dS^T Q for this warp's keys
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, sa;
      wmma::load_matrix_sync(pa, &sm.pd[(kk * 16) * LDP + warp * 16], LDP);
      wmma::load_matrix_sync(sa, &sm.ds[(kk * 16) * LDP + warp * 16], LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> of, qf;
        wmma::load_matrix_sync(of, &sm.dout[(kk * 16) * LDB + j * 16], LDB);
        wmma::load_matrix_sync(qf, &sm.q[(kk * 16) * LDB + j * 16], LDB);
        wmma::mma_sync(dv_acc[j], pa, of, dv_acc[j]);
        wmma::mma_sync(dk_acc[j], sa, qf, dk_acc[j]);
      }
    }
    __syncthreads();  // q / dO / P / dS tiles are overwritten next
  }

  // stage through the score tiles, then write
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    wmma::store_matrix_sync(&sm.s[(warp * 16) * LDS + j * 16], dk_acc[j], LDS,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(&sm.dp[(warp * 16) * LDS + j * 16], dv_acc[j], LDS,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < BK * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    if (k0 + r < Lk) {
      put(dk + dkb + (size_t)((k0 + r) * g.dk[2]) + c, sm.s[r * LDS + c] * scale);
      put(dv + dvb + (size_t)((k0 + r) * g.dv[2]) + c, sm.dp[r * LDS + c]);
    }
  }
}

template <typename TG>
int launch_bwd(const void* q, const void* k, const void* v, const void* key_mask,
               const void* out, const void* dout, const void* lse, void* di, void* dq, void* dk,
               void* dv, const void* seed, const Geom& g, int batch, int num_heads, int dec_len,
               unsigned int threshold, float keep_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto dkv_kernel = flash_bwd_dkv_kernel<TG>;
  const int smem_dq = (int)sizeof(SmemDq), smem_dkv = (int)sizeof(SmemDkv);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)HD);
  flash_bwd_dq_kernel<<<dim3((g.Lq + BQ - 1) / BQ, num_heads, batch), NT, smem_dq, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)key_mask, (const bf16*)out,
      (const bf16*)dout, (const float*)lse, (float*)di, (bf16*)dq, g, num_heads, dec_len,
      scale, (const int64_t*)seed, (uint32_t)threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3((g.Lk + BK - 1) / BK, num_heads, batch), NT, smem_dkv, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)key_mask, (const bf16*)dout,
      (const float*)lse, (const float*)di, (TG*)dk, (TG*)dv, g, num_heads, dec_len, scale,
      (const int64_t*)seed, (uint32_t)threshold, keep_scale);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace vt

// q, k, v, out, dout, dq, dk, dv [B, L, H*64] bf16; key_mask [B, L] f32;
// lse [B, H, L] f32 from the forward; di [B, H, L] f32 scratch; seed:
// int64 [1] on the device, or null for no dropout.
extern "C" int vt_flash_attention_merged_bwd(const void* q, const void* k, const void* v,
                                             const void* key_mask, const void* out,
                                             const void* dout, const void* lse, void* di,
                                             void* dq, void* dk, void* dv, const void* seed,
                                             int batch, int seq_len, int num_heads,
                                             int head_dim, int dec_len, unsigned int threshold,
                                             float keep_scale, void* stream) {
  using namespace vt::flash;
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  return launch_bwd<vt::bf16>(q, k, v, key_mask, out, dout, lse, di, dq, dk, dv, seed,
                              merged_geom(seq_len, num_heads), batch, num_heads, dec_len,
                              threshold, keep_scale, stream);
}

// The split-head form (#10b): q, out, dout, dq [B, H, Lq, 64] bf16; k, v
// [B, H, Lk, 64] bf16; dk, dv [B, H, Lk, 64] f32; each through its (batch,
// head, row) element strides (strides: 24 int64, q, k, v, out, dout, dq,
// dk, dv), the last dimension contiguous and the bf16 rows 16-byte
// aligned; key_mask [B, Lk] f32; lse [B, H, Lq] f32 from the forward; di
// [B, H, Lq] f32 scratch; row_offset, seed, threshold, keep_scale as the
// forward's.
extern "C" int vt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* out, const void* dout,
                                      const void* lse, void* di, void* dq, void* dk, void* dv,
                                      const void* seed, const void* strides, int batch,
                                      int num_heads, int len_q, int len_k, int head_dim,
                                      int dec_len, int row_offset, unsigned int threshold,
                                      float keep_scale, void* stream) {
  using namespace vt::flash;
  if (head_dim != HD || batch <= 0 || num_heads <= 0 || len_q <= 0 || len_k <= 0 ||
      dec_len < 0 || dec_len > len_k || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  Geom g = merged_geom(len_k, num_heads);
  read_strides(g, (const long long*)strides, 8);
  g.Lq = len_q;
  g.row_offset = row_offset;
  return launch_bwd<float>(q, k, v, key_mask, out, dout, lse, di, dq, dk, dv, seed, g, batch,
                           num_heads, dec_len, threshold, keep_scale, stream);
}
