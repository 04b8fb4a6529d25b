// Flash attention, forward, with optional in-kernel dropout of the
// attention probabilities and the row log-sum-exp for the backward.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:flash_attention_merged
// (the Pallas body _flash_merged_kernel / _merged_heads_attend), and, as
// its split-head form (#10), pallas_attention.py:flash_attention
// (_flash_impl / _flash_kernel): q [B, H, Lq, 64] and k / v [B, H, Lk, 64]
// read through their strides (the split-head views of the merged
// projections, not copied), Lq != Lk (a sequence-parallel query shard
// against the whole key range), and row_offset, the global row of query
// row 0, which enters the mask and the dropout coordinates, so a shard's
// rows are the unsharded call's rows.  The output is written [B, Lq, H,
// 64]-major, so merge_heads and the ranks' row gather work on contiguous
// row blocks.  One kernel body serves both, a template flag apart
// (kSplit): the split form reads its offsets from a Geom of strides
// (flash_attention.cuh); the merged form computes them from H as it did
// before the split form existed, so #1's and #11's instantiations compile
// as they did.
//
// Computes, per head h, softmax(Q_h K_h^T / sqrt(d) + mask) V_h on bf16
// operands, with the mask built in-kernel from key_mask [B, Lk] plus a
// trailing causal decoder block of dec_len rows (pallas_attention.py
// _allowed): global query row r may attend key c when key_mask[c] > 0, or
// when both lie in the decoder block and c <= r.  Masked scores take -1e9.
// Training (rate > 0): the normalised probabilities are dropped where the
// Philox bits of element (b, h, r, c) fall below the threshold
// (philox.cuh) and the kept ones divided by 1 - rate, as
// _merged_heads_attend does; lse [B, H, Lq] f32 receives m + log(l).
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
// #10 at its serving shape (q [8, 12, 576, 64] against [8, 12, 1152, 64])
// is half of #1's work per rank: ~287 FLOP per byte, at the bf16 ridge.
//
// Design: one block of 4 warps per (64-row q tile, head, batch); heads are
// read through their strides (merged: a row stride of H*D), so no
// split/merge copies.  The block walks the keys in 64-wide tiles with an online
// softmax: S = Q K^T through nvcuda::wmma bf16 m16n16k16 with f32
// accumulate; each warp then handles two rows at a time, a lane owning four
// consecutive keys (one Philox evaluation gives their four keep bits); the
// row max / sum live in shared memory; the kept probabilities are rounded
// to bf16 for the P V product (as the Pallas kernel feeds bf16 weights to
// its second matmul) into an f32 accumulator in shared memory, rescaled per
// row.  The row sum l counts the dropped entries too; only the numerator
// skips them.  Loads are synchronous 16-byte copies; cp.async/TMA double
// buffering and wgmma are later work.
//
// The int8-cache form (kEmit) also replaces pallas_attention.py:
// flash_attention_merged_q8 (_flash_merged_q8_kernel): the same forward,
// plus the quantize_kv layout of this layer's K and V (k8 / v8 [B, L, H*D]
// int8, ks / vs [B, L] f32 per-token scales), bit for bit: the amax of a
// token's H*D bf16 values, scale = max(amax, 1e-6) / 127, rint(v / scale)
// (IEEE division, round half to even) clipped to +-127.  The TPU kernel
// quantizes at its first q block from a batch-resident K/V block; here a
// block sees one head, but a token's scale spans all H heads, so the
// q-tile-0 block of each (head h, batch b) quantizes tokens [h * ceil(L /
// H), (h + 1) * ceil(L / H)) of batch b across all H*D columns, a warp per
// token, before its own attention: the other q tiles run unchanged.  The
// emission reads each K / V token once more (while the other blocks of the
// batch stream the same K / V, so mostly from L2) and writes its int8 row
// and scale: 3 bytes an element over q/k/v/out's 8, in place of the
// separate quantize_kv pass and its launch.  kEmit is a template flag, so
// the eval and training forms compile as before.
#include <type_traits>

#include "flash_attention.cuh"

namespace vt {
namespace flash {

using namespace nvcuda;

// quantize_kv of tokens [r0, r1) of one batch's [L, row_stride] slice, a
// warp per token; row_stride % 8 == 0 (the row is read twice, the second
// time from cache)
__device__ __forceinline__ void emit_int8(const bf16* __restrict__ src, int8_t* __restrict__ dst8,
                                          float* __restrict__ scales, int r0, int r1,
                                          int row_stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = r0 + warp; r < r1; r += NT / 32) {
    const bf16* row = src + (size_t)r * row_stride;
    float amax = 0.f;
    for (int c = lane * 8; c < row_stride; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(__bfloat162float(e[t])));
    }
    const float scale = fmaxf(warp_max(amax), 1e-6f) / 127.0f;
    for (int c = lane * 8; c < row_stride; c += 256) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      __align__(8) int8_t o[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        o[t] = (int8_t)fminf(fmaxf(rintf(__bfloat162float(e[t]) / scale), -127.f), 127.f);
      *reinterpret_cast<uint2*>(dst8 + (size_t)r * row_stride + c) =
          *reinterpret_cast<const uint2*>(o);
    }
    if (lane == 0) scales[r] = scale;
  }
}

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

struct Emit {
  int8_t* k8;
  float* ks;
  int8_t* v8;
  float* vs;
};

template <bool kEmit, bool kSplit>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ key_mask,
                 bf16* __restrict__ out, float* __restrict__ lse, Geom g, int H, int dec_len,
                 float scale, const int64_t* __restrict__ seed_ptr, uint32_t threshold,
                 float keep_scale, Emit emit) {
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
  const int Lq = g.Lq, Lk = g.Lk;
  const int row_stride = H * HD;  // the merged layout
  const size_t merged = (size_t)b * Lk * row_stride + (size_t)h * HD;
  const size_t qb = kSplit ? head_base(g.q, b, h) : merged;
  const size_t kb = kSplit ? head_base(g.k, b, h) : merged;
  const size_t vb = kSplit ? head_base(g.v, b, h) : merged;
  const size_t ob = kSplit ? head_base(g.o, b, h) : merged;
  using Stride = typename std::conditional<kSplit, long long, int>::type;
  const Stride qs = kSplit ? g.q[2] : row_stride, ks = kSplit ? g.k[2] : row_stride;
  const Stride vs = kSplit ? g.v[2] : row_stride, os = kSplit ? g.o[2] : row_stride;
  const int row0 = kSplit ? g.row_offset : 0;
  const int l_enc = Lk - dec_len;
  const bool dropout = seed_ptr != nullptr;
  const uint32_t seed = dropout ? (uint32_t)(*seed_ptr) : 0u;

  if (kEmit && blockIdx.x == 0) {  // the merged layout only
    const int per = (Lk + H - 1) / H;
    const int r0 = h * per, r1 = min(Lk, r0 + per);
    const size_t bb = (size_t)b * Lk * row_stride;
    emit_int8(k + bb, emit.k8 + bb, emit.ks + (size_t)b * Lk, r0, r1, row_stride);
    emit_int8(v + bb, emit.v8 + bb, emit.vs + (size_t)b * Lk, r0, r1, row_stride);
  }

  load_tile(sm.q, q, qb, q0, Lq, qs);
  for (int i = tid; i < BQ * LDO; i += NT) sm.o[i] = 0.f;
  if (tid < BQ) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    load_tile(sm.k, k, kb, k0, Lk, ks);
    load_tile(sm.v, v, vb, k0, Lk, vs);
    if (tid < BK) sm.kmask[tid] = (k0 + tid < Lk) ? key_mask[(size_t)b * Lk + k0 + tid] : 0.f;
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
      const int qrow = row0 + q0 + row;  // global row
      const float4 s4 = *reinterpret_cast<const float4*>(&sm.s[row * LDS + c0]);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float x[4];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = k0 + c0 + t;
        x[t] = -INFINITY;  // past the sequence end: no weight at all
        if (col < Lk) x[t] = allowed(sm.kmask[c0 + t], qrow, col, l_enc, dec_len) ? sv[t] * scale : kNeg;
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
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, &sm.p[(warp * 16) * LDP + kk * 16], LDP);
        wmma::load_matrix_sync(vf, &sm.v[(kk * 16) * LDB + j * 16], LDB);
        wmma::mma_sync(oacc, pa, vf, oacc);
      }
      wmma::store_matrix_sync(&sm.o[(warp * 16) * LDO + j * 16], oacc, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    if (q0 + r < Lq)
      out[ob + (size_t)(q0 + r) * os + c] =
          __float2bfloat16(sm.o[r * LDO + c] / sm.l[r] * keep_scale);
  }
  if (lse != nullptr && tid < BQ && q0 + tid < Lq)
    lse[((size_t)b * H + h) * Lq + q0 + tid] = sm.m[tid] + logf(sm.l[tid]);
}

template <bool kEmit, bool kSplit>
int launch_fwd(const void* q, const void* k, const void* v, const void* key_mask, void* out,
               void* lse, const void* seed, Emit e, const Geom& g, int batch, int num_heads,
               int dec_len, unsigned int threshold, float keep_scale, void* stream) {
  auto kernel = flash_fwd_kernel<kEmit, kSplit>;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.Lq + BQ - 1) / BQ, num_heads, batch);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)key_mask, (bf16*)out,
      (float*)lse, g, num_heads, dec_len, 1.0f / sqrtf((float)HD), (const int64_t*)seed,
      (uint32_t)threshold, keep_scale, e);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace vt

// q, k, v, out [B, L, H*64] bf16; key_mask [B, L] f32; lse [B, H, L] f32
// or null (eval); seed: int64 [1] on the device, or null for no dropout;
// k8, ks, v8, vs: the int8 cache of k and v ([B, L, H*64] int8, [B, L] f32),
// or all null; threshold / keep_scale: the dropout keep test and 1 / (1 -
// rate).
extern "C" int vt_flash_attention_merged(const void* q, const void* k, const void* v,
                                         const void* key_mask, void* out, void* lse,
                                         const void* seed, void* k8, void* ks, void* v8,
                                         void* vs, int batch, int seq_len, int num_heads,
                                         int head_dim, int dec_len, unsigned int threshold,
                                         float keep_scale, void* stream) {
  using namespace vt::flash;
  if (head_dim != HD) return (int)cudaErrorInvalidValue;
  const bool emit = k8 != nullptr;
  if (emit && (ks == nullptr || v8 == nullptr || vs == nullptr)) return (int)cudaErrorInvalidValue;
  const Emit e = {(int8_t*)k8, (float*)ks, (int8_t*)v8, (float*)vs};
  const Geom g = merged_geom(seq_len, num_heads);
  return emit ? launch_fwd<true, false>(q, k, v, key_mask, out, lse, seed, e, g, batch,
                                        num_heads, dec_len, threshold, keep_scale, stream)
              : launch_fwd<false, false>(q, k, v, key_mask, out, lse, seed, e, g, batch,
                                         num_heads, dec_len, threshold, keep_scale, stream);
}

// The split-head form (#10): q [B, H, Lq, 64], k / v [B, H, Lk, 64], out
// [B, H, Lq, 64] bf16, each through its (batch, head, row) element strides
// (strides: 12 int64, q, k, v, out), the last dimension contiguous and
// every row 16-byte aligned; key_mask [B, Lk] f32; lse [B, H, Lq] f32 or
// null; row_offset: the global row of query row 0; seed / threshold /
// keep_scale as above.
extern "C" int vt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* out, void* lse, const void* seed,
                                  const void* strides, int batch, int num_heads, int len_q,
                                  int len_k, int head_dim, int dec_len, int row_offset,
                                  unsigned int threshold, float keep_scale, void* stream) {
  using namespace vt::flash;
  if (head_dim != HD || batch <= 0 || num_heads <= 0 || len_q <= 0 || len_k <= 0 ||
      dec_len < 0 || dec_len > len_k || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  Geom g = merged_geom(len_k, num_heads);
  read_strides(g, (const long long*)strides, 4);
  g.Lq = len_q;
  g.row_offset = row_offset;
  const Emit e = {nullptr, nullptr, nullptr, nullptr};
  return launch_fwd<false, true>(q, k, v, key_mask, out, lse, seed, e, g, batch, num_heads,
                                 dec_len, threshold, keep_scale, stream);
}
