// The flash attention backward body for Hopper, shared by the merged-head
// backward (#1b) and its split-head form with a query-row offset (#10b):
// dq, dk and dv, with the attention-probs dropout regenerated exactly as
// the forward drew it.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:_flash_merged_bwd_impl
// (the Pallas body _flash_merged_bwd_kernel) and, as its split-head form,
// pallas_attention.py:_flash_bwd_impl (_flash_bwd_kernel): the operands
// read and written through their strides (flash_attention.cuh Geom), an
// Lq-row query shard at global row row_offset against Lk keys, and dk / dv
// returned in f32, the shard's partial sums that the sequence-parallel
// ranks add up before the cast (the TPU kernel's f32 accumulator blocks,
// summed by shard_map's psum).  For each (batch b, head h), with P =
// exp(S * scale - lse) (the forward's mask, lse saved by the forward),
// K_r = the forward's keep mask over 1 - rate (or 1 without dropout) and
// D_i = rowsum(dO * O):
//   dV = (P * K_r)^T dO
//   dS = P * (K_r * (dO V^T) - D_i)
//   dQ = dS K * scale,   dK = dS^T Q * scale
// in f32 accumulation from bf16 operands (P * K_r and dS rounded to bf16
// before their products, as the Pallas kernel feeds bf16 to its matmuls);
// dq comes back bf16, dk and dv bf16 (#1b) or f32 (#10b).  Any head width
// D a multiple of 8 up to 128, on the forward's tiers (flash_fwd.cuh):
// below 64 on one 64-column atom zero-filled past D, 64 on one atom with
// every width a constant (the main path), above 64 on two atoms.
//
// Semantics kept from the JAX wrappers, which pad the keys to round_up(Lk,
// 128) with key mask 0: a masked score is kBwdFill (-1e4) here, so that a
// row with no allowed key, whose lse is the forward's -1e9 fill, takes lse
// = kBwdFill + log(round_up(Lk, 128)) (row_lse) and weighs every key 1 /
// round_up(Lk, 128), as the padded softmax has it (to a relative ~1e-3
// from the rounding of that lse, below the bf16 rounding of P and dS);
// assumed: a row with an allowed key has lse > kBwdFill + 104 (its largest
// allowed scaled score above about -9,900; the model's are in the tens),
// so that its masked keys weigh exactly 0.  P is 0 past Lk; the pad rows
// of the last q tile contribute nothing (their lse is +inf).  Dropout keep
// bits are those of element (b, h, global row, key) (philox.cuh), four
// consecutive keys of a row from one Philox evaluation (keep4).
//
// What bounds it on the H100: per allowed (query row, key) pair of a head
// it does five products of 2 * 64 operations (S and dP = dO V^T
// recomputed, dV, dQ, dK), 2.5x the forward's.  Counting the allowed pairs
// only (the bound's accounting; the kernel runs whole 64 x 64 tiles, about
// 1.7x the allowed pairs at this mask): at the training shape (B = 48, L =
// 1152) with the MMT mask of a synthetic batch, 446 of the 1152 keys of a
// row on average, that is 190 GFLOP (0.19 ms at 989 TFLOP/s), against
// 0.68 GB that must move (q, k, v, O, dO and the lse read; dq, dk, dv
// written; 0.20 ms at 3.35 TB/s): the bytes bind, by a hair (chip_smoke.py,
// flash_bwd_bound).  #10b at the
// SP training shape (q [4, 12, 576, 64] against [4, 12, 1152, 64]) does
// half of #1b's work per rank and writes dk / dv in f32
// (split_flash_bwd_bound).
//
// Design: the TPU kernel walks the q blocks in order and accumulates dk /
// dv in resident output blocks.  Here each call is three launches:
//  1. flash_bwd_pre_kernel: D_i = rowsum(dO * O) and the lse in the base-2
//     domain (row_lse * log2 e; +inf on pad rows) into f32 scratch, eight
//     threads a row with 16-byte loads, and the f32 dq accumulator zeroed;
//  2. flash_bwd_kernel: a block of one warpgroup (128 threads) owns 64 keys
//     of one (head, batch).  Its K and V are loaded once into 128-byte-
//     swizzled shared memory (sm90.cuh).  It walks its live q tiles of 64
//     rows; Q, dO and the tile's lse / D stream through a 2-stage cp.async
//     ring (the copies of tile t + 1 issued before the products of tile t).
//     Per q tile, all on wgmma with the accumulators in registers:
//       S^T = K Q^T and dP^T = V dO^T (SS; a thread holds 2 keys x 16
//       rows), then P^T and dS^T on the fragment (ex2 with scale * log2 e
//       folded in; the lse and D of the tile's rows are per column here and
//       come from the stage in shared memory);
//       dV += (P^T * K_r) dO and dK += dS^T Q (RS: the A operand is the
//       bf16 fragment in the accumulator layout, dO / Q the MN-major
//       trans-b B operand, as the forward's P V);
//       dQ_tile = dS K (SS with both operands MN-major: dS^T staged bf16
//       in a swizzled tile, async-proxy fence and a barrier before the
//       product), added into the f32 accumulator with vector atomicAdd
//       (float2).  The order of those sums changes from run to run, so
//       dq's last bits may too (dk and dv are deterministic).  The ordered
//       form (parts > 1, taken under PyTorch's deterministic algorithms)
//       stores each key block's dQ tile into a slice of its own instead,
//       and launch 3 sums the slices in key order: the same bits every
//       run, for parts x the accumulator's scratch and its traffic.
//     dK * scale and dV leave from registers at the end: bf16 (#1b) or f32
//     (#10b).  Five products per pair, one Philox evaluation per four
//     elements: in the S^T layout a four-key group of one row lies on the
//     four lanes lane / 4 = 4g .. 4g + 3 that share lane % 4; each of them
//     evaluates one of the four groups of its (8-row chunk) and they
//     exchange the words by three xor shuffles.
//  3. flash_bwd_dq_kernel: dq = bf16(acc * scale) through dq's strides
//     (the ordered form: acc = the key blocks' slices summed in order).
//  Head widths above 64 (two atoms): dK and dV of 64 keys x 128 columns
//  in registers would be 128 floats a thread beside S, dP and dQ's 96, past
//  the 255 a thread may hold.  So the grid gets a block per (key block,
//  atom): each block computes S^T and dP^T over the whole head row (4 k16
//  steps an atom) and then dV, dK and dQ for its atom's 64 columns only,
//  with today's registers; S, dP and the Philox groups are computed once
//  per atom (at D = 128, 7 products a pair instead of 5).  Its shared
//  memory doubles the K / V tiles and each Q / dO stage (107 KB with the
//  ring's two stages, two blocks an SM).
// The form was chosen by measurement on the H100 (PERF.md section 6; the
// sweep was removed once the choice was made): against 128 keys on two
// warpgroups sharing each Q / dO stage (their dQ partials summed in shared
// memory before the atomics: 25% slower at #1b's training shape, one block
// of 256 threads an SM at 213-254 registers) and against two launches with
// no atomics (dK / dV per key tile, then dQ per q tile: 7 products a pair
// and every Philox group drawn twice; 12% faster without dropout, 35%
// slower with it, the training step's case).  Also tried and not kept:
// float4 atomics (no change), a register cap for three blocks an SM
// (spills, slower).  The kernel takes 207 registers (240 with dropout),
// no spills: two blocks an SM.
// Live q tiles: a block walks a q tile only where a pair of it can be
// nonzero: every tile if one of its keys has key_mask > 0; the tiles with a
// global row at or past its first decoder key if it reaches the decoder
// block; the tiles holding an encoder row if the batch row has no valid key
// (those rows weigh every key).  A block with no live tile writes zero dk /
// dv and adds nothing to dq.
#pragma once

#include <limits.h>

#include "flash_fwd.cuh"

namespace vt {
namespace flash {

constexpr int kBwdRows = 64;        // q rows of a tile
constexpr int kBwdKeys = 64;        // keys of a warpgroup
constexpr int kBwdStages = 2;       // Q / dO ring depth
constexpr int kTile = kAtom;        // bytes of a 64-row bf16 tile of one 64-column atom
// a stage at NA atoms a head row: Q, dO, then the tile's lse (base 2) and
// D, 64 floats each
template <int NA>
__host__ __device__ constexpr int bwd_stage_bytes() {
  return (2 * NA * kTile + 2 * 64 * 4 + 1023) / 1024 * 1024;
}
// shared memory of a block: + 1024 (the dynamic shared memory is aligned
// to 1024 bytes in-kernel), K, V, dS^T and the ring
template <int NA>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 1024 + (2 * NA + 1) * kTile + kBwdStages * bwd_stage_bytes<NA>();
}

// A masked score takes kBwdFill here, not the forward's -1e9: see the note.
constexpr float kBwdFill = -1e4f;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* key_mask;  // [B, Lk]
  const float* lse;       // [B, H, Lq] from the forward
  float* acc;             // scratch [parts, B, H, lq_pad, 64 * na]: dq sums
  float* di;              // scratch [B, H, lq_pad]: D_i
  float* lse2;            // scratch [B, H, lq_pad]: row_lse * log2 e
  bf16* dq;
  void* dk;               // TG
  void* dv;
  Geom g;
  int heads, lq_pad, l_pad, dec_len;
  int na, dch;            // 64-column atoms of a head row; D / 8
  float scale;            // 1 / sqrt(D)
  int parts;              // 1: atomics; else one slice a key block (ordered)
  size_t part_stride;     // floats between two slices of acc
  const int64_t* seed;    // dropout seed on the device, or null
  uint32_t threshold;
  float keep_scale;
};

// the number of dq slices of the scratch: 1 (atomics), or with `ordered`
// one a key block
inline int bwd_parts(int len_k, int ordered) {
  return ordered ? (len_k + kBwdKeys - 1) / kBwdKeys : 1;
}

// the parameters shared by both entry points at head width d; scratch:
// f32, parts x [B, H, lq_pad, 64 * na] dq sums, then [B, H, lq_pad] D_i,
// then [B, H, lq_pad] base-2 lse, with lq_pad = round_up(Lq, 64), parts =
// bwd_parts(Lk, ordered) and na = 1 (d <= 64) or 2
inline BwdParams bwd_params(const void* q, const void* k, const void* v, const void* key_mask,
                            const void* out, const void* dout, const void* lse, void* scratch,
                            void* dq, void* dk, void* dv, const void* seed, const Geom& g,
                            int batch, int num_heads, int d, int dec_len, int ordered,
                            unsigned int threshold, float keep_scale) {
  BwdParams p = {};
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.o = (const bf16*)out;
  p.dout = (const bf16*)dout;
  p.key_mask = (const float*)key_mask;
  p.lse = (const float*)lse;
  p.g = g;
  p.heads = num_heads;
  p.lq_pad = (g.Lq + kBwdRows - 1) / kBwdRows * kBwdRows;
  p.l_pad = (g.Lk + 127) / 128 * 128;
  p.dec_len = dec_len;
  p.na = d <= 64 ? 1 : 2;
  p.dch = d / 8;
  p.scale = 1.0f / sqrtf((float)d);
  const size_t stats = (size_t)batch * num_heads * p.lq_pad;
  p.parts = bwd_parts(g.Lk, ordered);
  p.part_stride = stats * 64 * p.na;
  p.acc = (float*)scratch;
  p.di = p.acc + p.parts * p.part_stride;
  p.lse2 = p.di + stats;
  p.dq = (bf16*)dq;
  p.dk = dk;
  p.dv = dv;
  p.seed = (const int64_t*)seed;
  p.threshold = (uint32_t)threshold;
  p.keep_scale = keep_scale;
  return p;
}

// 1. D_i, the base-2 lse and the zeroed dq accumulator (each slice of
// it): eight threads a row (16-byte chunks c, c + 8 of dO and O), 32 rows
// a block; NA / kFull: the head-width tier (flash_fwd.cuh)
template <int NA, bool kFull>
__global__ void __launch_bounds__(256) flash_bwd_pre_kernel(const BwdParams p) {
  const Geom& g = p.g;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * 32 + threadIdx.x / 8, c = threadIdx.x % 8;
  const size_t stat = ((size_t)b * p.heads + h) * p.lq_pad + row;
  const int dch = kFull ? 8 * NA : p.dch;
  float d = 0.f, l2 = INFINITY;
  if (row < g.Lq) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int cc = c + 8 * a;
      if (!kFull && cc >= dch) continue;
      const uint4 go = *reinterpret_cast<const uint4*>(p.dout + head_base(g.dout, b, h) +
                                                       (size_t)row * g.dout[2] + cc * 8);
      const uint4 oo = *reinterpret_cast<const uint4*>(p.o + head_base(g.o, b, h) +
                                                       (size_t)row * g.o[2] + cc * 8);
      const bf16* ge = reinterpret_cast<const bf16*>(&go);
      const bf16* oe = reinterpret_cast<const bf16*>(&oo);
#pragma unroll
      for (int t = 0; t < 8; ++t) d += __bfloat162float(ge[t]) * __bfloat162float(oe[t]);
    }
    const float lse = p.lse[((size_t)b * p.heads + h) * g.Lq + row];
    l2 = (lse <= 0.5f * kNeg ? kBwdFill + logf((float)p.l_pad) : lse) * kLog2e;
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  for (int s = 0; s < p.parts; ++s)
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      float4* acc = reinterpret_cast<float4*>(p.acc + s * p.part_stride + stat * (64 * NA) +
                                              (c + 8 * a) * 8);
      acc[0] = acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  if (c == 0) {
    p.di[stat] = d;
    p.lse2[stat] = l2;
  }
}

// 3. dq = bf16(acc * scale), eight elements a thread; the ordered form
// sums the slices in key-block order first
template <int NA, bool kFull>
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(const BwdParams p, int batch) {
  const Geom& g = p.g;
  constexpr int CPR = 8 * NA;  // 16-byte chunks of an accumulator row
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)batch * p.heads * g.Lq * CPR) return;
  const int c = (int)(i % CPR);
  if (!kFull && c >= p.dch) return;  // a zero-filled column of the tier
  const long long r = i / CPR;
  const int row = (int)(r % g.Lq), bh = (int)(r / g.Lq);
  const int h = bh % p.heads, b = bh / p.heads;
  const float4* src = reinterpret_cast<const float4*>(
      p.acc + ((size_t)bh * p.lq_pad + row) * (64 * NA) + c * 8);
  float4 a0 = src[0], a1 = src[1];
  for (int s = 1; s < p.parts; ++s) {
    const float4* part = src + s * (p.part_stride / 4);
    const float4 b0 = part[0], b1 = part[1];
    a0 = make_float4(a0.x + b0.x, a0.y + b0.y, a0.z + b0.z, a0.w + b0.w);
    a1 = make_float4(a1.x + b1.x, a1.y + b1.y, a1.z + b1.z, a1.w + b1.w);
  }
  const float sc = kFull && NA == 1 ? 0.125f : p.scale;  // 1 / sqrt(D)
  const uint4 out = make_uint4(sm90::pack_bf16(a0.x * sc, a0.y * sc),
                               sm90::pack_bf16(a0.z * sc, a0.w * sc),
                               sm90::pack_bf16(a1.x * sc, a1.y * sc),
                               sm90::pack_bf16(a1.z * sc, a1.w * sc));
  *reinterpret_cast<uint4*>(p.dq + head_base(g.dq, b, h) + (size_t)row * g.dq[2] + c * 8) = out;
}

__device__ __forceinline__ void put2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = sm90::pack_bf16(a, b);
}
__device__ __forceinline__ void put2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ uint32_t pick4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                          int i) {
  return i == 0 ? w0 : i == 1 ? w1 : i == 2 ? w2 : w3;
}

// P^T * K_r and dS^T of one q tile on the S^T / dP^T fragments (s[4j +
// 2hh + e] is key row hh of the thread, q column 8j + 2tq + e), packed to
// bf16 A fragments: pa[kk][t], sa[kk][t] hold q columns 16kk + 8 (t >> 1)
// + 2tq, +1 of key row t & 1.  lse2_s / d_s: the tile's base-2 lse and D
// per q row; grow0: the global row of q column 0; kval / kin / kdec: the
// thread's keys valid, inside Lk, and the first row a decoder key allows
// (INT_MAX: none); key_group / ci: the four-key group this lane evaluates
// and its place in it (dropout).
template <bool kDropout>
__device__ __forceinline__ void bwd_probs(float (&s)[32], float (&dp)[32], uint32_t (&pa)[4][4],
                                          uint32_t (&sa)[4][4], const float* lse2_s,
                                          const float* d_s, int grow0, const bool (&kval)[2],
                                          const bool (&kin)[2], const int (&kdec)[2],
                                          int key_group, int ci, int tq, uint32_t seed,
                                          uint32_t threshold, float keep_scale, int h, int b,
                                          float scale) {
  using namespace sm90;
  const float sl2 = scale * kLog2e;  // 1 / sqrt(D), in the base-2 domain
  const float fill2 = kBwdFill * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2_s + 8 * j + 2 * tq);
    const float2 dd = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * tq);
    const int grow = grow0 + 8 * j + 2 * tq;
    uint32_t kw[4] = {0u, 0u, 0u, 0u};  // keep words of combos e + 2hh
    if constexpr (kDropout) {
      // lane ci draws combo ci's group; the four lanes of a group swap
      // the words by xor shuffles: each needs word ci of every combo
      const uint4 w = philox_group(seed, 0u, (uint32_t)key_group, (uint32_t)(grow + (ci & 1)),
                                   (uint32_t)h, (uint32_t)b);
      uint32_t recv[4];
      recv[0] = pick4(w.x, w.y, w.z, w.w, ci);
#pragma unroll
      for (int r = 1; r < 4; ++r)
        recv[r] = __shfl_xor_sync(0xffffffffu, pick4(w.x, w.y, w.z, w.w, ci ^ r), 4 * r);
#pragma unroll
      for (int c = 0; c < 4; ++c) kw[c] = pick4(recv[0], recv[1], recv[2], recv[3], c ^ ci);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * hh + e;
        const float lq = e ? l2.y : l2.x, di = e ? dd.y : dd.x;
        const bool ok = kval[hh] || grow + e >= kdec[hh];
        float pv = exp2_approx(ok ? fmaf(s[idx], sl2, -lq) : fill2 - lq);
        pv = kin[hh] ? pv : 0.f;
        float kr = keep_scale;
        if constexpr (kDropout) kr = kw[e + 2 * hh] >= threshold ? keep_scale : 0.f;
        s[idx] = pv * kr;
        dp[idx] = pv * fmaf(dp[idx], kr, -di);
      }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pa[kk][t] = pack_bf16(s[8 * kk + 2 * t], s[8 * kk + 2 * t + 1]);
      sa[kk][t] = pack_bf16(dp[8 * kk + 2 * t], dp[8 * kk + 2 * t + 1]);
    }
}

// dS^T to a swizzled shared tile [key][q row] for dQ = dS K: sa[kk][t] is
// key row wrow + 8 (t & 1), chunk 2kk + (t >> 1) of that row
__device__ __forceinline__ void store_ds(uint32_t dst, const uint32_t (&sa)[4][4], int wrow,
                                         int tq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + sm90::sw128(wrow + 8 * (t & 1),
                                                                          2 * kk + (t >> 1)) +
                                                       4 * tq),
                   "r"(sa[kk][t])
                   : "memory");
}

// 2. the main kernel: one warpgroup of 64 keys and (NA = 2) one 64-column
// atom of dK / dV / dQ; TG the type of dk / dv (bf16 for #1b, f32 for
// #10b); NA / kFull the head-width tier
template <bool kDropout, typename TG, int NA, bool kFull>
__global__ void __launch_bounds__(128) flash_bwd_kernel(const BwdParams p) {
  using namespace sm90;
  constexpr int kThreads = 128;
  constexpr int CPR = 8 * NA;  // 16-byte chunks of a tile row
  constexpr int kStage = bwd_stage_bytes<NA>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  unsigned char* sm = smem_raw + (((raw_addr + 1023u) & ~1023u) - raw_addr);

  const Geom& g = p.g;
  const int Lq = g.Lq, Lk = g.Lk;
  const int kblk = blockIdx.x / NA, ca = blockIdx.x % NA;  // key block, dK / dV / dQ atom
  const int c0 = kblk * kBwdKeys, h = blockIdx.y, b = blockIdx.z;
  const int dch = kFull ? CPR : p.dch;
  const int tid = threadIdx.x, lane = tid % 32, tq = lane & 3;
  const int wrow = (tid / 32) * 16 + lane / 4;  // the thread's lower key row of its tile
  const int l_enc = Lk - p.dec_len;
  const size_t qb = head_base(g.q, b, h), kb = head_base(g.k, b, h);
  const size_t vb = head_base(g.v, b, h), gb = head_base(g.dout, b, h);
  const size_t stat = ((size_t)b * p.heads + h) * p.lq_pad;

  unsigned char* k_s = sm;
  unsigned char* v_s = sm + NA * kTile;
  unsigned char* dst_s = sm + 2 * NA * kTile;  // dS^T, [key][q row]
  unsigned char* stages = dst_s + kTile;

  // the live q tiles: all of them, or a prefix (encoder rows of a batch row
  // with no valid key) and a suffix (rows at or past the first decoder key)
  const float* km = p.key_mask + (size_t)b * Lk;
  const int c1 = min(c0 + kBwdKeys, Lk);
  bool mine = false, any = false;
  for (int c = tid; c < Lk; c += kThreads) {
    const bool on = km[c] > 0.f;
    any |= on;
    mine |= on && c >= c0 && c < c1;
  }
  const bool block_any = __syncthreads_or(mine), row_any = __syncthreads_or(any);
  const int nq = (Lq + kBwdRows - 1) / kBwdRows;
  int pre = nq, suf = nq;
  if (!block_any) {
    pre = 0;
    if (!row_any) {
      const int x = l_enc - g.row_offset;
      pre = x <= 0 ? 0 : min(nq, (x + kBwdRows - 1) / kBwdRows);
    }
    if (p.dec_len > 0 && c1 > l_enc) {
      const int x = max(c0, l_enc) - g.row_offset;
      if (x <= Lq - 1) suf = x <= 0 ? 0 : x / kBwdRows;
    }
    if (pre >= suf) pre = suf = nq;
  }
  const int n_live = pre + (nq - suf);
  auto tile_of = [&](int i) { return i < pre ? i : suf + (i - pre); };

  // this thread's two keys
  bool kval[2], kin[2];
  int kdec[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = c0 + wrow + 8 * hh;
    kin[hh] = key < Lk;
    kval[hh] = kin[hh] && km[key] > 0.f;
    kdec[hh] = (kin[hh] && p.dec_len > 0 && key >= l_enc) ? key : INT_MAX;
  }

  auto load_stage = [&](int s, int t) {
    unsigned char* st = stages + s * kStage;
    const uint32_t q_dst = smem_addr(st), o_dst = q_dst + NA * kTile;
    const int q0 = t * kBwdRows;
    for (int i = tid; i < kBwdRows * CPR; i += kThreads) {
      const int r = (unsigned)i / CPR, cc = (unsigned)i % CPR, row = q0 + r;
      const bool in = kFull || cc < dch;
      const bool ok = row < Lq && in;
      const size_t rr = (size_t)(row < Lq ? row : 0);
      const int col = in ? cc * 8 : 0;
      cp_async16(q_dst + atom_off(r, cc), p.q + qb + rr * g.q[2] + col, ok);
      cp_async16(o_dst + atom_off(r, cc), p.dout + gb + rr * g.dout[2] + col, ok);
    }
    if (tid < 32) {  // the tile's lse and D: 16 chunks of 4 floats each
      const float* src = (tid < 16 ? p.lse2 : p.di) + stat + q0 + (tid % 16) * 4;
      cp_async16(o_dst + NA * kTile + tid * 16, src, true);
    }
  };

  // prologue: K, V and the first tile, one commit group
  {
    const uint32_t k_dst = smem_addr(k_s), v_dst = smem_addr(v_s);
    for (int i = tid; i < kBwdKeys * CPR; i += kThreads) {
      const int r = (unsigned)i / CPR, cc = (unsigned)i % CPR, key = c0 + r;
      const bool in = kFull || cc < dch;
      const bool ok = key < Lk && in;
      const size_t row = (size_t)(key < Lk ? key : 0);
      const int col = in ? cc * 8 : 0;
      cp_async16(k_dst + atom_off(r, cc), p.k + kb + row * g.k[2] + col, ok);
      cp_async16(v_dst + atom_off(r, cc), p.v + vb + row * g.v[2] + col, ok);
    }
  }
  if (n_live > 0) load_stage(0, tile_of(0));
  cp_async_commit();

  const uint32_t seed = kDropout ? (uint32_t)(*p.seed) : 0u;
  const float keep_scale = kDropout ? p.keep_scale : 1.f;
  // dropout: this lane's place in its four-key group, and the first key of
  // the group it draws (combo ci = e + 2hh: q column e, key row hh)
  const int ci = (lane >> 2) & 3;
  const int key_group = c0 + (tid / 32) * 16 + 4 * (lane >> 4) + 8 * (ci >> 1);
  const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);
  const uint32_t dst_addr = smem_addr(dst_s);
  const int ksteps = kFull ? 4 * NA : (dch + 1) / 2;  // k16 steps of S^T, dP^T
  const float scale = kFull && NA == 1 ? 0.125f : p.scale;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kBwdStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + 1 < n_live) load_stage((i + 1) % kBwdStages, tile_of(i + 1));
    cp_async_commit();

    const int q0 = tile_of(i) * kBwdRows;
    unsigned char* st = stages + (i % kBwdStages) * kStage;
    const uint32_t q_addr = smem_addr(st), o_addr = q_addr + NA * kTile;
    const float* lse2_s = reinterpret_cast<const float*>(st + 2 * NA * kTile);

    // S^T = K Q^T, dP^T = V dO^T over the whole head row
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4 * NA; ++kt)
      if (kFull || kt < ksteps)
        wgmma_ss_n64(s, desc_sw128(k_addr + (kt / 4) * kTile) + 2 * (kt % 4),
                     desc_sw128(q_addr + (kt / 4) * kTile) + 2 * (kt % 4), kt > 0);
#pragma unroll
    for (int kt = 0; kt < 4 * NA; ++kt)
      if (kFull || kt < ksteps)
        wgmma_ss_n64(dp, desc_sw128(v_addr + (kt / 4) * kTile) + 2 * (kt % 4),
                     desc_sw128(o_addr + (kt / 4) * kTile) + 2 * (kt % 4), kt > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    uint32_t pa[4][4], sa[4][4];
    bwd_probs<kDropout>(s, dp, pa, sa, lse2_s, lse2_s + kBwdRows, g.row_offset + q0, kval, kin,
                        kdec, key_group, ci, tq, seed, p.threshold, keep_scale,
                        h + g.head_offset, b, scale);
    store_ds(dst_addr, sa, wrow, tq);
    fence_proxy_async();
    __syncthreads();  // dS^T complete before the product reads it

    // dV += (P^T K_r) dO, dK += dS^T Q, dQ_tile = dS K on this block's atom
    float dq[32];
    const uint32_t at = ca * kTile;
    wgmma_fence();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_tb(dv, pa[kk], desc_sw128(o_addr + at + kk * 2048));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_tb(dk, sa[kk], desc_sw128(q_addr + at + kk * 2048));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64_tatb(dq, desc_sw128(dst_addr + kk * 2048),
                        desc_sw128(k_addr + at + kk * 2048), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      asm volatile("" ::"r"(pa[kk][0]), "r"(pa[kk][1]), "r"(pa[kk][2]), "r"(pa[kk][3]),
                   "r"(sa[kk][0]), "r"(sa[kk][1]), "r"(sa[kk][2]), "r"(sa[kk][3])
                   : "memory");
    fence_regs(dq);
    // dq[4j + 2hh + e] is (q row wrow + 8hh, column 64 ca + 8j + 2tq + e);
    // the pad rows of the last tile add zeros into the scratch's padded
    // rows; the ordered form stores into this key block's own slice
    constexpr int DP = 64 * NA;  // columns of an accumulator row
    if (p.parts > 1) {
      float* part = p.acc + kblk * p.part_stride + (stat + q0 + wrow) * DP + 64 * ca + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(part + 8 * j) = make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(part + 8 * DP + 8 * j) =
            make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
    } else {
      float* acc = p.acc + (stat + q0 + wrow) * DP + 64 * ca + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        atomicAdd(reinterpret_cast<float2*>(acc + 8 * j), make_float2(dq[4 * j], dq[4 * j + 1]));
        atomicAdd(reinterpret_cast<float2*>(acc + 8 * DP + 8 * j),
                  make_float2(dq[4 * j + 2], dq[4 * j + 3]));
      }
    }
  }
  cp_async_wait<0>();

  // dK * scale and dV: dk[4j + 2hh + e] is (key wrow + 8hh, column 64 ca +
  // 8j + 2tq + e)
  TG* dkp = reinterpret_cast<TG*>(p.dk) + head_base(g.dk, b, h);
  TG* dvp = reinterpret_cast<TG*>(p.dv) + head_base(g.dv, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = c0 + wrow + 8 * hh;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * ca + 8 * j + 2 * tq, idx = 4 * j + 2 * hh;
      if (!kFull && c >= 8 * dch) continue;  // a zero-filled column of the tier
      put2(dkp + (size_t)key * g.dk[2] + c, dk[idx] * scale, dk[idx + 1] * scale);
      put2(dvp + (size_t)key * g.dv[2] + c, dv[idx], dv[idx + 1]);
    }
  }
}

// the three launches of one backward on `stream` at one head-width tier
template <typename TG, int NA, bool kFull>
int launch_flash_bwd(const BwdParams& p, int batch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int smem = bwd_smem_bytes<NA>();
  flash_bwd_pre_kernel<NA, kFull><<<dim3(p.lq_pad / 32, p.heads, batch), 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = p.seed != nullptr ? flash_bwd_kernel<true, TG, NA, kFull>
                                  : flash_bwd_kernel<false, TG, NA, kFull>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.g.Lk + kBwdKeys - 1) / kBwdKeys * NA, p.heads, batch), 128, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)batch * p.heads * p.g.Lq * 8 * NA;
  flash_bwd_dq_kernel<NA, kFull><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(p, batch);
  return (int)cudaGetLastError();
}

// the launches of one backward at head width d (flash_fwd.cuh's tiers); the
// tiers other than 64 are instantiated in flash_bwd_narrow.cu and
// flash_bwd_wide.cu and declared extern here
#define VT_FLASH_BWD_TIER(PREFIX, NA, FULL)                                              \
  PREFIX template int launch_flash_bwd<bf16, NA, FULL>(const BwdParams&, int, void*);  \
  PREFIX template int launch_flash_bwd<float, NA, FULL>(const BwdParams&, int, void*);

VT_FLASH_BWD_TIER(extern, 1, false)
VT_FLASH_BWD_TIER(extern, 2, false)

template <typename TG>
int launch_flash_bwd_d(const BwdParams& p, int batch, int d, void* stream) {
  return by_head_tier(d, [&](auto na, auto full) {
    return launch_flash_bwd<TG, decltype(na)::value, decltype(full)::value>(p, batch, stream);
  });
}

}  // namespace flash
}  // namespace vt
