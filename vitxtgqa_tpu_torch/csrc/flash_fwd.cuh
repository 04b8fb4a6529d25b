// The flash attention forward body shared by the merged-head flash (#1),
// its int8-emitting form (#11), its split-head form with a query-row offset
// (#10) and the bias-tensor attention (#14): one key loop for Hopper, a
// score policy chosen at compile time.
//
//   out = softmax(Q K^T / sqrt(64) + score policy) V  per (batch b, head h)
//
// on bf16 q [Lq, 64] and k / v [Lk, 64] slices read through their element
// strides (Geom, flash_attention.cuh), out bf16 through its own.
//
// Score policies:
//  - mask (kMask, #1 / #10 / #11): the in-kernel mask of
//    pallas_attention._allowed: global query row r (row_offset + local
//    row) may attend key c when key_mask[c] > 0, or when both lie in the
//    trailing causal decoder block of dec_len rows and c <= r.  A masked
//    score takes the -1e9 fill, a key past Lk takes -inf.  The JAX
//    wrappers pad the keys to round_up(Lk, 128) with key mask 0, so a row
//    with no allowed key averages V over round_up(Lk, 128) keys, the
//    zero-padded ones included: a row whose running max is still the fill
//    at the end adds round_up(Lk, 128) - Lk to its sum.  With dropout the
//    probabilities are dropped where the Philox bits of element (b, h, r,
//    c) fall below the threshold (philox.cuh; the row sum still counts
//    them) and the output is scaled by 1 / (1 - rate); the row log-sum-exp
//    (natural log, [B, H, Lq] f32) is written for the backward.
//  - bias (#14): s * scale + bias, an f32 bias broadcast over the query
//    rows (row stride 0) or per row, or none; keys past Lk take -inf in the
//    loop; a row whose running max is still -inf takes its exponentials
//    against 0.  The JAX wrapper pads the keys to round_up(Lk, 128) with
//    bias -1e9 and zero k / v, so at the end each row's sum gains
//    round_up(Lk, 128) - Lk keys scoring -1e9: nothing for a row with a
//    score above about -1e9 + 104, that share of the row for a row of -1e9
//    biases.
// The probabilities are rounded to bf16 for the P V product, as the Pallas
// kernels feed bf16 weights to their second matmul.
//
// What bounds it on the H100: at #1's serving shape ([8, 1152, 768], the
// synthetic batch's key mask) the two products are 32.6 GFLOP dense, about
// 21.5 over the live key tiles, against 57 MB of q / k / v / out: ~380
// FLOP per byte over the live tiles, above the bf16 ridge (~295), so the
// tensor cores bound it; #14 at [8, 16, 577, 64] likewise (10.9 GFLOP
// against 19 MB).  With dropout every probability also costs a quarter of
// a Philox4x32-10 evaluation on the integer units.
//
// Design.  A block of one warpgroup (128 threads) owns 64 query rows of one
// (head, batch) and walks the keys in tiles of 64.
//  - S = Q K^T is wgmma m64n64k16 from shared memory (sm90.cuh), Q and K
//    tiles in the 128-byte-swizzle layout (a 64-wide bf16 head row is one
//    128-byte atom).  S lives in registers (32 floats a thread).
//  - The online softmax runs on the accumulator fragment: a thread holds
//    two rows, the row max and sum are shuffles among the four lanes of a
//    row; exponentials are ex2 with scale * log2(e) folded into one
//    multiply, or into the exponent's FFMA on a tile with nothing to mask
//    or add (the -1e9 fill is used as is in that domain: its exponential
//    against any real row max is 0, and a row of fills still weighs its
//    keys equally); the lse is converted back to natural log.
//  - P goes to the second product in registers: the S fragment converted
//    to bf16x2 is the A operand of O += P V (wgmma m64n64k16, register A),
//    with V the MN-major B operand from shared memory (trans-b).  O stays
//    in registers (32 floats a thread).
//  - K / V tiles (and #14's bias tile) stream through a ring of two
//    shared-memory stages filled by 16-byte cp.async copies: the copies of
//    tile t + 1 are issued before the products of tile t, and waited for
//    with cp.async.wait_group.  Not TMA: serving is host-bound,
//    and a tensor map per operand per call (cuTensorMapEncodeTiled) would
//    add host work to every launch, while cp.async reads the strided
//    split-head views with no descriptor; a TMA producer warp is later
//    work if the loads stay exposed.
//  - Mask policy only: the block first reads its batch row's key mask
//    into a bit mask in shared memory and lists its live key tiles: a tile
//    is live if one of its keys has key_mask > 0, or if it reaches the
//    decoder block at or below the block's last row and the block has a row
//    at or past l_enc.  The ring walks only that list: exact for every row
//    with an allowed key (exp(-1e9 - m) is 0 in f32).  A block holding an
//    encoder row of a batch row with no valid key walks every tile, which
//    keeps the padded-key semantics above.  #14 skips nothing (its bias is
//    arbitrary).
//  - Dropout: a group of four keys (col0 % 4 == 0, philox.cuh) is split
//    between two lanes of the accumulator fragment; the lane pair shares
//    one evaluation per group and row pair: the even lane draws its upper
//    row's group, the odd lane its lower row's, and they swap the two
//    words the other needs by shuffle.
//  - #11's emission of the int8 cache (q-tile-0 blocks, before their own
//    attention) runs after the first stages' copies are issued, outside
//    the ring's steady state.
#pragma once

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace vt {
namespace flash {

// tile sizes, chosen by measurement on the H100 (PERF.md section 6: 3 or 4
// stages, two warpgroups of 64 rows and 128-key tiles were slower)
constexpr int kBQ = 64;       // query rows of a block: one warpgroup
constexpr int kBK = 64;       // keys per tile
constexpr int kStages = 2;    // K / V ring depth
constexpr int kThreads = 128;

constexpr float kLn2 = 0.6931471805599453f;

struct Emit {
  int8_t* k8;
  float* ks;
  int8_t* v8;
  float* vs;
};

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  Geom g;       // q / k / v / o strides, Lq, Lk, row_offset
  int heads;    // of the lse layout [B, H, Lq]
  int l_pad;    // round_up(Lk, 128): the keys a row of mask fills averages over
  // mask policy
  const float* key_mask;  // [B, Lk]
  int dec_len;
  float* lse;             // [B, H, Lq] or null
  const int64_t* seed;    // dropout seed on the device (kDropout)
  uint32_t threshold;
  float keep_scale;
  Emit emit;              // kEmit
  // bias policy: bias + b * bias_b + row * bias_r (bias_r 0: one row), or null
  const float* bias;
  long long bias_b, bias_r;
  int bias_vec16;         // the bias rows are 16-byte aligned: 16-byte copies
};

// quantize_kv of tokens [r0, r1) of one batch's [L, row_stride] slice, a
// warp per token; row_stride % 8 == 0 (the row is read twice, the second
// time from cache)
template <int NTH>
__device__ __forceinline__ void emit_int8(const bf16* __restrict__ src, int8_t* __restrict__ dst8,
                                          float* __restrict__ scales, int r0, int r1,
                                          int row_stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = r0 + warp; r < r1; r += NTH / 32) {
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

// Shared-memory layout of one launch: the Q tile, kStages stages of (K, V,
// bias) each 1024-byte aligned, then (mask policy) the key bit mask and the
// live tile list.
struct FwdLayout {
  static constexpr int kQBytes = kBQ * 128;
  static constexpr int kKVBytes = kBK * 128;
  static constexpr int kBiasLd = kBK + 8;  // floats: conflict-free float2 reads
  int bias_rows;                           // 0 (none), 1 (one row) or kBQ
  int stage_bytes, n_words, n_tiles, bytes;

  __host__ __device__ FwdLayout(int Lk, bool mask, int rows) : bias_rows(rows) {
    const int bias_bytes = rows * kBiasLd * 4;
    stage_bytes = (2 * kKVBytes + bias_bytes + 1023) / 1024 * 1024;
    n_tiles = (Lk + kBK - 1) / kBK;
    n_words = n_tiles * (kBK / 32);  // whole tiles: a tile reads kBK / 32 words
    // + 1024: the dynamic shared memory is aligned to 1024 bytes in-kernel
    bytes = 1024 + kQBytes + kStages * stage_bytes + (mask ? 4 * (n_words + n_tiles) : 0);
  }
};

template <bool kMask, bool kDropout, bool kEmit>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  using namespace sm90;
  constexpr int NJ = kBK / 8;  // 8-key column chunks of the S fragment
  static_assert(!kDropout || kMask, "dropout: mask policy only");

  extern __shared__ unsigned char smem_raw[];
  __shared__ int n_live_s;
  const uint32_t raw_addr = smem_addr(smem_raw);
  unsigned char* sm = smem_raw + (((raw_addr + 1023u) & ~1023u) - raw_addr);

  const Geom& g = p.g;
  const int Lq = g.Lq, Lk = g.Lk;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, tq = lane & 3;
  const int wrow = (tid / 32) * 16 + lane / 4;  // the thread's lower row
  const FwdLayout lay(Lk, kMask, kMask || p.bias == nullptr ? 0 : (p.bias_r == 0 ? 1 : kBQ));
  const size_t qb = head_base(g.q, b, h), kb = head_base(g.k, b, h);
  const size_t vb = head_base(g.v, b, h), ob = head_base(g.o, b, h);
  const int l_enc = Lk - p.dec_len;

  unsigned char* q_s = sm;
  unsigned char* stages = sm + FwdLayout::kQBytes;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(stages + kStages * lay.stage_bytes);
  int* live = reinterpret_cast<int*>(kbits + lay.n_words);

  // the live key tiles (mask policy); the bias policy walks them all
  int n_live = lay.n_tiles;
  if (kMask) {
    const float* km = p.key_mask + (size_t)b * Lk;
    for (int w = tid / 32; w < lay.n_words; w += kThreads / 32) {
      const int c = w * 32 + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, c < Lk && km[c] > 0.f);
      if (lane == 0) kbits[w] = bits;
    }
    __syncthreads();
    if (tid == 0) {
      const int row_lo = g.row_offset + q0;
      const int row_hi = g.row_offset + min(q0 + kBQ, Lq) - 1;
      bool any = false;
      for (int w = 0; w < lay.n_words; ++w) any |= kbits[w] != 0u;
      const bool walk_all = !any && row_lo < l_enc;  // rows with no allowed key
      const bool dec_rows = p.dec_len > 0 && row_hi >= l_enc;
      int n = 0;
      for (int t = 0; t < lay.n_tiles; ++t) {
        const int c0 = t * kBK, c1 = min(c0 + kBK, Lk);
        bool on = walk_all || (dec_rows && c1 > l_enc && max(c0, l_enc) <= row_hi);
        for (int w = c0 / 32; !on && w < (c1 + 31) / 32; ++w) on = kbits[w] != 0u;
        if (on) live[n++] = t;
      }
      n_live_s = n;
    }
    __syncthreads();
    n_live = n_live_s;
  }

  // one tile's K, V (and bias) into stage s
  auto load_stage = [&](int s, int t) {
    unsigned char* st = stages + s * lay.stage_bytes;
    const uint32_t k_dst = smem_addr(st), v_dst = k_dst + FwdLayout::kKVBytes;
    const int k0 = t * kBK;
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7, key = k0 + r;
      const bool ok = key < Lk;
      const size_t row = (size_t)(ok ? key : 0);
      cp_async16(k_dst + sw128(r, c), p.k + kb + row * g.k[2] + c * 8, ok);
      cp_async16(v_dst + sw128(r, c), p.v + vb + row * g.v[2] + c * 8, ok);
    }
    if (!kMask && lay.bias_rows > 0) {
      const uint32_t b_dst = v_dst + FwdLayout::kKVBytes;
      const float* src = p.bias + b * p.bias_b;
      if (p.bias_vec16) {
        for (int i = tid; i < lay.bias_rows * (kBK / 4); i += kThreads) {
          const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
          const int qr = q0 + r, key = k0 + c;
          const bool ok = qr < Lq && key < Lk;
          const int bytes = ok ? min(16, (Lk - key) * 4) : 0;
          const float* s_ = ok ? src + qr * p.bias_r + key : p.bias;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           b_dst + (uint32_t)((r * FwdLayout::kBiasLd + c) * 4)),
                       "l"(s_), "r"(bytes)
                       : "memory");
        }
      } else {
        for (int i = tid; i < lay.bias_rows * kBK; i += kThreads) {
          const int r = i / kBK, c = i % kBK, qr = q0 + r, key = k0 + c;
          const bool ok = qr < Lq && key < Lk;
          cp_async4(b_dst + (uint32_t)((r * FwdLayout::kBiasLd + c) * 4),
                    ok ? src + qr * p.bias_r + key : p.bias, ok);
        }
      }
    }
  };
  auto tile_of = [&](int i) { return kMask ? live[i] : i; };

  // prologue: Q and the first kStages - 1 tiles, one commit group each
  {
    const uint32_t q_dst = smem_addr(q_s);
    for (int i = tid; i < kBQ * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const bool ok = q0 + r < Lq;
      cp_async16(q_dst + sw128(r, c), p.q + qb + (size_t)(ok ? q0 + r : 0) * g.q[2] + c * 8, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_live) load_stage(s, tile_of(s));
    cp_async_commit();
  }

  if (kEmit && blockIdx.x == 0) {  // the merged layout only
    const int per = (Lk + p.heads - 1) / p.heads;
    const int r0 = h * per, r1 = min(Lk, r0 + per);
    const int rs = (int)g.k[2];
    const size_t bb = (size_t)b * g.k[0];
    emit_int8<kThreads>(p.k + bb, p.emit.k8 + bb, p.emit.ks + (size_t)b * Lk, r0, r1, rs);
    emit_int8<kThreads>(p.v + bb, p.emit.v8 + bb, p.emit.vs + (size_t)b * Lk, r0, r1, rs);
  }

  const float sl2 = 0.125f * kLog2e;  // 1 / sqrt(64), in the log2 domain
  const uint32_t seed = kDropout ? (uint32_t)(*p.seed) : 0u;
  const int grow_lo = g.row_offset + q0 + wrow, grow_hi = grow_lo + 8;  // global rows
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const uint64_t q_desc = desc_sw128(smem_addr(q_s));

  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1's stage
    if (i + kStages - 1 < n_live) load_stage((i + kStages - 1) % kStages, tile_of(i + kStages - 1));
    cp_async_commit();

    const int t = tile_of(i), k0 = t * kBK;
    unsigned char* st = stages + (i % kStages) * lay.stage_bytes;
    const uint32_t k_addr = smem_addr(st), v_addr = k_addr + FwdLayout::kKVBytes;

    // S = Q K^T
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(s, q_desc + 2 * kk, desc_sw128(k_addr) + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scores: s[4j + 2hh + e] is (row lo / hi, key k0 + 8j + 2tq + e).  A
    // tile with nothing to mask or add (every key valid or no bias, no
    // decoder key, no key past Lk) keeps its raw scores and folds the scale
    // into the exponent (e2 = sl2); any other tile is rewritten into the
    // log2 domain (e2 = 1: the exponent's argument is then exactly x - ref,
    // so a row of fills weighs its keys 1 each).
    const bool tail = k0 + kBK > Lk;
    bool raw = !tail;
    if constexpr (kMask) {
      uint32_t wb[kBK / 32];
#pragma unroll
      for (int w = 0; w < kBK / 32; ++w) {
        wb[w] = kbits[k0 / 32 + w];
        raw = raw && wb[w] == 0xffffffffu;
        wb[w] >>= 2 * tq;
      }
      const bool dec_tile = p.dec_len > 0 && k0 + kBK > l_enc;
      raw = raw && !dec_tile;
      if (!raw) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + 8 * j + 2 * tq + e, row = hh ? grow_hi : grow_lo;
              bool ok = (wb[j / 4] >> (8 * (j % 4) + e)) & 1u;
              if (dec_tile) ok = ok || (col >= l_enc && row >= l_enc && col <= row);
              float x = ok ? s[4 * j + 2 * hh + e] * sl2 : kNeg;
              if (tail && col >= Lk) x = -INFINITY;
              s[4 * j + 2 * hh + e] = x;
            }
      }
    } else {
      raw = raw && lay.bias_rows == 0;
      if (!raw) {
        const float* bs = reinterpret_cast<const float*>(st + 2 * FwdLayout::kKVBytes);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = 8 * j + 2 * tq;
            float2 bv = make_float2(0.f, 0.f);
            if (lay.bias_rows > 0)
              bv = *reinterpret_cast<const float2*>(
                  bs + (lay.bias_rows == 1 ? 0 : (wrow + 8 * hh) * FwdLayout::kBiasLd) + c);
            float x0 = s[4 * j + 2 * hh] * sl2 + bv.x * kLog2e;
            float x1 = s[4 * j + 2 * hh + 1] * sl2 + bv.y * kLog2e;
            if (tail && k0 + c >= Lk) x0 = -INFINITY;
            if (tail && k0 + c + 1 >= Lk) x1 = -INFINITY;
            s[4 * j + 2 * hh] = x0;
            s[4 * j + 2 * hh + 1] = x1;
          }
      }
    }
    const float e2 = raw ? sl2 : 1.f;

    // online softmax over the four lanes of each row (the max in the log2
    // domain: a raw tile's max times sl2)
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * e2), mn_hi = fmaxf(m_hi, mx_hi * e2);
    const float ref_lo = (!kMask && mn_lo == -INFINITY) ? 0.f : mn_lo;
    const float ref_hi = (!kMask && mn_hi == -INFINITY) ? 0.f : mn_hi;
    const float corr_lo = exp2_approx(m_lo - ref_lo), corr_hi = exp2_approx(m_hi - ref_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[4 * j] = exp2_approx(fmaf(s[4 * j], e2, -ref_lo));
      s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], e2, -ref_lo));
      s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], e2, -ref_hi));
      s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], e2, -ref_hi));
      ps_lo += s[4 * j] + s[4 * j + 1];
      ps_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * corr_lo + ps_lo;  // this thread's share of the row sum
    l_hi = l_hi * corr_hi + ps_hi;

    if constexpr (kDropout) {
      // the group of keys k0 + 8j + 4 * (tq / 2) .. + 3: the even lane of
      // the pair draws row lo's words, the odd lane row hi's
      const bool odd = tq & 1;
      const int my_row = odd ? grow_hi : grow_lo;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint4 w = philox_group(seed, 0u, (uint32_t)(k0 + 8 * j + 4 * (tq >> 1)),
                                     (uint32_t)my_row, (uint32_t)h, (uint32_t)b);
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        const uint32_t lo0 = odd ? r0 : w.x, lo1 = odd ? r1 : w.y;
        const uint32_t hi0 = odd ? w.z : r0, hi1 = odd ? w.w : r1;
        if (lo0 < p.threshold) s[4 * j] = 0.f;
        if (lo1 < p.threshold) s[4 * j + 1] = 0.f;
        if (hi0 < p.threshold) s[4 * j + 2] = 0.f;
        if (hi1 < p.threshold) s[4 * j + 3] = 0.f;
      }
    }

    // O = O * corr + P V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= corr_lo;
      o[4 * j + 1] *= corr_lo;
      o[4 * j + 2] *= corr_hi;
      o[4 * j + 3] *= corr_hi;
    }
    uint32_t a[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_n64_tb(o, a[kk], desc_sw128(v_addr + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      asm volatile("" ::"r"(a[kk][0]), "r"(a[kk][1]), "r"(a[kk][2]), "r"(a[kk][3]) : "memory");
  }
  cp_async_wait<0>();

  // the row sums over the four lanes; a row of mask fills also counts the
  // zero-padded keys up to round_up(Lk, 128)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const bool filled_lo = kMask && m_lo <= kNeg, filled_hi = kMask && m_hi <= kNeg;
  if (filled_lo) l_lo += (float)(p.l_pad - Lk);
  if (filled_hi) l_hi += (float)(p.l_pad - Lk);
  float f_lo = p.keep_scale, f_hi = p.keep_scale;
  if (!kMask && p.l_pad > Lk) {
    // the padded keys, each scoring -1e9 (log2 domain: pad2) against the
    // row max: 0 for a row with a score above about -1e9 + 104, a share
    // of the row for a row of -1e9 biases; a row below pad2 is rescaled
    // to it
    const float pad2 = kNeg * kLog2e, n_pad = (float)(p.l_pad - Lk);
    const float mf_lo = fmaxf(m_lo, pad2), mf_hi = fmaxf(m_hi, pad2);
    const float c_lo = exp2_approx(m_lo - mf_lo), c_hi = exp2_approx(m_hi - mf_hi);
    l_lo = fmaf(n_pad, exp2_approx(pad2 - mf_lo), l_lo * c_lo);
    l_hi = fmaf(n_pad, exp2_approx(pad2 - mf_hi), l_hi * c_hi);
    f_lo *= c_lo;
    f_hi *= c_hi;
  }
  f_lo /= l_lo;
  f_hi /= l_hi;
  const int r_lo = q0 + wrow, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    if (r_lo < Lq)
      *reinterpret_cast<uint32_t*>(p.out + ob + (size_t)r_lo * g.o[2] + c) =
          pack_bf16(o[4 * j] * f_lo, o[4 * j + 1] * f_lo);
    if (r_hi < Lq)
      *reinterpret_cast<uint32_t*>(p.out + ob + (size_t)r_hi * g.o[2] + c) =
          pack_bf16(o[4 * j + 2] * f_hi, o[4 * j + 3] * f_hi);
  }
  if (kMask && p.lse != nullptr && tq == 0) {
    const size_t stat = ((size_t)b * p.heads + h) * Lq;
    if (r_lo < Lq) p.lse[stat + r_lo] = (filled_lo ? kNeg : m_lo * kLn2) + logf(l_lo);
    if (r_hi < Lq) p.lse[stat + r_hi] = (filled_hi ? kNeg : m_hi * kLn2) + logf(l_hi);
  }
}

// launch one forward over grid (q tiles, heads, batch) on `stream`
template <bool kMask, bool kDropout, bool kEmit>
int launch_flash_fwd(const FwdParams& p, int batch, void* stream) {
  auto kernel = flash_fwd_kernel<kMask, kDropout, kEmit>;
  const int bias_rows = kMask || p.bias == nullptr ? 0 : (p.bias_r == 0 ? 1 : kBQ);
  const FwdLayout lay(p.g.Lk, kMask, bias_rows);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.g.Lq + kBQ - 1) / kBQ, p.heads, batch);
  kernel<<<grid, kThreads, lay.bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace vt
