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
// A launch takes at most 8 batch rows: a larger batch runs in groups of 8
// rows (the last one 1-8), a launch each, in turn on one stream, as the
// Pallas kernel's grid runs blocks of 8 rows.  A group's pointers start at
// its first row; the [L, B, ...] arrays (kv8, kvs, row8, rowsc) keep the
// whole batch's layer stride (Params::BS), so no group copies the cache,
// and the scratch is one group's, reused by the next launch.
// Weights arrive in torch nn.Linear layout ([out, in], bf16, stacked over
// layers); biases and LayerNorm parameters in f32 [L, width].
//
// What bounds it on the H100: at the main path's widths, at batch 1-2 the
// weight reads, 14.2 MB per layer (42.5 MB per 3-layer step; ~13 us at
// 3.35 TB/s), plus 3.5 MB of int8 cache per row and layer; the FLOPs (2 per weight byte per row) are
// negligible.  The per-layer dependencies cost grid-wide barriers, and
// every phase between two barriers is a chain of memory latencies.
//
// Design: a persistent cooperative kernel, one block of 384 threads per SM
// (at most 168 registers a thread), four phases a layer with
// cooperative_groups::this_grid().sync() between them, where the first
// version had five and put each (row, head) unit's attention on one block
// (PERF.md section 6 has the phase times that chose this):
//  A. LN2 of the previous layer (every block, from the f32 rows staged in
//     shared memory), then the Q/K/V GEMV;
//  B. attention and Wo: each (batch row, head) unit is cut into key spans
//     that together fill the grid.  Every block of a unit scores all its
//     keys (so each forms the same softmax max and sum, and the weights
//     round after normalising as in the twin), then weighs V over its own
//     span only and writes that f32 partial; the unit's blocks meet at a
//     counter (no grid barrier), each sums the unit's partials in span order
//     into ctx_h (bf16), and each multiplies ctx_h by its share of the
//     output rows of Wo[:, h], writing the head's f32 partial of ctx Wo^T;
//  C. x1 = LN1(x + sum of the head partials in head order + bo) in every
//     block, then the W1 GEMV with the gelu;
//  D. the W2 GEMV, x1 + h W2^T + b2 -> the next layer's pre-LN rows.
// Each GEMV gives a warp several weight rows at once (one row of 3,072, or
// four of 768, on the main path), the groups of rows dealt to the blocks in
// turn so that every SM streams, and issues all of a lane's 16-byte loads
// of them before the phase's input is formed (the LayerNorm, the staging of
// h), so twelve loads a lane are in flight under it.  A weight of K input
// columns takes one of two forms (gemv): four rows a warp in pieces of 768
// columns where K <= 1,536, else one row a warp in pieces of 3,072 (the
// kernel is instantiated per pair of forms); a piece is twelve loads a
// lane, the last one masked where K ends inside it, and the next piece's
// loads go out before the dots of this one are reduced.  The GEMV inputs are bf16 values (the layer input, bf16(LN1)
// and h), held as bf16 in shared memory.  Before the attention phase each
// warp prefetches its W1 and W2 rows into L2 (cp.async.bulk.prefetch), and
// before the W2 phase its next-layer Q/K/V rows.  Scratch written inside
// the launch is read back with __ldcg (L2, not the non-coherent L1 path).
// The grid and the shared-memory attribute are computed once per device
// and shared-memory size.  The widths are runtime values: the hidden width
// D = H x Dh, a multiple of 128 up to 2,048, with the head width Dh a
// multiple of 8 up to 128, the FFN width M, a multiple of 128 up to 8,192
// (the main path's MMT: 768, 3,072, 12 heads of 64), at most 8 batch rows
// a launch, and the cache at most 4,096 slots; the wrapper raises on others.  Shared
// memory holds the f32 pre-LN rows [B][D], the bf16 layer input [B][D] and
// the GEMV input [B][max(D, M)] in bf16, which the attention scratch
// shares: 229,440 bytes at B = 8, D = 2,048, M = 8,192, within the 232,448
// a block may take.
//
// Head widths: the attention phase is a template on CPL, the 8-channel
// chunks of a head row a lane holds (four lanes a key): CPL = 2 takes
// heads up to 64 wide (the main path's 64, MiniLM's 32 on lanes 0-1), CPL
// = 4 up to 128 (72, 80, 128); a lane's chunks past Dh load nothing and
// hold zeros.  A head row starts at a multiple of 8 bytes of the int8
// cache (of 16 where Dh is a multiple of 16: then two chunks load as one
// 16-byte load, as the main path's do).
// Caches longer than 1,152 slots: the choice was between keeping a unit's
// scores in shared memory and merging the spans' (max, sum) pairs, or
// scores in global scratch.  Neither is needed: the scores take 4 bytes a
// slot of the attention scratch, which shares its bytes with the GEMV
// input (2 x B x max(D, M) bytes), so 4,096 slots (16 KB, 24,736 bytes of
// scratch with the 128-wide tier's) fit beside the widest launch's
// 229,440 bytes unchanged, and a narrow launch grows by at most that.
// Each block of a unit still scores every key, as before.  The scratch is
// sized by the launch's cache (Lp rounded to 4; the main path's form
// keeps 1,152), the first 1,152 keys' mask and K scale are loaded ahead
// into registers as before, and the keys past them read theirs in the
// masking pass.  The main path's form (768 / 3,072, 12 x 64, at most
// 1,152 slots) keeps every width and the cache bound compile-time
// constants; it compiles in fused_decode_step.cu, the run-time forms in
// fused_decode_step_{b2,b8}_{h64,h128}.cu (a source per batch bound and
// head tier, so that the build compiles them in parallel).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace vt {
namespace step {

constexpr int NT = 384;
constexpr int NW = NT / 32;
constexpr int MAXB = 8;
constexpr int kMaxD = 2048, kMaxM = 8192;  // the widest hidden and FFN widths
constexpr int kMaxHd = 128;         // the widest head
constexpr int kLoads = 12;          // a lane's 16-byte weight loads in flight
constexpr int kNarrowK = 1536;      // the widest K of the four-row GEMV form
constexpr int kMainLp = 1152;       // the main path's cache slots (the exact serving sequence)
constexpr int kMaxLp = 4096;        // cache slots of a run-time form
constexpr int kMaxSpans = 16;       // key spans of one (row, head) unit
constexpr float kFill = -1e30f;     // pallas_decode_step.py _NEG

// attention scratch floats of a unit: the scores (scap slots), then qh,
// cur (k8 | v8), per-warp partial outputs, reduction scratch, scalars,
// ctx_h, each HT (the head tier's width) where it holds a head row
__host__ __device__ constexpr int attn_floats(int scap, int ht) {
  return scap + ht + 2 * ht + NW * ht + 32 + 8 + ht;
}

// the dynamic shared memory of a launch: x1 f32 [B][D], xs bf16 [B][D],
// the GEMV input bf16 [B][max(D, M)] or the attention scratch (attn
// bytes), the LayerNorm statistics f32 [B][2]
__host__ __device__ constexpr int act_bytes(int B, int D, int M, int attn) {
  return 2 * B * (D > M ? D : M) > attn ? 2 * B * (D > M ? D : M) : attn;
}
__host__ __device__ constexpr int smem_bytes(int B, int D, int M, int attn) {
  return 4 * B * D + 2 * B * D + act_bytes(B, D, M, attn) + 8 * B;
}
static_assert(smem_bytes(MAXB, kMaxD, kMaxM, 4 * attn_floats(kMaxLp, kMaxHd)) <= 232448,
              "the widest launch fits an SM");

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
  float* pre;                                                    // [B, D] pre-LN rows
  bf16* h;                                                       // [B, M] scratch
  float* opart;                                                  // [H, B, D] ctx_h Wo[:, h]^T
  float* apart;                                                  // [B*H, spans, Dh] V partials
  int* arrive;                                                   // [B*H] span counters
  int L, B, Lp, step, write_offset, spans;                       // B: this launch's rows
  int BS;                                                        // rows a layer of kv8 / kvs / row8 / rowsc
  int D, M, H, Dh;                                               // hidden, FFN, heads, head width
  int scap;                                                      // score slots of the scratch
  float eps, scale;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ int8_t quantize(float x, float sc) {
  return (int8_t)fminf(fmaxf(rintf(x / sc), -127.f), 127.f);
}

// an asynchronous L2 prefetch of `bytes` (a multiple of 16) from p
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bf16x8(uint4 raw, float (&w)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) w[t] = __bfloat162float(e[t]);
}

// the first row of this warp's first group of R rows: groups go to the
// blocks in turn, so that a phase's rows spread over every SM
__device__ __forceinline__ int first_group() {
  return (threadIdx.x / 32) * gridDim.x + blockIdx.x;
}

// The two GEMV forms: four rows a warp in pieces of 3 x 256 columns (K up
// to kNarrowK), or one row in pieces of 12 x 256.  The kernel is a
// template on the form of its D-column weights (Q/K/V, W1) and of its
// M-column one (W2), so each call site holds one form's registers.
struct Rows4 {
  static constexpr int C = 3, R = 4;
};
struct Rows1 {
  static constexpr int C = 12, R = 1;
};
__host__ __device__ constexpr bool narrow_k(int K) { return K <= kNarrowK; }

// out[b][n] = act[b, :] . W[n, :] for the N rows of one [N, K] weight (K a
// multiple of 128): a warp takes R consecutive rows at once, in pieces of
// C x 256 columns, and loads a piece of all R rows (R x C = kLoads loads a
// lane; where K ends inside a piece the loads past it are skipped) before
// it uses any.  The warp's first loads are issued before prep(), which
// every thread calls and which fills act ([B][K] bf16 in shared memory, B
// <= MB) and ends in a block barrier, so the weights stream while the
// input is formed; each later piece's loads (the next piece, or the next
// group's first) go out before the dots of the current one are reduced.
// epi(b, n, acc) consumes each dot on lane 0.  F: the form (Rows4, Rows1).
template <class F, int MB, typename Row, typename Prep, typename Epi>
__device__ __forceinline__ void gemv(Row wrow, const bf16* act, int K, int N, int B, Prep prep,
                                     Epi epi) {
  constexpr int C = F::C, R = F::R;
  static_assert(R * C == kLoads, "a piece is kLoads loads a lane");
  const int lane = threadIdx.x % 32;
  const int step = gridDim.x * NW * R;
  const int pieces = (K + C * 256 - 1) / (C * 256);
  uint4 raw[R][C];
  auto load = [&](int n0, int pc) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bf16* wr = wrow(min(n0 + r, N - 1));
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int k = (pc * C + i) * 256 + lane * 8;
        if (k < K) raw[r][i] = __ldg(reinterpret_cast<const uint4*>(wr + k));
      }
    }
  };
  int n0 = first_group() * R;
  if (n0 < N) load(n0, 0);
  prep();
  for (; n0 < N; n0 += step) {
    float acc[R][MB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < MB; ++b) acc[r][b] = 0.f;
    for (int pc = 0; pc < pieces; ++pc) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int k0 = (pc * C + i) * 256 + lane * 8;
        if (k0 < K) {
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            if (b < B) {
              float a[8];
              bf16x8(*reinterpret_cast<const uint4*>(act + b * K + k0), a);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                float w[8];
                bf16x8(raw[r][i], w);
                acc[r][b] += a[0] * w[0] + a[1] * w[1] + a[2] * w[2] + a[3] * w[3] +
                             a[4] * w[4] + a[5] * w[5] + a[6] * w[6] + a[7] * w[7];
              }
            }
          }
        }
      }
      if (pc + 1 < pieces) load(n0, pc + 1);
      else if (n0 + step < N) load(n0 + step, 0);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        if (b < B) {
          const float s = warp_sum(acc[r][b]);
          if (lane == 0 && n0 + r < N) epi(b, n0 + r, s);
        }
      }
  }
}

// prefetch into L2 the weight rows this warp's gemv in the form F will read
// (a group of R rows is contiguous; N is a multiple of R): one bulk
// prefetch a group
template <class F, typename Row>
__device__ __forceinline__ void prefetch_rows(Row wrow, int N, int K) {
  constexpr int R = F::R;
  if (threadIdx.x % 32) return;
  for (int n0 = first_group() * R; n0 < N; n0 += gridDim.x * NW * R)
    prefetch_l2(wrow(n0), R * K * 2);
}

// LayerNorm of the B rows of src (shared memory, f32, D wide) with the f32
// scale / shift: a warp forms each row's statistics, then every thread
// normalises elements.  Each output is nullable: out_f32 (shared) takes
// the f32 result, out_bfs (shared) and out_bf (global) the bf16 values.
// Safe in place (out_f32 == src); stats is 2 * B floats of shared scratch.
// Ends in a block barrier.
template <int KD>
__device__ void layer_norm_rows(const float* src, const float* gamma, const float* beta, int B,
                                int d, float eps, float* stats, float* out_f32, bf16* out_bfs,
                                bf16* out_bf) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, D = KD ? KD : d;
  for (int b = warp; b < B; b += NW) {
    const float* r = src + b * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += r[c];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = r[c] - mu;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / D + eps);
    if (lane == 0) stats[2 * b] = mu, stats[2 * b + 1] = inv;
  }
  __syncthreads();
  constexpr int kU = 4;  // elements a thread, their scale / shift loaded together
  for (int i0 = threadIdx.x; i0 < B * D; i0 += kU * NT) {
    float gv[kU], bv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = (i0 + u * NT) % D;
      gv[u] = __ldg(gamma + c);
      bv[u] = __ldg(beta + c);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * NT, b = i / D;
      if (i >= B * D) break;
      const float y = (src[i] - stats[2 * b]) * stats[2 * b + 1] * gv[u] + bv[u];
      if (out_f32) out_f32[i] = y;
      if (out_bfs) out_bfs[i] = __float2bfloat16(y);
      if (out_bf) out_bf[i] = __float2bfloat16(y);
    }
  }
  __syncthreads();
}

// dst[i] = src[i] for count f32 values written in this launch
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int count) {
  for (int i = threadIdx.x * 4; i < count; i += NT * 4)
    *reinterpret_cast<float4*>(dst + i) = __ldcg(reinterpret_cast<const float4*>(src + i));
}

// dst[i] = src[i] for count bf16 values written in this launch
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int count) {
  for (int i = threadIdx.x * 8; i < count; i += NT * 8)
    *reinterpret_cast<uint4*>(dst + i) = __ldcg(reinterpret_cast<const uint4*>(src + i));
}

// four int8 of a word as exact floats: each byte, biased by 128, becomes
// the mantissa of 2^23 (a byte permute and a subtraction, no conversion)
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// a lane's CPL 8-channel chunks of one int8 head row
template <int CPL>
struct KRow {
  uint2 c[CPL];
};

// load the nval chunks of a lane's share of a head row at src (the others
// zero): as 16-byte pairs where vec16 (the row and the lane's share start
// at a multiple of 16 bytes and nval is even), else 8 bytes each
template <int CPL>
__device__ __forceinline__ void load_krow(KRow<CPL>& r, const int8_t* src, int nval,
                                          bool vec16) {
  if (vec16) {
#pragma unroll
    for (int i = 0; i < CPL / 2; ++i) {
      int4 w = make_int4(0, 0, 0, 0);
      if (2 * i < nval) w = __ldg(reinterpret_cast<const int4*>(src + 16 * i));
      r.c[2 * i] = make_uint2((uint32_t)w.x, (uint32_t)w.y);
      r.c[2 * i + 1] = make_uint2((uint32_t)w.z, (uint32_t)w.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      r.c[i] = i < nval ? __ldg(reinterpret_cast<const uint2*>(src + 8 * i)) : make_uint2(0u, 0u);
  }
}

template <int CPL>
__device__ __forceinline__ void i8row(const KRow<CPL>& r, float (&f)[8 * CPL]) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    i8x4(r.c[i].x, f + 8 * i);
    i8x4(r.c[i].y, f + 8 * i + 4);
  }
}

// the shared attention scratch of one unit (attn_floats(scap, HT) floats)
struct AttnSmem {
  float *s, *qh, *cur, *part, *red, *scal, *ctxh;
  __device__ AttnSmem(float* sm, int scap, int ht) {
    s = sm;
    qh = s + scap;
    cur = qh + ht;
    part = cur + 2 * ht;
    red = part + NW * ht;
    scal = red + 32;
    ctxh = scal + 8;
  }
};

constexpr int kKeyPass = NT / 4;              // keys a pass: four lanes a key
constexpr int kBatch = 4;                     // key passes whose loads are in flight together
constexpr int kKeyIts = kMainLp / NT;         // keys a thread whose mask and scale load ahead
constexpr int kVPre = 2;                      // V passes of a span loaded early

// Attention of one (batch row b, head h) unit of layer l over key span sp of
// S: the new row's quantization (span 0 writes row8 / rowsc), the scores and
// softmax over all keys, the weighted V rows of the span -> apart.  Four
// lanes share a key, 8 x CPL channels each (int8 to f32 by byte permutes);
// the span's first V rows and scales load under the softmax.
template <int KD, int CPL>
__device__ void attention_span(const Params& p, int l, int b, int h, int sp, int S,
                               const AttnSmem& a) {
  constexpr int HT = 32 * CPL, NC = 8 * CPL;  // the tier's head width; a lane's channels
  const int tid = threadIdx.x, ch = tid % 4, D = KD ? KD : p.D, H = KD ? KD / 64 : p.H;
  const int Dh = KD ? 64 : p.Dh;
  const bf16* qkv = p.qkv + (size_t)b * 3 * D;
  const int pos = p.write_offset + p.step;
  const size_t cache0 = ((size_t)l * p.BS + b) * p.Lp;
  // this lane's chunks of a head row, and whether they load in pairs
  const int nval = min(CPL, max(0, (Dh - ch * NC) / 8));
  const bool vec16 = KD ? true : Dh % 16 == 0;
  const int8_t* kv = p.kv8 + cache0 * 2 * D + h * Dh + (nval > 0 ? ch * NC : 0);
  const float* ks = p.kvs + ((size_t)l * p.BS + b) * 2 * p.Lp;
  const float* vs = ks + p.Lp;
  const float* mask = p.mask + (size_t)b * p.Lp;
  const int j0 = sp * p.Lp / S, j1 = (sp + 1) * p.Lp / S;
  // every key's mask and K scale (a key a thread), loaded first
  float mk[kKeyIts], ksk[kKeyIts];
#pragma unroll
  for (int it = 0; it < kKeyIts; ++it) {
    const int j = tid + it * NT;
    if (j < p.Lp) mk[it] = mask[j], ksk[it] = ks[j];
  }

  // the new row's scales from the amax over all heads (bf16 values): the K
  // row then the V row, eight values a thread at a time
  float ka = 0.f, va = 0.f;
  for (int c = tid * 8; c < 2 * D; c += NT * 8) {
    float w[8];
    bf16x8(__ldcg(reinterpret_cast<const uint4*>(qkv + D + c)), w);
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) m = fmaxf(m, fabsf(w[t]));
    if (c < D) ka = fmaxf(ka, m);
    else va = fmaxf(va, m);
  }
  ka = block_max(ka, a.red);
  va = block_max(va, a.red);
  const float k_sc = fmaxf(ka, 1e-6f) / 127.f;
  const float v_sc = fmaxf(va, 1e-6f) / 127.f;
  int8_t* r8 = p.row8 + ((size_t)l * p.BS + b) * 2 * D;
  if (tid < HT) {  // the head's row, zero past Dh
    float qv = 0.f, kc = 0.f, vc = 0.f;
    if (KD || tid < Dh) {
      const int c = h * Dh + tid;
      qv = __bfloat162float(__ldcg(qkv + c));
      const int8_t k8 = quantize(__bfloat162float(__ldcg(qkv + D + c)), k_sc);
      const int8_t v8 = quantize(__bfloat162float(__ldcg(qkv + 2 * D + c)), v_sc);
      kc = (float)k8;
      vc = (float)v8;
      if (sp == 0) {
        r8[c] = k8;
        r8[D + c] = v8;
      }
    }
    a.qh[tid] = qv;
    a.cur[tid] = kc;
    a.cur[HT + tid] = vc;
  }
  if (h == 0 && sp == 0 && tid == 0) {
    p.rowsc[((size_t)l * p.BS + b) * 2] = k_sc;
    p.rowsc[((size_t)l * p.BS + b) * 2 + 1] = v_sc;
  }
  __syncthreads();

  float qr[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) qr[t] = a.qh[ch * NC + t];
  float cur_sc = 0.f;  // the current token's score (slot pos)
  for (int t = 0; t < Dh; ++t) cur_sc += a.qh[t] * a.cur[t];
  cur_sc *= k_sc * p.scale;
  // q . k of every key, kBatch passes' loads in flight at a time
  for (int it0 = 0; it0 * kKeyPass < p.Lp; it0 += kBatch) {
    KRow<CPL> kr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = tid / 4 + (it0 + u) * kKeyPass;
      if (j < p.Lp && j != pos) load_krow<CPL>(kr[u], kv + (size_t)j * 2 * D, nval, vec16);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = tid / 4 + (it0 + u) * kKeyPass;
      float part = 0.f;
      if (j < p.Lp && j != pos) {
        float kf[NC];
        i8row<CPL>(kr[u], kf);
#pragma unroll
        for (int t = 0; t < NC; ++t) part += qr[t] * kf[t];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (ch == 0 && j < p.Lp) a.s[j] = part;
    }
  }
  __syncthreads();
  // the scores: scaled, masked, the current token's from registers
  float lmax = -INFINITY;
#pragma unroll
  for (int it = 0; it < kKeyIts; ++it) {
    const int j = tid + it * NT;
    if (j >= p.Lp) break;
    float sc;
    if (j == pos) sc = cur_sc;
    else if (mk[it] > 0.f || (j >= p.write_offset && j < pos)) sc = a.s[j] * (ksk[it] * p.scale);
    else sc = kFill;
    a.s[j] = sc;
    lmax = fmaxf(lmax, sc);
  }
  if (!KD) {  // keys past the ones loaded ahead (caches longer than 1,152)
    for (int j = tid + kKeyIts * NT; j < p.Lp; j += NT) {
      float sc;
      if (j == pos) sc = cur_sc;
      else if (mask[j] > 0.f || (j >= p.write_offset && j < pos)) sc = a.s[j] * (ks[j] * p.scale);
      else sc = kFill;
      a.s[j] = sc;
      lmax = fmaxf(lmax, sc);
    }
  }
  KRow<CPL> vr[kVPre];
  float vsr[kVPre];
#pragma unroll
  for (int it = 0; it < kVPre; ++it) {
    const int j = j0 + tid / 4 + it * kKeyPass;
    if (j < j1 && j != pos) {
      load_krow<CPL>(vr[it], kv + (size_t)j * 2 * D + D, nval, vec16);
      vsr[it] = vs[j];
    }
  }
  const float mx = block_max(lmax, a.red);
  float lsum = 0.f;
  for (int j = tid; j < p.Lp; j += NT) {
    const float e = expf(a.s[j] - mx);
    a.s[j] = e;
    lsum += e;
  }
  const float total = block_sum(lsum, a.red);
  if (tid == 0) {
    a.scal[0] = a.s[pos] / total;  // w_cur
    a.scal[1] = v_sc;
  }

  // the span's weights x V: a lane owns NC channels of one key; a warp
  // covers 8 keys, the block 96 keys per pass; each weight is rounded
  // after normalising (slot pos is skipped: w_cur enters in head_out);
  // lanes that share channels reduce by shuffles, the warps through shared
  // memory
  const int lane = tid % 32, warp = tid / 32;
  float acc[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) acc[t] = 0.f;
  auto weigh = [&](int j, const KRow<CPL>& raw, float vsj) {
    const float w = round_bf16(a.s[j] / total * vsj);
    if (w != 0.f) {
      float vf[NC];
      i8row<CPL>(raw, vf);
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[t] += w * vf[t];
    }
  };
#pragma unroll
  for (int it = 0; it < kVPre; ++it) {
    const int j = j0 + tid / 4 + it * kKeyPass;
    if (j < j1 && j != pos) weigh(j, vr[it], vsr[it]);
  }
  for (int j = j0 + tid / 4 + kVPre * kKeyPass; j < j1; j += kKeyPass)
    if (j != pos) {
      KRow<CPL> raw;
      load_krow<CPL>(raw, kv + (size_t)j * 2 * D + D, nval, vec16);
      weigh(j, raw, vs[j]);
    }
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 4);
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 8);
    acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int t = 0; t < NC; ++t) a.part[warp * HT + ch * NC + t] = acc[t];
  }
  __syncthreads();
  if (tid < Dh) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) o += a.part[i * HT + tid];
    p.apart[((size_t)(b * H + h) * S + sp) * Dh + tid] = o;
  }
}

// wait until `count` arrivals at *counter, this block's included (the
// blocks of one unit; co-resident under the cooperative launch)
__device__ __forceinline__ void unit_barrier(int* counter, int count) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counter, 1);
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < count);
  }
  __syncthreads();
}

constexpr int kWoPre = 2;  // passes of a span's Wo rows loaded before the wait

// Wo rows n .. of head h for this span's outputs: eight lanes on one output
// row (the head's Dh columns of Wo: chunks c8, c8 + 8 of a lane, CW of
// them, the ones past Dh skipped), a warp on four
template <int CW>
struct WoSlice {
  const bf16* wo;  // Wo[l] + h * Dh + (lane % 8) * 8
  int n_lo, n_hi, D, nval;
  uint4 pre[kWoPre][CW];
  __device__ WoSlice(const Params& p, int l, int h, int sp, int S, int d, int dh) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    D = d;
    nval = min(CW, max(0, (dh / 8 - lane % 8 + 7) / 8));
    wo = p.wo + (size_t)l * D * D + h * dh + (lane % 8) * 8;
    n_lo = sp * D / S;
    n_hi = (sp + 1) * D / S;
#pragma unroll
    for (int i = 0; i < kWoPre; ++i) {
      const int n = n_lo + warp * 4 + i * NW * 4 + lane / 8;
#pragma unroll
      for (int w = 0; w < CW; ++w)
        if (n < n_hi && w < nval)
          pre[i][w] = __ldg(reinterpret_cast<const uint4*>(wo + (size_t)n * D + 64 * w));
    }
  }
};

// ctx_h = bf16(sum of the unit's span partials in span order + w_cur *
// v_cur), then this span's share of ctx_h Wo[n, h*Dh:(h+1)*Dh]^T -> opart
template <int CW>
__device__ void head_out(const Params& p, int b, int h, int H, int S, int Dh, int HT,
                         const WoSlice<CW>& wos, const AttnSmem& a) {
  const int tid = threadIdx.x;
  if (tid < Dh) {
    const float* part = p.apart + (size_t)(b * H + h) * S * Dh + tid;
    float o = 0.f;
    for (int s = 0; s < S; ++s) o += __ldcg(part + s * Dh);
    o += a.scal[0] * (a.cur[HT + tid] * a.scal[1]);
    a.ctxh[tid] = round_bf16(o);
  }
  __syncthreads();
  const int lane = tid % 32, warp = tid / 32, c8 = lane % 8;
  auto out = [&](int i, const uint4 (&raw)[CW]) {  // pass i: warp-uniform
    const int n = wos.n_lo + warp * 4 + i * NW * 4 + lane / 8;
    float acc = 0.f;
    if (n < wos.n_hi) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
        if (cw < wos.nval) {
          float w[8];
          bf16x8(raw[cw], w);
#pragma unroll
          for (int t = 0; t < 8; ++t) acc += a.ctxh[(c8 + 8 * cw) * 8 + t] * w[t];
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (c8 == 0 && n < wos.n_hi) p.opart[((size_t)h * p.B + b) * wos.D + n] = acc;
  };
#pragma unroll
  for (int i = 0; i < kWoPre; ++i)
    if (wos.n_lo + warp * 4 + i * NW * 4 < wos.n_hi) out(i, wos.pre[i]);
  for (int i = kWoPre; wos.n_lo + warp * 4 + i * NW * 4 < wos.n_hi; ++i) {
    const int n = min(wos.n_lo + warp * 4 + i * NW * 4 + lane / 8, wos.n_hi - 1);
    uint4 raw[CW];
#pragma unroll
    for (int cw = 0; cw < CW; ++cw)
      if (cw < wos.nval)
        raw[cw] = __ldg(reinterpret_cast<const uint4*>(wos.wo + (size_t)n * wos.D + 64 * cw));
    out(i, raw);
  }
  __syncthreads();  // the unit's scratch is reused by the block's next unit
}

// MB: the largest batch of the instantiation (its GEMV accumulators); FD,
// FM: the GEMV forms of the D-column and the M-column weights; KD, KM: the
// widths where fixed at compile time (the main path's: heads of 64, at most
// kMainLp slots), else 0 (the widths of Params); CPL: the head tier (a
// lane's 8-channel chunks: heads up to 32 x CPL wide)
template <int MB, class FD, class FM, int KD, int KM, int CPL>
__global__ void __launch_bounds__(NT, 1) fused_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(!KD || CPL == 2, "the main path's form has heads of 64");
  constexpr int HT = 32 * CPL;
  const int D = KD ? KD : p.D, M = KM ? KM : p.M, H = KD ? KD / 64 : p.H;
  const int Dh = KD ? 64 : p.Dh, scap = KD ? kMainLp : p.scap;
  const int B = p.B, S = p.spans, units = B * H;
  float* x1 = reinterpret_cast<float*>(smem);           // [B][D] pre-LN rows, then LN1, f32
  bf16* xs = reinterpret_cast<bf16*>(x1 + B * D);        // [B][D] layer input
  unsigned char* act_raw = reinterpret_cast<unsigned char*>(xs + B * D);
  bf16* act = reinterpret_cast<bf16*>(act_raw);          // [B][max(D, M)] GEMV input
  float* stats = reinterpret_cast<float*>(
      act_raw + act_bytes(B, D, M, 4 * attn_floats(scap, HT)));  // [B][2]
  // the attention scratch shares the GEMV input's bytes
  const AttnSmem attn(reinterpret_cast<float*>(act_raw), scap, HT);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  auto qkv_row = [&](int l) {
    const size_t o = (size_t)l * D * D;
    const bf16 *wq = p.wq + o, *wk = p.wk + o, *wv = p.wv + o;
    return [=](int n) { return (n < D ? wq : (n < 2 * D ? wk : wv)) + (size_t)(n % D) * D; };
  };

  for (int l = 0; l < p.L; ++l) {
    const size_t vD = (size_t)l * D, vM = (size_t)l * M;
    const bf16* w1 = p.w1 + (size_t)l * M * D;
    const bf16* w2 = p.w2 + (size_t)l * D * M;
    auto w1_row = [=](int n) { return w1 + (size_t)n * D; };
    auto w2_row = [=](int n) { return w2 + (size_t)n * M; };
    // A: the layer input (LN2 of the previous layer's rows), then the
    // Q/K/V rows
    gemv<FD, MB>(qkv_row(l), xs, D, 3 * D, B, [&] {
      if (l == 0) {
        for (int i = tid; i < B * D; i += NT) xs[i] = p.x[i];
        __syncthreads();
      } else {
        stage_f32(x1, p.pre, B * D);
        __syncthreads();
        layer_norm_rows<KD>(x1, p.s2 + vD - D, p.g2 + vD - D, B, D, p.eps, stats, nullptr, xs,
                            nullptr);
      }
    }, [&](int b, int n, float a) {
      const float* bias = n < D ? p.bq : (n < 2 * D ? p.bk : p.bv);
      p.qkv[(size_t)b * 3 * D + n] = __float2bfloat16(a + bias[vD + n % D]);
    });
    prefetch_rows<FD>(w1_row, M, D);
    prefetch_rows<FM>(w2_row, D, M);
    grid.sync();

    // B: attention over key spans and the head's share of ctx Wo^T
    for (int item = blockIdx.x; item < units * S; item += gridDim.x) {
      const int u = item / S, sp = item % S;
      attention_span<KD, CPL>(p, l, u / H, u % H, sp, S, attn);
      const WoSlice<CPL / 2> wos(p, l, u % H, sp, S, D, Dh);
      if (S > 1) unit_barrier(p.arrive + u, (l + 1) * S);
      else __syncthreads();
      head_out<CPL / 2>(p, u / H, u % H, H, S, Dh, HT, wos, attn);
    }
    grid.sync();

    // C: x1 = LN1(x + sum_h opart[h] + bo) (in every block), then
    // h = bf16(gelu(bf16(x1) W1^T + b1))
    gemv<FD, MB>(w1_row, act, D, M, B, [&] {
      for (int i = tid * 4; i < B * D; i += NT * 4) {
        const int n = i % D;
        float4 o = __ldcg(reinterpret_cast<const float4*>(p.opart + i));
        for (int hh = 1; hh < H; ++hh) {
          const float4 t =
              __ldcg(reinterpret_cast<const float4*>(p.opart + (size_t)hh * B * D + i));
          o.x += t.x, o.y += t.y, o.z += t.z, o.w += t.w;
        }
        const float* bo = p.bo + vD + n;
        x1[i] = __bfloat162float(xs[i]) + (o.x + bo[0]);
        x1[i + 1] = __bfloat162float(xs[i + 1]) + (o.y + bo[1]);
        x1[i + 2] = __bfloat162float(xs[i + 2]) + (o.z + bo[2]);
        x1[i + 3] = __bfloat162float(xs[i + 3]) + (o.w + bo[3]);
      }
      __syncthreads();
      layer_norm_rows<KD>(x1, p.s1 + vD, p.g1 + vD, B, D, p.eps, stats, x1, act, nullptr);
    }, [&](int b, int n, float a) {
      p.h[(size_t)b * M + n] = __float2bfloat16(gelu_erf(a + p.b1[vM + n]));
    });
    if (l + 1 < p.L) prefetch_rows<FD>(qkv_row(l + 1), 3 * D, D);
    grid.sync();

    // D: x1 + h W2^T + b2 -> pre (LN2 runs at the next layer's start)
    gemv<FM, MB>(w2_row, act, M, D, B, [&] {
      stage_bf16(act, p.h, B * M);
      __syncthreads();
    }, [&](int b, int n, float a) {
      p.pre[(size_t)b * D + n] = x1[b * D + n] + (a + p.b2[vD + n]);
    });
    grid.sync();
  }
  if (blockIdx.x == 0) {
    // every unit barrier of the launch is behind the last grid barrier:
    // the counters go back to zero for the next launch
    for (int u = tid; u < units; u += NT) p.arrive[u] = 0;
    const size_t vD = (size_t)(p.L - 1) * D;
    stage_f32(x1, p.pre, B * D);
    __syncthreads();
    layer_norm_rows<KD>(x1, p.s2 + vD, p.g2 + vD, B, D, p.eps, stats, nullptr, nullptr, p.y);
  }
}

// One launch of an instantiation: its cooperative grid (one block an SM)
// on the current device for `smem` bytes, with the shared-memory attribute
// raised to it (computed once a (device, size)), and the key spans of a
// unit: the units' spans fill the grid at most once, so every block of a
// unit is resident when it waits for the others.
template <int MB, class FD, class FM, int KD, int KM, int CPL>
cudaError_t launch(Params p, int smem, cudaStream_t stream) {
  static CoopCache cache;
  const void* kernel = (const void*)fused_step_kernel<MB, FD, FM, KD, KM, CPL>;
  const CoopLaunch cfg = coop_launch(cache, kernel, NT, smem, 1);
  if (cfg.err != cudaSuccess) return cfg.err;
  const int per_unit = cfg.grid / (p.B * p.H);
  p.spans = per_unit < 1 ? 1 : (per_unit > kMaxSpans ? kMaxSpans : per_unit);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, cfg.grid, NT, args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the run-time forms of batch bound MB and head tier CPL: the pair of GEMV
// forms that fits the widths.  Instantiated in fused_decode_step_b{2,8}_
// h{64,128}.cu, declared extern below.
template <int MB, int CPL>
cudaError_t launch_runtime(const Params& p, int smem, cudaStream_t stream) {
  if (narrow_k(p.D))
    return narrow_k(p.M) ? launch<MB, Rows4, Rows4, 0, 0, CPL>(p, smem, stream)
                         : launch<MB, Rows4, Rows1, 0, 0, CPL>(p, smem, stream);
  return narrow_k(p.M) ? launch<MB, Rows1, Rows4, 0, 0, CPL>(p, smem, stream)
                       : launch<MB, Rows1, Rows1, 0, 0, CPL>(p, smem, stream);
}

extern template cudaError_t launch_runtime<2, 2>(const Params&, int, cudaStream_t);
extern template cudaError_t launch_runtime<8, 2>(const Params&, int, cudaStream_t);
extern template cudaError_t launch_runtime<2, 4>(const Params&, int, cudaStream_t);
extern template cudaError_t launch_runtime<8, 4>(const Params&, int, cudaStream_t);

}  // namespace step
}  // namespace vt
