// Greedy-decode epilogue of one step in ONE launch: classifier scores,
// OcrPtrNet copy scores, argmax and the next step's decoder-slot embedding.
//
// Replaces: vitxtgqa_tpu/ops/pallas_decode_step.py:fused_epilogue (the
// Pallas body _fused_epilogue_kernel).  Per batch row, with y the decode
// step's output (bf16, taken in f32):
//   fixed = y cls_w^T + cls_b                      [Vp]   (pad lanes -1e30)
//   q     = y ptr_w^T + ptr_b                      [QK]
//   dyn_n = (q . keys_n) * qk_scale + mask_n       [N]    (raw 0/1 mask ADDED)
//   scores = [fixed | dyn];  idx = argmax(scores), ties to the lowest index
//   next  = bf16(row + bf16(emb_rows[2 * min(step + 1, dec_len - 1) + is_ocr]))
// where row is answer-table row idx, or OCR-table row idx - Vp when idx >= Vp.
// cls_w [Vp, D] and ptr_w [QK, D] arrive in torch nn.Linear layout, f32 (the
// classifier and the pointer net stay float32); keys [B, N, QK] f32; the
// answer table [Vp, D] and the OCR table [B, N, D] in bf16.
//
// What bounds it on the H100: bytes.  Each call reads the f32 classifier
// (15.7 MB at Vp = 5120, D = 768), 2.4 MB of pointer weight and 2.9 MB of
// keys per batch row, about 21 MB at batch 1 (6.2 us at 3.35 TB/s), for 2
// operations per 4 bytes.  In the decode loop each call follows a decode
// step (#5) that streams the MMT weights and the cache, so it mostly reads
// these bytes from HBM, not from the L2.
//
// Design: every row dot is one work item of a warp, in the order q rows
// (ptr_w), classifier rows, key rows; with W warps in the grid, item i
// goes to warp i mod W, the warps numbered block-minor so that
// consecutive items land on consecutive blocks (each SM's share of the
// rows within one of every other's).  A warp takes its items two at a time,
// the loads of both rows (six 16-byte loads a lane each, a 768-float row)
// issued before the first FMA, every warp's first row (the q rows among
// them) before any other.  No grid-wide barrier and no fence before a q
// row is published (a fence would wait for the warp's outstanding row
// loads too): each q entry is one 8-byte store of its value and this
// launch's tag (one more than the last launch's, kept in the scratch), and
// a warp that reaches a key row copies q[b] into its shared memory, again
// while any entry lacks the tag.  Each warp keeps the (max, index) of the
// scores it wrote per batch row, each block merges its warps' into one
// partial per batch row, and the last block to take a ticket loads the
// grid's partials all at once, merges them (ties to the lowest index) and
// gathers the chosen rows in 16-byte chunks, a thread a chunk.  The waits
// need every block resident: the launch is cooperative, its grid (at most
// two 256-thread blocks an SM, sized at the instantiation's largest launch)
// computed once per device and width.  The scratch
// (ops/decode_step.epilogue_buffers) is zero before the first launch;
// every launch leaves its ticket zero.  A launch takes at most 8 batch
// rows: a larger batch runs in groups of 8 rows (the last one 1-8), a
// launch each, in turn on one stream, every batch-major pointer (y, keys,
// mask, ocr, scores, tok, emb_out) at the group's first row, as the Pallas
// kernel's grid runs blocks of rows.  The groups share one scratch: each
// launch's q rows carry its own tag and the ticket is zero between them.
#include "common.cuh"

namespace vt {
namespace epilogue {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int MAXB = 8;
constexpr int kCh = 6;  // 16-byte chunks a lane holds of one row: 768 floats a warp
constexpr int kMaxBlocksPerSM = 2;
constexpr int kMaxGrid = 1024;  // partials a batch row (ops/decode_step.EPILOGUE_MAX_GRID)

struct Params {
  const bf16* y;        // [B, D]
  const float* cls_w;   // [Vp, D]
  const float* cls_b;   // [Vp]
  const float* ptr_w;   // [QK, D]
  const float* ptr_b;   // [QK]
  const float* keys;    // [B, N, QK]
  const float* mask;    // [B, N]
  const bf16* ans;      // [Vp, D]
  const bf16* ocr;      // [B, N, D]
  const float* emb;     // [S2, D]
  float* scores;        // [B, Vp + N]
  int* tok;             // [B]
  bf16* emb_out;        // [B, D]
  unsigned long long* q;  // [B, QK] scratch: (launch tag << 32) | f32 bits
  float* part_v;        // [B, kMaxGrid] the blocks' (max, index) partials
  int* part_i;
  int* sync;            // [2]: blocks done, the last launch's tag
  int B, D, Vp, N, QK, S2, step, dec_len;
  float qk_scale;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// one row dot, work item i: a q row (kind 0) or a classifier row (1)
// against every y, or a key row (2) against q[b]
struct Item {
  const float* row;
  int kind, j, b, len;
};

__device__ __forceinline__ Item item_of(const Params& p, int i) {
  if (i < p.QK) return {p.ptr_w + (size_t)i * p.D, 0, i, 0, p.D};
  if (i < p.QK + p.Vp) return {p.cls_w + (size_t)(i - p.QK) * p.D, 1, i - p.QK, 0, p.D};
  // the batch row varies fastest: a warp's key rows (W items apart) share
  // one when B divides W, so it copies one q
  const int u = i - p.QK - p.Vp, n = u / p.B, b = u - n * p.B;
  return {p.keys + ((size_t)b * p.N + n) * p.QK, 2, n, b, p.QK};
}

// the bias of a q or classifier row, the mask entry of a key row
__device__ __forceinline__ float addend_of(const Params& p, const Item& it) {
  if (it.kind == 0) return __ldg(p.ptr_b + it.j);
  if (it.kind == 1) return __ldg(p.cls_b + it.j);
  return __ldg(p.mask + (size_t)it.b * p.N + it.j);
}

// chunks c0 .. c0 + kCh - 1 of a row (lane's 16 bytes every 128 floats)
__device__ __forceinline__ void load_row(float4* r, const Item& it, int c0, int lane) {
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int k = (c0 + c) * 128 + lane * 4;
    r[c] = k < it.len ? __ldg(reinterpret_cast<const float4*>(it.row + k))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int MB>
struct Warp {
  const Params& p;
  float* ys;  // [B][D] f32, the block's
  float* qs;  // [QK] f32, this warp's copy of q[qb]
  int lane, qb;
  unsigned tag;  // this launch's: one more than the last launch's
  float bv[MB];
  int bi[MB];

  __device__ Warp(const Params& p_, float* ys_, float* qs_, int lane_, unsigned tag_)
      : p(p_), ys(ys_), qs(qs_), lane(lane_), qb(-1), tag(tag_) {
#pragma unroll
    for (int b = 0; b < MB; ++b) bv[b] = -INFINITY, bi[b] = 0x7fffffff;
  }

  // q[b] in this warp's shared copy: each lane loads its entries of a
  // 768-entry run, all at once, until every entry of the run carries this
  // launch's tag
  __device__ __forceinline__ void ensure_q(int b) {
    if (qb == b) return;
    constexpr int kPairs = kCh;  // 16-byte pairs of entries a lane: 768 entries a warp
    const unsigned long long* src = p.q + (size_t)b * p.QK;
    __syncwarp();  // the last reads of the old copy
    for (int k0 = 0; k0 < p.QK; k0 += 64 * kPairs) {
      while (true) {
        unsigned long long e[kPairs][2];
        bool ok = true;
#pragma unroll
        for (int m = 0; m < kPairs; ++m) {
          const int k = k0 + 2 * lane + 64 * m;
          if (k < p.QK)
            asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];\n"
                         : "=l"(e[m][0]), "=l"(e[m][1]) : "l"(src + k) : "memory");
        }
#pragma unroll
        for (int m = 0; m < kPairs; ++m) {
          const int k = k0 + 2 * lane + 64 * m;
          if (k < p.QK) {
            ok &= (unsigned)(e[m][0] >> 32) == tag && (unsigned)(e[m][1] >> 32) == tag;
            qs[k] = __uint_as_float((unsigned)e[m][0]);
            qs[k + 1] = __uint_as_float((unsigned)e[m][1]);
          }
        }
        if (__all_sync(0xffffffffu, ok)) break;
        __nanosleep(64);
      }
    }
    __syncwarp();
    qb = b;
  }

  // one item start to end, its first kCh chunks already in r
  __device__ __forceinline__ void run(const Item& it, float4* r, float add) {
    const int W = p.Vp + p.N;
    float acc[MB];
#pragma unroll
    for (int i = 0; i < MB; ++i) acc[i] = 0.f;
    if (it.kind == 2) ensure_q(it.b);
    for (int c0 = 0; c0 * 128 < it.len; c0 += kCh) {
      if (c0) load_row(r, it, c0, lane);  // rows wider than kCh * 128 floats
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int k = (c0 + c) * 128 + lane * 4;
        if (k >= it.len) continue;
        if (it.kind == 2) {
          acc[0] += dot4(*reinterpret_cast<const float4*>(qs + k), r[c]);
        } else {
#pragma unroll
          for (int b = 0; b < MB; ++b)
            if (b < p.B) acc[b] += dot4(*reinterpret_cast<const float4*>(ys + b * p.D + k), r[c]);
        }
      }
    }
    if (it.kind == 2) {
      const float s = __fadd_rn(__fmul_rn(warp_sum(acc[0]), p.qk_scale), add);
      const int idx = p.Vp + it.j;
      if (lane == 0) p.scores[(size_t)it.b * W + idx] = s;
#pragma unroll
      for (int b = 0; b < MB; ++b)  // bv / bi stay in registers
        if (b == it.b && better(s, idx, bv[b], bi[b])) bv[b] = s, bi[b] = idx;
      return;
    }
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      if (b < p.B) {
        const float s = warp_sum(acc[b]) + add;
        if (it.kind == 0) {
          if (lane == 0) {  // one 8-byte store: the value and its tag together
            const unsigned long long e = (unsigned long long)tag << 32 | __float_as_uint(s);
            asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n"
                         : : "l"(p.q + (size_t)b * p.QK + it.j), "l"(e) : "memory");
          }
        } else {
          if (lane == 0) p.scores[(size_t)b * W + it.j] = s;
          if (better(s, it.j, bv[b], bi[b])) bv[b] = s, bi[b] = it.j;
        }
      }
    }
  }
};

template <int MB>
__global__ void __launch_bounds__(NT, kMaxBlocksPerSM)
fused_epilogue_kernel(const __grid_constant__ Params p) {
  constexpr int S = 2;  // rows a warp holds in flight (4 measured slower: PERF.md)
  extern __shared__ __align__(16) float smem[];
  __shared__ float wv[NW][MB];
  __shared__ int wi[NW][MB];
  __shared__ int chosen[MB];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // consecutive items on consecutive blocks: every SM's share of the rows
  // within one of every other's, the q rows spread over all of them
  const int nw = gridDim.x * NW, gw = warp * gridDim.x + blockIdx.x;
  const int n_items = p.QK + p.Vp + p.B * p.N;
  float* ys = smem;                             // [B][D]
  float* qs = smem + p.B * p.D + warp * p.QK;   // [NW][QK]
  Warp<MB> w(p, ys, qs, lane, (unsigned)__ldcg(p.sync + 1) + 1u);

  // a round: the warp's next S items, all their rows' loads (and their
  // addends) issued before the first FMA.  In round 0 every warp of the
  // block issues its slot 0 (the q rows among them) before any warp issues
  // the rest; y is staged between
  float4 r[S][kCh];
  float add[S];
  auto issue = [&](int base, int s0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = base + s * nw;
      if (s >= s0 && i < n_items) {
        const Item it = item_of(p, i);
        load_row(r[s], it, 0, lane);
        add[s] = addend_of(p, it);
      }
    }
  };
  if (gw < n_items) {
    const Item it = item_of(p, gw);
    load_row(r[0], it, 0, lane);
    add[0] = addend_of(p, it);
  }
  for (int i = tid; i < p.B * p.D; i += NT) ys[i] = __bfloat162float(p.y[i]);
  __syncthreads();
  issue(gw, 1);
  for (int base = gw; base < n_items; base += S * nw) {
#pragma unroll
    for (int s = 0; s < S; ++s) {  // a q row comes before a key row that waits
      const int i = base + s * nw;
      if (i < n_items) w.run(item_of(p, i), r[s], add[s]);
    }
    if (base + S * nw < n_items) issue(base + S * nw, 0);
  }

  // the block's (max, index) per batch row, then the ticket: one thread
  // merges the warps', writes the partials and takes the ticket with
  // acquire-release semantics, after its own writes
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < MB; ++i) wv[warp][i] = w.bv[i], wi[warp][i] = w.bi[i];
  }
  __syncthreads();
  if (tid == 0) {
    for (int row = 0; row < p.B; ++row) {
      float v = wv[0][row];
      int ix = wi[0][row];
      for (int k = 1; k < NW; ++k)
        if (better(wv[k][row], wi[k][row], v, ix)) v = wv[k][row], ix = wi[k][row];
      p.part_v[row * kMaxGrid + blockIdx.x] = v;
      p.part_i[row * kMaxGrid + blockIdx.x] = ix;
    }
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(p.sync) : "memory");
    last = ticket == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every partial loaded at once (kMaxGrid / NT a thread
  // and batch row), merged by warps, then across them (ties to the lower
  // index at every step) ...
  __threadfence();
  if (tid == 0) p.sync[0] = 0, p.sync[1] = (int)w.tag;  // every other block is done
  constexpr int PT = kMaxGrid / NT;
  float pv[MB][PT];
  int pi[MB][PT];
#pragma unroll
  for (int row = 0; row < MB; ++row)
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int k = tid + j * NT;
      const bool live = row < p.B && k < (int)gridDim.x;
      pv[row][j] = live ? __ldcg(p.part_v + row * kMaxGrid + k) : -INFINITY;
      pi[row][j] = live ? __ldcg(p.part_i + row * kMaxGrid + k) : 0x7fffffff;
    }
#pragma unroll
  for (int row = 0; row < MB; ++row) {
    float v = pv[row][0];
    int ix = pi[row][0];
#pragma unroll
    for (int j = 1; j < PT; ++j)
      if (better(pv[row][j], pi[row][j], v, ix)) v = pv[row][j], ix = pi[row][j];
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
      if (better(ov, oi, v, ix)) v = ov, ix = oi;
    }
    if (lane == 0) wv[warp][row] = v, wi[warp][row] = ix;
  }
  __syncthreads();
  if (tid < p.B) {
    float v = wv[0][tid];
    int ix = wi[0][tid];
    for (int k = 1; k < NW; ++k)
      if (better(wv[k][tid], wi[k][tid], v, ix)) v = wv[k][tid], ix = wi[k][tid];
    if (ix == 0x7fffffff) ix = 0;  // no finite score: argmax's first index
    chosen[tid] = ix;
    p.tok[tid] = ix;
  }
  __syncthreads();
  // ... and the chosen rows gathered in 8-element chunks, a thread a chunk
  const int t_next = p.step + 1 < p.dec_len - 1 ? p.step + 1 : p.dec_len - 1;
  for (int u = tid; u < p.B * (p.D / 8); u += NT) {
    const int row = u / (p.D / 8), c = (u - row * (p.D / 8)) * 8;
    const int ix = chosen[row];
    const bool is_ocr = ix >= p.Vp;
    const bf16* src = is_ocr ? p.ocr + ((size_t)row * p.N + (ix - p.Vp)) * p.D
                             : p.ans + (size_t)ix * p.D;
    const float* er = p.emb + (size_t)(2 * t_next + (is_ocr ? 1 : 0)) * p.D + c;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + c));
    const float4 e0 = __ldg(reinterpret_cast<const float4*>(er));
    const float4 e1 = __ldg(reinterpret_cast<const float4*>(er + 4));
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    const float e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
    uint4 o;
    bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int k = 0; k < 8; ++k) ob[k] = __float2bfloat16(__bfloat162float(x[k]) + round_bf16(e[k]));
    *reinterpret_cast<uint4*>(p.emb_out + (size_t)row * p.D + c) = o;
  }
}

// y [B][D] and each warp's copy of a q row
int smem_bytes(int batch, int d, int qk) { return (batch * d + NW * qk) * (int)sizeof(float); }

// the cooperative grid of one instantiation on the current device (at
// most kMaxBlocksPerSM blocks an SM, at most kMaxGrid), with the
// shared-memory attribute raised to the instantiation's largest launch at
// these widths (batch MB); computed once a (device, widths)
template <int MB>
CoopLaunch launch_config(int d, int qk) {
  static CoopCache cache;
  CoopLaunch c = coop_launch(cache, (const void*)fused_epilogue_kernel<MB>, NT,
                             smem_bytes(MB, d, qk), kMaxBlocksPerSM);
  if (c.grid > kMaxGrid) c.grid = kMaxGrid;
  return c;
}

template <int MB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const CoopLaunch cfg = launch_config<MB>(p.D, p.QK);
  if (cfg.err != cudaSuccess) return cfg.err;
  void* args[] = {(void*)&p};
  return cudaLaunchCooperativeKernel((const void*)fused_epilogue_kernel<MB>, cfg.grid, NT, args,
                                     smem_bytes(p.B, p.D, p.QK), stream);
}

}  // namespace epilogue
}  // namespace vt

// ptrs, in order: y, cls_w, cls_b, ptr_w, ptr_b, keys, mask, ans, ocr, emb,
// scores, tok, emb_out, q, part_v [B, 1024] f32, part_i [B, 1024] int32,
// sync [2] int32 (the blocks' ticket, left zero by each launch, and the
// last launch's tag; q and sync zero before the first launch) (17).
extern "C" int vt_fused_epilogue(void* const* ptrs, int batch, int d, int vp, int n, int qk,
                                 int s2, int step, int dec_len, float qk_scale, void* stream) {
  using namespace vt::epilogue;
  using vt::bf16;
  if (batch < 1 || batch > MAXB || d % 128 || qk % 128 || s2 < 2 * dec_len || dec_len < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  int i = 0;
  p.y = (const bf16*)ptrs[i++];
  p.cls_w = (const float*)ptrs[i++];
  p.cls_b = (const float*)ptrs[i++];
  p.ptr_w = (const float*)ptrs[i++];
  p.ptr_b = (const float*)ptrs[i++];
  p.keys = (const float*)ptrs[i++];
  p.mask = (const float*)ptrs[i++];
  p.ans = (const bf16*)ptrs[i++];
  p.ocr = (const bf16*)ptrs[i++];
  p.emb = (const float*)ptrs[i++];
  p.scores = (float*)ptrs[i++];
  p.tok = (int*)ptrs[i++];
  p.emb_out = (bf16*)ptrs[i++];
  p.q = (unsigned long long*)ptrs[i++];
  p.part_v = (float*)ptrs[i++];
  p.part_i = (int*)ptrs[i++];
  p.sync = (int*)ptrs[i++];
  p.B = batch;
  p.D = d;
  p.Vp = vp;
  p.N = n;
  p.QK = qk;
  p.S2 = s2;
  p.step = step;
  p.dec_len = dec_len;
  p.qk_scale = qk_scale;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = batch <= 2 ? launch<2>(p, s) : launch<MAXB>(p, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the grid of a launch at (batch, d, qk) on the current device
// (ops/decode_step.epilogue_grid)
extern "C" int vt_fused_epilogue_grid(int batch, int d, int qk, int* grid) {
  using namespace vt::epilogue;
  if (batch < 1 || batch > MAXB) return (int)cudaErrorInvalidValue;
  const vt::CoopLaunch c = batch <= 2 ? launch_config<2>(d, qk) : launch_config<MAXB>(d, qk);
  *grid = c.grid;
  return (int)c.err;
}
