// A wgmma GEMM body for Hopper (sm_90a), templated over its tile form,
// its operand layouts and its epilogue:
//
//   C[M, N] = A[M, K] B[K, N] over k in one split of K, bf16 operands with
//   f32 accumulated in registers, or s8 operands with s32 accumulated
//   (exact), handed to an epilogue functor as an f32 tile.
//
// Its users: the training block (block_train.cu, #9a / #9b), the eval block
// (fused_block.cu, #2 / #3) and the ViT FFN (fused_ffn.cu, #13) in bf16; the
// W8A8 block (fused_block_w8a8.cu, #8) in s8.
//
// Operand layouts (row-major storage with a leading dimension ld):
//  - A K-major: A[m, k] at a[m * ld + k] (activations);
//  - A MN-major: A[m, k] at a[k * ld + m] (the A^T of a weight gradient
//    dW = X^T dY, whose reduction runs over the rows);
//  - B K-major: B[k, n] at b[n * ld + k] (the nn.Linear weight of x W^T);
//  - B MN-major: B[k, n] at b[k * ld + n] (the weight in the dy W of a
//    backward, and the second operand of a weight gradient).
// K-major tiles are rows of 64 K-elements (128 bytes) in the 128-byte
// swizzle of sm90.cuh; an MN-major tile is one such 64 x 64 block per 64
// MN-elements, its rows the K index, the blocks 8 KB apart (the
// descriptor's leading byte offset, LBO, for a tile 128 or 256 wide; the
// 8-row groups 1 KB apart, SBO).  The instruction's transpose bits read
// them MN-major.
//
// Element forms (Elem<T>): bf16, K step 64 elements, m64nNk16 products; s8,
// K step 128 elements, m64nNk32 products, both operands K-major (the
// integer wgmma has no transpose).  Either way a K step is one 128-byte
// swizzled row and a product step 32 bytes of it, so the ring, the swizzle
// and the descriptors' K advance are the same bytes; the s32 sums are
// converted to f32 (__int2float_rn) where the tile is staged.
//
// Tiles: a block of two consumer warpgroups (256 threads) owns kBM = 128
// output rows (64 a warpgroup) by Form::kBN columns and walks K in steps
// of one 128-byte row through a ring of Form::kStages shared-memory stages
// filled by 16-byte cp.async copies (every thread copies; zero fill past the
// ragged edge of M, and of K where K is the rows of a weight gradient).
// The copies of step i + kStages - 2 are issued at step i, after a barrier
// that every warpgroup reaches only once its products of step i - 2 are
// complete (wgmma.wait_group 1 keeps one step's products in flight behind
// the next).  Copies reach wgmma through the async-proxy fence.
//
// Tile forms (PERF.md section 6 has the sweeps): in bf16, chosen per launch
// by launch_gemm, Wide, 256 columns (m64n256) and a 4-stage ring, or
// Narrow, 128 columns (m64n128), for a launch where some N is no multiple
// of 256 or whose narrow tiles fit one wave of the card, or Thin, 64
// columns (m64n64), for a launch where some N is no multiple of 128 (a
// tensor-parallel rank's 192-column attention share at model 4: the split
// training block's dctx and dWo); one block an SM.
// In s8 (launch_gemm_s8) one form, S8: 128 columns and a 3-stage ring, two
// blocks an SM, since the W8A8 epilogues cost more than its products.  N is
// a multiple of the form's width; the host-side mirror of the choice and of
// the tile walk is ops/gemm_sm90.py.
//
// Work: a launch covers up to three problems (the weight gradients of the
// training block share one), each cut into splits of K x row tiles x
// column tiles; blockIdx.x walks the list, column tiles fastest so that
// the blocks in flight share their A rows in L2.
//
// Epilogue: once its products are done, a block stages its f32 tile in
// the ring's shared memory ([kBM][kBN + 8], padded against bank conflicts)
// and hands it to epi(tile, problem) on every thread; tile_rows walks it
// in chunks of eight consecutive columns of a row (a thread keeps its
// columns, so an epilogue's column sums stay in registers until
// tile_colsum adds the threads' in a fixed order), so the epilogue's loads
// and stores are 16-byte and row-contiguous.  Rows past M are never
// handed to the epilogue.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace vt {
namespace g90 {

constexpr int kBM = 128;      // output rows of a block: two warpgroups of 64
constexpr int kBK = 64;       // the bf16 K step: one 128-byte swizzled row
constexpr int kThreads = 256;
constexpr int kMaxProblems = 3;

// a tile form: its output columns and ring depth, and its shared memory
// (one block an SM)
template <int BN, int STAGES>
struct Form {
  static constexpr int kBN = BN, kStages = STAGES;
  static constexpr int kA = kBM * kBK * 2;  // 16 KB, either layout
  static constexpr int kB = BN * kBK * 2;
  static constexpr int kStage = kA + kB;
  static constexpr int kLdC = BN + 8;  // f32 row stride of the staged tile
  static_assert(kBM * kLdC * 4 <= STAGES * kStage, "the staged tile fits the ring");
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static constexpr int kRed = kThreads * 8 * 4;  // a thread's eight column sums
  // + 1024: the dynamic shared memory is aligned to 1024 bytes in-kernel
  static constexpr int kBytes = 1024 + STAGES * kStage + kRed;
};

// the element forms: accumulator type and K step (elements of one
// 128-byte row)
template <class T>
struct Elem;
template <>
struct Elem<bf16> {
  using Acc = float;
  static constexpr int kK = 64;
};
template <>
struct Elem<int8_t> {
  using Acc = int;
  static constexpr int kK = 128;
};

// the forms, chosen by measurement on the H100 (PERF.md section 6); S8, the
// s8 products' one form, fits two blocks an SM, so one block's epilogue
// runs under the other's products
using Wide = Form<256, 4>;
using Narrow = Form<128, 4>;
using Thin = Form<64, 4>;
using S8 = Form<128, 3>;
constexpr int kSMs = 132;  // the H100's SMs: one wave of one-block-an-SM tiles

// wgmma descriptor of a 128-byte-swizzled tile with an explicit leading
// byte offset (the MN-block stride of an MN-major operand wider than 64)
__device__ __forceinline__ uint64_t desc_sw128_lbo(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// one operand: row-major storage with leading dimension ld (elements of
// the launch's element form)
struct Operand {
  const void* p;
  int ld;
};

// one product C[M, N] = A B over K, cut into splits of k_chunk rows of K
// (a multiple of the K step); its blocks are items item0 .. item0 + items - 1
// (the tile counts are the launch's: tile_args)
struct Problem {
  Operand a, b;
  int M, N, K, k_chunk;
  int m_tiles, n_tiles, splits, item0;
};

struct GemmArgs {
  Problem p[kMaxProblems];
  int n_problems, items;
};

inline Problem make_problem(Operand a, Operand b, int M, int N, int K, int k_chunk) {
  Problem p = {a, b, M, N, K, k_chunk, 0, 0, 0, 0};
  return p;
}

// one product over all its rows: A [M, K] K-major, B K-major (x W^T) or
// MN-major (dy W)
inline GemmArgs one(const void* a, int lda, const void* b, int ldb, int M, int N, int K) {
  GemmArgs args = {};
  args.p[0] = make_problem({a, lda}, {b, ldb}, M, N, K, K);
  args.n_problems = 1;
  return args;
}

// the staged output tile an epilogue sees
template <int BN>
struct Tile {
  static constexpr int kBN = BN;
  const float* c;  // [kBM][ld] f32 in shared memory
  int ld;
  int m0, n0;      // global row and column of c[0]
  int M, N;
  int m_tile, split;
  float* red;      // [kThreads / (kBN / 8)][kBN] f32 shared scratch (column sums)
};

// copy rows r0 .. r0 + ROWS - 1 (< limit, else zero) x one 128-byte row of
// K-elements from k0 of a K-major operand into a swizzled [ROWS][128 B] tile
template <int ROWS, class T>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const Operand& o, int r0, int limit,
                                            int k0) {
  constexpr int kChunk = 16 / sizeof(T);  // elements of a 16-byte chunk
  const T* p = static_cast<const T*>(o.p);
  for (int i = threadIdx.x; i < ROWS * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7, row = r0 + r;
    const bool ok = row < limit;
    sm90::cp_async16(dst + sm90::sw128(r, c), p + (size_t)(ok ? row : 0) * o.ld + k0 + c * kChunk,
                     ok);
  }
}

// copy K rows k0 .. k0 + 63 (< k_end, else zero) x WIDTH MN-elements from
// mn0 of an MN-major operand into WIDTH / 64 swizzled [64][64] blocks
template <int WIDTH>
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const Operand& o, int mn0, int k0,
                                             int k_end) {
  constexpr int kChunks = WIDTH / 8;
  const bf16* p = static_cast<const bf16*>(o.p);
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, cc = i % kChunks, k = k0 + r;
    const bool ok = k < k_end;
    sm90::cp_async16(dst + (cc >> 3) * 8192 + sm90::sw128(r, cc & 7),
                     p + (size_t)(ok ? k : 0) * o.ld + mn0 + cc * 8, ok);
  }
}

// one 32-byte product step of the form's width: bf16 k16, or s8 k32
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    sm90::wgmma_ss_n256<TA, TB>(d, da, db);
  else if constexpr (BN == 128)
    sm90::wgmma_ss_n128<TA, TB>(d, da, db);
  else
    sm90::wgmma_ss_n64t<TA, TB>(d, da, db);
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(TA == 0 && TB == 0, "the s8 products read K-major operands only");
  static_assert(BN == 256 || BN == 128, "the s8 forms are 256 or 128 columns wide");
  if constexpr (BN == 256)
    sm90::wgmma_ss_s8_n256(d, da, db);
  else
    sm90::wgmma_ss_s8_n128(d, da, db);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }

// the tile loop; see the header comment
template <class F, bool kAMN, bool kBMN, class Epi, class T>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const GemmArgs args, const Epi epi) {
  using namespace sm90;
  using Acc = typename Elem<T>::Acc;
  constexpr int kK = Elem<T>::kK;
  constexpr int kBN = F::kBN, kStages = F::kStages;
  constexpr int kAhead = kStages - 2;  // K steps whose copies are in flight
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_addr(sm);

  // the item's problem, split and tile
  const int item = blockIdx.x;
  const int pi = (args.n_problems > 1 && item >= args.p[1].item0)
                     ? ((args.n_problems > 2 && item >= args.p[2].item0) ? 2 : 1)
                     : 0;
  const Problem pr = pi == 0 ? args.p[0] : (pi == 1 ? args.p[1] : args.p[2]);
  const int per_split = pr.m_tiles * pr.n_tiles;
  int t = item - pr.item0;
  const int split = t / per_split;
  t -= split * per_split;
  const int m_tile = t / pr.n_tiles, n_tile = t - m_tile * pr.n_tiles;
  const int m0 = m_tile * kBM, n0 = n_tile * kBN;
  const int kb = split * pr.k_chunk, ke = min(pr.K, kb + pr.k_chunk);
  const int nk = ke > kb ? (ke - kb + kK - 1) / kK : 0;

  auto load = [&](int s, int kt) {
    const uint32_t a_dst = base + s * F::kStage, b_dst = a_dst + F::kA;
    const int k0 = kb + kt * kK;
    if (kAMN)
      load_mnmajor<kBM>(a_dst, pr.a, m0, k0, ke);
    else
      load_kmajor<kBM, T>(a_dst, pr.a, m0, pr.M, k0);
    if (kBMN)
      load_mnmajor<kBN>(b_dst, pr.b, n0, k0, ke);
    else
      load_kmajor<kBN, T>(b_dst, pr.b, n0, pr.N, k0);
  };

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  Acc acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  const int wg = threadIdx.x / 128;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();  // step i has landed; every warpgroup is done with step i - 2
    if (i + kAhead < nk) load((i + kAhead) % kStages, i + kAhead);
    cp_async_commit();
    const uint32_t a_addr = base + (i % kStages) * F::kStage + wg * 8192;
    const uint32_t b_addr = base + (i % kStages) * F::kStage + F::kA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 32-byte product steps of the 128-byte row
      const uint64_t da = desc_sw128(a_addr + (kAMN ? kk * 2048 : kk * 32));
      const uint64_t db = kBMN ? desc_sw128_lbo(b_addr + kk * 2048, 8192)
                               : desc_sw128(b_addr + kk * 32);
      wgmma_ss<kBN, kAMN ? 1 : 0, kBMN ? 1 : 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring

  // stage the tile in f32: acc[4 j + 2 h + e] is row 16 (warp % 4) + lane /
  // 4 + 8 h of the warpgroup's 64, column 8 j + 2 (lane % 4) + e
  float* c_s = reinterpret_cast<float*>(sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int r0 = wg * 64 + (warp & 3) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(c_s + (r0 + 8 * h) * F::kLdC + 8 * j + 2 * (lane & 3)) =
          make_float2(to_f32(acc[4 * j + 2 * h]), to_f32(acc[4 * j + 2 * h + 1]));
  __syncthreads();
  const Tile<kBN> tile = {c_s, F::kLdC, m0, n0, pr.M, pr.N, m_tile, split,
                          reinterpret_cast<float*>(sm + kStages * F::kStage)};
  epi(tile, pi);
}

// Thin where some problem's N is no multiple of the narrow tile
// (ops/gemm_sm90.tile_n)
inline bool thin_launch(const GemmArgs& a) {
  for (int i = 0; i < a.n_problems; ++i)
    if (a.p[i].N % Narrow::kBN) return true;
  return false;
}

// Narrow where some problem's N is no multiple of the wide tile, or where
// the launch's narrow tiles (over all problems and splits) fit one wave of
// the card, twice as many blocks on it as wide ones (ops/gemm_sm90.tile_n)
inline bool narrow_launch(const GemmArgs& a) {
  long long wide = 0;
  for (int i = 0; i < a.n_problems; ++i) {
    const Problem& p = a.p[i];
    if (p.N % Wide::kBN) return true;
    wide += (long long)((p.M + kBM - 1) / kBM) * (p.N / Wide::kBN) *
            ((p.K + p.k_chunk - 1) / p.k_chunk);
  }
  return 2 * wide <= kSMs;
}

// every problem's tile counts and first item for tiles bn columns wide;
// false where a problem does not fit them (N no multiple of bn, a K-major
// K or a split no multiple of the K step k_step)
inline bool tile_args(GemmArgs& a, int bn, bool ragged_k, int k_step) {
  a.items = 0;
  for (int i = 0; i < a.n_problems; ++i) {
    Problem& p = a.p[i];
    if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.N % bn || p.k_chunk <= 0 || p.k_chunk % k_step ||
        (!ragged_k && p.K % k_step))
      return false;
    p.m_tiles = (p.M + kBM - 1) / kBM;
    p.n_tiles = p.N / bn;
    p.splits = (p.K + p.k_chunk - 1) / p.k_chunk;
    p.item0 = a.items;
    a.items += p.m_tiles * p.n_tiles * p.splits;
  }
  return true;
}

// launch one GemmArgs in form F and element type T on `st`
template <class F, bool kAMN, bool kBMN, class T, class Epi>
cudaError_t launch_form(GemmArgs args, const Epi& epi, cudaStream_t st) {
  // K-major loads read whole K steps; only the MN-major pair zero-fills K
  if (!tile_args(args, F::kBN, kAMN && kBMN, Elem<T>::kK)) return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<F, kAMN, kBMN, Epi, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kBytes);
  if (err != cudaSuccess) return err;
  if (args.items > 0) kernel<<<args.items, kThreads, F::kBytes, st>>>(args, epi);
  return cudaGetLastError();
}

// launch one GemmArgs of bf16 operands on `st` in the form thin_launch and
// narrow_launch pick
template <bool kAMN, bool kBMN, class Epi>
cudaError_t launch_gemm(const GemmArgs& args, const Epi& epi, cudaStream_t st) {
  if (thin_launch(args)) return launch_form<Thin, kAMN, kBMN, bf16>(args, epi, st);
  return narrow_launch(args) ? launch_form<Narrow, kAMN, kBMN, bf16>(args, epi, st)
                             : launch_form<Wide, kAMN, kBMN, bf16>(args, epi, st);
}

// launch one GemmArgs of int8 operands (both K-major) on `st`: form S8
template <class Epi>
cudaError_t launch_gemm_s8(const GemmArgs& args, const Epi& epi, cudaStream_t st) {
  return launch_form<S8, false, false, int8_t>(args, epi, st);
}

// ---- epilogue helpers --------------------------------------------------------

// f(row, col, v) for each chunk of eight consecutive columns of each row
// of the tile below M: thread t takes columns (t % (kBN / 8)) * 8 .. + 7
// of rows t / (kBN / 8), then every kThreads / (kBN / 8) rows further
template <class T, class F>
__device__ __forceinline__ void tile_rows(const T& t, F&& f) {
  constexpr int kPer = T::kBN / 8, kRows = kThreads / kPer;
  const int c = (threadIdx.x % kPer) * 8;
  for (int r = threadIdx.x / kPer; r < kBM && t.m0 + r < t.M; r += kRows) {
    const float4 lo = *reinterpret_cast<const float4*>(t.c + r * t.ld + c);
    const float4 hi = *reinterpret_cast<const float4*>(t.c + r * t.ld + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    f(t.m0 + r, t.n0 + c, v);
  }
}

// the tile's column sums in a fixed order: cs[e] is this thread's sum of
// column (t % (kBN / 8)) * 8 + e over its rows (tile_rows); the row
// groups' sums meet in red and thread c < kBN adds them in order into out[c]
template <class T>
__device__ __forceinline__ void tile_colsum(const T& t, const float (&cs)[8], float* out) {
  constexpr int kBN = T::kBN, kPer = kBN / 8, kGroups = kThreads / kPer;
  float* r = t.red + (threadIdx.x / kPer) * kBN + (threadIdx.x % kPer) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) r[e] = cs[e];
  __syncthreads();
  for (int c = threadIdx.x; c < kBN; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += t.red[g * kBN + c];
    out[c] = s;
  }
}

// eight floats as eight bf16, one 16-byte word
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(sm90::pack_bf16(v[0], v[1]), sm90::pack_bf16(v[2], v[3]),
                    sm90::pack_bf16(v[4], v[5]), sm90::pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void unpack8(uint4 w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace g90
}  // namespace vt
