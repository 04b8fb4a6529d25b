// A wgmma GEMM body for Hopper (sm_90a), templated over its operand
// layouts and its epilogue:
//
//   C[M, N] = A[M, K] B[K, N] over k in one split of K, bf16 operands, f32
//   accumulated in registers, handed to an epilogue functor.
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
// descriptor's leading byte offset, LBO; the 8-row groups 1 KB apart,
// SBO).  The instruction's transpose bits read them MN-major.
//
// Tiles: a block of two consumer warpgroups (256 threads) owns kBM = 128
// output rows (64 a warpgroup) by kBN = 256 columns and walks K in steps
// of kBK = 64 through a ring of kStages shared-memory stages filled by
// 16-byte cp.async copies (every thread copies; zero fill past the ragged
// edge of M, and of K where K is the rows of a weight gradient).  The
// copies of step i + kStages - 2 are issued at step i, after a barrier that every
// warpgroup reaches only once its products of step i - 2 are complete
// (wgmma.wait_group 1 keeps one step's products in flight behind the
// next).  Copies reach wgmma through the async-proxy fence.
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
// and stores are 16-byte and row-contiguous.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace vt {
namespace g90 {

// the tile, chosen by measurement on the H100 (PERF.md section 6: 128 x
// 128 tiles with 3 or 4 stages, or two blocks an SM, were slower)
constexpr int kBM = 128;      // output rows of a block: two warpgroups of 64
constexpr int kBN = 256;      // output columns of a block
constexpr int kBK = 64;       // K step: one 128-byte swizzled row of bf16
constexpr int kStages = 4;    // ring depth: copies run two K steps ahead
constexpr int kThreads = 256;
constexpr int kMaxProblems = 3;

// wgmma descriptor of a 128-byte-swizzled tile with an explicit leading
// byte offset (the MN-block stride of an MN-major operand wider than 64)
__device__ __forceinline__ uint64_t desc_sw128_lbo(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define VT_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
                 "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 256] += A[64 x 16] B[16 x 256] from shared memory (descriptors);
// TA / TB: the operand is MN-major (transposed by the instruction)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : VT_R8(0), VT_R8(8), VT_R8(16), VT_R8(24), VT_R8(32), VT_R8(40), VT_R8(48), VT_R8(56), VT_R8(64), VT_R8(72), VT_R8(80), VT_R8(88), VT_R8(96), VT_R8(104), VT_R8(112), VT_R8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


#undef VT_R8

// one operand: row-major storage with leading dimension ld (elements)
struct Operand {
  const bf16* p;
  int ld;
};

// one product C[M, N] = A B over K, cut into splits of k_chunk rows of K
// (a multiple of kBK); its blocks are items item0 .. item0 + items - 1
struct Problem {
  Operand a, b;
  int M, N, K, k_chunk;
  int m_tiles, n_tiles, splits, item0;
};

struct GemmArgs {
  Problem p[kMaxProblems];
  int n_problems, items;
};

// a host-side problem: its tile counts and first item
inline Problem make_problem(Operand a, Operand b, int M, int N, int K, int k_chunk, int item0) {
  Problem p = {a, b, M, N, K, k_chunk, (M + kBM - 1) / kBM, N / kBN,
               (K + k_chunk - 1) / k_chunk, item0};
  return p;
}

inline int items_of(const Problem& p) { return p.m_tiles * p.n_tiles * p.splits; }

// the staged output tile an epilogue sees
struct Tile {
  const float* c;  // [kBM][ld] f32 in shared memory
  int ld;
  int m0, n0;      // global row and column of c[0]
  int M, N;
  int m_tile, split;
  float* red;      // [kThreads / (kBN / 8)][kBN] f32 shared scratch (column sums)
};

struct Layout {
  static constexpr int kA = kBM * kBK * 2;  // 16 KB, either layout
  static constexpr int kB = kBN * kBK * 2;
  static constexpr int kStage = kA + kB;
  static constexpr int kLdC = kBN + 8;  // f32 row stride of the staged tile
  static_assert(kBM * kLdC * 4 <= kStages * kStage, "the staged tile fits the ring");
  static constexpr int kRed = kThreads * 8 * 4;  // a thread's eight column sums
  // + 1024: the dynamic shared memory is aligned to 1024 bytes in-kernel
  static constexpr int kBytes = 1024 + kStages * kStage + kRed;
};

// copy rows r0 .. r0 + ROWS - 1 (< limit, else zero) x 64 K-elements from
// k0 of a K-major operand into a swizzled [ROWS][64] tile
template <int ROWS>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const Operand& o, int r0, int limit,
                                            int k0) {
  for (int i = threadIdx.x; i < ROWS * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7, row = r0 + r;
    const bool ok = row < limit;
    sm90::cp_async16(dst + sm90::sw128(r, c), o.p + (size_t)(ok ? row : 0) * o.ld + k0 + c * 8,
                     ok);
  }
}

// copy K rows k0 .. k0 + 63 (< k_end, else zero) x WIDTH MN-elements from
// mn0 of an MN-major operand into WIDTH / 64 swizzled [64][64] blocks
template <int WIDTH>
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const Operand& o, int mn0, int k0,
                                             int k_end) {
  constexpr int kChunks = WIDTH / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, cc = i % kChunks, k = k0 + r;
    const bool ok = k < k_end;
    sm90::cp_async16(dst + (cc >> 3) * 8192 + sm90::sw128(r, cc & 7),
                     o.p + (size_t)(ok ? k : 0) * o.ld + mn0 + cc * 8, ok);
  }
}

// the tile loop; see the header comment
template <bool kAMN, bool kBMN, class Epi>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const GemmArgs args, const Epi epi) {
  using namespace sm90;
  using L = Layout;
  constexpr int kAhead = kStages - 2;  // K steps whose copies are in flight
  static_assert(kAhead >= 1, "a ring of at least three stages");
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
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  auto load = [&](int s, int kt) {
    const uint32_t a_dst = base + s * L::kStage, b_dst = a_dst + L::kA;
    const int k0 = kb + kt * kBK;
    if (kAMN)
      load_mnmajor<kBM>(a_dst, pr.a, m0, k0, ke);
    else
      load_kmajor<kBM>(a_dst, pr.a, m0, pr.M, k0);
    if (kBMN)
      load_mnmajor<kBN>(b_dst, pr.b, n0, k0, ke);
    else
      load_kmajor<kBN>(b_dst, pr.b, n0, pr.N, k0);
  };

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  const int wg = threadIdx.x / 128;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();  // step i has landed; every warpgroup is done with step i - 2
    if (i + kAhead < nk) load((i + kAhead) % kStages, i + kAhead);
    cp_async_commit();
    const uint32_t a_addr = base + (i % kStages) * L::kStage + wg * 8192;
    const uint32_t b_addr = base + (i % kStages) * L::kStage + L::kA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc_sw128(a_addr + (kAMN ? kk * 2048 : kk * 32));
      const uint64_t db = kBMN ? desc_sw128_lbo(b_addr + kk * 2048, 8192)
                               : desc_sw128(b_addr + kk * 32);
      wgmma_ss_n256<kAMN ? 1 : 0, kBMN ? 1 : 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring

  // stage the tile: acc[4 j + 2 h + e] is row 16 (warp % 4) + lane / 4 +
  // 8 h of the warpgroup's 64, column 8 j + 2 (lane % 4) + e
  float* c_s = reinterpret_cast<float*>(sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int r0 = wg * 64 + (warp & 3) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(c_s + (r0 + 8 * h) * L::kLdC + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  const Tile tile = {c_s, L::kLdC, m0, n0, pr.M, pr.N, m_tile, split,
                     reinterpret_cast<float*>(sm + kStages * L::kStage)};
  epi(tile, pi);
}

// launch one GemmArgs on `st`
template <bool kAMN, bool kBMN, class Epi>
cudaError_t launch_gemm(const GemmArgs& args, const Epi& epi, cudaStream_t st) {
  auto kernel = gemm_kernel<kAMN, kBMN, Epi>;
  constexpr int bytes = Layout::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (args.items > 0) kernel<<<args.items, kThreads, bytes, st>>>(args, epi);
  return cudaGetLastError();
}

// ---- epilogue helpers --------------------------------------------------------

// f(row, col, v) for each chunk of eight consecutive columns of each row
// of the tile below M: thread t takes columns (t % (kBN / 8)) * 8 .. + 7
// of rows t / (kBN / 8), then every kThreads / (kBN / 8) rows further
template <class F>
__device__ __forceinline__ void tile_rows(const Tile& t, F&& f) {
  constexpr int kPer = kBN / 8, kRows = kThreads / kPer;
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
__device__ __forceinline__ void tile_colsum(const Tile& t, const float (&cs)[8], float* out) {
  constexpr int kPer = kBN / 8, kGroups = kThreads / kPer;
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
