// W8A8 post-attention block (eval): the three products int8 x int8 on the
// tensor cores, with per-row activation scales and per-output-channel
// weight scales.
//
// Replaces: vitxtgqa_tpu/ops/pallas_ffn.py:fused_block_w8a8 (the Pallas body
// _block_w8a8_kernel; its quantized math is block_w8a8_reference):
//   c8, cs = q(ctx)                                    per row: amax in the
//            input dtype, scale = max(amax, 1e-6) / 127, rint(v / scale)
//            clipped to +-127 (IEEE division, round half to even)
//   x      = LN1(x_q + (f32(c8 Wo8^T) * cs * wos + bo))           f32
//   h      = gelu_as(f32(q(x) W18^T) * xs * w1s + b1)              f32
//   out    = LN2(x + (f32(q(h) W28^T) * hs * w2s + b2))            bf16
// The weights arrive quantized once per set of weights (int8 [out, in],
// the nn.Linear layout, and f32 scales [out]); gelu_as is the
// Abramowitz-Stegun erf of the Pallas kernel (expf, never __expf).  The
// int32 sums are exact, so the kernel differs from its plain version only
// in the order of the LayerNorms' f32 sums, which can move one element of
// x or h across a rounding boundary of its int8 step.
//
// What bounds it on the H100: at the serving shape (rows = 8 * 1152 = 9216,
// D = 768, M = 3072) the products are 2 * rows * (D*D + 2*D*M) = 97.8 G
// integer operations against ~48 MB of activations and int8 weights: at
// 1,979 T int8 operations/s the tensor cores bound it (0.049 ms; the bytes
// need 0.014 ms).
//
// Design (first version, five launches):
//  1. quant_rows_kernel<bf16>: q(ctx), a warp per row (c8, cs);
//  2. row_gemm_s8<768>: a block owns 32 full rows of the 768-wide output,
//     c8 Wo8^T with mma.sync m16n8k32 s8 (s32 accumulate), the sums staged
//     in shared memory as f32, then an epilogue with a warp per row: scales,
//     bias, residual, LN1, and, since the block owns the whole row, x's own
//     per-row quantization (x32, x8, xs);
//  3. tile_gemm_s8: 128 x 128 output tiles of x8 W18^T whose epilogue applies
//     the scales, b1 and gelu_as from the accumulator registers, writing h
//     f32 [rows, M];
//  4. quant_rows_kernel<float>: q(h) over all M columns of a row (its amax
//     spans more than one tile) (h8, hs);
//  5. row_gemm_s8<M>: h8 W28^T, scales, b2, the f32 residual x, LN2 -> bf16.
// Tiles load with synchronous 16-byte copies into padded shared memory;
// fragments are 32-bit shared-memory reads.  wgmma (s8, 64-row tiles) and
// TMA pipelining are later work, as is keeping h on chip.
#include "row_ops.cuh"

namespace vt {
namespace w8a8 {

using gemm::RN;
using gemm::RGROUPS;
using gemm::load4;
using gemm::store4;
using gemm::row_stats;

constexpr int NT = 256;         // 8 warps
constexpr int KS = 64;          // K bytes per step (two k32 mma steps)
constexpr int LDK = KS + 16;    // byte row stride of a [rows][KS] tile: conflict-free fragments
constexpr int RBM = 32;         // rows per row-GEMM block
constexpr int RLDC = RN + 4;    // f32 row stride of the staged row-GEMM sums
constexpr int TBM = 128, TBN = 128;  // tile-GEMM output tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment of a 16 x 32 tile at rows r0.., bytes k0.. of a [rows][LDK] tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* As, int r0, int k0, int g,
                                       int t) {
  a[0] = lds32(As + (r0 + g) * LDK + k0 + 4 * t);
  a[1] = lds32(As + (r0 + g + 8) * LDK + k0 + 4 * t);
  a[2] = lds32(As + (r0 + g) * LDK + k0 + 16 + 4 * t);
  a[3] = lds32(As + (r0 + g + 8) * LDK + k0 + 16 + 4 * t);
}

// the B fragment of a 32 x 8 tile: output channels n0.., bytes k0.. of a
// [channels][LDK] weight tile (the [out, in] layout is mma's "col" B)
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* Ws, int n0, int k0, int g,
                                       int t) {
  b[0] = lds32(Ws + (n0 + g) * LDK + k0 + 4 * t);
  b[1] = lds32(Ws + (n0 + g) * LDK + k0 + 16 + 4 * t);
}

// rows r0 .. r0 + n - 1, bytes k0 .. k0 + KS - 1 of a [*, K] int8 matrix
// into a [n][LDK] tile; rows past `limit` read as zero
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src, int r0,
                                          int n, int limit, int K, int k0) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < n * (KS / 16); i += NT) {
    const int r = i / (KS / 16), c = (i % (KS / 16)) * 16;
    uint4 val = zero;
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * K + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDK + c) = val;
  }
}

__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-a * a));
}

__device__ __forceinline__ float gelu_as(float x) {
  return x * 0.5f * (1.0f + erf_as(x * 0.7071067811865476f));
}

__device__ __forceinline__ float quant_scale(float amax) { return fmaxf(amax, 1e-6f) / 127.0f; }

__device__ __forceinline__ int8_t quant(float v, float scale) {
  return (int8_t)fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
}

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(e[t]);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// ---- 1 / 4: per-row quantization, a warp per row -------------------------
// cols % 8 == 0; the row is read twice (amax, then the values), the second
// time from cache
template <typename T>
__global__ void __launch_bounds__(NT)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                  int rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  float amax = 0.f;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
  }
  const float scale = quant_scale(warp_max(amax));
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    load8(xr + c, v);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = quant(v[t], scale);
    *reinterpret_cast<uint2*>(q + (size_t)row * cols + c) = *reinterpret_cast<const uint2*>(o);
  }
  if (lane == 0) scales[row] = scale;
}

// ---- 2 / 5: the row GEMM with a LayerNorm epilogue ------------------------
// u = resid + (f32(acc) * a_scale[row] * w_scale[col] + bias[col]);
// y = LN(u).  LN1 form (out_q set): y -> out_f32, and y quantized per row
// -> out_q, out_qs.  LN2 form: y -> out_bf16.
struct LnEpi {
  const float* a_scale;
  const float* w_scale;
  const float* bias;
  const bf16* resid_bf16;
  const float* resid_f32;
  const float* gamma;
  const float* beta;
  float* out_f32;
  int8_t* out_q;
  float* out_qs;
  bf16* out_bf16;
  float eps;

  __device__ void operator()(const float* Cs, int m0, int M) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < RBM; r += NT / 32) {
      const int row = m0 + r;
      if (row >= M) continue;
      const float as = a_scale[row];
      float x[RGROUPS][4];
#pragma unroll
      for (int g = 0; g < RGROUPS; ++g) {
        const int c = g * 128 + lane * 4;
        const size_t gi = (size_t)row * RN + c;
        float cv[4], ws[4], bv[4], rv[4];
        load4(&Cs[r * RLDC + c], cv);
        load4(w_scale + c, ws);
        load4(bias + c, bv);
        if (resid_f32 != nullptr) load4(resid_f32 + gi, rv);
        else load4(resid_bf16 + gi, rv);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          x[g][t] = __fadd_rn(rv[t], __fadd_rn(__fmul_rn(__fmul_rn(cv[t], as), ws[t]), bv[t]));
      }
      const gemm::RowStats st = row_stats(x, eps);
      float amax = 0.f;
#pragma unroll
      for (int g = 0; g < RGROUPS; ++g) {
        const int c = g * 128 + lane * 4;
        float gm[4], bt[4];
        load4(gamma + c, gm);
        load4(beta + c, bt);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          x[g][t] = (x[g][t] - st.mu) * st.inv * gm[t] + bt[t];
          amax = fmaxf(amax, fabsf(x[g][t]));
        }
        if (out_f32 != nullptr) store4(out_f32 + (size_t)row * RN + c, x[g]);
        if (out_bf16 != nullptr) store4(out_bf16 + (size_t)row * RN + c, x[g]);
      }
      if (out_q != nullptr) {
        const float scale = quant_scale(warp_max(amax));
#pragma unroll
        for (int g = 0; g < RGROUPS; ++g) {
          const int c = g * 128 + lane * 4;
          const char4 q4 = make_char4(quant(x[g][0], scale), quant(x[g][1], scale),
                                      quant(x[g][2], scale), quant(x[g][3], scale));
          *reinterpret_cast<char4*>(out_q + (size_t)row * RN + c) = q4;
        }
        if (lane == 0) out_qs[row] = scale;
      }
    }
  }
};

constexpr int kRowLoop = (RBM + RN) * LDK;        // A and W tiles of one K step
constexpr int kRowSmem = RBM * RLDC * 4;           // the staged f32 sums (reuses the tiles)
static_assert(kRowSmem >= kRowLoop, "the staged sums cover the K-loop tiles");

// C[32, 768] = A[32, K] W[768, K]^T (int8, s32), then epi.  Warps: 2 along
// M (16 rows) x 4 along N (192 columns = 24 mma tiles of 8).
__global__ void __launch_bounds__(NT)
row_gemm_s8(const int8_t* __restrict__ A, const int8_t* __restrict__ W, int M, int K, LnEpi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Ws = As + RBM * LDK;
  float* Cs = reinterpret_cast<float*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  constexpr int NF = RN / 4 / 8;  // 24
  const int m0 = blockIdx.x * RBM;

  int acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += KS) {
    load_tile(As, A, m0, RBM, M, K, k0);
    load_tile(Ws, W, 0, RN, RN, K, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; kk += 32) {
      uint32_t a[4];
      load_a(a, As, wm * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        uint32_t b[2];
        load_b(b, Ws, wn * (RN / 4) + j * 8, kk, g, t);
        mma_s8(acc[j], a, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int col = wn * (RN / 4) + j * 8 + 2 * t;
    const int r = wm * 16 + g;
    Cs[r * RLDC + col] = __int2float_rn(acc[j][0]);
    Cs[r * RLDC + col + 1] = __int2float_rn(acc[j][1]);
    Cs[(r + 8) * RLDC + col] = __int2float_rn(acc[j][2]);
    Cs[(r + 8) * RLDC + col + 1] = __int2float_rn(acc[j][3]);
  }
  __syncthreads();
  epi(Cs, m0, M);
}

// ---- 3: the tile GEMM with the gelu epilogue ------------------------------
// h[M, N] = gelu_as(f32(A W^T) * a_scale[row] * w_scale[col] + bias[col]),
// f32.  Warps: 4 along M (32 rows = 2 mma tiles of 16) x 2 along N (64
// columns = 8 mma tiles of 8).
__global__ void __launch_bounds__(NT)
tile_gemm_s8_gelu(const int8_t* __restrict__ A, const int8_t* __restrict__ W, int M, int N, int K,
                  const float* __restrict__ a_scale, const float* __restrict__ w_scale,
                  const float* __restrict__ bias, float* __restrict__ h) {
  __shared__ __align__(16) int8_t As[TBM * LDK];
  __shared__ __align__(16) int8_t Ws[TBN * LDK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += KS) {
    load_tile(As, A, m0, TBM, M, K, k0);
    load_tile(Ws, W, n0, TBN, N, K, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a(a[i], As, wm * 32 + i * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b[2];
        load_b(b, Ws, wn * 64 + j * 8, kk, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + i * 16 + g + 8 * half;
      if (row >= M) continue;
      const float as = a_scale[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + 2 * t;
        float2 o;
        o.x = gelu_as(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), as),
                                          w_scale[col]), bias[col]));
        o.y = gelu_as(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), as),
                                          w_scale[col + 1]), bias[col + 1]));
        *reinterpret_cast<float2*>(h + (size_t)row * N + col) = o;
      }
    }
  }
}

}  // namespace w8a8
}  // namespace vt

// ptrs (void*, in this order): x_q, ctx [rows, d] bf16; wo8 [d, d], wos [d];
// bo, s1, g1 [d]; w18 [m, d], w1s [m], b1 [m]; w28 [d, m], w2s [d]; b2, s2,
// g2 [d] (int8 weights, f32 vectors); scratch c8 [rows, d] int8, cs [rows],
// x32 [rows, d] f32, x8 [rows, d] int8, xs [rows], h [rows, m] f32, h8
// [rows, m] int8, hs [rows]; out [rows, d] bf16.
extern "C" int vt_fused_block_w8a8(void* const* ptrs, int rows, int d, int m, float eps,
                                   void* stream) {
  using namespace vt::w8a8;
  using vt::bf16;
  if (d != RN || m % TBN != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const bf16* x_q = (const bf16*)ptrs[0];
  const bf16* ctx = (const bf16*)ptrs[1];
  const int8_t* wo8 = (const int8_t*)ptrs[2];
  const float *wos = (const float*)ptrs[3], *bo = (const float*)ptrs[4];
  const float *s1 = (const float*)ptrs[5], *g1 = (const float*)ptrs[6];
  const int8_t* w18 = (const int8_t*)ptrs[7];
  const float *w1s = (const float*)ptrs[8], *b1 = (const float*)ptrs[9];
  const int8_t* w28 = (const int8_t*)ptrs[10];
  const float *w2s = (const float*)ptrs[11], *b2 = (const float*)ptrs[12];
  const float *s2 = (const float*)ptrs[13], *g2 = (const float*)ptrs[14];
  int8_t* c8 = (int8_t*)ptrs[15];
  float* cs = (float*)ptrs[16];
  float* x32 = (float*)ptrs[17];
  int8_t* x8 = (int8_t*)ptrs[18];
  float* xs = (float*)ptrs[19];
  float* h = (float*)ptrs[20];
  int8_t* h8 = (int8_t*)ptrs[21];
  float* hs = (float*)ptrs[22];
  bf16* out = (bf16*)ptrs[23];
  cudaStream_t st = (cudaStream_t)stream;

  cudaError_t err =
      cudaFuncSetAttribute(row_gemm_s8, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmem);
  if (err != cudaSuccess) return (int)err;
  const int quant_blocks = (rows + NT / 32 - 1) / (NT / 32);
  const int row_blocks = (rows + RBM - 1) / RBM;

  quant_rows_kernel<bf16><<<quant_blocks, NT, 0, st>>>(ctx, c8, cs, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  LnEpi ln1 = {cs, wos, bo, x_q, nullptr, s1, g1, x32, x8, xs, nullptr, eps};
  row_gemm_s8<<<row_blocks, NT, kRowSmem, st>>>(c8, wo8, rows, d, ln1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 tgrid(m / TBN, (rows + TBM - 1) / TBM);
  tile_gemm_s8_gelu<<<tgrid, NT, 0, st>>>(x8, w18, rows, m, d, xs, w1s, b1, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  quant_rows_kernel<float><<<quant_blocks, NT, 0, st>>>(h, h8, hs, rows, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  LnEpi ln2 = {hs, w2s, b2, nullptr, x32, s2, g2, nullptr, nullptr, nullptr, out, eps};
  row_gemm_s8<<<row_blocks, NT, kRowSmem, st>>>(h8, w28, rows, m, ln2);
  return (int)cudaGetLastError();
}
