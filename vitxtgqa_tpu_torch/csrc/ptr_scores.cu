// OCR pointer-net scores of one decode step over int8 per-token-scaled keys.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:ptr_scores_int8 (the Pallas
// body _ptr_scores_int8_kernel):
//   out[b, 0, n] = (q[b] . k8[b, n]) * (ks[b, n] * scale) + mask[b, n]
// q [B, 1, D] f32 (the pointer net computes in f32), k8 [B, N, D] int8 and
// ks [B, N] f32 in the ops/attention.quantize_kv layout, mask [B, N] the raw
// 0/1 OCR mask, ADDED (the reference OcrPtrNet quirk), scale = 1 / sqrt(D);
// f32 out [B, 1, N].
//
// What bounds it on the H100: one call reads the keys once, B*N*D bytes
// (5.9 MB at B = 8, N = 960, D = 768; 425 MB at the JAX bench's B = 576)
// for 2*B*N*D operations: 2 per byte, so device-memory bandwidth (1.8 us
// at B = 8, 127 us at B = 576, at 3.35 TB/s).  Two things stand in the
// way: the int8 -> f32 conversion (I2F runs at a quarter of the FFMA rate
// on sm_90, and at B = 576 its 425 M conversions alone take about as long
// as the bytes), and bytes in flight (a thread that loads q before its
// keys, or one key at a time, waits out a round trip per load).
//
// Design:
// - a half warp per key, its 16 lanes on 16-byte runs of the key row
//   (neighbouring lanes on neighbouring addresses), the dot reduced over
//   the half warp in the order of the kernel it replaces;
// - every key load of a tile (KH keys a half warp) is issued first, then
//   the keys' scales and mask entries, then q (only when the batch row
//   changes: once into shared memory for the block, then each lane's runs
//   into registers) while the keys are in flight, then the math;
// - the conversion without I2F: the byte with its sign bit flipped is
//   u = e + 128; one PRMT puts it into the low mantissa of 2^23, so the
//   float is 2^23 + u exactly, and one FADD of -(2^23 + 128) leaves e
//   exactly, so every product is the one of (float)e;
// - the launch plan (ops/ptr_scores.launch_plan mirrors it): tiles of
//   keys of one batch row; where fewer than one tile of 32 keys an SM
//   exists (B = 1, 2, 4 at N = 960), tiles of 4 keys on 64-thread blocks
//   spread the keys over every SM; else tiles of 32 keys (8 half warps x 4
//   keys) on 128-thread blocks, at most kPerSM a SM, each block streaming a
//   contiguous range of tiles; a block divides once, to find its first
//   tile's batch row (the only I2F-family instruction in the kernel is that
//   division's reciprocal seed, I2F.RP: chip_smoke.check_no_i2f).
#include "common.cuh"

namespace vt {
namespace ptr {

constexpr int kMaxChunks = 8;  // D <= 16 lanes x 16 bytes x 8 = 2048
constexpr int kSpreadThreads = 64, kSpreadKh = 1;  // 4 keys a block
constexpr int kStreamThreads = 128, kStreamKh = 4;  // 32 keys a block
constexpr int kPerSM = 4;
constexpr float kMagic = 8388736.f;  // 2^23 + 128

// the four int8 values of a word as exact floats, without I2F
__device__ __forceinline__ void bytes_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // e + 128 in each byte
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)), kMagic);
}

struct Plan {
  int threads, kh, kpb, tiles_per_row, tiles, chunk, grid;
};

// tiles of KH keys a half warp, batch row major; block `blk` takes tiles
// [blk * chunk, (blk + 1) * chunk)
template <int NC, int KH>
__global__ void __launch_bounds__(kStreamThreads)
ptr_scores_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                       const float* __restrict__ ks, const float* __restrict__ mask,
                       float* __restrict__ out, int N, int D, float scale, int tiles_per_row,
                       int tiles, int chunk) {
  __shared__ __align__(16) float qs[kMaxChunks * 256];  // q of the current batch row
  const int hw = blockDim.x / 16, h = threadIdx.x / 16, hl = threadIdx.x % 16;
  const int kpb = hw * KH;
  const int t0 = blockIdx.x * chunk, t1 = min(t0 + chunk, tiles);
  int b = t0 / tiles_per_row, tr = t0 - b * tiles_per_row;  // the block's one division
  int qrow = -1;
  float qr[NC][16];
  for (int t = t0; t < t1; ++t) {
    const int key0 = tr * kpb;
    // 1. the tile's key rows, then their scales and mask entries
    int4 w[KH][NC];
    float sc[KH], mk[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int n = key0 + h + j * hw;
      const size_t row = (size_t)b * N + n;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = hl * 16 + i * 256;
        w[j][i] = make_int4(0, 0, 0, 0);
        if (n < N && c < D) w[j][i] = __ldg(reinterpret_cast<const int4*>(k8 + row * D + c));
      }
    }
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int n = key0 + h + j * hw;
      const size_t row = (size_t)b * N + n;
      sc[j] = mk[j] = 0.f;
      if (n < N && hl == 0) {
        sc[j] = __ldg(ks + row);
        mk[j] = __ldg(mask + row);
      }
    }
    // 2. q of a new batch row, while the keys are in flight: once into
    // shared memory for the block, then each lane's runs into registers
    if (b != qrow) {
      qrow = b;
      __syncthreads();  // the last tile's reads of qs
      for (int k = threadIdx.x * 4; k < D; k += blockDim.x * 4)
        *reinterpret_cast<float4*>(qs + k) = __ldg(reinterpret_cast<const float4*>(q + (size_t)b * D + k));
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = hl * 16 + i * 256;
#pragma unroll
        for (int u = 0; u < 16; u += 4) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c < D) v = *reinterpret_cast<const float4*>(qs + c + u);
          qr[i][u] = v.x, qr[i][u + 1] = v.y, qr[i][u + 2] = v.z, qr[i][u + 3] = v.w;
        }
      }
    }
    // 3. the dots, in the order of the kernel this one replaced
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const uint32_t words[4] = {(uint32_t)w[j][i].x, (uint32_t)w[j][i].y,
                                   (uint32_t)w[j][i].z, (uint32_t)w[j][i].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float f[4];
          bytes_to_f32(words[x], f);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc = fmaf(qr[i][4 * x + e], f[e], acc);
        }
      }
      for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const int n = key0 + h + j * hw;
      if (hl == 0 && n < N)
        out[(size_t)b * N + n] = __fadd_rn(__fmul_rn(acc, __fmul_rn(sc[j], scale)), mk[j]);
    }
    if (++tr == tiles_per_row) tr = 0, ++b;
  }
}

// the launch of (batch, n) on `sms` SMs; ops/ptr_scores.launch_plan
Plan launch_plan(int batch, int n, int sms) {
  Plan p;
  const int stream_kpb = kStreamThreads / 16 * kStreamKh;
  const bool spread = batch * ((n + stream_kpb - 1) / stream_kpb) < sms;
  p.threads = spread ? kSpreadThreads : kStreamThreads;
  p.kh = spread ? kSpreadKh : kStreamKh;
  p.kpb = p.threads / 16 * p.kh;
  p.tiles_per_row = (n + p.kpb - 1) / p.kpb;
  p.tiles = batch * p.tiles_per_row;
  const int cap = spread ? p.tiles : sms * kPerSM;
  p.chunk = (p.tiles + cap - 1) / cap;
  p.grid = (p.tiles + p.chunk - 1) / p.chunk;
  return p;
}

template <int NC>
void launch(const Plan& p, cudaStream_t stream, const float* q, const int8_t* k8, const float* ks,
            const float* mask, float* out, int n, int d, float scale) {
  if (p.kh == kStreamKh)
    ptr_scores_int8_kernel<NC, kStreamKh><<<p.grid, p.threads, 0, stream>>>(
        q, k8, ks, mask, out, n, d, scale, p.tiles_per_row, p.tiles, p.chunk);
  else
    ptr_scores_int8_kernel<NC, kSpreadKh><<<p.grid, p.threads, 0, stream>>>(
        q, k8, ks, mask, out, n, d, scale, p.tiles_per_row, p.tiles, p.chunk);
}

}  // namespace ptr
}  // namespace vt

// q [B, D] f32; k8 [B, N, D] int8; ks, mask [B, N] f32; out [B, N] f32;
// D % 16 == 0 and D <= 2048; scale: 1 / sqrt(D) as the caller rounds it.
extern "C" int vt_ptr_scores_int8(const void* q, const void* k8, const void* ks, const void* mask,
                                  void* out, int batch, int n, int d, float scale, void* stream) {
  using namespace vt::ptr;
  if (d % 16 != 0 || d > 16 * 16 * kMaxChunks || batch <= 0 || n <= 0 ||
      (long long)batch * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if (const cudaError_t err = vt::device_sms(&dev, &sms)) return (int)err;
  const Plan p = launch_plan(batch, n, sms);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto qp = (const float*)q;
  const auto kp = (const int8_t*)k8;
  const auto sp = (const float*)ks;
  const auto mp = (const float*)mask;
  switch ((d + 255) / 256) {  // 16-byte chunks a lane
    case 1: launch<1>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    case 2: launch<2>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    case 3: launch<3>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    case 4: launch<4>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    case 5: launch<5>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    case 6: launch<6>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    case 7: launch<7>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
    default: launch<8>(p, s, qp, kp, sp, mp, (float*)out, n, d, scale); break;
  }
  return (int)cudaGetLastError();
}
