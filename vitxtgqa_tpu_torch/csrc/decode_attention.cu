// One greedy-decode step of attention over the unified KV cache, int8 or
// bf16.
//
// Replaces: vitxtgqa_tpu/ops/pallas_attention.py:decode_attention_int8
// (the Pallas body _decode_int8_kernel) and pallas_attention.py:
// decode_attention (_decode_kernel).  One query row per batch, in merged
// [B, 1, H*D] layout, over k/v [B, L, H*D] (int8 with per-token f32 scales
// ks/vs [B, L] in the ops/attention.quantize_kv layout, or bf16 without
// scales).  The query may attend key j when key_mask[j] > 0 (a valid
// encoder key) or when write_offset <= j <= write_offset + step (decoder
// slots written so far); other scores take -1e9.  As the Pallas kernels:
//   int8: s_j = (q . k8_j) * (ks_j / sqrt(D));  w_j = bf16(softmax(s)_j * vs_j)
//   bf16: s_j = (q . k_j) / sqrt(D);            w_j = bf16(softmax(s)_j)
//   out = sum_j w_j v_j, f32 accumulation.
// The softmax rounds the *normalised* weight, as the twins in
// ops/decode_attention.py do, so it needs the row's max and sum before
// any V row is weighed.  exp is expf of (s - max), no log2(e) folding.
//
// What bounds it on the H100: 1-2 FLOP per cache byte, deep under the
// ridge, so device-memory bytes.  Only the allowed keys need reading: at
// the serving shape (B=8, L=1152, H*D=768) about 40% of the rows, ~5.7 MB
// of int8 cache (1.7 us at 3.35 TB/s).  The grid has to keep enough loads
// in flight to approach that rate at batch 1 as well as at batch 576.
//
// Design: a thread block cluster per (head group, batch row).  The grid is
// (cluster, head_groups, batch) with a cluster of `cluster` blocks along x;
// ops/decode_attention.launch_plan picks both counts from B and L, for one
// wave of up to four blocks on each SM (8 x 12 clusters of 8 at batch 1,
// 8 x 6 at batch 8, 64 x 1 at batch 64).  Each block of the cluster owns a
// contiguous span of keys and the heads of its group:
//   1. it reads its span of key_mask and compacts the allowed keys into a
//      shared index list (per-thread runs and a block scan);
//   2. a thread owns one 16-byte chunk of the group's row segment (fixed
//      head and 16 (int8) or 8 (bf16) dims, the query's matching values in
//      registers) and a slice of the live keys; it loads U chunks at once,
//      plain 16-byte loads into registers, K and (for its first U keys) V
//      together, so V's first rows are in flight across the cluster
//      barrier; the lanes of a head reduce the dot product by shuffles;
//      scores go to shared memory, head-major;
//   3. the block's (max, sum exp) per head, written into every peer's
//      shared memory (distributed shared memory); cluster barrier; each
//      block forms the row's max M and sum S from the pairs it received (a
//      peer with no live key sends (-inf, 0) and adds nothing);
//   4. weights w = bf16(expf(s - M) / S [* vs]) in place; each thread
//      accumulates its chunk over its keys in f32 registers; the slices
//      sum in shared memory;
//   5. output element e belongs to block e % C: each block writes its sum
//      of e into that block's shared memory; cluster barrier; each block
//      adds what it received in rank order (the result does not depend on
//      timing) and writes it in bf16.
// Only stores cross the cluster, so it needs two full barriers: no block
// reads a peer's shared memory, so none has to wait for its peers before
// it exits.  A block may write a peer's shared memory only once the peer
// runs: an arrival at the start, waited for before the first such write,
// orders that without a third barrier.
// Head widths.  D is any multiple of 8 up to 128; a thread owns one chunk
// of kPer elements of its head's row segment, CPH chunks a head (a power of
// two, so that a head's lanes reduce by xor shuffles within a warp), and
// the chunks past D of a head idle (they load nothing and add zeros):
//   D = 64 (every form before):      int8 16 x 4 (16-byte chunks), bf16 8 x 8
//   D <= 32 (MiniLM's 12 heads of 32): 8 x 4, 8-byte int8 / 16-byte bf16 chunks
//   32 < D < 64:                      8 x 8
//   64 < D <= 128 (ViT-H's 16 of 80,  8 x 16 (80: 10 of 16 lanes busy)
//     8 or 16 of 128)
// Eight elements a chunk below 64 and above: an int8 head row of 72 or 80
// starts at a multiple of 8 bytes, not of 16.  The D = 64 forms take D as
// a compile-time constant (KD), as before; the others read it at run time.
// A block's heads hg x CPH chunks must divide the NT = 192 threads: 12
// heads of 32 in one group (48 chunks, 4 key slices), 16 of 80 or 8 of 128
// in groups of up to 4 (ops/decode_attention.launch_plan).
// Dead keys are never read.  That leaves the result unchanged: every row
// has at least one allowed key, the decoder slot at write_offset (the
// wrapper requires 0 <= write_offset and write_offset + step < L), so M is
// a real score and a masked key's exp(-1e9 - M) is exactly 0 in f32.  The
// row segments are read whole by the block (H/head_groups heads x 64 x 1 or
// 2 bytes, a multiple of 16), each 16-byte chunk once.  The rows are used
// once each, so they go straight to registers: a shared-memory ring would
// add a copy without reuse.  Measured on the H100 (PERF.md §6): pulling
// the pairs and partial outputs from the peers after a third barrier was
// 0.7-0.8 us slower at batch 1-8, eight keys a thread at once (U = 8) 1.2-3x
// slower everywhere, and a grid of two waves slower than one.
#include "common.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace vt {
namespace decode {

constexpr int NT = 192;         // threads a block: CPH * heads divides it for 1-12 heads at D 64
constexpr int NW = NT / 32;
constexpr int U = 4;            // keys a thread loads at once
constexpr int kMaxPer = 32;     // keys a thread tests in the compaction (span <= 32 * NT)
constexpr int kMaxCluster = 8;  // the portable cluster size

// dynamic shared memory: part [NT * kPer], peer_stat [kMaxCluster][hg][2], obuf
// [hg * D + kMaxCluster], gstat [hg][2], wcount [8], idx [span], vss
// [span], sc [hg * span]
inline size_t smem_bytes(int span, int hg, int kPer, int D) {
  return 4 * ((size_t)NT * kPer + (2 * kMaxCluster + 2) * hg + hg * D + kMaxCluster + 8 +
              (size_t)span * (2 + hg));
}

// one thread's chunk of a cache row: kPer elements of T, 16 or 8 bytes
template <typename T, int kPer>
using Chunk = typename std::conditional<kPer * sizeof(T) == 16, int4, int2>::type;

template <typename V>
__device__ __forceinline__ V zero_chunk();
template <>
__device__ __forceinline__ int4 zero_chunk<int4>() { return make_int4(0, 0, 0, 0); }
template <>
__device__ __forceinline__ int2 zero_chunk<int2>() { return make_int2(0, 0); }

// a full cluster barrier: what a thread wrote before it, to its own or a
// peer's shared memory, is seen by every thread of the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

template <typename V>
__device__ __forceinline__ V ldc(const void* p) {
  return __ldg(reinterpret_cast<const V*>(p));
}

// the query's kPer values at p (bf16) as floats (kPer a multiple of 8)
template <int kPer>
__device__ __forceinline__ void load_q(const bf16* p, float* out) {
#pragma unroll
  for (int w = 0; w < kPer / 8; ++w) {
    const int4 r = ld16(p + 8 * w);
    const bf16* e = reinterpret_cast<const bf16*>(&r);
#pragma unroll
    for (int t = 0; t < 8; ++t) out[8 * w + t] = __bfloat162float(e[t]);
  }
}

// element t of a chunk of the cache as a float
template <typename T, typename V>
__device__ __forceinline__ float elem(const V& r, int t);
template <>
__device__ __forceinline__ float elem<int8_t, int4>(const int4& r, int t) {
  return (float)reinterpret_cast<const int8_t*>(&r)[t];
}
template <>
__device__ __forceinline__ float elem<int8_t, int2>(const int2& r, int t) {
  return (float)reinterpret_cast<const int8_t*>(&r)[t];
}
template <>
__device__ __forceinline__ float elem<bf16, int4>(const int4& r, int t) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&r)[t]);
}

// T = int8_t: ks / vs are the per-token scales; T = bf16: both null.
// kPer: elements of a thread's chunk; CPH: chunks a head (kPer x CPH >= D);
// KD: the head width where fixed at compile time (64), else 0 and the
// head width is d (a multiple of kPer)
template <typename T, int kPer, int CPH, int KD>
__global__ void __launch_bounds__(NT)
decode_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
              const float* __restrict__ ks, const T* __restrict__ v,
              const float* __restrict__ vs, const float* __restrict__ key_mask,
              bf16* __restrict__ out, int L, int H, int hg, int span, int step,
              int write_offset, float scale, int d) {
  using V = Chunk<T, kPer>;
  static_assert(KD == 0 || KD == kPer * CPH, "a fixed width fills its chunks");
  const int D = KD ? KD : d;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nchunks = hg * CPH, nsl = NT / nchunks;
  const int c = tid % nchunks, sl = tid / nchunks, hl = c / CPH;
  const int row = H * D;                     // elements of a cache row
  const int seg = hg * D;                    // elements of the group's row segment
  const int segp = nchunks * kPer;           // ... with each head padded to CPH chunks
  const int shmax = (seg + C - 1) / C;       // output elements a block sums
  const bool live = KD || (c % CPH) * kPer < D;  // the chunk lies inside its head
  const int col = g * seg + hl * D + (live ? (c % CPH) * kPer : 0);  // the chunk in a row
  const int k0 = rank * span, k1 = max(k0, min(L, k0 + span));
  const size_t row0 = (size_t)b * L;

  extern __shared__ __align__(16) float sh[];
  float* part = sh;                          // [nsl][seg] V partial sums
  float* peer_stat = part + NT * kPer;             // [C][hg][2] the peers' (max, sum exp)
  float* obuf = peer_stat + 2 * kMaxCluster * hg;  // [C][shmax] the peers' partial outputs
  float* gstat = obuf + seg + kMaxCluster;   // [hg][2] the row's (max, sum)
  int* wcount = reinterpret_cast<int*>(gstat + 2 * hg);  // [8]
  int* idx = wcount + 8;                     // [span] live keys
  float* vss = reinterpret_cast<float*>(idx + span);     // [span] their vs
  float* sc = vss + span;                    // [hg][span] scores, then weights

  // a peer's shared memory may be written once the peer has started: this
  // arrival is waited for in step 3, after the loads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float qr[kPer];
  load_q<kPer>(q + (size_t)b * row + col, qr);
  if (!live)
#pragma unroll
    for (int t = 0; t < kPer; ++t) qr[t] = 0.f;

  // 1. compaction: thread tid tests keys [j0, j1) of the span
  const int per = (k1 - k0 + NT - 1) / NT;
  const int j0 = min(k1, k0 + tid * per), j1 = min(k1, j0 + per);
  unsigned bits = 0;
  for (int j = j0; j < j1; ++j) {
    const bool ok = key_mask[row0 + j] > 0.f || (j >= write_offset && j <= write_offset + step);
    bits |= (unsigned)ok << (j - j0);
  }
  const int cnt = __popc(bits);
  int incl = cnt;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wcount[warp] = incl;
  __syncthreads();
  int pos = incl - cnt, n = 0;
  for (int w = 0; w < NW; ++w) {
    pos += w < warp ? wcount[w] : 0;
    n += wcount[w];
  }
  for (; bits; bits &= bits - 1) idx[pos++] = j0 + __ffs(bits) - 1;
  __syncthreads();

  // 2. scores of the live keys; V's first U keys of each thread prefetched
  const bool lead = c % CPH == 0;  // the lane that writes its head's score
  V vpre[U];
#pragma unroll
  for (int u = 0; u < U; ++u) vpre[u] = zero_chunk<V>();
  for (int base = 0; base < n; base += U * nsl) {
    V kr[U];
    float ksc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + sl + u * nsl;
      kr[u] = zero_chunk<V>();
      ksc[u] = 1.f;
      if (i < n) {
        const int j = idx[i];
        const size_t off = (row0 + j) * row + col;
        if (live) kr[u] = ldc<V>(k + off);
        if (base == 0 && live) vpre[u] = ldc<V>(v + off);
        if (ks != nullptr && lead) ksc[u] = __ldg(ks + row0 + j);
        if (vs != nullptr && lead && hl == 0) vss[i] = __ldg(vs + row0 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) dot += qr[t] * elem<T, V>(kr[u], t);
#pragma unroll
      for (int o = CPH / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int i = base + sl + u * nsl;
      if (i < n && lead) sc[hl * span + i] = ks != nullptr ? dot * (ksc[u] * scale) : dot * scale;
    }
  }
  __syncthreads();

  // 3. the block's (max, sum exp) per head, pushed to every peer; then the
  // row's from the cluster's pairs
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int h = warp; h < hg; h += NW) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[h * span + i]);
    m = warp_max(m);
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s += expf(sc[h * span + i] - m);
    s = warp_sum(s);
    if (lane < C) {
      float* dst = cluster.map_shared_rank(peer_stat, lane) + 2 * (rank * hg + h);
      dst[0] = m;
      dst[1] = s;
    }
  }
  cluster_sync();
  if (tid < hg) {
    float mx = -INFINITY, sum = 0.f;
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, peer_stat[2 * (r * hg + tid)]);
    for (int r = 0; r < C; ++r) {
      const float* p = peer_stat + 2 * (r * hg + tid);
      if (p[1] > 0.f) sum += p[1] * expf(p[0] - mx);
    }
    gstat[2 * tid] = mx;
    gstat[2 * tid + 1] = sum;
  }
  __syncthreads();

  // 4. the rounded weights, then each thread's chunk over its keys
  for (int t = tid; t < hg * n; t += NT) {
    const int h = t / n, i = t - h * n;
    const float p = expf(sc[h * span + i] - gstat[2 * h]) / gstat[2 * h + 1];
    sc[h * span + i] = round_bf16(vs != nullptr ? p * vss[i] : p);
  }
  __syncthreads();
  float acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.f;
  for (int base = 0; base < n; base += U * nsl) {
    V vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + sl + u * nsl;
      if (base == 0) {
        vr[u] = vpre[u];
      } else {
        vr[u] = zero_chunk<V>();
        if (i < n && live) vr[u] = ldc<V>(v + (row0 + idx[i]) * row + col);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + sl + u * nsl;
      if (i < n) {
        const float w = sc[hl * span + i];
#pragma unroll
        for (int t = 0; t < kPer; ++t) acc[t] += w * elem<T, V>(vr[u], t);
      }
    }
  }
  float4* pp = reinterpret_cast<float4*>(part + tid * kPer);  // [sl][c * kPer + t], padded heads
#pragma unroll
  for (int t = 0; t < kPer; t += 4) pp[t / 4] = make_float4(acc[t], acc[t + 1], acc[t + 2], acc[t + 3]);
  __syncthreads();

  // 5. output element e is summed by block e % C: each block pushes its
  // slices' sum there; after the barrier each sums what it received in
  // rank order (so the result does not depend on timing).  No block
  // touches a peer's shared memory after the barrier, so each may exit.
  for (int e = tid; e < seg; e += NT) {
    const int ep = KD ? e : (e / D) * (CPH * kPer) + e % D;  // in the padded heads
    float s = 0.f;
    for (int x = 0; x < nsl; ++x) s += part[x * segp + ep];
    cluster.map_shared_rank(obuf, e % C)[rank * shmax + e / C] = s;
  }
  cluster_sync();
  bf16* o = out + (size_t)b * row + g * seg;
  for (int t = tid; t < shmax && rank + C * t < seg; t += NT) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += obuf[r * shmax + t];
    o[rank + C * t] = __float2bfloat16(s);
  }
}

template <typename T, int kPer, int CPH, int KD>
cudaError_t config(int batch, int cache_len, int num_heads, int head_dim, int cluster,
                   int head_groups, int* span, int* hg, size_t* smem) {
  if (head_dim % kPer || head_dim > kPer * CPH || cluster < 1 || cluster > kMaxCluster ||
      head_groups < 1 || num_heads % head_groups || batch < 1 || cache_len < 1)
    return cudaErrorInvalidValue;
  *hg = num_heads / head_groups;
  *span = (cache_len + cluster - 1) / cluster;
  if (NT % (*hg * CPH) || *span > kMaxPer * NT) return cudaErrorInvalidValue;
  *smem = smem_bytes(*span, *hg, kPer, head_dim);
  return cudaFuncSetAttribute(decode_kernel<T, kPer, CPH, KD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

inline void fill(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int batch, int cluster,
          int head_groups, size_t smem, void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(cluster, head_groups, batch);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, int kPer, int CPH, int KD>
int launch_form(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                const void* key_mask, void* out, int batch, int cache_len, int num_heads,
                int head_dim, int cluster, int head_groups, int step, int write_offset,
                void* stream) {
  int span, hg;
  size_t smem;
  cudaError_t err = config<T, kPer, CPH, KD>(batch, cache_len, num_heads, head_dim, cluster,
                                             head_groups, &span, &hg, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill(&cfg, &attr, batch, cluster, head_groups, smem, stream);
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, kPer, CPH, KD>, (const bf16*)q, (const T*)k,
                           (const float*)ks, (const T*)v, (const float*)vs,
                           (const float*)key_mask, (bf16*)out, cache_len, num_heads, hg, span,
                           step, write_offset, 1.0f / sqrtf((float)head_dim), head_dim);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int kPer, int CPH, int KD>
int max_clusters_form(int batch, int cache_len, int num_heads, int head_dim, int cluster,
                      int head_groups, int* count) {
  int span, hg;
  size_t smem;
  cudaError_t err = config<T, kPer, CPH, KD>(batch, cache_len, num_heads, head_dim, cluster,
                                             head_groups, &span, &hg, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  fill(&cfg, &attr, batch, cluster, head_groups, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(count, (void*)decode_kernel<T, kPer, CPH, KD>,
                                             &cfg);
}

// the form of head width d (the table in the note): f(kPer, CPH, KD) as
// integral constants; d a multiple of 8 up to 128 (else invalid)
template <typename T, typename F>
int by_width(int d, F&& f) {
  using std::integral_constant;
  using Runtime = integral_constant<int, 0>;
  if (d <= 0 || d % 8 || d > 128) return (int)cudaErrorInvalidValue;
  if (d == 64)
    return f(integral_constant<int, 16 / (int)sizeof(T)>(),
             integral_constant<int, 64 * (int)sizeof(T) / 16>(), integral_constant<int, 64>());
  if (d <= 32) return f(integral_constant<int, 8>(), integral_constant<int, 4>(), Runtime());
  if (d < 64) return f(integral_constant<int, 8>(), integral_constant<int, 8>(), Runtime());
  return f(integral_constant<int, 8>(), integral_constant<int, 16>(), Runtime());
}

template <typename T>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* key_mask, void* out, int batch, int cache_len, int num_heads,
           int head_dim, int cluster, int head_groups, int step, int write_offset,
           void* stream) {
  return by_width<T>(head_dim, [&](auto per, auto cph, auto kd) {
    return launch_form<T, decltype(per)::value, decltype(cph)::value, decltype(kd)::value>(
        q, k, ks, v, vs, key_mask, out, batch, cache_len, num_heads, head_dim, cluster,
        head_groups, step, write_offset, stream);
  });
}

template <typename T>
int max_clusters(int batch, int cache_len, int num_heads, int head_dim, int cluster,
                 int head_groups, int* count) {
  return by_width<T>(head_dim, [&](auto per, auto cph, auto kd) {
    return max_clusters_form<T, decltype(per)::value, decltype(cph)::value,
                             decltype(kd)::value>(
        batch, cache_len, num_heads, head_dim, cluster, head_groups, count);
  });
}

}  // namespace decode
}  // namespace vt

extern "C" int vt_decode_attention_int8(const void* q, const void* k8, const void* ks,
                                        const void* v8, const void* vs, const void* key_mask,
                                        void* out, int batch, int cache_len, int num_heads,
                                        int head_dim, int cluster, int head_groups, int step,
                                        int write_offset, void* stream) {
  return vt::decode::launch<int8_t>(q, k8, ks, v8, vs, key_mask, out, batch, cache_len,
                                    num_heads, head_dim, cluster, head_groups, step,
                                    write_offset, stream);
}

extern "C" int vt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* key_mask, void* out, int batch, int cache_len,
                                   int num_heads, int head_dim, int cluster, int head_groups,
                                   int step, int write_offset, void* stream) {
  return vt::decode::launch<vt::bf16>(q, k, nullptr, v, nullptr, key_mask, out, batch,
                                      cache_len, num_heads, head_dim, cluster, head_groups,
                                      step, write_offset, stream);
}

// cudaOccupancyMaxActiveClusters of one launch plan (int8 != 0: the int8 form)
extern "C" int vt_decode_attention_clusters(int int8, int batch, int cache_len, int num_heads,
                                            int head_dim, int cluster, int head_groups,
                                            int* count) {
  return int8 ? vt::decode::max_clusters<int8_t>(batch, cache_len, num_heads, head_dim,
                                                 cluster, head_groups, count)
              : vt::decode::max_clusters<vt::bf16>(batch, cache_len, num_heads, head_dim,
                                                   cluster, head_groups, count);
}
