// Shared helpers for the port's hand-written Hopper kernels.
//
// Every file exposes plain C entry points (bound from Python with ctypes):
// pointers arrive as void*, the stream as a void* holding the caller's
// cudaStream_t, and each entry returns cudaGetLastError() after its
// launches so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// check a launch; leave the entry point with its error
#define VT_TRY(expr)                       \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

namespace vt {

using bf16 = __nv_bfloat16;

// masked scores take the same fill as the Pallas kernels
// (vitxtgqa_tpu/ops/pallas_attention.py _NEG)
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide reductions for blockDim.x a multiple of 32; `red` holds at
// least 32 floats of shared memory; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr int kMaxDevices = 64;

// the current device and its SM count, the count read once a device
inline cudaError_t device_sms(int* dev, int* sms) {
  static int cached[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cached[*dev]) {
    err = cudaDeviceGetAttribute(&cached[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached[*dev];
  return cudaSuccess;
}

// A cooperative launch of one kernel on the current device: the grid of
// co-resident blocks (at most max_per_sm an SM) at `smem` bytes of dynamic
// shared memory, the largest any launch of that setup takes.  The kernel's
// shared-memory attribute belongs to the kernel, not to a launch, so it
// only ever rises: a launch of fewer bytes after one of more stays allowed.
// Each setup is made once a (device, smem) and kept in the kernel's cache.
struct CoopLaunch {
  int grid;
  cudaError_t err;
};

struct CoopCache {
  static constexpr int kEntries = 16;
  int attr[kMaxDevices] = {};  // the attribute as set on each device
  struct Entry {
    int dev, smem;
    CoopLaunch l;
  } e[kEntries];
  int n = 0;
};

inline CoopLaunch coop_launch(CoopCache& c, const void* kernel, int threads, int smem,
                              int max_per_sm) {
  int dev = 0, sms = 0;
  const cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return {0, err};
  for (int i = 0; i < c.n; ++i)
    if (c.e[i].dev == dev && c.e[i].smem == smem) return c.e[i].l;
  CoopLaunch l = {0, cudaSuccess};
  if (smem > c.attr[dev]) {
    l.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (l.err == cudaSuccess) c.attr[dev] = smem;
  }
  int coop = 0, per_sm = 0;
  if (l.err == cudaSuccess) l.err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (l.err == cudaSuccess && !coop) l.err = cudaErrorNotSupported;
  if (l.err == cudaSuccess)
    l.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (l.err == cudaSuccess && per_sm < 1) l.err = cudaErrorCooperativeLaunchTooLarge;
  l.grid = (per_sm < max_per_sm ? per_sm : max_per_sm) * sms;
  if (c.n < CoopCache::kEntries) c.e[c.n++] = {dev, smem, l};
  return l;
}

}  // namespace vt
