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

}  // namespace vt
