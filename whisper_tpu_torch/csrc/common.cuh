// Shared helpers for the whisper_tpu_torch kernels (sm_90a).
//
// Every entry point is `extern "C"`, launches on the stream it is given,
// never synchronises, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cmath>
#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

typedef __nv_bfloat16 bf16;

#define WT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction of one float per thread; `scratch` holds one float
// per warp.  Every thread gets the result.  `is_max` picks max, else sum.
template <int NTHREADS>
__device__ __forceinline__ float block_reduce(float v, float* scratch,
                                              bool is_max) {
  constexpr int NW = NTHREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}
