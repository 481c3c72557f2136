// Shared helpers for the whisper_tpu_torch kernels (sm_90a).
//
// Every entry point is `extern "C"`, launches on the stream it is given,
// never synchronises, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper can raise on a refused launch.
#pragma once

#include <cmath>
#include <cstdint>
#include <cfloat>
#include <mutex>
#include <unordered_map>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

// Raises a kernel's dynamic shared memory limit to at least `bytes`, once
// per new maximum, not on every call, and never lowers it.  Launches come
// from several host threads at once (the serving engine's lanes), so the
// most set so far for each kernel is kept under one lock: two threads that
// both find the limit too small then leave it at the larger of their sizes
// and never at the smaller, which would refuse the larger launch.  The
// first call sets the limit even below 48 KB, since a kernel's static
// shared memory counts against the 48 KB a launch gets unasked.
inline cudaError_t allow_smem(const void* fn, size_t bytes) {
  static std::mutex lock;
  static std::unordered_map<const void*, size_t> allowed;
  std::lock_guard<std::mutex> hold(lock);
  const auto it = allowed.find(fn);
  if (it != allowed.end() && bytes <= it->second) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess) allowed[fn] = bytes;
  return rc;
}
