// An empty kernel, one block of one warp: what a launch through this
// library's C interface costs on the card when the kernel does nothing.
// chip_smoke.py times it beside the kernels whose bound is a few
// microseconds, where the launch is most of the cost.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

WT_EXPORT int wt_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
