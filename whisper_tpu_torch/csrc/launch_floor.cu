// An empty kernel, one block of one warp: what a launch through this
// library's C interface costs on the card when the kernel does nothing.
// chip_smoke.py times it beside the kernels whose bound is a few
// microseconds, where the launch is most of the cost, and, as a kernel
// that only adds one to a counter, as the body of a CUDA-graph while node
// against a flat graph of as many launches: what the node and its
// condition kernel cost an iteration.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

__global__ void count_kernel(long long* counter) {
  if (threadIdx.x == 0) ++*counter;
}

}  // namespace

WT_EXPORT int wt_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// counter: [1] int64 on the card, one added.
WT_EXPORT int wt_launch_count(long long* counter, void* stream) {
  count_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(counter);
  return (int)cudaGetLastError();
}

// The library's own CUDA runtime keeps a current device per host thread,
// card 0 until told otherwise; ops/kernels.stream_ptr calls this before
// every launch with the index of the tensor's card, so a kernel launches
// where its operands lie (one process a card under a mesh).  The card a
// thread last set is remembered, so a launch on the same card costs no
// runtime call.  A refused card (no such device) is reported here and
// cleared from the runtime's last error, so that the next launch's
// cudaGetLastError does not report it again.
WT_EXPORT int wt_set_device(int device) {
  static thread_local int current = -1;
  if (device == current) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    current = device;
  } else {
    cudaGetLastError();
  }
  return (int)err;
}
