// A CUDA-graph conditional (if) node around a decode loop's step: the
// counterpart of the JAX loops' lax.while_loop condition
// (whisper_tpu/runtime/generate.py:206, beam.py:172, speculative.py:241).
//
// Called while PyTorch captures a graph on the parent stream
// (torch.cuda.CUDAGraph.capture_begin): wt_if_node_begin adds, after the
// parent's work so far, a kernel that sets a conditional handle to "some
// row is undone" from the loop's n done flags (bools on the card) and an
// if node on that handle, makes the if node the parent's only dependency,
// and starts capturing the body stream into the node's body graph;
// wt_if_node_end ends that capture.  Each replay then runs the body while
// a row is undone and skips it once every row is done.  The work in
// between is queued on the body stream.
//
// Both return a cudaError_t, 0 on success; neither synchronises.  Needs
// CUDA 12.3 or later (conditional nodes, cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* done, int n) {
  int undone = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) undone |= !done[i];
  undone = __syncthreads_or(undone);
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, undone ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                           nullptr, n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                           n);
#endif
  if (e == cudaSuccess && status != cudaStreamCaptureStatusActive)
    e = cudaErrorIllegalState;  // the parent stream is not capturing
  return e;
}

}  // namespace

extern "C" int wt_if_node_begin(const bool* done, int n_done, void* parent,
                                void* body, int mode) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(ps, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_condition_kernel<<<1, kThreads, 0, ps>>>(handle, done, n_done);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(ps, &graph, &deps, &n);  // now after the kernel
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int wt_if_node_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}
