// A CUDA-graph conditional (while) node around a decode loop's step: the
// counterpart of the JAX loops' lax.while_loop
// (whisper_tpu/runtime/generate.py:170-206, beam.py:121,172,
// speculative.py:159,241), the whole loop one device program.
//
// Called while PyTorch captures a graph on the parent stream
// (torch.cuda.CUDAGraph.capture_begin): wt_while_node_begin adds, after the
// parent's work so far, a kernel that sets a conditional handle to the
// loop's condition, "trips[0] < bound and some of the n done flags (bools
// on the card) is false", and a while node on that handle, makes the node
// the parent's only dependency, and starts capturing the body stream into
// the node's body graph.  wt_while_node_end queues the same kernel on the
// body stream, as the body's last node, and ends that capture.  One launch
// of the graph then runs the body for as long as the condition holds,
// evaluated on the card before the first iteration and after each: the
// host queues one launch a decode and reads nothing.  The handle is set by
// the kernel ahead of the node at every launch (no default value is
// assigned), and the `trips < bound` term ends a loop whose rows never end.
//
// Both return a cudaError_t, 0 on success; neither synchronises.  Needs
// CUDA 12.3 or later (conditional nodes, cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr int kThreads = 128;

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* done, int n,
                                     const long long* trips,
                                     long long bound) {
  int undone = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) undone |= !done[i];
  undone = __syncthreads_or(undone);
  if (threadIdx.x == 0)
    cudaGraphSetConditional(handle, undone && trips[0] < bound ? 1u : 0u);
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
    e = cudaErrorIllegalState;  // the stream is not capturing
  return e;
}

// Adds to *ops the kernel, copy and fill nodes of graph g and of its child
// graphs; *ops becomes -1 at a conditional node.
cudaError_t work_nodes(cudaGraph_t g, long long* ops) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) e = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; i < n && e == cudaSuccess && *ops >= 0; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) break;
    if (type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
        type == cudaGraphNodeTypeMemset) {
      ++*ops;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = work_nodes(child, ops);
    } else if (type == cudaGraphNodeTypeConditional) {
      *ops = -1;
    }
  }
  return e;
}
}  // namespace

// done [n_done] bools and trips [1] int64 on the card; handle: where the
// node's handle is written, for wt_while_node_end.
extern "C" int wt_while_node_begin(const bool* done, int n_done,
                                   const long long* trips, long long bound,
                                   void* parent, void* body, int mode,
                                   unsigned long long* handle) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(ps, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (e != cudaSuccess) return e;
  *handle = h;
  set_condition_kernel<<<1, kThreads, 0, ps>>>(h, done, n_done, trips,
                                               bound);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(ps, &graph, &deps, &n);  // now after the kernel
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = cudaGraphCondTypeWhile;
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

// The body's last node, the condition for the next iteration, then the end
// of the body's capture (ended whatever the launch returned, so that the
// body stream stops capturing).  body_ops (or null): where the body's
// device operations are written, its kernel, copy and fill nodes (those of
// child graphs included), what one iteration puts on the card; -1 if it
// holds a conditional node, whose work the graph alone does not fix.
extern "C" int wt_while_node_end(unsigned long long handle, const bool* done,
                                 int n_done, const long long* trips,
                                 long long bound, void* body,
                                 long long* body_ops) {
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  set_condition_kernel<<<1, kThreads, 0, bs>>>(handle, done, n_done, trips,
                                               bound);
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t e = cudaStreamEndCapture(bs, &graph);
  if (launch != cudaSuccess) return launch;
  if (e == cudaSuccess && body_ops != nullptr) e = work_nodes(graph, body_ops);
  return e;
}
