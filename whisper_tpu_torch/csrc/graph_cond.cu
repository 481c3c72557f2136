// A CUDA-graph conditional (while) node around a decode loop's step: the
// counterpart of the JAX loops' lax.while_loop
// (whisper_tpu/runtime/generate.py:170-206, beam.py:121,172,
// speculative.py:159,241), the whole loop one device program.
//
// Called while PyTorch captures a graph on the parent stream
// (torch.cuda.CUDAGraph.capture_begin): wt_while_node_begin adds, after the
// parent's work so far, a kernel that sets a conditional handle to the
// loop's condition, "trips[0] < bound and some of the n done flags (bools
// on the card) is false" (the condition kernel, C), and a while node on
// that handle, makes the node the parent's only dependency, and starts
// capturing the body stream into the node's body graph.  wt_while_node_end
// ends that capture; with queue_condition it first queues C on the body
// stream, as the body's last node.  One launch of the graph then runs the
// body for as long as the condition holds, evaluated on the card before
// the first iteration and after each: the host queues one launch a decode
// and reads nothing.  The handle is set by the kernel ahead of the node at
// every launch (no default value is assigned), and the `trips < bound`
// term ends a loop whose rows never end.
//
// The greedy step ends in the loop's tail (wt_loop_tail): one kernel that
// does the step's bookkeeping, the seven PyTorch operations after the
// pick (twelve with scores: loop_tail_plain in ops/loop_tail.py), and,
// given the node's handle, sets the condition from the state it has just
// written.  That body ends with no C: its iteration runs one launch for
// the eight (thirteen) it ran before, the work XLA fuses into its loop
// program on the TPU.  The beam and speculative bodies end in gathers and
// commits and keep C.
//
// Bound: launches.  C reads n bools and 8 bytes; the tail reads and writes
// ~40 bytes a row: at bucket 16 both are a few nanoseconds of bytes, and a
// launch in a graph costs ~1 us.  So each is one block of 128 threads
// (rows in turn past 128), the OR across rows one __syncthreads_or, and
// the point of the tail is the launches it removes.
//
// A conditional node's body may hold kernel, copy, fill, empty,
// child-graph and conditional nodes only (CUDA's rules for body graphs): no
// event record or wait, host, allocation or semaphore node.  A body with
// one makes a graph the runtime cannot instantiate, so the step's throwaway
// trial capture is walked first (wt_capture_bad_node) and the caller raises
// before any node is made: a collective that left such a node in a step
// (a mesh's, captured with it) is found there.
//
// Every entry point returns a cudaError_t, 0 on success; none
// synchronises.  Needs CUDA 12.3 or later (conditional nodes,
// cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

#include <climits>
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

// The greedy step's tail, for rows b < rows, with s = step[0]:
//   m = done[b] ? eot : nxt[b];  buf[b, s] = m;  last[b] = m;
//   with scores: sum_lp[b] += done[b] ? 0 : lp[b];  n_tok[b] += !done[b];
//   done[b] |= m == eot;  then pos[0] += 1, step[0] = s + 1,
// and, with set, the handle to "some row undone and s + 1 < bound".  The
// sum is one fp32 addition of the same operands as torch's add_, so every
// value is bitwise the PyTorch sequence's.  Every thread reads step[0]
// before the barrier; thread 0 writes it after.
__global__ void loop_tail_kernel(const long long* nxt, const float* lp,
                                 bool* done, long long* buf, long long* last,
                                 float* sum_lp, long long* n_tok, int* pos,
                                 long long* step, int rows, int cols,
                                 long long eot,
                                 cudaGraphConditionalHandle handle, int set,
                                 long long bound) {
  const long long s = step[0];
  int undone = 0;
  for (int b = threadIdx.x; b < rows; b += kThreads) {
    const bool was = done[b];
    const long long m = was ? eot : nxt[b];
    if (lp != nullptr) {
      sum_lp[b] = sum_lp[b] + (was ? 0.0f : lp[b]);
      n_tok[b] += was ? 0 : 1;
    }
    if (s >= 0 && s < cols) buf[static_cast<long long>(b) * cols + s] = m;
    last[b] = m;
    const bool now = was || m == eot;
    done[b] = now;
    undone |= !now;
  }
  undone = __syncthreads_or(undone);
  if (threadIdx.x == 0) {
    pos[0] += 1;
    step[0] = s + 1;
    if (set) cudaGraphSetConditional(handle, undone && s + 1 < bound ? 1u
                                                                     : 0u);
  }
}

__global__ void empty_body_kernel() {}

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
bool allowed_in_body(cudaGraphNodeType type) {
  return type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
         type == cudaGraphNodeTypeMemset || type == cudaGraphNodeTypeEmpty ||
         type == cudaGraphNodeTypeGraph ||
         type == cudaGraphNodeTypeConditional;
}

// The type of the first node of graph g, or of its child graphs, that a
// conditional node's body may not hold, in *bad; *bad stays -1 if none.
cudaError_t first_bad_node(cudaGraph_t g, int* bad) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) e = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; i < n && e == cudaSuccess && *bad < 0; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) break;
    if (!allowed_in_body(type)) {
      *bad = static_cast<int>(type);
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = first_bad_node(child, bad);
    }
  }
  return e;
}
}  // namespace

// Inside a capture on the stream, before it ends: the type of the first
// node captured so far that a while node's body may not hold (a
// cudaGraphNodeType), in *bad; -1 if every node may be there.
extern "C" int wt_capture_bad_node(void* stream, int* bad) {
  *bad = -1;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(static_cast<cudaStream_t>(stream), &graph,
                               &deps, &n);
  if (e != cudaSuccess) return e;
  return first_bad_node(graph, bad);
}

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

// The end of the body's capture, after C as the body's last node when
// queue_condition is not 0 (a body whose tail kernel set the condition
// queues none); the capture is ended whatever the launch returned, so that
// the body stream stops capturing.  body_ops (or null): where the body's
// device operations are written, its kernel, copy and fill nodes (those of
// child graphs included), what one iteration puts on the card; -1 if it
// holds a conditional node, whose work the graph alone does not fix.
extern "C" int wt_while_node_end(unsigned long long handle, const bool* done,
                                 int n_done, const long long* trips,
                                 long long bound, void* body,
                                 int queue_condition, long long* body_ops) {
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  cudaError_t launch = cudaSuccess;
  if (queue_condition) {
    set_condition_kernel<<<1, kThreads, 0, bs>>>(handle, done, n_done, trips,
                                                 bound);
    launch = cudaGetLastError();
  }
  cudaGraph_t graph;
  cudaError_t e = cudaStreamEndCapture(bs, &graph);
  if (launch != cudaSuccess) return launch;
  if (e == cudaSuccess && body_ops != nullptr) e = work_nodes(graph, body_ops);
  return e;
}

// The greedy step's tail (loop_tail_kernel) on the stream: nxt [rows]
// int64; lp, sum_lp [rows] fp32 and n_tok [rows] int64, or all three null
// (no scores); done [rows] bools; buf [rows, cols] int64; last [rows]
// int64; pos [1] int32; step [1] int64; set: whether to set the while
// node's handle (inside the capture of that node's body) to "some row
// undone and step < bound" once the step is written.
extern "C" int wt_loop_tail(const long long* nxt, const float* lp, bool* done,
                            long long* buf, long long* last, float* sum_lp,
                            long long* n_tok, int* pos, long long* step,
                            int rows, int cols, long long eot,
                            unsigned long long handle, int set,
                            long long bound, void* stream) {
  loop_tail_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nxt, lp, done, buf, last, sum_lp, n_tok, pos, step, rows, cols, eot,
      handle, set, bound);
  return cudaGetLastError();
}

// C alone, for timing: inside a capture on the stream, `launches` launches
// of the condition kernel one after another, then the while node whose
// handle they set, its body one empty kernel (a handle needs its node).
// The bound is LLONG_MIN, so every launch reads the n flags and the
// counter and sets 0, and the node runs no iteration.
extern "C" int wt_condition_kernels(const bool* done, int n_done,
                                    const long long* trips, void* stream,
                                    int launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(s, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  for (int i = 0; i < launches && e == cudaSuccess; ++i) {
    set_condition_kernel<<<1, kThreads, 0, s>>>(h, done, n_done, trips,
                                                LLONG_MIN);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = capture_info(s, &graph, &deps, &n);
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
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  cudaKernelNodeParams body = {};
  body.func = reinterpret_cast<void*>(empty_body_kernel);
  body.gridDim = dim3(1);
  body.blockDim = dim3(32);
  cudaGraphNode_t kernel;
  return cudaGraphAddKernelNode(&kernel, params.conditional.phGraph_out[0],
                                nullptr, 0, &body);
}
