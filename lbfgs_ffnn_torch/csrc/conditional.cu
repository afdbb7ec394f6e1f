// CUDA graph conditional nodes under stream capture, for the resident
// solver iterations (lbfgs_ffnn_torch/ops/control.py: guard, loop).
//
// The JAX solve decides inside lax.while_loop / lax.cond on the device. The
// port captures one iteration into a CUDA graph, and each of its decisions
// is a conditional node: an IF node's body graph runs on a replay only when
// a device bool says so, a WHILE node's body graph runs again and again as
// long as one does. torch 2.11's torch.cuda.CUDAGraph has no method that
// opens such a node, so this file does it on the stream torch is capturing:
//
//   cond_begin_if(parent, flag, body) and
//   cond_begin_while(parent, flag, body, &handle):
//     1. cudaGraphConditionalHandleCreate on the graph `parent` captures into;
//     2. a one-thread kernel on `parent` that sets the handle from *flag
//        (cudaGraphSetConditional), read when the replay reaches it;
//     3. an IF or WHILE node added after it (cudaGraphAddNode), made the
//        stream's only dependency (cudaStreamUpdateCaptureDependencies);
//     4. the stream `body` starts capturing into the node's body graph
//        (cudaStreamBeginCaptureToGraph), in the global mode, which refuses
//        a host sync as torch's capture does.
//   cond_set(body, handle, flag): the same set kernel on `body`, as a WHILE
//     body's last node: the node runs its body again while *flag holds.
//   cond_end(body): ends the body's capture.
//   cond_invalidate(stream): after a body failed, makes the outermost
//     capture fail as well.
//
// Nested nodes work the same way, `parent` then being the outer body's
// stream. Conditional nodes need CUDA 12.4 or later in the driver and the
// toolkit (WHILE nodes too). Every function returns a cudaError_t (0 on
// success).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t begin_node(void* parent, const void* flag, void* body, cudaGraphConditionalNodeType type,
                       cudaGraphConditionalHandle* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  if ((e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0)) != cudaSuccess) return e;
  set_conditional_kernel<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(flag));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &ndeps)) != cudaSuccess)
    return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  if ((e = cudaGraphAddNode(&node, graph, deps, ndeps, &params)) != cudaSuccess) return e;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  if ((e = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies)) !=
      cudaSuccess)
    return e;
  if (handle_out != nullptr) *handle_out = handle;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body), body_graph, nullptr,
                                       nullptr, 0, cudaStreamCaptureModeGlobal);
}

}  // namespace

// A non-blocking stream for capturing bodies (one per nesting depth).
extern "C" int cond_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return e;
  *out = s;
  return cudaSuccess;
}

extern "C" int cond_begin_if(void* parent, const void* flag, void* body) {
  return begin_node(parent, flag, body, cudaGraphCondTypeIf, nullptr);
}

// `handle` receives the node's handle, for cond_set at the end of its body.
extern "C" int cond_begin_while(void* parent, const void* flag, void* body,
                                unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t e = begin_node(parent, flag, body, cudaGraphCondTypeWhile, &h);
  if (e == cudaSuccess) *handle = static_cast<unsigned long long>(h);
  return e;
}

extern "C" int cond_set(void* body, unsigned long long handle, const void* flag) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(body)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(flag));
  return cudaGetLastError();
}

extern "C" int cond_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// Invalidates the capture `stream` takes part in: a stream query is not
// permitted during capture. After a body failed, its enclosing capture must
// fail too, rather than end with a half-built body graph in it.
extern "C" int cond_invalidate(void* stream) {
  cudaError_t e = cudaStreamQuery(static_cast<cudaStream_t>(stream));
  // the query fails on purpose; clear the thread's last error, or the next
  // launch check (cudaGetLastError in begin_node, cond_set) would report it
  cudaGetLastError();
  return e;
}

extern "C" const char* cond_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
