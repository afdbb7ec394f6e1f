// CUDA graph IF nodes under stream capture, for the resident L-BFGS
// iteration (lbfgs_ffnn_torch/ops/control.py::guard).
//
// The JAX solve decides inside lax.while_loop / lax.cond on the device. The
// port captures one iteration into a CUDA graph, and each of its decisions
// is a conditional node: the body graph runs on a replay only when a device
// bool says so. torch 2.11's torch.cuda.CUDAGraph has no method that opens
// such a node, so this file does it on the stream torch is capturing:
//
//   cond_begin_if(parent, flag, body):
//     1. cudaGraphConditionalHandleCreate on the graph `parent` captures into;
//     2. a one-thread kernel on `parent` that sets the handle from *flag
//        (cudaGraphSetConditional), read when the replay reaches it;
//     3. an IF node added after it (cudaGraphAddNode), made the stream's
//        only dependency (cudaStreamUpdateCaptureDependencies);
//     4. the stream `body` starts capturing into the node's body graph
//        (cudaStreamBeginCaptureToGraph), in the global mode, which refuses
//        a host sync as torch's capture does.
//   cond_end(body): ends the body's capture.
//   cond_invalidate(parent): after a body failed, makes the enclosing
//     capture fail as well.
//
// Nested IF nodes work the same way, `parent` then being the outer body's
// stream. Conditional nodes need CUDA 12.4 or later in the driver and the
// toolkit. Every function returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
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
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  if ((e = cudaGraphAddNode(&node, graph, deps, ndeps, &params)) != cudaSuccess) return e;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  if ((e = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies)) !=
      cudaSuccess)
    return e;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body), body_graph, nullptr,
                                       nullptr, 0, cudaStreamCaptureModeGlobal);
}

extern "C" int cond_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// Invalidates the capture `stream` takes part in: a stream query is not
// permitted during capture. After a body failed, its enclosing capture must
// fail too, rather than end with a half-built body graph in it.
extern "C" int cond_invalidate(void* stream) {
  return cudaStreamQuery(static_cast<cudaStream_t>(stream));
}

extern "C" const char* cond_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
