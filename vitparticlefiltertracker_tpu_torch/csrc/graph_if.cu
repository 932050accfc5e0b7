// CUDA graph conditional (IF) nodes for a captured tracker step.
//
// The JAX package's step holds two lax.cond branches that run only on lost
// frames (the probe and the global re-detection scan), chosen on the device
// from the step's own state. Their counterpart here: during stream capture of
// the step, vpt_if_begin
//   1. creates a conditional handle in the graph being captured,
//   2. enqueues a one-thread kernel on the capturing stream that sets the
//      handle from a bool the step computed on the card (the predicate),
//   3. adds an IF node after it (its body runs on a replay only when the
//      handle is 1), makes it the capturing stream's only dependency, and
//   4. starts capturing `body_stream` into the node's body graph,
// so that the work enqueued on body_stream until vpt_if_end becomes the
// branch. The host never reads the predicate. Nothing is launched eagerly
// here: outside a capture vpt_if_begin refuses.
//
// Needs CUDA 12.4 or later (conditional nodes and capture into a given
// graph). Plain C interface, loaded with ctypes (ops/_build.py).

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* num_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, num_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, num_deps);
#endif
}

}  // namespace

extern "C" {

// stream: the capturing stream; pred: device address of one bool, written
// on `stream` before this call; body_stream: a stream that is not capturing.
// Returns a cudaError_t value (0 = success), -1 when `stream` is not
// capturing, -2 when body_stream already is.
int vpt_if_begin(void* stream, const void* pred, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaStreamCaptureStatus body_status;
  err = cudaStreamIsCapturing(b, &body_status);
  if (err != cudaSuccess) return err;
  if (body_status != cudaStreamCaptureStatusNone) return -2;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The dependencies now end at the set kernel.
  err = capture_info(s, &status, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, num_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(b, body, nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// Loads the module of set_if_kernel (so that its first launch, inside a
// capture, loads nothing). Returns a cudaError_t value.
int vpt_if_load() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, set_if_kernel);
}

// Ends the capture of the body that vpt_if_begin started on body_stream.
int vpt_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

}  // extern "C"
