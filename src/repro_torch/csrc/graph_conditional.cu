// IF nodes for captured CUDA graphs (CUDA 12.4 conditional nodes).
//
// The counterpart, in a captured step, of the reference's `lax.cond`
// inside its compiled window: the graph evaluates a predicate on the
// device and runs the body only when it holds, so the host never reads it.
//
// mpic_graph_if_begin is called while `stream` is being captured. It adds
// to the graph under capture a one-thread kernel that copies the 0-d bool
// `pred` into a conditional handle, then an IF node on that handle after
// it, makes the IF node the stream's capture frontier, and begins
// capturing `body_stream` into the IF node's body graph. Work issued on
// `body_stream` until mpic_graph_if_end forms the body; work issued on
// `stream` afterwards runs after the IF node. Bodies may nest.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Returns a cudaError_t (0 = the body's capture has begun).
extern "C" int mpic_graph_if_begin(cudaStream_t stream, const bool* pred, cudaStream_t body_stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_condition_kernel<<<1, 1, 0, stream>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body_stream, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

// Ends the body's capture. Returns a cudaError_t.
extern "C" int mpic_graph_if_end(cudaStream_t body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(body_stream, &body);
}
