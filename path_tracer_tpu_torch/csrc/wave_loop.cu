// The wavefront's wave loop on the device (B8'): a CUDA graph whose
// conditional WHILE node runs one wave per iteration until no work is left.
//
// Replaces the lax.while_loop(live, wave) of path_tracer_tpu/ops/
// wavefront.py render_batch (:427-467, :509), which keeps the whole loop on
// the TPU.  The graph is
//
//   head: wave_loop_kernel -> WHILE(handle) { K1, K3, K4, K2,
//                                             wave_loop_kernel }
//
// wave_loop_kernel evaluates the loop predicate (`live`, :464-465) from the
// counters on the device and sets the node's condition, so the host
// launches the frame once and reads the counters once, after the loop.  The
// body is captured from the launchers of the other kernel libraries
// (cudaStreamBeginCaptureToGraph on a stream of this library), so a wave in
// the graph is the very launch sequence of the per-wave host loop.  A wave
// bound (`max_waves`) stops a loop that does not drain; the host then
// raises.  Every pointer the body captures is the wave state's, which lives
// as long as the graph.
//
// wave_loop_kernel is one thread reading three counters: its cost is its
// launch.
// Needs CUDA 12.4 (conditional nodes, capture into a graph); any failure is
// returned as the CUDA error code and the wrapper raises.
#include "common.cuh"

struct WaveLoop {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  cudaGraphConditionalHandle handle;
  cudaStream_t stream;
};

__global__ void wave_loop_kernel(const long long* ctr, long long items_total,
                                 long long max_waves,
                                 cudaGraphConditionalHandle handle) {
  const long long spawned =
      ctr[C_SPAWNED] < items_total ? ctr[C_SPAWNED] : items_total;
  const bool live = (spawned < items_total || ctr[C_N_OCC] > 0) &&
                    ctr[C_WAVES] < max_waves;
  cudaGraphSetConditional(handle, live ? 1u : 0u);
}

#define PTT_TRY(x)              \
  do {                          \
    const cudaError_t e_ = (x); \
    if (e_ != cudaSuccess) {    \
      return (int)e_;           \
    }                           \
  } while (0)

// Build the graph's head and its WHILE node, then start capturing the body
// on the loop's own stream (returned in *stream): the caller launches one
// wave's kernels there and calls ptt_wave_loop_end.
extern "C" int ptt_wave_loop_begin(const long long* ctr, long long items_total,
                                   long long max_waves, WaveLoop** out,
                                   void** stream) {
  WaveLoop* L = new WaveLoop{};
  *out = L;
  PTT_TRY(cudaGraphCreate(&L->graph, 0));
  PTT_TRY(cudaGraphConditionalHandleCreate(&L->handle, L->graph, 0, 0));
  cudaGraphNode_t head;
  cudaKernelNodeParams kp = {};
  void* kargs[] = {(void*)&ctr, (void*)&items_total, (void*)&max_waves,
                   (void*)&L->handle};
  kp.func = (void*)wave_loop_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = kargs;
  PTT_TRY(cudaGraphAddKernelNode(&head, L->graph, nullptr, 0, &kp));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = L->handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  PTT_TRY(cudaGraphAddNode(&loop, L->graph, &head, 1, &cp));
  PTT_TRY(cudaStreamCreateWithFlags(&L->stream, cudaStreamNonBlocking));
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  PTT_TRY(cudaStreamBeginCaptureToGraph(L->stream, body, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeRelaxed));
  *stream = (void*)L->stream;
  return 0;
}

// End the body with wave_loop_kernel, close the capture and instantiate.
extern "C" int ptt_wave_loop_end(WaveLoop* L, const long long* ctr,
                                 long long items_total, long long max_waves) {
  wave_loop_kernel<<<1, 1, 0, L->stream>>>(ctr, items_total, max_waves,
                                           L->handle);
  const cudaError_t launch = cudaGetLastError();
  cudaGraph_t body;
  const cudaError_t end = cudaStreamEndCapture(L->stream, &body);
  PTT_TRY(launch);
  PTT_TRY(end);
  PTT_TRY(cudaGraphInstantiate(&L->exec, L->graph, 0));
  return 0;
}

extern "C" int ptt_wave_loop_launch(WaveLoop* L, void* stream) {
  PTT_TRY(cudaGraphLaunch(L->exec, (cudaStream_t)stream));
  return 0;
}

// Free what was made; safe on a loop whose build failed part way.
extern "C" int ptt_wave_loop_free(WaveLoop* L) {
  if (L == nullptr) return 0;
  cudaStreamCaptureStatus st = cudaStreamCaptureStatusNone;
  if (L->stream != nullptr &&
      cudaStreamIsCapturing(L->stream, &st) == cudaSuccess &&
      st != cudaStreamCaptureStatusNone) {
    cudaGraph_t g;
    cudaStreamEndCapture(L->stream, &g);
  }
  if (L->exec != nullptr) cudaGraphExecDestroy(L->exec);
  if (L->graph != nullptr) cudaGraphDestroy(L->graph);
  if (L->stream != nullptr) cudaStreamDestroy(L->stream);
  delete L;
  cudaGetLastError();
  return 0;
}
