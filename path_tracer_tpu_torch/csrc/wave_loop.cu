// The wavefront's wave loop on the device (B8'): a CUDA graph whose
// conditional WHILE node runs one wave per iteration until no work is left.
//
// Replaces the lax.while_loop(live, wave) of path_tracer_tpu/ops/
// wavefront.py render_batch (:427-467, :509), which keeps the whole loop on
// the TPU.  The graph is
//
//   WHILE(h_while, default 1) { K1, K3, K4, K2 }
//
// K1 (csrc/trace_step.cu) evaluates the loop predicate (`live`, :464-465,
// and the wave bound) at its start: a wave with no work left clears
// h_while and the control flag and returns, K3, K4 and K2 after it return
// at once, and the loop ends; every wave before sets nothing.  So the loop
// has no kernel of its own: its cost is that last empty wave.  The host
// launches the frame once and reads the counters once, after the loop.
// The body is captured from the launchers of the other kernel libraries
// (cudaStreamBeginCaptureToGraph on a stream of this library), so a wave
// in the graph is the launch sequence of the per-wave host loop.  A wave
// bound (WaveArgs.max_waves) stops a loop that does not drain; the host
// then raises.  Every pointer the body captures is the wave state's, which
// lives as long as the graph.
//
// Measured slower and not used (PERF.md): a kernel of one thread after K2
// that sets the condition (the loop's first form, 1.7 us a wave), and an
// IF node around K3, K4 and K2 on K1's control predicate (it skips the 51
// launches of each that find no control step, but each of the 516 waves
// pays the conditional node's scheduling, ~5 us).
// Needs CUDA 12.4 (conditional nodes, capture into a graph); any failure is
// returned as the CUDA error code and the wrapper raises.
#include "common.cuh"

struct WaveLoop {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  cudaGraphConditionalHandle h_while;
  cudaStream_t stream;
};

#define PTT_TRY(x)              \
  do {                          \
    const cudaError_t e_ = (x); \
    if (e_ != cudaSuccess) {    \
      return (int)e_;           \
    }                           \
  } while (0)

// Build the graph and its WHILE node, make its condition handle (returned
// for K1's argument block) and start capturing the body on the loop's own
// stream (returned in *stream): the caller launches one wave's kernels
// there and calls ptt_wave_loop_end.
extern "C" int ptt_wave_loop_begin(WaveLoop** out,
                                   unsigned long long* h_while,
                                   void** stream) {
  WaveLoop* L = new WaveLoop{};
  *out = L;
  PTT_TRY(cudaGraphCreate(&L->graph, 0));
  PTT_TRY(cudaGraphConditionalHandleCreate(&L->h_while, L->graph, 1,
                                           cudaGraphCondAssignDefault));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = L->h_while;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  PTT_TRY(cudaGraphAddNode(&loop, L->graph, nullptr, 0, &cp));
  PTT_TRY(cudaStreamCreateWithFlags(&L->stream, cudaStreamNonBlocking));
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  PTT_TRY(cudaStreamBeginCaptureToGraph(L->stream, body, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeRelaxed));
  *h_while = (unsigned long long)L->h_while;
  *stream = (void*)L->stream;
  return 0;
}

// Close the capture and instantiate.
extern "C" int ptt_wave_loop_end(WaveLoop* L) {
  cudaGraph_t body;
  PTT_TRY(cudaStreamEndCapture(L->stream, &body));
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
