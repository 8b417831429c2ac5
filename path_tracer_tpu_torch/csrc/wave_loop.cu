// The wavefront's wave loop on the device (B8'): a CUDA graph whose
// conditional WHILE node runs one wave per iteration until no work is left,
// captured once per configuration and replayed for every batch of it.
//
// Replaces the lax.while_loop(live, wave) of path_tracer_tpu/ops/
// wavefront.py render_batch (:427-467, :509), which keeps the whole loop on
// the TPU.  The graph is
//
//   wave_reset -> WHILE(h_while, default 1) { K1, K3, K4, K2 }
//
// wave_reset (wave_reset_kernel below) puts the wave state back to
// WaveEngine.init_state's values at the start of every launch: each slot,
// the counters, the depth histogram and the per-pixel path counts.  It
// leaves accum alone: the host copies the batch's frame in before the
// launch, and writes the batch's first sample to the word K2 reads
// (WaveArgs.sample_dev).  Nothing else of the graph changes between two
// batches of one configuration: the scene, BVH, key, camera, sizes and
// pointers are the same, so the host keeps the graph and its wave state
// (wavefront.WaveLoop) and launches it once a batch.
//
// K1 (csrc/trace_step.cu) evaluates the loop predicate (`live`, :464-465,
// and the wave bound) at its start: a wave with no work left clears
// h_while and the control flag and returns, K3, K4 and K2 after it return
// at once, and the loop ends; every wave before sets nothing.  So the loop
// has no kernel of its own: its cost is that last empty wave.  The
// condition is made with cudaGraphCondAssignDefault, so every launch starts
// it at 1 again.  The host reads the counters once, after the loop.
// The body is captured from the launchers of the other kernel libraries
// (cudaStreamBeginCaptureToGraph on a stream of this library), so a wave
// in the graph is the launch sequence of the per-wave host loop.  A wave
// bound (WaveArgs.max_waves) stops a loop that does not drain; the host
// then raises.  Every pointer the graph holds is the wave state's, which
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

// The reset's grid covers the largest of the per-slot, per-pixel, depth
// histogram and counter ranges; the stack (R x sd ints) goes in a
// grid-stride loop, so its writes coalesce.
__host__ __device__ __forceinline__ long long wave_reset_items(
    const WaveArgs& a) {
  long long n = a.R > a.npix ? a.R : a.npix;
  if (a.max_depth + 1 > n) n = a.max_depth + 1;
  return n > PTT_N_COUNTERS ? n : PTT_N_COUNTERS;
}

// Item i of the reset: slot i to init_state's values, pixel i's path count,
// histogram bin i and counter i to 0, where each exists.
__device__ __forceinline__ void wave_reset_item(const WaveArgs& a,
                                                long long i) {
  if (i < a.R) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.origin[3 * i + k] = 0.0f;
      a.direction[3 * i + k] = k == 2 ? 1.0f : 0.0f;
      a.color[3 * i + k] = 0.0f;
      a.throughput[3 * i + k] = 1.0f;
    }
    a.time[i] = 0.0f;
    a.depth[i] = 0;
    a.iters[i] = 0;
    a.alive[i] = false;
    a.cur[i] = PTT_DONE;
    a.sp[i] = 0;
    a.best_t[i] = a.t_max;
    a.best_pt[i] = -1;
    a.best_pi[i] = -1;
    a.phase[i] = 0;
    a.hit_found[i] = false;
    a.hit_pt[i] = -1;
    a.hit_pi[i] = -1;
    a.hit_t[i] = 0.0f;
    a.pixel[i] = 0;
    a.sample[i] = 0;
    a.last[i] = 0;
    a.occupied[i] = false;
    a.flag[i] = 0;
  }
  if (i < a.npix) a.pix_paths[i] = 0;
  if (i <= a.max_depth) a.depth_hist[i] = 0;
  if (i < PTT_N_COUNTERS) a.ctr[i] = 0;
}

__device__ __forceinline__ void wave_reset_stack(const WaveArgs& a,
                                                 long long j0,
                                                 long long step) {
  const long long words = (long long)a.R * a.sd;
  for (long long j = j0; j < words; j += step) a.stack[j] = 0;
}

#ifndef PTT_HOST_EMULATION
#define PTT_RESET_BLOCK 256

__global__ void wave_reset_kernel(WaveArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < wave_reset_items(a)) wave_reset_item(a, i);
  wave_reset_stack(a, i, (long long)gridDim.x * blockDim.x);
}

static dim3 wave_reset_grid(const WaveArgs& a) {
  return dim3((unsigned)((wave_reset_items(a) + PTT_RESET_BLOCK - 1) /
                         PTT_RESET_BLOCK));
}

// The reset on its own, on `stream` (the card's check of the kernel).
extern "C" int ptt_launch_wave_reset(const WaveArgs* a, void* stream) {
  wave_reset_kernel<<<wave_reset_grid(*a), PTT_RESET_BLOCK, 0,
                      (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

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

// Build the graph: the reset of the state `reset` points at, then the WHILE
// node after it; make the node's condition handle (returned for K1's
// argument block) and start capturing the body on the loop's own stream
// (returned in *stream): the caller launches one wave's kernels there and
// calls ptt_wave_loop_end.
extern "C" int ptt_wave_loop_begin(WaveLoop** out, const WaveArgs* reset,
                                   unsigned long long* h_while,
                                   void** stream) {
  WaveLoop* L = new WaveLoop{};
  *out = L;
  PTT_TRY(cudaGraphCreate(&L->graph, 0));
  cudaKernelNodeParams kp = {};
  void* params[] = {(void*)reset};          // copied into the node
  kp.func = (void*)wave_reset_kernel;
  kp.gridDim = wave_reset_grid(*reset);
  kp.blockDim = dim3(PTT_RESET_BLOCK);
  kp.kernelParams = params;
  cudaGraphNode_t reset_node;
  PTT_TRY(cudaGraphAddKernelNode(&reset_node, L->graph, nullptr, 0, &kp));
  PTT_TRY(cudaGraphConditionalHandleCreate(&L->h_while, L->graph, 1,
                                           cudaGraphCondAssignDefault));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = L->h_while;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  PTT_TRY(cudaGraphAddNode(&loop, L->graph, &reset_node, 1, &cp));
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

// One batch: the reset and the loop, on `stream`.
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
#endif
