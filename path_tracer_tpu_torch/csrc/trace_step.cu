// K1 trace_step: one wave of suspended closest-hit traversal of a BVH4 or a
// BVH8 (one instantiation per node width, chosen by WaveArgs.branching),
// with the adaptive wave exit.
//
// Replaces path_tracer_tpu/ops/traverse.py _step_tiled (:334) driven by
// traversal_steps_batched(adaptive=True) (:408, the exit at :459-490), plus
// the wave's control predicate (ops/wavefront.py:451-462).  A wave walks in
// chunks of `chunk` steps (JAX's _unroll(): 4 on an accelerator); the first
// chunk always runs, and chunk i+1 runs only while i+chunk < steps and more
// than R / exit_den lanes are still walking.  The rule needs a grid-wide
// count after every chunk, so a wave is one cooperative launch: its
// resident grid strides over the slots and takes two grid-wide barriers per
// chunk, one before block 0 reads the reduced counts and one before every
// block reads its decision.  (One launch per chunk, the launch boundary as
// the barrier, gave the same lanes and counters and measured slower per
// wave and per frame; PERF.md.)
//
// The epilogue of a chunk adds its walking lanes x chunk to
// ctr[C_TRAV_STEPS] and chunk to ctr[C_EXEC_STEPS] and sets ctr[C_GO]; the
// last chunk that ran evaluates the control predicate into ctr[C_DO_CTRL],
// which K3/K4/K2 read in the same wave.  A wave is one launch, so a CUDA
// graph can hold it (csrc/wave_loop.cu).
//
// One thread per slot walks its query up to `chunk` steps of traverse.cuh
// or until done.  Like JAX, every lane whose node pointer is not done walks
// and counts, occupied or not (an empty slot's pointer is done).  The stack
// lives in device memory (R x sd ints, L1/L2-resident); a push at a full
// stack is dropped exactly as in the JAX step and counted in
// ctr[C_STACK_OVF], which the renderer requires to be 0.
//
// Bound: the node-row gathers.  Each step reads one row per lane (384 bytes
// at K = 4, 736 at K = 8); rows are shared across lanes and stay in the
// 50 MB L2 (the vol2_final BVH is ~0.6 MB at K = 4), so the kernel is latency-bound on dependent gathers, not on
// HBM bandwidth.  The chunks add one reload of each walking lane's ray and
// traversal state per chunk, and two grid barriers per chunk.
#include "traverse.cuh"

#ifndef PTT_HOST_EMULATION
#include <cooperative_groups.h>
#endif

// Lane counts of one chunk: walking at the chunk's start and end (every
// lane), ready and walking occupied slots after the chunk, dropped pushes.
struct ChunkCount {
  int act, act_end, ready, walk, ovf;
};

template <int K>
__device__ __forceinline__ void trace_lane(const WaveArgs& a, int i,
                                           ChunkCount& n) {
  int cur = a.cur[i];
  if (cur != PTT_DONE) {
    ++n.act;
    const TravRay r = trav_ray(
        a.origin[3 * i], a.origin[3 * i + 1], a.origin[3 * i + 2],
        a.direction[3 * i], a.direction[3 * i + 1], a.direction[3 * i + 2],
        a.time[i], a.phase[i] == PH_EXIT ? a.hit_t[i] + 1e-4f : a.t_min);
    int sp = a.sp[i];
    float best_t = a.best_t[i];
    int best_pt = a.best_pt[i], best_pi = a.best_pi[i];
    int* stack = a.stack + (size_t)i * a.sd;
    for (int k = 0; k < a.chunk && cur != PTT_DONE; ++k)
      trav_step<K>(a, r, cur, stack, sp, best_t, best_pt, best_pi, n.ovf);
    a.cur[i] = cur;
    a.sp[i] = sp;
    a.best_t[i] = best_t;
    a.best_pt[i] = best_pt;
    a.best_pi[i] = best_pi;
  }
  if (cur != PTT_DONE) ++n.act_end;
  if (a.occupied[i]) {
    if (cur == PTT_DONE) ++n.ready; else ++n.walk;
  }
}

// Wave bookkeeping and the control predicate, from the reduced counts.
__device__ __forceinline__ void wave_epilogue(const WaveArgs& a) {
  volatile long long* c = a.ctr;
  const long long n_ready = c[C_N_READY], n_walk = c[C_N_WALK];
  const long long n_occ = c[C_N_OCC];
  const long long spawned =
      c[C_SPAWNED] < a.items_total ? c[C_SPAWNED] : a.items_total;
  const long long n_empty = a.R - n_occ;
  const bool can_spawn = spawned < a.items_total && n_empty > 0;
  const bool do_ctrl =
      (n_ready + (can_spawn ? n_empty : 0)) * a.ctrl_den >= a.R || n_walk == 0;
  c[C_WAVES] = c[C_WAVES] + 1;
  c[C_OCC_SUM] = c[C_OCC_SUM] + n_occ;
  c[C_CTRLS] = c[C_CTRLS] + (do_ctrl ? 1 : 0);
  c[C_DO_CTRL] = do_ctrl ? 1 : 0;
}

// After the chunk that starts at step i, from the reduced counts: account
// the chunk (JAX adds the walking lanes at the chunk's start x chunk), then
// either let the next chunk run or end the wave.
__device__ __forceinline__ void chunk_epilogue(const WaveArgs& a, int i) {
  volatile long long* c = a.ctr;
  c[C_TRAV_STEPS] = c[C_TRAV_STEPS] + c[C_N_ACT] * a.chunk;
  c[C_EXEC_STEPS] = c[C_EXEC_STEPS] + a.chunk;
  const bool go = i + a.chunk < a.steps && c[C_N_ACT_END] * a.exit_den > a.R;
  c[C_GO] = go ? 1 : 0;
  if (!go) wave_epilogue(a);
  c[C_N_ACT] = 0;
  c[C_N_ACT_END] = 0;
  c[C_N_READY] = 0;
  c[C_N_WALK] = 0;
}

__device__ __forceinline__ bool wave_is_live(const WaveArgs& a) {
  const long long spawned =
      a.ctr[C_SPAWNED] < a.items_total ? a.ctr[C_SPAWNED] : a.items_total;
  return spawned < a.items_total || a.ctr[C_N_OCC] > 0;
}

// Whether the wave runs; a wave with no work left clears the control flag
// and the chunk flag instead.
__device__ __forceinline__ bool wave_runs(const WaveArgs& a, bool writer) {
  if (wave_is_live(a)) return true;
  if (writer) {
    a.ctr[C_DO_CTRL] = 0;
    a.ctr[C_GO] = 0;
  }
  return false;
}

#ifndef PTT_HOST_EMULATION
// One wave (see the top of the file).
template <int K>
__global__ void trace_step_kernel(WaveArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (!wave_runs(a, first)) return;
  __shared__ int s_act, s_act_end, s_ready, s_walk, s_ovf;
  for (int i = 0; i < a.steps; i += a.chunk) {
    if (threadIdx.x == 0) s_act = s_act_end = s_ready = s_walk = s_ovf = 0;
    __syncthreads();
    ChunkCount n{0, 0, 0, 0, 0};
    for (int lane = blockIdx.x * blockDim.x + threadIdx.x; lane < a.R;
         lane += gridDim.x * blockDim.x)
      trace_lane<K>(a, lane, n);
    if (n.act) atomicAdd(&s_act, n.act);
    if (n.act_end) atomicAdd(&s_act_end, n.act_end);
    if (n.ready) atomicAdd(&s_ready, n.ready);
    if (n.walk) atomicAdd(&s_walk, n.walk);
    if (n.ovf) atomicAdd(&s_ovf, n.ovf);
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long* c = (unsigned long long*)a.ctr;
      atomicAdd(c + C_N_ACT, (unsigned long long)s_act);
      atomicAdd(c + C_N_ACT_END, (unsigned long long)s_act_end);
      atomicAdd(c + C_N_READY, (unsigned long long)s_ready);
      atomicAdd(c + C_N_WALK, (unsigned long long)s_walk);
      if (s_ovf) atomicAdd(c + C_STACK_OVF, (unsigned long long)s_ovf);
    }
    grid.sync();
    if (first) chunk_epilogue(a, i);
    grid.sync();
    if (((volatile long long*)a.ctr)[C_GO] == 0) break;
  }
}

// A cooperative launch: as many blocks as the slots need, at most as many
// of the node width's instantiation as fit resident on the card (the
// wrapper counts one launch).
template <int K>
static int launch_trace_step(const WaveArgs* a, void* stream) {
  const int block = 128;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trace_step_kernel<K>, block, 0);
  if (err != cudaSuccess) return (int)err;
  const int need = (a->R + block - 1) / block;
  const int grid = need < per_sm * sms ? need : per_sm * sms;
  void* args[] = {(void*)a};
  return (int)cudaLaunchCooperativeKernel((void*)trace_step_kernel<K>,
                                          dim3(grid), dim3(block), args, 0,
                                          (cudaStream_t)stream);
}

extern "C" int ptt_launch_trace_step(const WaveArgs* a, void* stream) {
  if (a->chunk <= 0) return (int)cudaErrorInvalidValue;
  if (a->branching == 4) return launch_trace_step<4>(a, stream);
  if (a->branching == 8) return launch_trace_step<8>(a, stream);
  return (int)cudaErrorInvalidValue;
}
#endif
