// K1 trace_step: one wave of suspended BVH4 closest-hit traversal.
//
// Replaces path_tracer_tpu/ops/traverse.py _step_tiled (:334) driven by
// traversal_steps_batched (:408), plus the wave's control predicate
// (ops/wavefront.py:451-462).  One thread per slot walks its query up to
// `steps` steps of traverse.cuh or until done.  The stack lives in device
// memory (R x sd ints, L1/L2-resident); a push at a full stack is dropped
// exactly as in the JAX step and counted in ctr[C_STACK_OVF], which the
// renderer requires to be 0.
//
// Bound: the node-row gathers.  Each step reads one 384-byte row per lane;
// rows are shared across lanes and stay in the 50 MB L2 (the vol2_final BVH
// is ~0.6 MB), so the kernel is latency-bound on dependent gathers, not on
// HBM bandwidth.  The simple design keeps one lane per thread; a shared-
// memory node cache, warp-level work redistribution and a persistent grid
// are later work (PERF.md).
//
// The last block to finish (atomic ticket) evaluates the control predicate
// from the block-reduced counts and writes ctr[C_DO_CTRL], which K3/K4/K2
// read in the same wave.
#include "traverse.cuh"

__device__ __forceinline__ void trace_lane(const WaveArgs& a, int i,
                                           int& ready, int& walk,
                                           int& steps_done, int& ovf) {
  ready = walk = steps_done = ovf = 0;
  if (!a.occupied[i]) return;
  int cur = a.cur[i];
  if (cur != PTT_DONE) {
    const TravRay r = trav_ray(
        a.origin[3 * i], a.origin[3 * i + 1], a.origin[3 * i + 2],
        a.direction[3 * i], a.direction[3 * i + 1], a.direction[3 * i + 2],
        a.time[i], a.phase[i] == PH_EXIT ? a.hit_t[i] + 1e-4f : a.t_min);
    int sp = a.sp[i];
    float best_t = a.best_t[i];
    int best_pt = a.best_pt[i], best_pi = a.best_pi[i];
    int* stack = a.stack + (size_t)i * a.sd;
    while (cur != PTT_DONE && steps_done < a.steps) {
      ++steps_done;
      trav_step(a, r, cur, stack, sp, best_t, best_pt, best_pi, ovf);
    }
    a.cur[i] = cur;
    a.sp[i] = sp;
    a.best_t[i] = best_t;
    a.best_pt[i] = best_pt;
    a.best_pi[i] = best_pi;
  }
  if (cur == PTT_DONE) ready = 1; else walk = 1;
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
  c[C_EXEC_STEPS] = c[C_EXEC_STEPS] + c[C_WAVE_MAX];
  c[C_CTRLS] = c[C_CTRLS] + (do_ctrl ? 1 : 0);
  c[C_DO_CTRL] = do_ctrl ? 1 : 0;
  c[C_N_READY] = 0;
  c[C_N_WALK] = 0;
  c[C_WAVE_MAX] = 0;
  c[C_TICKET] = 0;
}

__device__ __forceinline__ bool wave_is_live(const WaveArgs& a) {
  const long long spawned =
      a.ctr[C_SPAWNED] < a.items_total ? a.ctr[C_SPAWNED] : a.items_total;
  return spawned < a.items_total || a.ctr[C_N_OCC] > 0;
}

#ifndef PTT_HOST_EMULATION
__global__ void trace_step_kernel(WaveArgs a) {
  if (!wave_is_live(a)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctr[C_DO_CTRL] = 0;
    return;
  }
  __shared__ int s_ready, s_walk, s_max, s_ovf;
  __shared__ unsigned long long s_steps;
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    s_ready = s_walk = s_max = s_ovf = 0;
    s_steps = 0ull;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) {
    int ready, walk, steps, ovf;
    trace_lane(a, i, ready, walk, steps, ovf);
    if (ready) atomicAdd(&s_ready, 1);
    if (walk) atomicAdd(&s_walk, 1);
    if (steps) {
      atomicAdd(&s_steps, (unsigned long long)steps);
      atomicMax(&s_max, steps);
    }
    if (ovf) atomicAdd(&s_ovf, ovf);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* c = (unsigned long long*)a.ctr;
    atomicAdd(c + C_N_READY, (unsigned long long)s_ready);
    atomicAdd(c + C_N_WALK, (unsigned long long)s_walk);
    atomicAdd(c + C_TRAV_STEPS, s_steps);
    atomicMax(c + C_WAVE_MAX, (unsigned long long)s_max);
    if (s_ovf) atomicAdd(c + C_STACK_OVF, (unsigned long long)s_ovf);
    __threadfence();
    const unsigned long long t = atomicAdd(c + C_TICKET, 1ull);
    s_last = (t == gridDim.x - 1);
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    wave_epilogue(a);
  }
}

extern "C" int ptt_launch_trace_step(const WaveArgs* a, void* stream) {
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  trace_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
