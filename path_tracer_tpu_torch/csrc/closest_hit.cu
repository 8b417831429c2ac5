// K7 closest_hit and K9 ring_hop: one closest-hit query per lane, walked to
// completion.
//
// K7 replaces path_tracer_tpu/ops/integrator_tiled.py closest_hit_batched
// (:46), the query of the tiled engine (B12) and, per shard, of the
// tensor-parallel mode (parallel/scene_shard.py _traverse_tp, :121; B14).
// One thread per lane runs the per-ray walk of traverse.cuh through a BVH4 or
// a BVH8 from the lane's own start q_tmin (the main query's t_min, or the
// volume-exit query's t_hit + 1e-4) to completion, with K5's stack (a local
// array up to PTT_MEGA_STACK entries, else the wrapper's per-lane buffer
// WaveArgs.stack; four instantiations of each kernel); a lane that is
// not q_active does not walk and reports no hit (found false, pt = pi = -1,
// t = t_max).  In the tiled engine's volume-exit launch (gate_pt set) a
// lane walks only where the main query's hit has a medium, the only lanes
// whose exit hit the bounce reads (ops/integrator_tiled.py exit_lanes); it
// writes hit_found, hit_pt, hit_pi and hit_t.
//
// K9 is the same walk with the epilogue of one hop of the pipeline ring
// (parallel/pipeline.py _ring_closest_hit, :82-94; B14): where this stage's
// hit is closer than the carried best (hit_t), it refines the full hit
// record from this stage's primitive rows (refine_hit_t, shade_tiled.py:155)
// into rec and sets hit_found and hit_t; the carried bundle then moves to
// the next stage (a point-to-point hop outside the kernel).  Only a hit
// strictly closer than the carried best is merged, so K9's walk starts with
// best_t = min(t_max, hit_t) instead of t_max (JAX walks from t_max): a box
// or primitive it prunes cannot hold a hit that would be merged, the merged
// bundle is the same, and the walk takes fewer steps from the second hop on
// (ring_hop_plain walks with the same bound, so the step counts agree).
//
// Traversal steps and dropped pushes are reduced per block and added to
// ctr[C_TRAV_STEPS] and ctr[C_STACK_OVF].
//
// Bound: as K5's walk, dependent node-row gathers (one 384-byte row per
// step at K = 4, 736 at K = 8, the rows L2-resident) and divergence between
// lanes whose walks end after different numbers of steps; ~220 fp32 ops per
// step at K = 4.  K7 and K9 walk traverse.cuh's trav_step16, the node row in
// 16-byte loads, with the pair loop unrolled: measured faster than rolled
// here, where the kernel holds one walk and no bounce (K5, with two walks
// and the bounce, runs it rolled).  Measured slower and not used
// (PERF.md): threads that take the next live lane from a counter when
// their walk ends, step by step or a warp at a time, dead lanes skipped 32
// at a time.
#include "path.cuh"

// Whether K7 walks lane i's query: the lane is q_active and, in the
// volume-exit launch (gate_pt set), the main query's hit has a medium.
__device__ __forceinline__ bool closest_hit_live(const WaveArgs& a, int i) {
  if (a.q_active != nullptr && !a.q_active[i]) return false;
  return a.gate_pt == nullptr || medium_of(a, a.gate_pt[i], a.gate_pi[i]) >= 0;
}

// The query of lane i over (its start, t_max): walked to completion by
// step S, or no hit.
template <int K, WalkStep S>
__device__ __forceinline__ void query_lane(const WaveArgs& a, int i,
                                           float t_max, int* stack,
                                           MegaCount& c, int& pt, int& pi,
                                           float& t) {
  pt = pi = -1;
  t = a.t_max;
  if (a.q_active != nullptr && !a.q_active[i]) return;
  const float o[3] = {a.origin[3 * i], a.origin[3 * i + 1],
                      a.origin[3 * i + 2]};
  const float d[3] = {a.direction[3 * i], a.direction[3 * i + 1],
                      a.direction[3 * i + 2]};
  const float t_min = a.q_tmin != nullptr ? a.q_tmin[i] : a.t_min;
  trav_full<K, S>(a, o, d, a.time[i], t_min, t_max, stack, t, pt, pi, c);
}

// K7's lane: the query's result, or no hit where K7 does not walk it.
template <int K>
__device__ __forceinline__ void closest_hit_lane(const WaveArgs& a, int i,
                                                 int* stack, MegaCount& c) {
  int pt = -1, pi = -1;
  float t = a.t_max;
  if (closest_hit_live(a, i))
    query_lane<K, kStep16Unrolled>(a, i, a.t_max, stack, c, pt, pi, t);
  a.hit_found[i] = pt >= 0;
  a.hit_pt[i] = pt;
  a.hit_pi[i] = pi;
  a.hit_t[i] = t;
}

// K9's lane: the query, bounded by the carried best (only a strictly closer
// hit is merged, so nothing beyond it is walked), merged into the carried
// best where it is closer.
template <int K>
__device__ __forceinline__ void ring_hop_lane(const WaveArgs& a, int i,
                                              int* stack, MegaCount& c) {
  int pt, pi;
  float t;
  query_lane<K, kStep16Unrolled>(a, i, fminf(a.t_max, a.hit_t[i]), stack, c,
                                 pt, pi, t);
  if (!(pt >= 0 && t < a.hit_t[i])) return;
  const float t_min = a.q_tmin != nullptr ? a.q_tmin[i] : a.t_min;
  const Hit h = refine_hit(a, pt, pi, a.origin[3 * i], a.origin[3 * i + 1],
                           a.origin[3 * i + 2], a.direction[3 * i],
                           a.direction[3 * i + 1], a.direction[3 * i + 2],
                           a.time[i], t_min);
  a.hit_found[i] = true;
  a.hit_t[i] = t;
  float* r = a.rec + PTT_REC * (size_t)i;
  r[0] = h.t;
  r[1] = h.px; r[2] = h.py; r[3] = h.pz;
  r[4] = h.nx; r[5] = h.ny; r[6] = h.nz;
  r[7] = h.front ? 1.0f : 0.0f;
  r[8] = h.u; r[9] = h.v;
  r[10] = (float)h.mat; r[11] = (float)h.medium;
}

#ifndef PTT_HOST_EMULATION
template <int K, bool kGlobal, bool kHop>
__device__ __forceinline__ void query_block(const WaveArgs& a) {
  __shared__ unsigned long long s_steps, s_ovf;
  if (threadIdx.x == 0) s_steps = s_ovf = 0ull;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) {
    int local[kGlobal ? 1 : PTT_MEGA_STACK];
    int* stack = kGlobal ? a.stack + (size_t)i * a.sd : local;
    MegaCount c{0, 0, 0};
    if constexpr (kHop) {
      ring_hop_lane<K>(a, i, stack, c);
    } else {
      closest_hit_lane<K>(a, i, stack, c);
    }
    if (c.trav_steps) atomicAdd(&s_steps, (unsigned long long)c.trav_steps);
    if (c.ovf) atomicAdd(&s_ovf, (unsigned long long)c.ovf);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* ctr = (unsigned long long*)a.ctr;
    if (s_steps) atomicAdd(ctr + C_TRAV_STEPS, s_steps);
    if (s_ovf) atomicAdd(ctr + C_STACK_OVF, s_ovf);
  }
}

template <int K, bool kGlobal>
__global__ void closest_hit_kernel(WaveArgs a) {
  query_block<K, kGlobal, false>(a);
}

template <int K, bool kGlobal>
__global__ void ring_hop_kernel(WaveArgs a) {
  query_block<K, kGlobal, true>(a);
}

template <int K, bool kGlobal>
static void launch_query_k(const WaveArgs* a, void* stream, bool hop) {
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  if (hop) {
    ring_hop_kernel<K, kGlobal><<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  } else {
    closest_hit_kernel<K, kGlobal><<<grid, block, 0, (cudaStream_t)stream>>>(
        *a);
  }
}

static int launch_query(const WaveArgs* a, void* stream, bool hop) {
  const bool global = a->sd > PTT_MEGA_STACK;
  if ((global && a->stack == nullptr) ||
      (a->branching != 4 && a->branching != 8))
    return (int)cudaErrorInvalidValue;
  if (a->R == 0) return 0;
  if (a->branching == 4) {
    if (global) launch_query_k<4, true>(a, stream, hop);
    else launch_query_k<4, false>(a, stream, hop);
  } else {
    if (global) launch_query_k<8, true>(a, stream, hop);
    else launch_query_k<8, false>(a, stream, hop);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptt_launch_closest_hit(const WaveArgs* a, void* stream) {
  return launch_query(a, stream, false);
}

extern "C" int ptt_launch_ring_hop(const WaveArgs* a, void* stream) {
  return launch_query(a, stream, true);
}
#endif
