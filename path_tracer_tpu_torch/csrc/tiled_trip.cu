// K8 tiled_trip: one fixed trip of the tiled engine for every lane.
//
// Replaces the body of path_tracer_tpu/ops/integrator_tiled.py
// trace_rays_tiled's scan (:91-118, B12) after its two closest-hit queries
// (K7): prim_medium_t of the exit hit (shade_tiled.py:116, B9), wave_rng
// (:701, B2; keys fold base -> sample -> pixel -> iters), bounce_shade_t
// (:773, B4, with the textures of B5 and the SSS walk of B6; bounce.cuh),
// and the freeze of finished lanes: a lane writes its new path state only
// where it is alive, so a dead lane keeps its state, as the scan's
// jnp.where(keep, new, old) does.
//
// Inputs per lane: the path state, its frame pixel, the main query's
// (hit_found, hit_pt, hit_pi) and, in a medium scene, the exit query's
// (exit_found, exit_t, exit_pt, exit_pi); exit_med, when given, replaces the
// medium lookup (the tensor-parallel mode broadcasts it from the shard that
// owns the exit hit).  Every lane takes one sample: start_sample, or
// *sample_dev when set (a captured trip graph replays each sample).  The rec
// variant (tiled_trip_rec_kernel) shades the hit record rec of the pipeline
// mode instead of refining (hit_pt, hit_pi) against the local rows
// (bounce_shade_t's rec=, shade_tiled.py:775, 785-790).  The SSS walk's
// trips are reduced per block into ctr[C_WALK_STEPS].
//
// Bound: per live lane one bounce, ~1,920 fp32 ops (12 threefry draws and a
// few transcendentals) plus the walk, and ~5 scattered row reads; divergence
// between families, and an SSS-volumetric lane walking while its warp waits
// (the walk stays a __noinline__ call, as in K3).
//
// The same source holds the engine's spawn (tiled_spawn_kernel): the first
// trip's path state, spawn_paths (shade_tiled.py:741, B3) with K2's camera
// code (camera.cuh), for the sample (as above) of each lane's frame pixel.
#include "bounce.cuh"

__device__ __forceinline__ int tiled_sample(const WaveArgs& a) {
  return a.sample_dev != nullptr ? *a.sample_dev : a.start_sample;
}

// The primary ray of lane i and a fresh path state.
__device__ __forceinline__ void tiled_spawn_lane(const WaveArgs& a, int i) {
  float o[3], d[3], time, u5[5];
  const int pix = a.pixel[i];
  primary_ray(a, path_key(a, tiled_sample(a), pix), pix, o, d, time, u5);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.origin[3 * i + k] = o[k];
    a.direction[3 * i + k] = d[k];
    a.color[3 * i + k] = 0.0f;
    a.throughput[3 * i + k] = 1.0f;
  }
  a.time[i] = time;
  a.depth[i] = 0;
  a.iters[i] = 0;
  a.alive[i] = true;
}

template <bool kRec>
__device__ __forceinline__ int tiled_lane(const WaveArgs& a, int i) {
  if (!a.alive[i]) return 0;
  PathRegs p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.o[k] = a.origin[3 * i + k];
    p.d[k] = a.direction[3 * i + k];
    p.col[k] = a.color[3 * i + k];
    p.thr[k] = a.throughput[3 * i + k];
  }
  p.time = a.time[i];
  p.depth = a.depth[i];
  p.iters = a.iters[i];
  p.alive = true;
  bool exit_found = false, exit_is_medium = false;
  float t_exit = 0.0f;
  if (a.has_medium) {
    exit_found = a.exit_found[i];
    t_exit = a.exit_t[i];
    exit_is_medium = a.exit_med != nullptr
                         ? a.exit_med[i]
                         : medium_of(a, a.exit_pt[i], a.exit_pi[i]) >= 0;
  }
  const Key kit = fold_in(fold_in(fold_in(Key{a.key0, a.key1},
                                          (uint32_t)tiled_sample(a)),
                                  (uint32_t)a.pixel[i]),
                          (uint32_t)p.iters);
  int trips;
  if constexpr (kRec) {
    const float* r = a.rec + PTT_REC * (size_t)i;
    const Hit h{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[8], r[9],
                r[7] != 0.0f, (int)r[10], (int)r[11]};
    trips = bounce<NoTape, true>(a, p, a.hit_found[i], 0, 0, exit_found,
                                 t_exit, exit_is_medium, kit, nullptr, &h);
  } else {
    trips = bounce(a, p, a.hit_found[i], a.hit_pt[i], a.hit_pi[i], exit_found,
                   t_exit, exit_is_medium, kit);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.origin[3 * i + k] = p.o[k];
    a.direction[3 * i + k] = p.d[k];
    a.color[3 * i + k] = p.col[k];
    a.throughput[3 * i + k] = p.thr[k];
  }
  a.depth[i] = p.depth;
  a.iters[i] = p.iters;
  a.alive[i] = p.alive;
  return trips;
}

#ifndef PTT_HOST_EMULATION
template <bool kRec>
__device__ __forceinline__ void trip_block(const WaveArgs& a) {
  __shared__ unsigned long long s_walk;
  if (threadIdx.x == 0) s_walk = 0ull;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) {
    const int trips = tiled_lane<kRec>(a, i);
    if (trips) atomicAdd(&s_walk, (unsigned long long)trips);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_walk) {
    atomicAdd((unsigned long long*)a.ctr + C_WALK_STEPS, s_walk);
  }
}

__global__ void tiled_trip_kernel(WaveArgs a) { trip_block<false>(a); }

__global__ void tiled_trip_rec_kernel(WaveArgs a) { trip_block<true>(a); }

__global__ void tiled_spawn_kernel(WaveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) tiled_spawn_lane(a, i);
}

static int launch_trip(const WaveArgs* a, void* stream, bool rec) {
  if (a->R == 0) return 0;
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  if (rec) {
    tiled_trip_rec_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  } else {
    tiled_trip_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptt_launch_tiled_trip(const WaveArgs* a, void* stream) {
  return launch_trip(a, stream, false);
}

extern "C" int ptt_launch_tiled_trip_rec(const WaveArgs* a, void* stream) {
  return launch_trip(a, stream, true);
}

extern "C" int ptt_launch_tiled_spawn(const WaveArgs* a, void* stream) {
  if (a->R == 0) return 0;
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  tiled_spawn_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
