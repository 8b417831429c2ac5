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
// *sample_dev when set (a captured trip graph replays each sample); the
// base key (and the spawn's camera) likewise come from frame_dev when set,
// so that a kept graph renders every frame's key and view.  The rec
// variant (tiled_trip_rec_kernel) shades the hit record rec of the pipeline
// mode instead of refining (hit_pt, hit_pi) against the local rows
// (bounce_shade_t's rec=, shade_tiled.py:775, 785-790).  The SSS walk's
// trips are reduced per block into ctr[C_WALK_STEPS].
//
// Bound: per live lane one bounce, ~1,920 fp32 ops (12 threefry draws and a
// few transcendentals) plus the walk, and ~5 scattered row reads.  What a
// launch loses against that is in its warps: as paths die, live lanes
// scatter over the chunk's 360,000 (from trip 6 of the 10-spp vol2_final
// frame a warp with a live lane holds fewer than 4), and a warp mixes
// material families, an SSS-volumetric lane walking while its warp waits
// (the walk stays a __noinline__ call, as in K3).  The design fills the
// warps: where the wrapper gives live lists (WaveArgs.live), a trip runs
// only the lanes of its list, over a fixed grid of the blocks resident on
// the card that strides over the list's count (read on the device, so a
// captured graph needs no host value), and appends the lanes that stay
// alive to the other list, one atomic ticket a warp; the launch's last
// block clears the count it read.  tiled_spawn writes the first list.  A
// lane's result does not depend on the thread that runs it (its keys fold
// sample -> pixel -> iters), so the frame is bit-identical to a launch over
// every lane.  Measured slower and not used (PERF.md): each block's lanes
// sorted by material family before they run, and a grid of a block per
// chunk of lanes in place of the resident one.
//
// The same source holds the engine's spawn (tiled_spawn_kernel): the first
// trip's path state, spawn_paths (shade_tiled.py:741, B3) with K2's camera
// code (camera.cuh), for the sample (as above) of each lane's frame pixel.
// Bound: 69 bytes a lane (its pixel read; origin, direction, colour,
// throughput, time, depth, iters, alive and its list entry written), and
// 8 threefry evaluations, one of them (the frame key folded with the
// sample) the same for every lane.  On an H100 (80GB HBM3, 700 W) the
// 4-byte stores of the three-float rows bounded it: a warp wrote each of
// their 32-byte sectors in three parts, and a launch with its draws taken
// out ran as long as the whole spawn.  So a whole warp writes those rows
// in 16-byte stores (staged in shared memory), and each block folds the
// sample once, with the camera, into a SpawnFrame that its lanes read, so
// that the argument block stays read-only; the result is bit-identical.
// Measured and not used (PERF.md): sincosf for the lens offset, blocks of
// 256 lanes.
#include "bounce.cuh"

__device__ __forceinline__ int tiled_sample(const WaveArgs& a) {
  return a.sample_dev != nullptr ? *a.sample_dev : a.start_sample;
}

// The frame's base key: from card memory where frame_dev is set (a kept
// trip graph renders each frame's key), else the argument block's.
__device__ __forceinline__ Key frame_key(const WaveArgs& a) {
  return a.frame_dev != nullptr ? Key{a.frame_dev[0], a.frame_dev[1]}
                                : Key{a.key0, a.key1};
}

// What the lanes of a tiled_spawn block share, staged once a block in
// shared memory: the frame's key folded with the launch's sample (the
// same for every lane) and the camera, from frame_dev where it is set
// (the layout in common.cuh), else from the argument block, which stays
// read-only.
struct SpawnFrame {
  Key ks;
  int width;
  float cam_origin[3], pixel00[3], du[3], dv[3], defocus_u[3], defocus_v[3];
  float defocus_angle;
};

__device__ __forceinline__ SpawnFrame spawn_frame(const WaveArgs& a) {
  SpawnFrame s;
  const unsigned int* f = a.frame_dev;
  s.ks = fold_in(frame_key(a), (uint32_t)tiled_sample(a));
  s.width = a.width;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.cam_origin[k] = f ? bits_as_float(f[2 + k]) : a.cam_origin[k];
    s.pixel00[k] = f ? bits_as_float(f[5 + k]) : a.pixel00[k];
    s.du[k] = f ? bits_as_float(f[8 + k]) : a.du[k];
    s.dv[k] = f ? bits_as_float(f[11 + k]) : a.dv[k];
    s.defocus_u[k] = f ? bits_as_float(f[14 + k]) : a.defocus_u[k];
    s.defocus_v[k] = f ? bits_as_float(f[17 + k]) : a.defocus_v[k];
  }
  s.defocus_angle = f ? bits_as_float(f[20]) : a.defocus_angle;
  return s;
}

// The primary ray of frame pixel pix: origin o, unit direction d, time.
__device__ __forceinline__ void spawn_ray(const SpawnFrame& s, int pix,
                                          float* o, float* d, float& time) {
  float u5[5];
  camera_ray(s, fold_in(s.ks, (uint32_t)pix), pix, o, d, time, u5);
}

// Lane i's fresh path state but its three-float rows.
__device__ __forceinline__ void spawn_fresh(const WaveArgs& a, int i,
                                            float time) {
  a.time[i] = time;
  a.depth[i] = 0;
  a.iters[i] = 0;
  a.alive[i] = true;
  if (a.live != nullptr) a.live[i] = i;
}

// Lane i's whole state in 4-byte stores (a warp past the lanes' end, or
// rows not 16-byte aligned).
__device__ __forceinline__ void spawn_store(const WaveArgs& a, int i,
                                            const float* o, const float* d,
                                            float time) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.origin[3 * i + k] = o[k];
    a.direction[3 * i + k] = d[k];
    a.color[3 * i + k] = 0.0f;
    a.throughput[3 * i + k] = 1.0f;
  }
  spawn_fresh(a, i, time);
}

// Whether the four three-float rows take 16-byte stores.
__device__ __forceinline__ bool spawn_rows16(const WaveArgs& a) {
  return (((uintptr_t)a.origin | (uintptr_t)a.direction |
           (uintptr_t)a.color | (uintptr_t)a.throughput) & 15u) == 0;
}

// Piece q (0..23) of the rows of the 32 lanes from i0 (a multiple of 32):
// one 16-byte store into each of the four row arrays, whose 384 bytes for
// those lanes are contiguous; o96 and d96 hold the warp's origins and
// directions lane after lane.
__device__ __forceinline__ void spawn_rows_piece(const WaveArgs& a, int i0,
                                                 int q, const float* o96,
                                                 const float* d96) {
  const size_t at = (size_t)3 * i0 / 4 + q;
  reinterpret_cast<float4*>(a.origin)[at] =
      reinterpret_cast<const float4*>(o96)[q];
  reinterpret_cast<float4*>(a.direction)[at] =
      reinterpret_cast<const float4*>(d96)[q];
  reinterpret_cast<float4*>(a.color)[at] = float4{0.0f, 0.0f, 0.0f, 0.0f};
  reinterpret_cast<float4*>(a.throughput)[at] =
      float4{1.0f, 1.0f, 1.0f, 1.0f};
}

template <bool kRec>
__device__ __forceinline__ int tiled_lane(const WaveArgs& a, int i,
                                          bool* alive_out = nullptr) {
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
  const Key kit = fold_in(fold_in(fold_in(frame_key(a),
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
  if (alive_out != nullptr) *alive_out = p.alive;
  return trips;
}

// Threads a block of K8, and of the spawn.
#define PTT_TRIP_THREADS 128
#define PTT_SPAWN_THREADS 128

// The lanes a trip runs: n positions, position p lane list[p], or lane p
// where list is null (no live lists: every lane, the dead ones returning
// at once).
struct TripLanes {
  const int* list;
  int n;
};

__device__ __forceinline__ TripLanes trip_lanes(const WaveArgs& a) {
  if (a.live == nullptr) return TripLanes{nullptr, a.R};
  return TripLanes{a.live + (size_t)a.live_parity * a.R,
                   a.live_n[a.live_parity]};
}

// The lane at position pos (-1 past the end).
__device__ __forceinline__ int trip_lane_at(const TripLanes& t, int pos) {
  if (pos >= t.n) return -1;
  return t.list != nullptr ? t.list[pos] : pos;
}

#ifndef PTT_HOST_EMULATION
// Append lane i to the other live list where keep holds, one atomic a warp
// (every lane of the warp calls it).
__device__ __forceinline__ void live_append(const WaveArgs& a, bool keep,
                                            int i) {
  const unsigned m = __ballot_sync(PTT_FULL_WARP, keep);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  const int out = 1 - a.live_parity;
  int base = 0;
  if (lane == leader) base = atomicAdd(a.live_n + out, __popc(m));
  base = __shfl_sync(PTT_FULL_WARP, base, leader);
  if (keep)
    a.live[(size_t)out * a.R + base + __popc(m & ((1u << lane) - 1u))] = i;
}

// One trip over this block's positions, a grid-stride loop over whole
// blocks of positions (one step without live lists, whose grid covers the
// lanes).
__device__ __forceinline__ void trip_block(const WaveArgs& a) {
  __shared__ unsigned long long s_walk;
  if (threadIdx.x == 0) s_walk = 0ull;
  __syncthreads();
  const TripLanes lanes = trip_lanes(a);
  unsigned long long trips = 0ull;
  for (int b = blockIdx.x * PTT_TRIP_THREADS; b < lanes.n;
       b += gridDim.x * PTT_TRIP_THREADS) {
    const int i = trip_lane_at(lanes, b + threadIdx.x);
    bool alive = false;
    if (i >= 0) trips += tiled_lane<false>(a, i, &alive);
    if (a.live != nullptr) live_append(a, alive, i);
  }
  if (trips) atomicAdd(&s_walk, trips);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_walk) atomicAdd((unsigned long long*)a.ctr + C_WALK_STEPS, s_walk);
    if (a.live != nullptr) {
      // the launch's last block clears the count every block has read
      __threadfence();
      if (atomicAdd(a.live_n + 2, 1) + 1 == (int)gridDim.x) {
        a.live_n[a.live_parity] = 0;
        a.live_n[2] = 0;
      }
    }
  }
}

// The rec variant: one thread a lane, every lane of the chunk.
__device__ __forceinline__ void trip_block_rec(const WaveArgs& a) {
  __shared__ unsigned long long s_walk;
  if (threadIdx.x == 0) s_walk = 0ull;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) {
    const int trips = tiled_lane<true>(a, i);
    if (trips) atomicAdd(&s_walk, (unsigned long long)trips);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_walk) {
    atomicAdd((unsigned long long*)a.ctr + C_WALK_STEPS, s_walk);
  }
}

__global__ void __launch_bounds__(PTT_TRIP_THREADS)
    tiled_trip_kernel(WaveArgs a) {
  trip_block(a);
}

__global__ void tiled_trip_rec_kernel(WaveArgs a) { trip_block_rec(a); }

// The first trip's state; with live lists, list 0 is every lane.  Thread 0
// stages the block's SpawnFrame while the lanes load their pixels.  A
// whole warp stages its origins and directions in shared memory (stride 3:
// no bank conflict) and writes its four three-float rows as 16-byte
// stores, each a full 32-byte sector, where lane by lane 4-byte stores at
// a 12-byte stride would write every sector in three parts.
__global__ void __launch_bounds__(PTT_SPAWN_THREADS)
    tiled_spawn_kernel(WaveArgs a) {
  __shared__ SpawnFrame s_frame;
  __shared__ __align__(16) float s_rows[PTT_SPAWN_THREADS / 32][2][96];
  const int i = blockIdx.x * PTT_SPAWN_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, i0 = i - lane;
  const int pix = i < a.R ? a.pixel[i] : 0;
  if (threadIdx.x == 0) s_frame = spawn_frame(a);
  __syncthreads();
  if (i0 >= a.R) return;
  float o[3], d[3], time;
  spawn_ray(s_frame, pix, o, d, time);
  if (i0 + 32 <= a.R && spawn_rows16(a)) {
    float* o96 = s_rows[threadIdx.x >> 5][0];
    float* d96 = s_rows[threadIdx.x >> 5][1];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o96[3 * lane + k] = o[k];
      d96[3 * lane + k] = d[k];
    }
    __syncwarp();
    if (lane < 24) spawn_rows_piece(a, i0, lane, o96, d96);
    spawn_fresh(a, i, time);
  } else if (i < a.R) {
    spawn_store(a, i, o, d, time);
  }
  if (i == 0 && a.live != nullptr) {
    a.live_n[0] = a.R;
    a.live_n[1] = 0;
    a.live_n[2] = 0;
  }
}

// A block per PTT_TRIP_THREADS lanes; with live lists a fixed grid of the
// blocks that fit on the card at once (asked once), at most that many.
static int launch_trip(const WaveArgs* a, void* stream) {
  if (a->R == 0) return 0;
  if (a->live != nullptr && a->live_parity != 0 && a->live_parity != 1)
    return (int)cudaErrorInvalidValue;
  int grid = (a->R + PTT_TRIP_THREADS - 1) / PTT_TRIP_THREADS;
  if (a->live != nullptr) {
    static int resident_blocks = 0;
    if (resident_blocks == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, tiled_trip_kernel, PTT_TRIP_THREADS, 0);
      if (err != cudaSuccess) return (int)err;
      resident_blocks = per_sm * sms;
    }
    grid = grid < resident_blocks ? grid : resident_blocks;
  }
  tiled_trip_kernel<<<grid, PTT_TRIP_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ptt_launch_tiled_trip(const WaveArgs* a, void* stream) {
  return launch_trip(a, stream);
}

extern "C" int ptt_launch_tiled_trip_rec(const WaveArgs* a, void* stream) {
  if (a->R == 0) return 0;
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  tiled_trip_rec_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ptt_launch_tiled_spawn(const WaveArgs* a, void* stream) {
  if (a->R == 0) return 0;
  const int grid = (a->R + PTT_SPAWN_THREADS - 1) / PTT_SPAWN_THREADS;
  tiled_spawn_kernel<<<grid, PTT_SPAWN_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
