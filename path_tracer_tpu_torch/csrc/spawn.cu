// K2 spawn: hand the next work items to empty slots and start their rays.
//
// Replaces path_tracer_tpu/ops/wavefront.py spawn (:216-266; the
// prefix-sum rank becomes one atomicAdd on the item counter),
// shade_tiled.py spawn_rng (:730, B2), spawn_paths/get_rays_t (:741, :333,
// B3; camera.cuh) and traversal_init_batched (traverse.py:280, root-leaf
// case included; traverse.cuh).  A work item id maps to (window g, pixel) =
// (id / npix, pix_offset + order[id % npix]) with samples
// [start + g*stride, start + min((g+1)*stride, n)); with stride 1 it is one
// (sample, pixel).  start is *sample_dev where it is set (the kept wave
// loop graph replays every batch of its configuration, csrc/wave_loop.cu),
// else start_sample.  order is WaveArgs.spawn_order, the identity where it is
// null (wavefront.py:237-243: JAX permutes the block pixel before it adds
// the offset).  A slot keeps its frame pixel, which the camera and the
// RNG take; K4 maps it into the block of npix pixels that starts at
// pix_offset (the data-parallel shard).  FL_RESAMPLE slots start the
// next sample of their window in place and keep their radiance sum.  The
// RNG folds fix the (sample, pixel) set, so which slot takes which item
// does not change the image beyond float add order.  nvcc compiles each
// atomicAdd(p, 1) here to one atomic per warp (a leader adds the warp's
// count, the lanes rank by population count); written out by hand, with
// the new occupancy summed per block, K2 ran slower (PERF.md).
//
// Bound: 6 threefry evaluations (~120 integer ops each) and a few
// transcendentals per renewed slot; memory traffic is ~100 bytes per slot.
#include "camera.cuh"
#include "traverse.cuh"

__device__ __forceinline__ void spawn_lane(const WaveArgs& a, int i) {
  const bool resample = a.flag[i] == FL_RESAMPLE;
  bool can = false;
  long long id = 0;
  if (!a.occupied[i] && a.ctr[C_SPAWNED] < a.items_total) {
    id = (long long)atomicAdd((unsigned long long*)a.ctr + C_SPAWNED, 1ull);
    can = id < a.items_total;
  }
  if (!can && !resample) return;
  int smp, pix, last;
  if (can) {
    const int start = a.sample_dev ? *a.sample_dev : a.start_sample;
    if (a.multi) {
      const long long g = id / a.npix;
      smp = start + (int)(g * a.stride);
      const long long end = (g + 1) * a.stride < a.n_samples
                                ? (g + 1) * a.stride : a.n_samples;
      last = start + (int)end - 1;
    } else {
      smp = start + (int)(id / a.npix);
      last = smp;
    }
    int p = (int)(id % a.npix);
    if (a.spawn_order != nullptr) p = a.spawn_order[p];
    pix = a.pix_offset + p;
  } else {
    smp = a.sample[i] + 1;
    pix = a.pixel[i];
    last = a.last[i];
  }
  float o[3], d[3], time, u5[5];
  primary_ray(a, path_key(a, smp, pix), pix, o, d, time, u5);
  if (a.u5_out) {
#pragma unroll
    for (int k = 0; k < 5; ++k) a.u5_out[5 * i + k] = u5[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.origin[3 * i + k] = o[k];
    a.direction[3 * i + k] = d[k];
    if (!resample) a.color[3 * i + k] = 0.0f;
    a.throughput[3 * i + k] = 1.0f;
  }
  a.time[i] = time;
  a.depth[i] = 0;
  a.iters[i] = 0;
  a.alive[i] = true;
  trav_init(a, i, o[0], o[1], o[2], d[0], d[1], d[2], time, a.t_min);
  a.phase[i] = PH_MAIN;
  a.pixel[i] = pix;
  a.sample[i] = smp;
  a.last[i] = last;
  a.flag[i] = FL_NONE;
  if (can) {
    a.occupied[i] = true;
    atomicAdd((unsigned long long*)a.ctr + C_N_OCC, 1ull);
  }
}

#ifndef PTT_HOST_EMULATION
__global__ void spawn_kernel(WaveArgs a) {
  if (a.ctr[C_DO_CTRL] == 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) spawn_lane(a, i);
}

extern "C" int ptt_launch_spawn(const WaveArgs* a, void* stream) {
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  spawn_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
