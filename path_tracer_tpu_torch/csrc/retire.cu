// K4 retire: harvest finished paths.
//
// Replaces the retire half of path_tracer_tpu/ops/wavefront.py control
// (:337-424): the compacted scatter-add ladder into the (npix, 3) frame, the
// one-hot depth histogram and the done/rays/depth_sum counters.  One thread
// per slot; a FL_FINISHED path is counted, then either resamples in place
// (its window has samples left: FL_RESAMPLE for K2) or adds its radiance to
// accum[pixel] with atomicAdd and frees the slot.  Float atomics change
// only the per-pixel add order, not the set of paths added.
//
// Bound: a few atomics per finished path (3 floats into the frame, 5
// counters); the frame (4.3 MB at 800x450) stays in L2.
#include "common.cuh"

__device__ __forceinline__ void retire_lane(const WaveArgs& a, int i) {
  if (a.flag[i] != FL_FINISHED) return;
  unsigned long long* c = (unsigned long long*)a.ctr;
  const int dp = a.depth[i];
  const int px = a.pixel[i] - a.pix_offset;   // index in the pixel block
  atomicAdd(c + C_DONE, 1ull);
  atomicAdd(c + C_RAYS, (unsigned long long)a.iters[i]);
  atomicAdd(c + C_DEPTH_SUM, (unsigned long long)dp);
  atomicAdd(a.depth_hist + clampi(dp, 0, a.max_depth), 1);
  atomicAdd(a.pix_paths + px, 1);
  if (a.multi && a.sample[i] < a.last[i]) {
    a.flag[i] = FL_RESAMPLE;
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) atomicAdd(a.accum + 3 * (size_t)px + k, a.color[3 * i + k]);
  a.occupied[i] = false;
  a.flag[i] = FL_NONE;
  atomicAdd(c + C_N_OCC, (unsigned long long)(-1LL));
}

#ifndef PTT_HOST_EMULATION
__global__ void retire_kernel(WaveArgs a) {
  if (a.ctr[C_DO_CTRL] == 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) retire_lane(a, i);
}

extern "C" int ptt_launch_retire(const WaveArgs* a, void* stream) {
  const int block = 256;
  const int grid = (a->R + block - 1) / block;
  retire_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
