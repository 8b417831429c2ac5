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
// Bound: a control wave runs once thousands of slots are ready, so its
// finished lanes would all add into the same four counters and ~11
// histogram bins, and same-address atomics serialise.  So the counters are
// summed per warp (__reduce_add_sync) and per block (shared memory, the
// histogram as max_depth + 1 shared bins, as K5 does), and a block adds
// each non-zero total with one atomic.  What is left per lane is the
// per-pixel path count and, for a path that retires, its three frame adds:
// different pixels, almost never contended.  Integer counters are exact in
// any order.
#include "common.cuh"

#define PTT_RETIRE_BLOCK 256

// What lane i adds to the counters (all 0 and bin -1 unless it finished).
// A warp's sums fit 32 bits: iters and depth are at most cfg.iters.
struct RetireCount {
  unsigned int done, rays, depth_sum, freed;
  int bin;   // its depth-histogram bin, or -1
};

// A block's totals of RetireCount.
struct RetireTotals {
  long long done, rays, depth_sum, freed;
};

__device__ __forceinline__ RetireCount retire_lane(const WaveArgs& a, int i) {
  RetireCount n{0u, 0u, 0u, 0u, -1};
  if (a.flag[i] != FL_FINISHED) return n;
  const int dp = a.depth[i];
  const int px = a.pixel[i] - a.pix_offset;   // index in the pixel block
  n.done = 1u;
  n.rays = (unsigned int)a.iters[i];
  n.depth_sum = (unsigned int)dp;
  n.bin = clampi(dp, 0, a.max_depth);
  atomicAdd(a.pix_paths + px, 1);
  if (a.multi && a.sample[i] < a.last[i]) {
    a.flag[i] = FL_RESAMPLE;
    return n;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) atomicAdd(a.accum + 3 * (size_t)px + k, a.color[3 * i + k]);
  a.occupied[i] = false;
  a.flag[i] = FL_NONE;
  n.freed = 1u;
  return n;
}

// A block's commit of its histogram `hist`: one atomic per non-zero bin
// of the bins k0, k0 + dk, ... (the block's threads share them).
__device__ __forceinline__ void retire_commit_hist(const WaveArgs& a,
                                                   const int* hist, int k0,
                                                   int dk) {
  for (int k = k0; k <= a.max_depth; k += dk) {
    if (hist[k]) atomicAdd(a.depth_hist + k, hist[k]);
  }
}

// A block's commit of its totals: one atomic per non-zero total.
__device__ __forceinline__ void retire_commit_totals(const WaveArgs& a,
                                                     const RetireTotals& t) {
  unsigned long long* c = (unsigned long long*)a.ctr;
  if (t.done) atomicAdd(c + C_DONE, (unsigned long long)t.done);
  if (t.rays) atomicAdd(c + C_RAYS, (unsigned long long)t.rays);
  if (t.depth_sum) atomicAdd(c + C_DEPTH_SUM, (unsigned long long)t.depth_sum);
  if (t.freed) atomicAdd(c + C_N_OCC, (unsigned long long)(-t.freed));
}

#ifndef PTT_HOST_EMULATION
__global__ void __launch_bounds__(PTT_RETIRE_BLOCK) retire_kernel(WaveArgs a) {
  if (a.ctr[C_DO_CTRL] == 0) return;
  extern __shared__ int s_hist[];  // max_depth + 1 bins
  __shared__ unsigned long long s_tot[4];
  for (int k = threadIdx.x; k <= a.max_depth; k += blockDim.x) s_hist[k] = 0;
  if (threadIdx.x < 4) s_tot[threadIdx.x] = 0ull;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  RetireCount n{0u, 0u, 0u, 0u, -1};
  if (i < a.R) n = retire_lane(a, i);
  if (n.bin >= 0) atomicAdd(&s_hist[n.bin], 1);
  const unsigned int all = 0xffffffffu;
  const unsigned int w[4] = {
      __reduce_add_sync(all, n.done), __reduce_add_sync(all, n.rays),
      __reduce_add_sync(all, n.depth_sum), __reduce_add_sync(all, n.freed)};
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // sign-extend: a warp's depth sum is an int
      if (w[q]) atomicAdd(&s_tot[q], (unsigned long long)(long long)(int)w[q]);
    }
  }
  __syncthreads();
  retire_commit_hist(a, s_hist, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0)
    retire_commit_totals(a, RetireTotals{(long long)s_tot[0], (long long)s_tot[1],
                                         (long long)s_tot[2], (long long)s_tot[3]});
}

extern "C" int ptt_launch_retire(const WaveArgs* a, void* stream) {
  const int block = PTT_RETIRE_BLOCK;
  const int grid = (a->R + block - 1) / block;
  const size_t smem = sizeof(int) * (size_t)(a->max_depth + 1);
  retire_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
