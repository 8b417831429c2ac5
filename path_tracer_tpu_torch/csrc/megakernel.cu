// K5 megakernel: one sample of every pixel, each path traced to its end.
//
// Replaces path_tracer_tpu/ops/integrator.py render_sample (:288) with
// trace_ray (:253) and bounce_body (:99) — the per-ray BVH walk to
// completion of ops/traverse.py traversal_step / _traverse_impl /
// traverse_bvh (:183, :512, :526; B10) and the bounce loop of B11
// (bounce_shade :123, _medium_sample :72; bounce.cuh, with the SSS walk of
// B6).  One thread per pixel traces its path (path.cuh: trace_path).
// A launch covers the npix pixels of a block from frame pixel pix_offset
// (the data-parallel shard; the whole frame from 0 by default): the RNG and
// the camera take the frame pixel, every output its index in the block.
// The thread writes its colour, iters and depth, and adds the colour to
// accum[pixel] with a plain load and store: one launch per sample keeps the
// JAX frame's add order (acc + sample, in sample order) with no float
// atomics.
//
// Four instantiations: the node width K (4 or 8, WaveArgs.branching) and
// where the walk's stack lives.  Up to sd = min(stack_depth, max_stack) =
// PTT_MEGA_STACK entries it is a per-thread local array; a deeper stack
// lives in the wrapper's per-pixel buffer (WaveArgs.stack, npix x sd ints).
// A push at a full stack is dropped as in JAX and counted in C_STACK_OVF.
// Counters (rays = sum of iters, clipped depth sum and histogram, walk
// trips, traversal steps, overflows) are reduced per block in shared memory,
// then added with one atomic per block.
//
// Bound: dependent node-row gathers of the walk, as in K1, plus divergence:
// paths in a warp end after different numbers of bounces, and an
// SSS-volumetric path walks up to sss_steps trips while its warp waits.
// Persistent threads and ray sorting are later work (PERF.md).
#include "path.cuh"

// Sample a.start_sample of block pixel pix, frame pixel pix_offset + pix
// (trace_path); writes the pixel's colour, iters and depth and adds the
// colour to the block's frame entry.
template <int K>
__device__ __forceinline__ void mega_pixel(const WaveArgs& a, int pix,
                                           int* stack, MegaCount& c) {
  PathRegs p;
  trace_path<K>(a, a.pix_offset + pix, stack, c, p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.color[3 * pix + k] = p.col[k];
    a.accum[3 * (size_t)pix + k] = a.accum[3 * (size_t)pix + k] + p.col[k];
  }
  a.iters[pix] = p.iters;
  a.depth[pix] = p.depth;
}

#ifndef PTT_HOST_EMULATION
template <int K, bool kGlobal>
__global__ void megakernel_kernel(WaveArgs a) {
  extern __shared__ int s_hist[];  // max_depth + 1 bins
  __shared__ unsigned long long s_rays, s_dsum, s_steps, s_walk, s_ovf, s_done;
  for (int k = threadIdx.x; k <= a.max_depth; k += blockDim.x) s_hist[k] = 0;
  if (threadIdx.x == 0) s_rays = s_dsum = s_steps = s_walk = s_ovf = s_done = 0ull;
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < a.npix) {
    MegaCount c{0, 0, 0};
    if constexpr (kGlobal) {
      mega_pixel<K>(a, pix, a.stack + (size_t)pix * a.sd, c);
    } else {
      int stack[PTT_MEGA_STACK];
      mega_pixel<K>(a, pix, stack, c);
    }
    const int dc = clampi(a.depth[pix], 0, a.max_depth);
    atomicAdd(&s_hist[dc], 1);
    atomicAdd(&s_done, 1ull);
    atomicAdd(&s_rays, (unsigned long long)a.iters[pix]);
    atomicAdd(&s_dsum, (unsigned long long)dc);
    atomicAdd(&s_steps, (unsigned long long)c.trav_steps);
    if (c.walk_trips) atomicAdd(&s_walk, (unsigned long long)c.walk_trips);
    if (c.ovf) atomicAdd(&s_ovf, (unsigned long long)c.ovf);
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= a.max_depth; k += blockDim.x) {
    if (s_hist[k]) atomicAdd(a.depth_hist + k, s_hist[k]);
  }
  if (threadIdx.x == 0) {
    unsigned long long* c = (unsigned long long*)a.ctr;
    atomicAdd(c + C_DONE, s_done);
    atomicAdd(c + C_RAYS, s_rays);
    atomicAdd(c + C_DEPTH_SUM, s_dsum);
    atomicAdd(c + C_TRAV_STEPS, s_steps);
    if (s_walk) atomicAdd(c + C_WALK_STEPS, s_walk);
    if (s_ovf) atomicAdd(c + C_STACK_OVF, s_ovf);
  }
}

template <int K, bool kGlobal>
static void launch_mega(const WaveArgs* a, void* stream) {
  const int block = 128;
  const int grid = (a->npix + block - 1) / block;
  const size_t smem = sizeof(int) * (size_t)(a->max_depth + 1);
  megakernel_kernel<K, kGlobal><<<grid, block, smem, (cudaStream_t)stream>>>(
      *a);
}

extern "C" int ptt_launch_megakernel(const WaveArgs* a, void* stream) {
  const bool global = a->sd > PTT_MEGA_STACK;
  if ((global && a->stack == nullptr) ||
      (a->branching != 4 && a->branching != 8))
    return (int)cudaErrorInvalidValue;
  if (a->branching == 4) {
    if (global) launch_mega<4, true>(a, stream);
    else launch_mega<4, false>(a, stream);
  } else {
    if (global) launch_mega<8, true>(a, stream);
    else launch_mega<8, false>(a, stream);
  }
  return (int)cudaGetLastError();
}
#endif
