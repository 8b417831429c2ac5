// K5 megakernel: one sample of every pixel, each path traced to its end.
//
// Replaces path_tracer_tpu/ops/integrator.py render_sample (:288) with
// trace_ray (:253) and bounce_body (:99) — the per-ray BVH walk to
// completion of ops/traverse.py traversal_step / _traverse_impl /
// traverse_bvh (:183, :512, :526; B10) and the bounce loop of B11
// (bounce_shade :123, _medium_sample :72; bounce.cuh, with the SSS walk of
// B6).  Each pixel's path is traced by one thread (path.cuh).
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
//
// Bound: dependent node-row gathers of the walk, as in K1, plus divergence:
// paths in a warp end after different numbers of bounces (up to max_depth,
// each with one or two walks), and an SSS-volumetric path walks up to
// sss_steps trips while its warp waits.  The design:
// - The walks run trav_step16 (traverse.cuh): node rows in 16-byte loads
//   and the child loop rolled in pairs, so that each walk holds one copy
//   of a pair's code instead of K inline leaf tests.
// - Work is fetched when a path ends: the grid is as many blocks as fit on
//   the card at once, and each lane, when its path ends, writes its pixel
//   and takes the next one from ctr[C_FETCH] (one atomic per warp for the
//   lanes that need work, warp_fetch), so a warp stays full of paths until
//   the sample's pixels run out, trip by trip.  The last block clears the
//   counter (fetch_close), so every launch starts from 0.
// - Counters (rays = sum of iters, clipped depth sum, paths, walk trips,
//   traversal steps, overflows) are summed per thread over its pixels, per
//   warp (__reduce_add_sync) and per block in shared memory, then added
//   with one atomic per block; the depth histogram in shared bins.
// Measured slower and not used (PERF.md): persistent warps that take 32
// pixels at a time and trace each path to its end; the walk's stack in
// shared memory; the pair loop unrolled.
#include "fetch.cuh"
#include "path.cuh"

#define PTT_MEGA_BLOCK 128

// What a thread adds to the counters over the pixels it traced.
struct MegaTally {
  MegaCount c;   // traversal steps, SSS walk trips, dropped pushes
  unsigned int done, rays, depth_sum;
};

// The end of block pixel pix's path p: its colour, iters and depth
// written, its colour added to the block's frame entry, its counts into t;
// returns its depth-histogram bin.
__device__ __forceinline__ int mega_finish(const WaveArgs& a, int pix,
                                           const PathRegs& p, MegaTally& t) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.color[3 * pix + k] = p.col[k];
    a.accum[3 * (size_t)pix + k] = a.accum[3 * (size_t)pix + k] + p.col[k];
  }
  a.iters[pix] = p.iters;
  a.depth[pix] = p.depth;
  const int dc = clampi(p.depth, 0, a.max_depth);
  t.done += 1u;
  t.rays += (unsigned int)p.iters;
  t.depth_sum += (unsigned int)dc;
  return dc;
}

// Sample a.start_sample of block pixel pix, frame pixel pix_offset + pix,
// traced to its end (the trips a lane of the kernel runs for it);
// returns its depth-histogram bin (mega_finish).
template <int K>
__device__ __forceinline__ int mega_pixel(const WaveArgs& a, int pix,
                                          int* stack, MegaTally& t) {
  Key key_p;
  PathRegs p;
  path_begin(a, a.pix_offset + pix, key_p, p);
  while (path_runs(a, p)) path_trip<K>(a, key_p, stack, t.c, p);
  return mega_finish(a, pix, p, t);
}

#ifndef PTT_HOST_EMULATION
template <int K, bool kGlobal>
__global__ void __launch_bounds__(PTT_MEGA_BLOCK)
megakernel_kernel(WaveArgs a) {
  extern __shared__ int s_hist[];  // max_depth + 1 bins
  __shared__ unsigned long long s_tot[6];
  for (int k = threadIdx.x; k <= a.max_depth; k += blockDim.x) s_hist[k] = 0;
  if (threadIdx.x < 6) s_tot[threadIdx.x] = 0ull;
  __syncthreads();
  MegaTally t{{0, 0, 0}, 0u, 0u, 0u};
  int local[kGlobal ? 1 : PTT_MEGA_STACK];
  int* stack = local;
  int pix = -1;        // the lane's block pixel, -1 between paths
  bool more = true;    // pixels may be left to take
  Key key_p;
  PathRegs p;
  for (;;) {
    const bool need = pix < 0 && more;
    const unsigned int m = __ballot_sync(PTT_FULL_WARP, need);
    if (m == 0u && !__any_sync(PTT_FULL_WARP, pix >= 0)) break;
    if (m != 0u) {
      const long long q = warp_fetch(a, m);
      if (need) {
        if (q < a.npix) {
          pix = (int)q;
          if constexpr (kGlobal) stack = a.stack + (size_t)pix * a.sd;
          path_begin(a, a.pix_offset + pix, key_p, p);
        } else {
          more = false;
        }
      }
    }
    if (pix >= 0) {
      if (path_runs(a, p)) path_trip<K>(a, key_p, stack, t.c, p);
      if (!path_runs(a, p)) {
        atomicAdd(&s_hist[mega_finish(a, pix, p, t)], 1);
        pix = -1;
      }
    }
  }
  const unsigned int w[5] = {
      __reduce_add_sync(PTT_FULL_WARP, t.done),
      __reduce_add_sync(PTT_FULL_WARP, t.rays),
      __reduce_add_sync(PTT_FULL_WARP, t.depth_sum),
      __reduce_add_sync(PTT_FULL_WARP, (unsigned int)t.c.walk_trips),
      __reduce_add_sync(PTT_FULL_WARP, (unsigned int)t.c.ovf)};
  const long long steps = warp_sum64(t.c.trav_steps);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (w[k]) atomicAdd(&s_tot[k], (unsigned long long)w[k]);
    }
    if (steps) atomicAdd(&s_tot[5], (unsigned long long)steps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= a.max_depth; k += blockDim.x) {
    if (s_hist[k]) atomicAdd(a.depth_hist + k, s_hist[k]);
  }
  if (threadIdx.x == 0) {
    unsigned long long* c = (unsigned long long*)a.ctr;
    const int to[6] = {C_DONE, C_RAYS, C_DEPTH_SUM, C_WALK_STEPS,
                       C_STACK_OVF, C_TRAV_STEPS};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (s_tot[k]) atomicAdd(c + to[k], s_tot[k]);
    }
    fetch_close(a);
  }
}

// As many blocks as fit on the card at once (asked once per instantiation
// and histogram size), at most one pixel per thread.
template <int K, bool kGlobal>
static int launch_mega(const WaveArgs* a, void* stream) {
  static int resident = 0, resident_smem = -1;
  const size_t smem = sizeof(int) * (size_t)(a->max_depth + 1);
  if ((int)smem != resident_smem) {
    resident = resident_blocks(megakernel_kernel<K, kGlobal>, PTT_MEGA_BLOCK,
                               smem);
    if (resident == 0) return (int)cudaErrorInvalidConfiguration;
    resident_smem = (int)smem;
  }
  const int need = (a->npix + PTT_MEGA_BLOCK - 1) / PTT_MEGA_BLOCK;
  const int grid = need < resident ? need : resident;
  if (grid == 0) return 0;
  megakernel_kernel<K, kGlobal>
      <<<grid, PTT_MEGA_BLOCK, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ptt_launch_megakernel(const WaveArgs* a, void* stream) {
  const bool global = a->sd > PTT_MEGA_STACK;
  if ((global && a->stack == nullptr) ||
      (a->branching != 4 && a->branching != 8))
    return (int)cudaErrorInvalidValue;
  if (a->branching == 4) {
    return global ? launch_mega<4, true>(a, stream)
                  : launch_mega<4, false>(a, stream);
  }
  return global ? launch_mega<8, true>(a, stream)
                : launch_mega<8, false>(a, stream);
}
#endif
