// Work fetched by the lanes of a persistent grid (K5 megakernel.cu, K6
// adjoint.cu): as many blocks as fit on the card at once, each lane taking
// the next item (a pixel) from ctr[C_FETCH] when its work ends, one atomic
// per warp for the lanes that need work; the launch's last block clears the
// counter, so every launch (and every replay of a graph that holds it)
// starts from 0.
#pragma once

#include "common.cuh"

#ifndef PTT_HOST_EMULATION

// The warp's lanes in m (every lane of the warp calls this, m the same in
// all) take consecutive pixels from ctr[C_FETCH] with one atomic; returns
// this lane's pixel (meaningful where its bit is in m).
__device__ __forceinline__ long long warp_fetch(const WaveArgs& a,
                                                unsigned int m) {
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned long long base = 0ull;
  if (lane == leader)
    base = atomicAdd((unsigned long long*)a.ctr + C_FETCH,
                     (unsigned long long)__popc(m));
  base = __shfl_sync(PTT_FULL_WARP, base, leader);
  return (long long)base + __popc(m & ((1u << lane) - 1u));
}

// Sum of v over the warp.
__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(PTT_FULL_WARP, v, o);
  return v;
}

// A block's end, by one thread after the block's last fetch: the last
// block of the launch clears the fetch counter and the ticket, so that
// every launch (and every replay of a graph that holds it) starts from 0.
__device__ __forceinline__ void fetch_close(const WaveArgs& a) {
  __threadfence();
  unsigned long long* c = (unsigned long long*)a.ctr;
  if (atomicAdd(c + C_TICKET, 1ull) + 1 != (unsigned long long)gridDim.x)
    return;
  volatile long long* v = a.ctr;
  v[C_FETCH] = 0;
  v[C_TICKET] = 0;
}

// Blocks of `kernel` (block threads, smem dynamic shared bytes) that fit on
// the card at once, or 0 on an error.
template <class F>
static int resident_blocks(F kernel, int block, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

#endif
