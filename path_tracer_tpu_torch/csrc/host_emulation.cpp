// CPU build of the kernels' per-slot code, for tests.
//
// The CUDA sources keep each kernel's per-slot work in a __device__
// function (trace_lane, shade_lane, retire_lane, spawn_lane, mega_pixel,
// adjoint_pixel, adjoint_pixel_full) and only the grid plumbing in the
// __global__ wrapper.  Compiled by a host C++ compiler with
// PTT_HOST_EMULATION defined, the same per-slot code runs here in a
// loop over slots, so the CPU test suite holds the kernel sources — not only
// their plain-torch twins — against the JAX package's engine.
//   g++ -O1 -std=c++17 -ffp-contract=off -shared -fPIC -o emu.so host_emulation.cpp
#define PTT_HOST_EMULATION
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __global__
template <class T>
static T atomicAdd(T* p, T v) {
  T old = *p;
  *p = old + v;
  return old;
}
#include "trace_step.cu"
#include "shade.cu"
#include "retire.cu"
#include "spawn.cu"
#include "megakernel.cu"
#include "adjoint.cu"
#include "closest_hit.cu"
#include "tiled_trip.cu"

// K1: the wave's chunks in order, each a loop over the slots and then the
// epilogue that block 0 runs between the kernel's two grid barriers.
extern "C" void emu_trace_step(WaveArgs* a) {
  if (!wave_runs(*a, true)) return;
  for (int i = 0; i < a->steps; i += a->chunk) {
    ChunkCount n{0, 0, 0, 0, 0};
    for (int lane = 0; lane < a->R; ++lane) trace_lane(*a, lane, n);
    a->ctr[C_N_ACT] += n.act;
    a->ctr[C_N_ACT_END] += n.act_end;
    a->ctr[C_N_READY] += n.ready;
    a->ctr[C_N_WALK] += n.walk;
    a->ctr[C_STACK_OVF] += n.ovf;
    chunk_epilogue(*a, i);
    if (a->ctr[C_GO] == 0) break;
  }
}

extern "C" void emu_shade(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return;
  for (int i = 0; i < a->R; ++i) shade_lane(*a, i);
}

extern "C" void emu_retire(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return;
  for (int i = 0; i < a->R; ++i) retire_lane(*a, i);
}

extern "C" void emu_spawn(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return;
  for (int i = 0; i < a->R; ++i) spawn_lane(*a, i);
}

extern "C" void emu_megakernel(WaveArgs* a) {
  for (int pix = 0; pix < a->npix; ++pix) {
    int stack[PTT_MEGA_STACK];
    MegaCount c{0, 0, 0};
    mega_pixel(*a, pix, stack, c);
    const int dc = clampi(a->depth[pix], 0, a->max_depth);
    a->depth_hist[dc] += 1;
    a->ctr[C_DONE] += 1;
    a->ctr[C_RAYS] += a->iters[pix];
    a->ctr[C_DEPTH_SUM] += dc;
    a->ctr[C_TRAV_STEPS] += c.trav_steps;
    a->ctr[C_WALK_STEPS] += c.walk_trips;
    a->ctr[C_STACK_OVF] += c.ovf;
  }
}

extern "C" void emu_adjoint(WaveArgs* a) {
  const GradSink sink = global_sink(*a);
  for (int pix = 0; pix < a->npix; ++pix) {
    int stack[PTT_MEGA_STACK];
    TapeEntry tape[PTT_TAPE_MAX];
    adjoint_pixel(*a, pix, stack, tape, sink);
  }
}

extern "C" void emu_adjoint_full(WaveArgs* a) {
  const GradSink sink = global_sink(*a);
  for (int pix = 0; pix < a->npix; ++pix) {
    int stack[PTT_MEGA_STACK];
    TripIn trips[PTT_TAPE_MAX];
    adjoint_pixel_full(*a, pix, stack, trips, sink);
  }
}

// K7 and K9: one query per lane; steps and dropped pushes into the counters.
template <bool kHop>
static void emu_query(WaveArgs* a) {
  for (int i = 0; i < a->R; ++i) {
    int stack[PTT_MEGA_STACK];
    MegaCount c{0, 0, 0};
    if (kHop) {
      ring_hop_lane(*a, i, stack, c);
    } else {
      closest_hit_lane(*a, i, stack, c);
    }
    a->ctr[C_TRAV_STEPS] += c.trav_steps;
    a->ctr[C_STACK_OVF] += c.ovf;
  }
}

extern "C" void emu_closest_hit(WaveArgs* a) { emu_query<false>(a); }

extern "C" void emu_ring_hop(WaveArgs* a) { emu_query<true>(a); }

extern "C" void emu_tiled_trip(WaveArgs* a) {
  for (int i = 0; i < a->R; ++i) a->ctr[C_WALK_STEPS] += tiled_lane<false>(*a, i);
}

extern "C" void emu_tiled_spawn(WaveArgs* a) {
  for (int i = 0; i < a->R; ++i) tiled_spawn_lane(*a, i);
}

extern "C" void emu_tiled_trip_rec(WaveArgs* a) {
  for (int i = 0; i < a->R; ++i) a->ctr[C_WALK_STEPS] += tiled_lane<true>(*a, i);
}
