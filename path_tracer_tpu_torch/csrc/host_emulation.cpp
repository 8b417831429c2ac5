// CPU build of the kernels' per-slot code, for tests.
//
// The CUDA sources keep each kernel's per-slot work in a __device__
// function (walk_chunk, shade_lane, retire_lane, spawn_lane, mega_pixel,
// adj_begin / adj_trip / adj_*_sweep, closest_hit_lane, ring_hop_lane,
// tiled_lane, the wave loop's wave_reset_item; the walks' steps trav_step
// and trav_step16) and only the grid plumbing (and K5's and K6's work
// fetching, K8's live lists) in the __global__ wrapper.
// Compiled by a host C++ compiler with PTT_HOST_EMULATION defined, the same
// per-slot code runs here in a loop over slots, so the CPU test suite holds
// the kernel sources — not only their plain-torch twins — against the JAX
// package's engine.  Each walking function runs the instantiation its
// kernel's launcher picks: the node width from WaveArgs.branching (4 or 8),
// and the per-thread arrays in local memory or in the caller's per-lane
// buffers (WaveArgs stack, tape, walk) by the same size rule.  Each entry
// returns 0, or 1 where the launcher would refuse the arguments.
//   g++ -O1 -std=c++17 -ffp-contract=off -shared -fPIC -o emu.so host_emulation.cpp
#define PTT_HOST_EMULATION
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <vector>
#define __device__
#define __host__
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
#include "wave_loop.cu"

// Whether a walking kernel takes a's node width, and its stack placement.
static bool walk_args_ok(const WaveArgs* a, bool global) {
  return (a->branching == 4 || a->branching == 8) &&
         !(global && a->stack == nullptr);
}

// K1: the wave's chunks in order, each a loop over the slots and then the
// bookkeeping that the kernel's blocks do after its grid barrier, as one
// block.
template <int K>
static void emu_trace_step_k(WaveArgs* a) {
  if (!wave_runs(*a, true) || a->steps <= 0) return;
  ChunkSeen seen{};
  long long last[3] = {0, 0, 0};
  int q = 0;
  for (int i = 0;; i += a->chunk, ++q) {
    ChunkCount n{0, 0, 0, 0, 0};
    for (int lane = 0; lane < a->R; ++lane) {
      LaneState s;
      load_lane(*a, lane, s);
      walk_chunk<K>(*a, lane, s, n);
      store_lane(*a, lane, s);
    }
    chunk_commit(*a, q & 1, n);
    if (!chunk_go(*a, q, i, seen, last)) break;
  }
  wave_epilogue(*a, last[1], last[2], q + 1);
  chunk_close(*a, 1);
}

extern "C" int emu_trace_step(WaveArgs* a) {
  if (a->chunk <= 0 || !walk_args_ok(a, false)) return 1;
  if (a->branching == 4) emu_trace_step_k<4>(a); else emu_trace_step_k<8>(a);
  return 0;
}

extern "C" int emu_shade(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return 0;
  for (int i = 0; i < a->R; ++i) shade_lane(*a, i);
  return 0;
}

// K4: the slots in blocks of the kernel's size, each block's counts summed
// and committed as the kernel's block does it.
extern "C" int emu_retire(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return 0;
  std::vector<int> hist(a->max_depth + 1);
  for (int b0 = 0; b0 < a->R; b0 += PTT_RETIRE_BLOCK) {
    RetireTotals t{0, 0, 0, 0};
    std::fill(hist.begin(), hist.end(), 0);
    for (int i = b0; i < a->R && i < b0 + PTT_RETIRE_BLOCK; ++i) {
      const RetireCount n = retire_lane(*a, i);
      t.done += n.done;
      t.rays += n.rays;
      t.depth_sum += (int)n.depth_sum;
      t.freed += n.freed;
      if (n.bin >= 0) ++hist[n.bin];
    }
    retire_commit_hist(*a, hist.data(), 0, 1);
    retire_commit_totals(*a, t);
  }
  return 0;
}

extern "C" int emu_spawn(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return 0;
  for (int i = 0; i < a->R; ++i) spawn_lane(*a, i);
  return 0;
}

// The wave loop graph's reset: every item, then the stack.
extern "C" int emu_wave_reset(WaveArgs* a) {
  for (long long i = 0; i < wave_reset_items(*a); ++i) wave_reset_item(*a, i);
  wave_reset_stack(*a, 0, 1);
  return 0;
}

// The stack of lane i: a local array, or row i of the per-lane buffer.
#define PTT_EMU_STACK(i)                                          \
  int local_stack[PTT_MEGA_STACK];                                \
  int* stack = a->sd > PTT_MEGA_STACK ? a->stack + (size_t)(i) * a->sd \
                                      : local_stack

template <int K>
static void emu_megakernel_k(WaveArgs* a) {
  for (int pix = 0; pix < a->npix; ++pix) {
    PTT_EMU_STACK(pix);
    MegaTally t{{0, 0, 0}, 0u, 0u, 0u};
    a->depth_hist[mega_pixel<K>(*a, pix, stack, t)] += 1;
    a->ctr[C_DONE] += t.done;
    a->ctr[C_RAYS] += t.rays;
    a->ctr[C_DEPTH_SUM] += t.depth_sum;
    a->ctr[C_TRAV_STEPS] += t.c.trav_steps;
    a->ctr[C_WALK_STEPS] += t.c.walk_trips;
    a->ctr[C_STACK_OVF] += t.c.ovf;
  }
}

extern "C" int emu_megakernel(WaveArgs* a) {
  if (!walk_args_ok(a, a->sd > PTT_MEGA_STACK)) return 1;
  if (a->branching == 4) emu_megakernel_k<4>(a); else emu_megakernel_k<8>(a);
  return 0;
}

// K6's lane code over a launch's pixels: a simulated warp of kEmuLanes
// lanes, each with its own local arrays, in turns.  At each turn the lanes
// that need work take the next pixels from a shared counter in lane order
// (as warp_fetch hands them out), then every lane with a pixel runs one
// unit of it: a replay trip, or the sweep (the colour sweep whole, one
// entry of the full one).  So pixels start and end out of order, their
// gradients add in another order than the kernel's, and a lane's arrays
// carry over from one pixel to the next (the kernel's lane runs each pixel
// to its end, adj_pixel, from the same units).
constexpr int kEmuLanes = 32;

template <int K, bool kGlobal, bool kFull>
static void emu_adjoint_k(WaveArgs* a) {
  using E = typename AdjEntry<kFull>::T;
  const GradSink sink = global_sink(*a);
  std::vector<AdjLane> l(kEmuLanes);   // pix -1: no pixel
  std::vector<int> stacks(kGlobal ? 1 : (size_t)kEmuLanes * PTT_MEGA_STACK);
  std::vector<E> tapes(kGlobal ? 1 : (size_t)kEmuLanes * PTT_TAPE_MAX);
  for (AdjLane& x : l) x.pix = -1;
  int next = 0;
  for (bool busy = true; busy;) {
    busy = false;
    for (int i = 0; i < kEmuLanes; ++i) {
      if (l[i].pix < 0 && next < a->npix) adj_begin(*a, next++, l[i]);
    }
    for (int i = 0; i < kEmuLanes; ++i) {
      AdjLane& x = l[i];
      if (x.pix < 0) continue;
      busy = true;
      const AdjArrays<kGlobal, kFull> r(
          *a, x.pix, kGlobal ? nullptr : &stacks[(size_t)i * PTT_MEGA_STACK],
          kGlobal ? nullptr : &tapes[(size_t)i * PTT_TAPE_MAX]);
      if (!x.sweep) {
        adj_trip<K, kFull>(*a, x, r.stack, r.tape);
      } else if (x.n > 0) {
        if constexpr (kFull) {
          adj_full_sweep<kGlobal>(*a, x, r.tape, r.wrec, sink);
        } else {
          adj_colour_sweep(*a, x, r.tape, sink);
        }
      }
      if (x.sweep && x.n == 0) x.pix = -1;
    }
  }
}

template <bool kFull>
static int emu_adjoint_any(WaveArgs* a) {
  const bool global = adjoint_global(*a, kFull);
  if ((global &&
       (a->tape == nullptr || (kFull && a->sss_steps > 0 && a->walk == nullptr))) ||
      !walk_args_ok(a, global))
    return 1;
  if (a->branching == 4) {
    if (global) emu_adjoint_k<4, true, kFull>(a);
    else emu_adjoint_k<4, false, kFull>(a);
  } else {
    if (global) emu_adjoint_k<8, true, kFull>(a);
    else emu_adjoint_k<8, false, kFull>(a);
  }
  return 0;
}

extern "C" int emu_adjoint(WaveArgs* a) { return emu_adjoint_any<false>(a); }

extern "C" int emu_adjoint_full(WaveArgs* a) {
  return emu_adjoint_any<true>(a);
}

// K7 and K9: one query per lane; steps and dropped pushes into the counters.
template <int K, bool kHop>
static void emu_query_k(WaveArgs* a) {
  for (int i = 0; i < a->R; ++i) {
    PTT_EMU_STACK(i);
    MegaCount c{0, 0, 0};
    if (kHop) {
      ring_hop_lane<K>(*a, i, stack, c);
    } else {
      closest_hit_lane<K>(*a, i, stack, c);
    }
    a->ctr[C_TRAV_STEPS] += c.trav_steps;
    a->ctr[C_STACK_OVF] += c.ovf;
  }
}

template <bool kHop>
static int emu_query(WaveArgs* a) {
  if (!walk_args_ok(a, a->sd > PTT_MEGA_STACK)) return 1;
  if (a->branching == 4) emu_query_k<4, kHop>(a);
  else emu_query_k<8, kHop>(a);
  return 0;
}

extern "C" int emu_closest_hit(WaveArgs* a) { return emu_query<false>(a); }

extern "C" int emu_ring_hop(WaveArgs* a) { return emu_query<true>(a); }

// One traversal step of every walking slot of a wave state (cur not done;
// t_min by the slot's phase, as K1 loads it), by trav_step (step 0) or
// trav_step16 (step 1, rolled; 2, unrolled); steps and dropped pushes into
// the counters.  Each slot's stack is row i of a.stack, a.sd entries.
template <int K>
static void emu_walk_step_k(WaveArgs* a, int step) {
  for (int i = 0; i < a->R; ++i) {
    LaneState s;
    load_lane(*a, i, s);
    if (!s.walked) continue;
    int* stack = a->stack + (size_t)i * a->sd;
    int ovf = 0;
    if (step == 0) {
      trav_step<K>(*a, s.r, s.cur, stack, s.sp, s.best_t, s.best_pt,
                   s.best_pi, ovf);
    } else if (step == 1) {
      trav_step16<K, true>(*a, s.r, s.cur, stack, s.sp, s.best_t, s.best_pt,
                           s.best_pi, ovf);
    } else {
      trav_step16<K, false>(*a, s.r, s.cur, stack, s.sp, s.best_t,
                            s.best_pt, s.best_pi, ovf);
    }
    store_lane(*a, i, s);
    a->ctr[C_TRAV_STEPS] += 1;
    a->ctr[C_STACK_OVF] += ovf;
  }
}

extern "C" int emu_walk_step(WaveArgs* a, int step) {
  if (!walk_args_ok(a, false) || step < 0 || step > 2) return 1;
  if (a->branching == 4) emu_walk_step_k<4>(a, step);
  else emu_walk_step_k<8>(a, step);
  return 0;
}

// K8: the trip's lanes (every lane, or the live list's) in list order; with
// live lists the lanes that stay alive are appended to the other list in
// the order they ran, and the count read is cleared, as the launch's last
// block does.
extern "C" int emu_tiled_trip(WaveArgs* a) {
  if (a->live != nullptr && a->live_parity != 0 && a->live_parity != 1)
    return 1;
  const TripLanes lanes = trip_lanes(*a);
  for (int pos = 0; pos < lanes.n; ++pos) {
    const int i = trip_lane_at(lanes, pos);
    bool alive = false;
    a->ctr[C_WALK_STEPS] += tiled_lane<false>(*a, i, &alive);
    if (a->live != nullptr && alive) {
      const int out = 1 - a->live_parity;
      a->live[(size_t)out * a->R + a->live_n[out]++] = i;
    }
  }
  if (a->live != nullptr) a->live_n[a->live_parity] = 0;
  return 0;
}

// The spawn block by block, each block's SpawnFrame staged once, and warp
// by warp, a whole warp's rows staged and written in 16-byte pieces as the
// kernel writes them (the last block and warp partial ones).
extern "C" int emu_tiled_spawn(WaveArgs* a) {
  for (int b = 0; b < a->R; b += PTT_SPAWN_THREADS) {
    const SpawnFrame s = spawn_frame(*a);
    for (int i0 = b; i0 < std::min(b + PTT_SPAWN_THREADS, a->R); i0 += 32) {
      const bool rows16 = i0 + 32 <= a->R && spawn_rows16(*a);
      alignas(16) float o96[96], d96[96];
      for (int i = i0; i < std::min(i0 + 32, a->R); ++i) {
        float o[3], d[3], time;
        spawn_ray(s, a->pixel[i], o, d, time);
        if (!rows16) {
          spawn_store(*a, i, o, d, time);
          continue;
        }
        for (int k = 0; k < 3; ++k) {
          o96[3 * (i - i0) + k] = o[k];
          d96[3 * (i - i0) + k] = d[k];
        }
        spawn_fresh(*a, i, time);
      }
      if (rows16)
        for (int q = 0; q < 24; ++q) spawn_rows_piece(*a, i0, q, o96, d96);
    }
  }
  if (a->live != nullptr) {
    a->live_n[0] = a->R;
    a->live_n[1] = a->live_n[2] = 0;
  }
  return 0;
}

extern "C" int emu_tiled_trip_rec(WaveArgs* a) {
  for (int i = 0; i < a->R; ++i) a->ctr[C_WALK_STEPS] += tiled_lane<true>(*a, i);
  return 0;
}
