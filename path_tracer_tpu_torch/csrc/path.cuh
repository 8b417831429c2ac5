// One (sample, pixel) path, trip by trip, shared by K5 (megakernel.cu)
// and K6 (adjoint.cu): integrator.py trace_ray (:253) for the camera ray of
// render_sample (:288).  The thread folds its key base -> sample -> pixel,
// draws its camera ray from fold_in(key_p, 7) (path_begin), and loops while
// alive and iters < iters_cap (path_runs) over trips (path_trip):
// closest-hit walk, the volume-exit walk from t_hit + 1e-4 when the hit has
// a medium (JAX walks it on every lane but reads it only there), then the
// bounce with keys fold_in(key_p, iters).  Both kernels run the trips
// themselves so that a lane whose work ends can take the next pixel.
// K6 passes a recorder: the colour instantiation's is told the bounce's
// colour events (bounce.cuh), the full instantiation's (Rec::kTrips) the
// inputs of each trip's bounce (adjoint.cu); K5 passes none, and the hooks
// compile to nothing there.
//
// The walks take the traversal step as a template argument: K5 and K6 run
// trav_step16 (16-byte row loads, the child loop rolled in pairs), K7 and
// K9 the same step unrolled (closest_hit.cu).  No kernel walks the 4-byte
// step trav_step: tests/test_torch_walk_step.py holds trav_step16 against
// it step for step.
#pragma once

#include "bounce.cuh"
#include "traverse.cuh"

struct MegaCount {
  long long trav_steps;
  int walk_trips, ovf;
};

// The traversal step of a walk (traverse.cuh trav_step16): the pair loop
// rolled or unrolled.
enum WalkStep { kStep16, kStep16Unrolled };

// Closest hit from (o, d, time) over (t_min, t_max), walked to completion
// through a K-wide BVH by step S.
template <int K, WalkStep S>
__device__ __forceinline__ void trav_full(const WaveArgs& a, const float* o,
                                          const float* d, float time,
                                          float t_min, float t_max,
                                          int* stack, float& best_t,
                                          int& best_pt, int& best_pi,
                                          MegaCount& c) {
  int cur;
  trav_start(a, o[0], o[1], o[2], d[0], d[1], d[2], time, t_min, t_max, cur,
             best_t, best_pt, best_pi);
  const TravRay r = trav_ray(o[0], o[1], o[2], d[0], d[1], d[2], time, t_min);
  int sp = 0;
  while (cur != PTT_DONE) {
    ++c.trav_steps;
    trav_step16<K, S == kStep16>(a, r, cur, stack, sp, best_t, best_pt,
                                 best_pi, c.ovf);
  }
}

// Sample a.start_sample of frame pixel pix: its key and camera ray into p,
// colour 0, throughput 1, alive.
__device__ __forceinline__ void path_begin(const WaveArgs& a, int pix,
                                           Key& key_p, PathRegs& p) {
  key_p = path_key(a, a.start_sample, pix);
  float u5[5];
  primary_ray(a, key_p, pix, p.o, p.d, p.time, u5);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.col[k] = 0.0f;
    p.thr[k] = 1.0f;
  }
  p.depth = 0;
  p.iters = 0;
  p.alive = true;
}

// Whether the path takes another trip.
__device__ __forceinline__ bool path_runs(const WaveArgs& a,
                                          const PathRegs& p) {
  return p.alive && p.iters < a.iters_cap;
}

// One trip of the path with key key_p, its walks on step S: the walks and
// the bounce; a recorder with kTrips is handed the bounce's inputs, one with
// kOn its colour events.
template <int K, WalkStep S = kStep16, class Rec = NoTape>
__device__ __forceinline__ void path_trip(const WaveArgs& a, Key key_p,
                                          int* stack, MegaCount& c,
                                          PathRegs& p, Rec* tape = nullptr) {
  float best_t;
  int best_pt, best_pi;
  trav_full<K, S>(a, p.o, p.d, p.time, a.t_min, a.t_max, stack, best_t,
                  best_pt, best_pi, c);
  const bool found = best_pt >= 0;
  bool exit_found = false, exit_is_medium = false;
  float t_exit = 0.0f;
  if (a.has_medium && found && medium_of(a, best_pt, best_pi) >= 0) {
    int e_pt, e_pi;
    trav_full<K, S>(a, p.o, p.d, p.time, best_t + 1e-4f, a.t_max, stack,
                    t_exit, e_pt, e_pi, c);
    exit_found = e_pt >= 0;
    exit_is_medium = medium_of(a, e_pt, e_pi) >= 0;
  }
  if constexpr (Rec::kTrips) {
    tape->trip(p, found, best_pt, best_pi, exit_found, t_exit,
               exit_is_medium);
  }
  c.walk_trips += bounce(a, p, found, best_pt, best_pi, exit_found, t_exit,
                         exit_is_medium, fold_in(key_p, (uint32_t)p.iters),
                         tape);
}
