// One (sample, pixel) path traced to its end, shared by K5 (megakernel.cu)
// and K6 (adjoint.cu): integrator.py trace_ray (:253) for the camera ray of
// render_sample (:288).  The thread folds its key base -> sample -> pixel,
// draws its camera ray from fold_in(key_p, 7) (path_begin), and loops while
// alive and iters < iters_cap over trips (path_trip): closest-hit walk, the
// volume-exit walk from t_hit + 1e-4 when the hit has a medium (JAX walks it
// on every lane but reads it only there), then the bounce with keys
// fold_in(key_p, iters).  K5 runs the trips itself (path_begin,
// path_trip) so that a lane whose path ends can take the next pixel
// (megakernel.cu); K6 runs trace_path.
// K6 passes a recorder: the colour instantiation's is told the bounce's
// colour events (bounce.cuh), the full instantiation's (Rec::kTrips) the
// inputs of each trip's bounce (adjoint.cu); K5 passes none.
//
// The walks take the traversal step as a template argument: K5 runs
// trav_step16 (16-byte row loads, the child loop rolled in pairs), K7 the
// same step unrolled, K6 and K9 the 4-byte step trav_step.
#pragma once

#include "bounce.cuh"
#include "traverse.cuh"

struct MegaCount {
  long long trav_steps;
  int walk_trips, ovf;
};

// The traversal step of a walk (traverse.cuh).
enum WalkStep { kStep4, kStep16, kStep16Unrolled };

// Closest hit from (o, d, time) at t_min, walked to completion through a
// K-wide BVH by step S.
template <int K, WalkStep S = kStep4>
__device__ __forceinline__ void trav_full(const WaveArgs& a, const float* o,
                                          const float* d, float time,
                                          float t_min, int* stack,
                                          float& best_t, int& best_pt,
                                          int& best_pi, MegaCount& c) {
  int cur;
  trav_start(a, o[0], o[1], o[2], d[0], d[1], d[2], time, t_min, cur, best_t,
             best_pt, best_pi);
  const TravRay r = trav_ray(o[0], o[1], o[2], d[0], d[1], d[2], time, t_min);
  int sp = 0;
  while (cur != PTT_DONE) {
    ++c.trav_steps;
    if constexpr (S == kStep16) {
      trav_step16<K>(a, r, cur, stack, sp, best_t, best_pt, best_pi, c.ovf);
    } else if constexpr (S == kStep16Unrolled) {
      trav_step16<K, false>(a, r, cur, stack, sp, best_t, best_pt, best_pi,
                            c.ovf);
    } else {
      trav_step<K>(a, r, cur, stack, sp, best_t, best_pt, best_pi, c.ovf);
    }
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

// One trip of the path with key key_p on the 16-byte step (K5): the
// walks and the bounce.
template <int K>
__device__ __forceinline__ void path_trip(const WaveArgs& a, Key key_p,
                                          int* stack, MegaCount& c,
                                          PathRegs& p) {
  float best_t;
  int best_pt, best_pi;
  trav_full<K, kStep16>(a, p.o, p.d, p.time, a.t_min, stack, best_t,
                        best_pt, best_pi, c);
  const bool found = best_pt >= 0;
  bool exit_found = false, exit_is_medium = false;
  float t_exit = 0.0f;
  if (a.has_medium && found && medium_of(a, best_pt, best_pi) >= 0) {
    int e_pt, e_pi;
    trav_full<K, kStep16>(a, p.o, p.d, p.time, best_t + 1e-4f, stack, t_exit,
                          e_pt, e_pi, c);
    exit_found = e_pt >= 0;
    exit_is_medium = medium_of(a, e_pt, e_pi) >= 0;
  }
  c.walk_trips += bounce(a, p, found, best_pt, best_pi, exit_found, t_exit,
                         exit_is_medium, fold_in(key_p, (uint32_t)p.iters));
}

// Sample a.start_sample of pixel pix, traced into p, on the 4-byte step
// (K6).  path_begin and path_trip written out: called through them, K6's
// colour instantiation compiles to one register more.
template <int K, class Rec = NoTape>
__device__ __forceinline__ void trace_path(const WaveArgs& a, int pix,
                                           int* stack, MegaCount& c,
                                           PathRegs& p, Rec* tape = nullptr) {
  const Key key_p = path_key(a, a.start_sample, pix);
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
  while (p.alive && p.iters < a.iters_cap) {
    float best_t;
    int best_pt, best_pi;
    trav_full<K>(a, p.o, p.d, p.time, a.t_min, stack, best_t, best_pt,
                 best_pi, c);
    const bool found = best_pt >= 0;
    bool exit_found = false, exit_is_medium = false;
    float t_exit = 0.0f;
    if (a.has_medium && found && medium_of(a, best_pt, best_pi) >= 0) {
      int e_pt, e_pi;
      trav_full<K>(a, p.o, p.d, p.time, best_t + 1e-4f, stack, t_exit, e_pt,
                   e_pi, c);
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
}
