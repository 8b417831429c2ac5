// One (sample, pixel) path traced to its end, shared by K5 (megakernel.cu)
// and K6 (adjoint.cu): integrator.py trace_ray (:253) for the camera ray of
// render_sample (:288).  The thread folds its key base -> sample -> pixel,
// draws its camera ray from fold_in(key_p, 7), and loops while alive and
// iters < iters_cap: closest-hit walk, the volume-exit walk from
// t_hit + 1e-4 when the hit has a medium (JAX walks it on every lane but
// reads it only there), then the bounce with keys fold_in(key_p, iters).
// K6 passes a recorder to the bounce (bounce.cuh); K5 passes none.
#pragma once

#include "bounce.cuh"
#include "traverse.cuh"

#define PTT_MEGA_STACK 64

struct MegaCount {
  long long trav_steps;
  int walk_trips, ovf;
};

// Closest hit from (o, d, time) at t_min, walked to completion.
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
    trav_step(a, r, cur, stack, sp, best_t, best_pt, best_pi, c.ovf);
  }
}

// Sample a.start_sample of pixel pix, traced into p.
template <class Rec = NoTape>
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
    trav_full(a, p.o, p.d, p.time, a.t_min, stack, best_t, best_pt, best_pi,
              c);
    const bool found = best_pt >= 0;
    bool exit_found = false, exit_is_medium = false;
    float t_exit = 0.0f;
    if (a.has_medium && found && medium_of(a, best_pt, best_pi) >= 0) {
      int e_pt, e_pi;
      trav_full(a, p.o, p.d, p.time, best_t + 1e-4f, stack, t_exit, e_pt,
                e_pi, c);
      exit_found = e_pt >= 0;
      exit_is_medium = medium_of(a, e_pt, e_pi) >= 0;
    }
    c.walk_trips += bounce(a, p, found, best_pt, best_pi, exit_found, t_exit,
                           exit_is_medium, fold_in(key_p, (uint32_t)p.iters),
                           tape);
  }
}
