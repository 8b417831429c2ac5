// B6: the SSS-volumetric Henyey–Greenstein random walk of one lane, called
// by K3 (shade) and K5 (megakernel) through bounce.cuh.
//
// Replaces path_tracer_tpu/ops/shade_tiled.py scatter_t -> run_walk
// (:515-578) and the per-lane walk of ops/shade.py scatter (:530-572).
// Trip i reads uniforms i*6 .. i*6+5 of uniform(walk_key, (steps, 6)),
// drawn on demand with uniform_at instead of materialised.  The walk starts
// 1e-3 inside the hit along the shading normal, heading along the incoming
// direction; each trip flies an exponential distance, then exits with
// probability 1 - exp(-dist/2) (out along the normal plus a unit vector),
// is absorbed with probability sigma_a/sigma_t, or scatters by
// Henyey–Greenstein and multiplies the throughput by the albedo.  The loop
// ends at the first exit or absorption: the JAX walk's remaining trips
// change nothing, and `trips` counts only walking trips, as its step
// counter does.
//
// The walk is a call, not inlined: inlined, its loop raised K3's register
// count (92 -> 96) and its device time on the vol2_final frame, which has
// no SSS lane, by about a fifth; as a call K3 keeps its earlier time
// (PERF.md, Findings).
#pragma once

#include "sampling.cuh"
#include "threefry.cuh"

struct WalkOut {
  float th[3];   // throughput (excluding the final albedo factor)
  float op[3];   // exit point
  float od[3];   // exit direction
  int status;    // 0 still walking after `steps` trips, 1 exited, 2 absorbed
  int trips;     // walking trips
};

__device__ __noinline__ WalkOut sss_walk(Key wk, int steps, const float* h,
                                            const float* n, const float* ui,
                                            const float* alb, float sigma_t,
                                            float sigma_a, float g) {
  WalkOut w;
  float pos[3], wd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = h[k] - n[k] * 1e-3f;
    wd[k] = ui[k];
    w.th[k] = 1.0f;
    w.op[k] = h[k];
    w.od[k] = n[k];
  }
  w.status = 0;
  w.trips = 0;
  for (int i = 0; i < steps && w.status == 0; ++i) {
    const uint32_t b = 6u * (uint32_t)i;
    const float t = -logf(fmaxp(uniform_at(wk, b), 1e-10f)) / sigma_t;
    float p2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p2[k] = pos[k] + wd[k] * t;
    const float ex = p2[0] - h[0], ey = p2[1] - h[1], ez = p2[2] - h[2];
    const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
    const float exit_prob = 1.0f - expf(-dist * 0.5f);
    ++w.trips;
    const float u2 = uniform_at(wk, b + 2u);
    if (uniform_at(wk, b + 1u) < exit_prob) {
      float ev[3], ed[3];
      unit_vector(u2, uniform_at(wk, b + 3u), ev[0], ev[1], ev[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) ed[k] = n[k] + ev[k];
      const bool deg = near_zero(ed[0], ed[1], ed[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w.op[k] = p2[k];
        w.od[k] = deg ? n[k] : ed[k];
      }
      w.status = 1;
    } else if (uniform_at(wk, b + 4u) < sigma_a / sigma_t) {
      w.status = 2;
    } else {
      float nd[3];
      direction_from_cos(u2, sample_hg(uniform_at(wk, b + 5u), g), wd, nd);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        wd[k] = nd[k];
        pos[k] = p2[k];
        w.th[k] = w.th[k] * alb[k];
      }
    }
  }
  return w;
}
