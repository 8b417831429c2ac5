// The transpose of the SSS-volumetric walk (sss.cuh, B6) for a walk that
// exited (status 1; otherwise the bounce does not scatter and nothing
// reaches the walk).  Replaces what jax.grad takes through run_walk
// (path_tracer_tpu/ops/shade_tiled.py:515-578).
//
// The walk re-runs forward with the forward's code and draws, keeping each
// trip's heading and step length (4 floats per trip; the start points are
// not needed: d p2_i / d pos_i is the identity) in a local record of
// PTT_WALK_MAX trips, or with kGlobal in the caller's per-pixel buffer of
// sss_steps trips (`wrec`, 4 floats each), then reverses:
// trip i moves pos_{i+1} = pos_i + wd_i t_i with t_i = -log u / sigma_t,
// and a kept trip turns wd_{i+1} =
// direction_from_cos(u2, sample_hg(u5, g), wd_i).  The exit and absorb
// coins are constants, as the exit direction n + (unit vector) is but for
// n.  Adjoints: of the exit point op and direction od in; of the hit point
// h, the normal n, the incoming direction ui, sigma_t and g out.
#pragma once

#include "adjoint_ops.cuh"
#include "sss.cuh"

struct WalkAdj {
  float h[3], n[3], ui[3];
  float sigma_t, g;
};

template <bool kGlobal>
__device__ __noinline__ void sss_walk_adj(Key wk, int steps, const float* h,
                                          const float* n, const float* ui,
                                          float sigma_t, float sigma_a,
                                          float g, const float* opb,
                                          const float* odb, WalkAdj& out,
                                          float* wrec) {
  float wd_l[kGlobal ? 1 : PTT_WALK_MAX][3], t_l[kGlobal ? 1 : PTT_WALK_MAX];
  auto wd_t = [&](int i) -> float* {
    if constexpr (kGlobal) return wrec + 4 * i; else return wd_l[i];
  };
  auto t_t = [&](int i) -> float& {
    if constexpr (kGlobal) return wrec[4 * i + 3]; else return t_l[i];
  };
  float pos[3], wd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = h[k] - n[k] * 1e-3f;
    wd[k] = ui[k];
  }
  int trips = 0;
  bool exited = false;
  for (int i = 0; i < steps && (kGlobal || i < PTT_WALK_MAX); ++i) {
    const uint32_t b = 6u * (uint32_t)i;
    const float t = -logf(fmaxp(uniform_at(wk, b), 1e-10f)) / sigma_t;
    float p2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wd_t(i)[k] = wd[k];
      p2[k] = pos[k] + wd[k] * t;
    }
    t_t(i) = t;
    ++trips;
    const float ex = p2[0] - h[0], ey = p2[1] - h[1], ez = p2[2] - h[2];
    const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
    const float exit_prob = 1.0f - expf(-dist * 0.5f);
    const float u2 = uniform_at(wk, b + 2u);
    if (uniform_at(wk, b + 1u) < exit_prob) {
      exited = true;
      break;
    } else if (uniform_at(wk, b + 4u) < sigma_a / sigma_t) {
      break;
    }
    float nd[3];
    direction_from_cos(u2, sample_hg(uniform_at(wk, b + 5u), g), wd, nd);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wd[k] = nd[k];
      pos[k] = p2[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.h[k] = 0.0f;
    out.n[k] = odb[k];                 // od = n (+ a constant unit vector)
    out.ui[k] = 0.0f;
  }
  out.sigma_t = 0.0f;
  out.g = 0.0f;
  if (!exited) return;
  float p2b[3] = {opb[0], opb[1], opb[2]};   // op = p2 of the exit trip
  float wdb[3] = {0.0f, 0.0f, 0.0f};         // adjoint of wd_{i+1}
  for (int i = trips - 1; i >= 0; --i) {
    const uint32_t b = 6u * (uint32_t)i;
    float wdb_i[3];
    if (i < trips - 1) {
      // wd_{i+1} = direction_from_cos(u2, cos_hg(g), wd_i)
      const float u5 = uniform_at(wk, b + 5u);
      float ab[3] = {0.0f, 0.0f, 0.0f};
      const float cb = direction_from_cos_adj(uniform_at(wk, b + 2u),
                                              sample_hg(u5, g), wd_t(i), wdb,
                                              ab);
      out.g += cb * sample_hg_dg(u5, g);
#pragma unroll
      for (int k = 0; k < 3; ++k) wdb_i[k] = ab[k];
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) wdb_i[k] = 0.0f;
    }
    // p2_i = pos_i + wd_i t_i
    const float tb = dot3(p2b, wd_t(i));
#pragma unroll
    for (int k = 0; k < 3; ++k) wdb_i[k] += p2b[k] * t_t(i);
    out.sigma_t += tb * (-t_t(i) / sigma_t);
#pragma unroll
    for (int k = 0; k < 3; ++k) wdb[k] = wdb_i[k];
    // pos_i = p2_{i-1} (i > 0), or h - 1e-3 n: p2b carries over
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.h[k] += p2b[k];
    out.n[k] += -1e-3f * p2b[k];
    out.ui[k] += wdb[k];
  }
}
