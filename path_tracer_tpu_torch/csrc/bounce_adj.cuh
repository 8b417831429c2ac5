// The transpose of one bounce (bounce.cuh bounce()) for the full adjoint
// (K6, adjoint.cu): given the trip's inputs from the tape and the adjoints
// of its outputs (next origin, direction, throughput; the radiance's
// adjoint is the pixel's delta on every trip, since the colour only
// accumulates), it returns the adjoints of the trip's origin, direction
// and throughput and adds every leaf's gradient to the sink.
//
// Replaces what jax.grad takes through bounce_shade
// (path_tracer_tpu/ops/integrator.py:123, shade_tiled.py:773) and
// refine_hit (traverse.py:558), with JAX's constants: traversal (the prim
// id, t_exit, exit_is_medium) gives no gradient; the hit's t, point and
// normal are re-derived from (o, d) and the primitive's leaves; t_hit in
// the medium chord, cont_t, the roulette boost, the dielectric's
// reflect/refract choice and every coin are constants; floor and integer
// casts have zero derivative, so no texture has a gradient through (u, v)
// (checked against shade.py:120-160: checker lattice, nearest texel) and
// the sphere's acos/atan2 and the quad's w and (q, u, v) get nothing.  Each
// lane transposes only the family it took, which is what jnp.where's
// cotangent does.
//
// The forward quantities are recomputed from the tape entry with the
// forward's helpers and expressions, in its order (--fmad=false), so every
// decision (medium scatter, family, reflect/refract, walk coins, roulette)
// is the forward's.
#pragma once

#include "bounce.cuh"
#include "sss_adj.cuh"

// Inputs of one trip's bounce (the tape entry, 14 words).
struct TripIn {
  float o[3], d[3], thr[3];
  float t_exit;
  int r_pt, r_pi;
  int bits;   // 1 found, 2 exit_found, 4 exit_is_medium; depth << 3
};

// Adjoint of the path state between trips.
struct PathAdj {
  float o[3], d[3], thr[3];
};

// refine_hit's transpose: adjoints pb (hit point) and nb (shading normal,
// flipped to face the ray) in; adds ō, d̄ and the primitive row's leaves
// (sphere c0, c1, radius; quad n, d; triangle v0, e1, e2, n).
__device__ __forceinline__ void refine_hit_adj(const WaveArgs& a, int ptype,
                                               int pidx, const float* o,
                                               const float* d, float time,
                                               float t_min, const float* pb_in,
                                               const float* nb_in, float* ob,
                                               float* db,
                                               const GradSink& sink) {
  const int off = ptype == 0 ? 0 : (ptype == 1 ? a.n_sph : a.n_sph + a.n_qd);
  const int uid = clampi(pidx + off, 0, a.n_prim_rows - 1);
  const float* r = a.prim_tab + 18 * (size_t)uid;
  const float av[3] = {r[2], r[3], r[4]};
  const float bv[3] = {r[5], r[6], r[7]};
  const float cv[3] = {r[8], r[9], r[10]};
  const float sn[3] = {r[11], r[12], r[13]};
  float pb[3] = {pb_in[0], pb_in[1], pb_in[2]};
  float nob[3];
  if (ptype == 0) {
    const float cx = av[0] + (bv[0] - av[0]) * time,
                cy = av[1] + (bv[1] - av[1]) * time,
                cz = av[2] + (bv[2] - av[2]) * time;
    const float oc[3] = {cx - o[0], cy - o[1], cz - o[2]};
    const float ra = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float hh = d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2];
    const float radius = cv[0];
    const float cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] -
                     radius * radius;
    const float disc = hh * hh - ra * cc;
    const float sq = sqrtf(fmaxp(disc, 1e-12f));
    const float r0 = (hh - sq) / ra, r1 = (hh + sq) / ra;
    const bool in0 = (r0 > t_min) && (r0 < PTT_INF);
    const float t = in0 ? r0 : r1;
    const float p[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
    const bool rad_ok = fabsf(radius) > 1e-12f;
    const float safe_r = rad_ok ? radius : 1.0f;
    const float no[3] = {(p[0] - cx) / safe_r, (p[1] - cy) / safe_r,
                         (p[2] - cz) / safe_r};
    const float flip = (d[0] * no[0] + d[1] * no[1] + d[2] * no[2] < 0.0f)
                           ? 1.0f : -1.0f;
    float cb[3], radb = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nob[k] = flip * nb_in[k];
      pb[k] += nob[k] / safe_r;      // no = (p - c) / r
      cb[k] = -nob[k] / safe_r;
    }
    if (rad_ok) radb -= dot3(nob, no) / safe_r;
    // p = o + t d
    const float tb = dot3(pb, d);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ob[k] += pb[k];
      db[k] += pb[k] * t;
    }
    // t = (hh -+ sq) / ra, the root chosen by in0 (a constant)
    float hhb = tb / ra;
    const float sqb = (in0 ? -tb : tb) / ra;
    float rab = -tb * t / ra;
    const float discb = disc >= 1e-12f ? sqb * (0.5f / sq) : 0.0f;
    hhb += 2.0f * hh * discb;
    rab += -cc * discb;
    const float ccb = -ra * discb;
    radb += -2.0f * radius * ccb;
    float ocb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ocb[k] = 2.0f * oc[k] * ccb + hhb * d[k];
      db[k] += hhb * oc[k] + 2.0f * rab * d[k];
      cb[k] += ocb[k];
      ob[k] -= ocb[k];
    }
    // c = c0 + (c1 - c0) time
    const float g[7] = {cb[0] * (1.0f - time), cb[1] * (1.0f - time),
                        cb[2] * (1.0f - time), cb[0] * time, cb[1] * time,
                        cb[2] * time, radb};
    sink.prim_row(uid, 2, 7, g);
  } else if (ptype == 1) {
    const float pd = r[17];
    const float denom = sn[0] * d[0] + sn[1] * d[1] + sn[2] * d[2];
    const bool parallel = fabsf(denom) < 1e-8f;
    const float den = parallel ? 1.0f : denom;
    const float t = (pd - (sn[0] * o[0] + sn[1] * o[1] + sn[2] * o[2])) / den;
    const float flip = (d[0] * sn[0] + d[1] * sn[1] + d[2] * sn[2] < 0.0f)
                           ? 1.0f : -1.0f;
    const float tb = dot3(pb, d);
    const float numb = tb / den;
    const float denb = parallel ? 0.0f : -tb * t / den;
    float snb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ob[k] += pb[k] - numb * sn[k];
      db[k] += pb[k] * t + denb * sn[k];
      snb[k] = flip * nb_in[k] - numb * o[k] + denb * d[k];
    }
    const float g[7] = {snb[0], snb[1], snb[2], 0.0f, 0.0f, 0.0f, numb};
    sink.prim_row(uid, 11, 7, g);
  } else {
    const float pv[3] = {d[1] * cv[2] - d[2] * cv[1],
                         d[2] * cv[0] - d[0] * cv[2],
                         d[0] * cv[1] - d[1] * cv[0]};
    const float det = bv[0] * pv[0] + bv[1] * pv[1] + bv[2] * pv[2];
    const bool par = fabsf(det) < 1e-9f;
    const float inv_det = 1.0f / (par ? 1.0f : det);
    const float tv[3] = {o[0] - av[0], o[1] - av[1], o[2] - av[2]};
    const float qv[3] = {tv[1] * bv[2] - tv[2] * bv[1],
                         tv[2] * bv[0] - tv[0] * bv[2],
                         tv[0] * bv[1] - tv[1] * bv[0]};
    const float s = cv[0] * qv[0] + cv[1] * qv[1] + cv[2] * qv[2];
    const float t = s * inv_det;
    const float flip = (d[0] * sn[0] + d[1] * sn[1] + d[2] * sn[2] < 0.0f)
                           ? 1.0f : -1.0f;
    float g[12] = {0.0f};
    float* abar = g;
    float* bbar = g + 3;
    float* cbar = g + 6;
    const float tb = dot3(pb, d);
    const float sb = tb * inv_det, invb = tb * s;
    float qvb[3], tvb[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ob[k] += pb[k];
      db[k] += pb[k] * t;
      cbar[k] += sb * qv[k];
      qvb[k] = sb * cv[k];
      g[9 + k] = flip * nb_in[k];
    }
    if (!par) {
      const float detb = -invb * inv_det * inv_det;
      float pvb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bbar[k] += detb * pv[k];
        pvb[k] = detb * bv[k];
      }
      cross_adj(d, cv, pvb, db, cbar);      // pv = d × e2
    }
    cross_adj(tv, bv, qvb, tvb, bbar);        // qv = tv × e1
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ob[k] += tvb[k];                        // tv = o - v0
      abar[k] -= tvb[k];
    }
    sink.prim_row(uid, 2, 12, g);
  }
}

// r = ui - 2 (ui·n) n.
__device__ __forceinline__ void reflect_adj(const float* ui, const float* n,
                                            const float* rb, float* uib,
                                            float* nb) {
  const float vdn = dot3(ui, n);
  const float vdnb = -2.0f * dot3(rb, n);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uib[k] += rb[k] + vdnb * n[k];
    nb[k] += -2.0f * vdn * rb[k] + vdnb * ui[k];
  }
}

// One trip's transpose; adj holds the adjoint of the trip's outputs on
// entry and of its inputs on return.  With kGlobal the SSS walk's record is
// the pixel's buffer `wrec` (sss_adj.cuh).
template <bool kGlobal>
__device__ __forceinline__ void bounce_adj(const WaveArgs& a,
                                           const TripIn& in, float time,
                                           Key kit, const float* delta,
                                           PathAdj& adj,
                                           const GradSink& sink,
                                           float* wrec) {
  const float* o = in.o;
  const float* d = in.d;
  const float* thr = in.thr;
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = d[0], dy = d[1], dz = d[2];
  bool found = (in.bits & 1) != 0;
  const bool exit_found = (in.bits & 2) != 0;
  const bool exit_is_medium = (in.bits & 4) != 0;
  const int depth_in = in.bits >> 3;
  const Key ks = fold_in(kit, 0u), km = fold_in(kit, 1u), kr = fold_in(kit, 2u);

  // --- forward recompute (bounce.cuh, same order) ---
  Hit rec;
  if (in.r_pt >= 0) {
    rec = refine_hit(a, in.r_pt, in.r_pi, ox, oy, oz, dx, dy, dz, time,
                     a.t_min);
  } else {
    rec = Hit{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, 0, -1};
  }
  const float t_hit = rec.t;
  bool med_scatter = false, passthrough = false;
  float t_scatter = 0.0f, cont_t = 0.0f, hit_distance = 0.0f, ray_len = 0.0f;
  float density = 1.0f;
  int mi = 0;
  Col med_albedo{0.f, 0.f, 0.f};
  if (a.has_medium) {
    const bool in_medium = found && rec.medium >= 0;
    const bool entering = in_medium && rec.front;
    const bool exiting = in_medium && !rec.front;
    const float t1 = entering ? t_hit : 0.0f;
    const float t2 = entering ? in.t_exit : t_hit;
    const bool region_ok = entering ? exit_found : exiting;
    mi = clampi(rec.medium, 0, a.n_med - 1);
    density = a.med_tab[2 * mi];
    const float t1c = fmaxp(fmaxp(t1, a.t_min), 0.0f);
    const float t2c = fminp(t2, a.t_max);
    ray_len = sqrtf(dx * dx + dy * dy + dz * dz);
    const float distance_inside = (t2c - t1c) * ray_len;
    const float umed = uniform_at(km, 0u);
    hit_distance = -logf(fmaxp(umed, 1e-10f)) / density;
    med_scatter = in_medium && region_ok && (t1c < t2c) &&
                  (hit_distance < distance_inside);
    t_scatter = t1c + hit_distance / ray_len;
    if (med_scatter) {
      med_albedo = eval_texture(a, (int)a.med_tab[2 * mi + 1], 0.0f, 0.0f,
                                ox + t_scatter * dx, oy + t_scatter * dy,
                                oz + t_scatter * dz, a.has_noise_medium,
                                a.has_image_medium);
    }
    const bool stop_short = entering && exit_found && !exit_is_medium;
    const float hop_t = exiting ? t_hit : in.t_exit;
    cont_t = fmaxp(stop_short ? t2 - 2.0f * a.t_min : hop_t + 1e-3f, a.t_min);
    const bool escape = entering && !exit_found;
    passthrough = in_medium && !med_scatter && !escape;
    found = found && !escape;
  }
  const bool surface = found && !med_scatter && !passthrough;
  const int mat_row = clampi(rec.mat, 0, a.n_mat - 1);
  const float* mrow = a.mat_tab + 8 * mat_row;
  const int mtype = (int)mrow[0];
  bool scat_ok = mtype != MAT_EMISSIVE;
  const float n[3] = {rec.nx, rec.ny, rec.nz};
  const float p[3] = {rec.px, rec.py, rec.pz};
  float u8[8], ui[3] = {dx, dy, dz};
  float s_d[3] = {0.f, 0.f, 0.f}, s_at[3] = {0.f, 0.f, 0.f};
  float alb[3] = {0.f, 0.f, 0.f}, f[3] = {0.f, 0.f, 0.f};
  Col emit{0.f, 0.f, 0.f};
  bool reflect = false, displaced = false;
  int walk_trips = 0;
  if (surface) {
#pragma unroll
    for (int k = 0; k < 8; ++k) u8[k] = uniform_at(ks, (uint32_t)k);
    normalize3(ui[0], ui[1], ui[2]);
    if (mtype == MAT_LAMBERTIAN) {
      cosine_direction(u8[0], u8[1], n[0], n[1], n[2], s_d[0], s_d[1], s_d[2]);
    } else if (mtype == MAT_METAL) {
      unit_vector(u8[2], u8[3], f[0], f[1], f[2]);
    } else if (mtype == MAT_DIELECTRIC) {
      const float ir = mrow[3];
      const float ratio = rec.front ? 1.0f / ir : ir;
      const float cos_theta =
          fminp(-ui[0] * n[0] + -ui[1] * n[1] + -ui[2] * n[2], 1.0f);
      const float sin_theta =
          sqrtf(clampf(1.0f - cos_theta * cos_theta, 1e-12f, 1.0f));
      const bool cannot_refract = ratio * sin_theta > 1.0f;
      const float q = (1.0f - ratio) / (1.0f + ratio);
      const float r0 = q * q;
      const float m = 1.0f - cos_theta;
      const float m2 = m * m;
      const float m5 = m * (m2 * m2);
      const float reflectance = r0 + (1.0f - r0) * m5;
      reflect = cannot_refract || reflectance > u8[4];
    } else if (mtype == MAT_SSS_SIMPLE) {
      unit_vector(u8[5], u8[6], s_d[0], s_d[1], s_d[2]);
      unit_vector(u8[2], u8[3], f[0], f[1], f[2]);
      displaced = u8[7] >= 0.5f;
    }
    if (mtype != MAT_DIELECTRIC && scat_ok) {
      const Col c = eval_texture(a, (int)mrow[1], rec.u, rec.v, p[0], p[1],
                                 p[2], true, true);
      alb[0] = c.r; alb[1] = c.g; alb[2] = c.b;
#pragma unroll
      for (int k = 0; k < 3; ++k) s_at[k] = alb[k];
    } else if (mtype == MAT_DIELECTRIC) {
      s_at[0] = s_at[1] = s_at[2] = 1.0f;
    }
    if (mtype == MAT_SSS_VOLUMETRIC) {
      const float sigma_t = fmaxp(mrow[5] + mrow[6], 1e-6f);
      const WalkOut w = sss_walk(fold_in(ks, 1u), a.sss_steps, p, n, ui, s_at,
                                 sigma_t, mrow[6], mrow[4]);
#pragma unroll
      for (int k = 0; k < 3; ++k) s_at[k] = w.th[k] * s_at[k];
      scat_ok = w.status == 1;
      walk_trips = w.trips;
    }
    if (mtype == MAT_EMISSIVE) {
      emit = eval_texture(a, (int)mrow[1], rec.u, rec.v, p[0], p[1], p[2],
                          a.has_noise_emission, a.has_image_emission);
    }
  }
  const bool scattered = med_scatter || (surface && scat_ok);
  float at[3], thr_s[3];
  const float med_at[3] = {med_albedo.r, med_albedo.g, med_albedo.b};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    at[k] = med_scatter ? med_at[k] : s_at[k];
    thr_s[k] = scattered ? thr[k] * at[k] : thr[k];
  }
  float boost = 1.0f;
  if (a.use_rr) {
    const int depth = depth_in + (scattered ? 1 : 0);
    const bool rr_active = scattered && depth >= a.rr_min_depth;
    const float survival =
        fminp(fmaxp(fmaxp(thr_s[0], thr_s[1]), thr_s[2]), a.rr_max_prob);
    const bool killed = rr_active && (uniform_at(kr, 0u) > survival);
    boost = (rr_active && !killed) ? 1.0f / fmaxp(survival, 1e-6f) : 1.0f;
  }

  // --- reverse ---
  float ob[3] = {0.f, 0.f, 0.f}, db[3] = {0.f, 0.f, 0.f};
  float thrb[3], atb[3] = {0.f, 0.f, 0.f};
  float n_ob[3] = {0.f, 0.f, 0.f}, n_db[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float tb = adj.thr[k] * boost;        // thr' = thr_s * boost
    thrb[k] = scattered ? tb * at[k] : tb;
    if (scattered) atb[k] = tb * thr[k];
    if (passthrough) {                          // o + d cont_t, d
      ob[k] += adj.o[k];
      db[k] += adj.o[k] * cont_t + adj.d[k];
    } else if (scattered) {
      n_ob[k] = adj.o[k];
      n_db[k] = adj.d[k];
    } else {
      ob[k] += adj.o[k];
      db[k] += adj.d[k];
    }
  }
  // radiance: col += surf_f thr emit, or thr bg on a miss
  const float em[3] = {emit.r, emit.g, emit.b};
  float emb[3] = {0.f, 0.f, 0.f};
  if (found) {
    if (surface && mtype == MAT_EMISSIVE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        thrb[k] += delta[k] * em[k];
        emb[k] = delta[k] * thr[k];
      }
    }
  } else {
    float bg[3], bgb[3];
    background(a, dx, dy, dz, bg);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      thrb[k] += delta[k] * bg[k];
      bgb[k] = delta[k] * thr[k];
    }
    background_adj(a, dx, dy, dz, bgb, db);
  }
  if (med_scatter) {
    // next origin o + t_scatter d; albedo at that point
    float pmb[3] = {n_ob[0], n_ob[1], n_ob[2]};
    const float mp[3] = {ox + t_scatter * dx, oy + t_scatter * dy,
                         oz + t_scatter * dz};
    texture_adj(a, (int)a.med_tab[2 * mi + 1], 0.0f, 0.0f, mp[0], mp[1],
                mp[2], a.has_noise_medium, a.has_image_medium, atb, pmb, sink);
    const float tsb = dot3(pmb, d);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ob[k] += pmb[k];
      db[k] += pmb[k] * t_scatter;
    }
    // t_scatter = t1c + hit_distance / ray_len, hit_distance = c / density
    const float hdb = tsb / ray_len;
    const float rlb = -tsb * hit_distance / (ray_len * ray_len);
    sink.med_(mi, 0, hdb * (-hit_distance / density));
    if (ray_len > 0.0f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) db[k] += rlb * d[k] / ray_len;
    }
  }
  if (surface) {
    float pb[3] = {0.f, 0.f, 0.f}, nb[3] = {0.f, 0.f, 0.f};
    float uib[3] = {0.f, 0.f, 0.f};
    if (mtype == MAT_EMISSIVE) {
      texture_adj(a, (int)mrow[1], rec.u, rec.v, p[0], p[1], p[2],
                  a.has_noise_emission, a.has_image_emission, emb, pb, sink);
    }
    if (scat_ok) {
      if (mtype != MAT_DIELECTRIC) {
        float albb[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          // SSS-volumetric: alb^m (m walking trips, the exit's included)
          albb[k] = mtype == MAT_SSS_VOLUMETRIC
                        ? atb[k] * (float)walk_trips *
                              pow_int(alb[k], walk_trips - 1)
                        : atb[k];
        }
        texture_adj(a, (int)mrow[1], rec.u, rec.v, p[0], p[1], p[2], true,
                    true, albb, pb, sink);
      }
      if (mtype == MAT_SSS_VOLUMETRIC) {
        const float sigma_t = fmaxp(mrow[5] + mrow[6], 1e-6f);
        WalkAdj wa;
        sss_walk_adj<kGlobal>(fold_in(ks, 1u), a.sss_steps, p, n, ui,
                              sigma_t, mrow[6], mrow[4], n_ob, n_db, wa,
                              wrec);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pb[k] += wa.h[k];
          nb[k] += wa.n[k];
          uib[k] += wa.ui[k];
        }
        if (mrow[5] + mrow[6] >= 1e-6f) {
          sink.mat_(mat_row, 5, wa.sigma_t);
          sink.mat_(mat_row, 6, wa.sigma_t);
        }
        sink.mat_(mat_row, 4, wa.g);
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) pb[k] += n_ob[k];   // s_o = p (+ ...)
      }
      if (mtype == MAT_LAMBERTIAN) {
        if (near_zero(s_d[0], s_d[1], s_d[2])) {
#pragma unroll
          for (int k = 0; k < 3; ++k) nb[k] += n_db[k];
        } else {
          cosine_direction_adj(u8[0], u8[1], n, n_db, nb);
        }
      } else if (mtype == MAT_METAL) {
        sink.mat_(mat_row, 2, dot3(n_db, f));          // r + fuzz f
        reflect_adj(ui, n, n_db, uib, nb);
      } else if (mtype == MAT_DIELECTRIC) {
        if (reflect) {
          reflect_adj(ui, n, n_db, uib, nb);
        } else {
          const float ir = mrow[3];
          const float ratio = rec.front ? 1.0f / ir : ir;
          const float y = -ui[0] * n[0] + -ui[1] * n[1] + -ui[2] * n[2];
          const float cos_theta = fminp(y, 1.0f);
          float x[3], pp[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = ui[k] + cos_theta * n[k];
            pp[k] = ratio * x[k];
          }
          const float q = 1.0f - (pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2]);
          const float par = -sqrtf(fmaxp(q, 1e-12f));
          // s_d = pp + par n
          const float parb = dot3(n_db, n);
          float ppb[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ppb[k] = n_db[k];
            nb[k] += par * n_db[k];
          }
          if (q >= 1e-12f) {
            const float qb = parb * (0.5f / par);      // d(-sqrt q)/dq
#pragma unroll
            for (int k = 0; k < 3; ++k) ppb[k] += qb * (-2.0f * pp[k]);
          }
          // pp = ratio (ui + cos_theta n)
          const float ratiob = dot3(ppb, x);
          float cosb = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float xb = ratio * ppb[k];
            uib[k] += xb;
            cosb += xb * n[k];
            nb[k] += cos_theta * xb;
          }
          if (y <= 1.0f) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              uib[k] -= cosb * n[k];
              nb[k] -= cosb * ui[k];
            }
          }
          sink.mat_(mat_row, 3, rec.front ? -ratiob / (ir * ir) : ratiob);
        }
      } else if (mtype == MAT_SSS_SIMPLE) {
        if (displaced) {                       // s_o = p + s_d amp
          sink.mat_(mat_row, 7, dot3(n_ob, s_d) * u8[4]);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) nb[k] += n_db[k];    // n (+ f)
      }
    }
    if (uib[0] != 0.0f || uib[1] != 0.0f || uib[2] != 0.0f) {
      normalize3_adj(d, uib, db);              // ui = normalize(d)
    }
    if (pb[0] != 0.0f || pb[1] != 0.0f || pb[2] != 0.0f || nb[0] != 0.0f ||
        nb[1] != 0.0f || nb[2] != 0.0f) {
      refine_hit_adj(a, in.r_pt, in.r_pi, o, d, time, a.t_min, pb, nb, ob, db,
                     sink);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    adj.o[k] = ob[k];
    adj.d[k] = db[k];
    adj.thr[k] = thrb[k];
  }
}
