// One bounce of one path, shared by K3 (shade, the wavefront), K5
// (megakernel) and K8 (tiled_trip): hit refinement -> constant-medium free
// flight -> scatter of the seven families (with the SSS walk of sss.cuh) ->
// emission -> Russian roulette.
//
// Device copy of path_tracer_tpu/ops/shade_tiled.py bounce_shade_t (:773)
// and ops/integrator.py bounce_shade (:123), with refine_hit_t (:155),
// background_t (:357), _medium_sample (integrator.py:72), scatter_t (:386),
// emitted_t (:683) and the texture evaluation of texture.cuh, in the
// operation order of the plain-torch twin (ops/shade_tiled.py).  Each lane
// evaluates only the family it needs, where the TPU code evaluates every
// family on every lane; the selected values are the same.
//
// bounce() takes a compile-time recorder (K6, adjoint.cu) that is told each
// linear colour event of the trip: the throughput before it, the emission or
// background term, the attenuation's texture colour with its leaf address
// and exponent, and the roulette boost.  K3 and K5 pass none (NoTape): every
// recorder call sits under `if constexpr` and compiles to nothing there.
#pragma once

#include "camera.cuh"
#include "sss.cuh"
#include "texture.cuh"

struct Hit {
  float t, px, py, pz, nx, ny, nz, u, v;
  bool front;
  int mat, medium;
};

// Registers of one path (types.PathState).
struct PathRegs {
  float o[3], d[3], col[3], thr[3];
  float time;
  int depth, iters;
  bool alive;
};

// The recorder K3 and K5 use: records nothing.  (kOn: colour events of
// bounce(); kTrips: each trip's bounce inputs, recorded by path_trip.)
struct NoTape {
  static constexpr bool kOn = false;
  static constexpr bool kTrips = false;
};

// Shade-table row of (ptype, pidx): [mat, medium, a, b, c, n, w, d].
__device__ __forceinline__ const float* prim_row(const WaveArgs& a, int ptype,
                                                 int pidx) {
  const int off = ptype == 0 ? 0 : (ptype == 1 ? a.n_sph : a.n_sph + a.n_qd);
  int uid = clampi(pidx + off, 0, a.n_prim_rows - 1);
  if (ptype < 0) uid = 0;
  return a.prim_tab + 18 * (size_t)uid;
}

// Constant-medium index of a hit primitive, or -1 (prim_medium_of).
__device__ __forceinline__ int medium_of(const WaveArgs& a, int ptype,
                                         int pidx) {
  return ptype >= 0 ? (int)prim_row(a, ptype, pidx)[1] : -1;
}

// refine_hit_t for one lane with a known primitive (ptype >= 0).
__device__ __forceinline__ Hit refine_hit(const WaveArgs& a, int ptype,
                                          int pidx, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float time, float t_min) {
  const float* r = prim_row(a, ptype, pidx);
  const float a0 = r[2], a1 = r[3], a2 = r[4];
  const float b0 = r[5], b1 = r[6], b2 = r[7];
  const float c0 = r[8], c1 = r[9], c2 = r[10];
  const float sn0 = r[11], sn1 = r[12], sn2 = r[13];
  Hit h;
  h.mat = (int)r[0];
  h.medium = (int)r[1];
  float nox, noy, noz;
  if (ptype == 0) {
    const float cx = a0 + (b0 - a0) * time, cy = a1 + (b1 - a1) * time,
                cz = a2 + (b2 - a2) * time;
    const float ocx = cx - ox, ocy = cy - oy, ocz = cz - oz;
    const float ra = dx * dx + dy * dy + dz * dz;
    const float hh = dx * ocx + dy * ocy + dz * ocz;
    const float radius = c0;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius;
    const float disc = hh * hh - ra * cc;
    const float sq = sqrtf(fmaxp(disc, 1e-12f));
    const float r0 = (hh - sq) / ra, r1 = (hh + sq) / ra;
    const bool in0 = (r0 > t_min) && (r0 < PTT_INF);
    h.t = in0 ? r0 : r1;
    h.px = ox + h.t * dx;
    h.py = oy + h.t * dy;
    h.pz = oz + h.t * dz;
    const float safe_r = fabsf(radius) > 1e-12f ? radius : 1.0f;
    nox = (h.px - cx) / safe_r;
    noy = (h.py - cy) / safe_r;
    noz = (h.pz - cz) / safe_r;
    const float theta = acosf(clampf(-noy, (float)(-1.0 + 1e-7),
                                     (float)(1.0 - 1e-7)));
    const float phi = atan2f(-noz, nox) + PI_F;
    h.u = phi / TWO_PI_F;
    h.v = theta / PI_F;
  } else if (ptype == 1) {
    const float w0 = r[14], w1 = r[15], w2 = r[16], pd = r[17];
    const float denom = sn0 * dx + sn1 * dy + sn2 * dz;
    const bool parallel = fabsf(denom) < 1e-8f;
    h.t = (pd - (sn0 * ox + sn1 * oy + sn2 * oz)) / (parallel ? 1.0f : denom);
    h.px = ox + h.t * dx;
    h.py = oy + h.t * dy;
    h.pz = oz + h.t * dz;
    const float plx = h.px - a0, ply = h.py - a1, plz = h.pz - a2;
    const float cvx = ply * c2 - plz * c1, cvy = plz * c0 - plx * c2,
                cvz = plx * c1 - ply * c0;
    h.u = w0 * cvx + w1 * cvy + w2 * cvz;
    const float cux = b1 * plz - b2 * ply, cuy = b2 * plx - b0 * plz,
                cuz = b0 * ply - b1 * plx;
    h.v = w0 * cux + w1 * cuy + w2 * cuz;
    nox = sn0; noy = sn1; noz = sn2;
  } else {
    const float pvx = dy * c2 - dz * c1, pvy = dz * c0 - dx * c2,
                pvz = dx * c1 - dy * c0;
    const float det = b0 * pvx + b1 * pvy + b2 * pvz;
    const bool par = fabsf(det) < 1e-9f;
    const float inv_det = 1.0f / (par ? 1.0f : det);
    const float tvx = ox - a0, tvy = oy - a1, tvz = oz - a2;
    h.u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * b2 - tvz * b1, qvy = tvz * b0 - tvx * b2,
                qvz = tvx * b1 - tvy * b0;
    h.v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    h.t = (c0 * qvx + c1 * qvy + c2 * qvz) * inv_det;
    h.px = ox + h.t * dx;
    h.py = oy + h.t * dy;
    h.pz = oz + h.t * dz;
    nox = sn0; noy = sn1; noz = sn2;
  }
  h.front = dx * nox + dy * noy + dz * noz < 0.0f;
  const float flip = h.front ? 1.0f : -1.0f;
  h.nx = flip * nox;
  h.ny = flip * noy;
  h.nz = flip * noz;
  return h;
}

// One bounce of path p whose closest-hit query gave (found, r_pt, r_pi) and,
// for a hit entering a medium, whose volume-exit query gave (exit_found,
// t_exit, exit_is_medium).  kit = fold_in(key_p, iters).  Updates p (next
// segment, radiance, throughput, depth, iters + 1, alive) and returns the
// SSS walk's walking trips.  `tape`, when Rec::kOn, records the trip's
// colour events (see the note at the top).  With kInj the hit record is
// *inj (the pipeline mode's record, refined on the stage that owns the
// primitive; K8's rec variant) and (r_pt, r_pi) are not read.
template <class Rec = NoTape, bool kInj = false>
__device__ __forceinline__ int bounce(const WaveArgs& a, PathRegs& p,
                                      bool found, int r_pt, int r_pi,
                                      bool exit_found, float t_exit,
                                      bool exit_is_medium, Key kit,
                                      Rec* tape = nullptr,
                                      const Hit* inj = nullptr) {
  const float ox = p.o[0], oy = p.o[1], oz = p.o[2];
  const float dx = p.d[0], dy = p.d[1], dz = p.d[2];
  const float time = p.time;
  const Key ks = fold_in(kit, 0u), km = fold_in(kit, 1u), kr = fold_in(kit, 2u);
  const Key kiso = fold_in(km, 1u);
  float* col = p.col;
  float* thr = p.thr;
  const float* dirc = p.d;
  int walk_trips = 0;
  if constexpr (Rec::kOn) tape->begin(thr);

  Hit rec;
  if constexpr (kInj) {
    rec = *inj;
  } else if (r_pt >= 0) {
    rec = refine_hit(a, r_pt, r_pi, ox, oy, oz, dx, dy, dz, time, a.t_min);
  } else {
    rec = Hit{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, 0, -1};
  }
  const float t_hit = rec.t;

  // --- constant medium ---
  bool med_scatter = false, passthrough = false;
  float t_scatter = 0.0f, cont_t = 0.0f;
  Col med_albedo{0.f, 0.f, 0.f};
  if (a.has_medium) {
    const bool in_medium = found && rec.medium >= 0;
    const bool entering = in_medium && rec.front;
    const bool exiting = in_medium && !rec.front;
    const float t1 = entering ? t_hit : 0.0f;
    const float t2 = entering ? t_exit : t_hit;
    const bool region_ok = entering ? exit_found : exiting;
    const int mi = clampi(rec.medium, 0, a.n_med - 1);
    const float density = a.med_tab[2 * mi];
    const float t1c = fmaxp(fmaxp(t1, a.t_min), 0.0f);
    const float t2c = fminp(t2, a.t_max);
    const float ray_len = sqrtf(dx * dx + dy * dy + dz * dz);
    const float distance_inside = (t2c - t1c) * ray_len;
    const float umed = uniform_at(km, 0u);
    const float hit_distance = -logf(fmaxp(umed, 1e-10f)) / density;
    med_scatter = in_medium && region_ok && (t1c < t2c) &&
                  (hit_distance < distance_inside);
    t_scatter = t1c + hit_distance / ray_len;
    if (med_scatter) {
      med_albedo = eval_texture(a, (int)a.med_tab[2 * mi + 1], 0.0f, 0.0f,
                                ox + t_scatter * dx, oy + t_scatter * dy,
                                oz + t_scatter * dz, a.has_noise_medium,
                                a.has_image_medium);
      if constexpr (Rec::kOn) {
        tape->albedo(texture_src(a, (int)a.med_tab[2 * mi + 1], 0.0f, 0.0f,
                                ox + t_scatter * dx, oy + t_scatter * dy,
                                oz + t_scatter * dz, a.has_noise_medium,
                                a.has_image_medium),
                    med_albedo);
      }
    }
    const bool stop_short = entering && exit_found && !exit_is_medium;
    const float hop_t = exiting ? t_hit : t_exit;
    cont_t = fmaxp(stop_short ? t2 - 2.0f * a.t_min : hop_t + 1e-3f, a.t_min);
    const bool escape = entering && !exit_found;
    passthrough = in_medium && !med_scatter && !escape;
    found = found && !escape;
  }

  // --- surface: scatter + emission ---
  const bool surface = found && !med_scatter && !passthrough;
  const float* mrow = a.mat_tab + 8 * clampi(rec.mat, 0, a.n_mat - 1);
  const int mtype = (int)mrow[0];
  bool scat_ok = mtype != MAT_EMISSIVE;
  float s_o[3] = {rec.px, rec.py, rec.pz};
  float s_d[3] = {0.f, 0.f, 0.f}, s_at[3] = {0.f, 0.f, 0.f};
  Col emit{0.f, 0.f, 0.f};
  if (surface) {
    float u8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) u8[k] = uniform_at(ks, (uint32_t)k);
    float uix = dx, uiy = dy, uiz = dz;
    normalize3(uix, uiy, uiz);
    const float nx = rec.nx, ny = rec.ny, nz = rec.nz;
    if (mtype == MAT_LAMBERTIAN) {
      cosine_direction(u8[0], u8[1], nx, ny, nz, s_d[0], s_d[1], s_d[2]);
      if (near_zero(s_d[0], s_d[1], s_d[2])) {
        s_d[0] = nx; s_d[1] = ny; s_d[2] = nz;
      }
    } else if (mtype == MAT_METAL || mtype == MAT_DIELECTRIC) {
      const float vdn = uix * nx + uiy * ny + uiz * nz;
      const float rx = uix - 2.0f * vdn * nx, ry = uiy - 2.0f * vdn * ny,
                  rz = uiz - 2.0f * vdn * nz;
      if (mtype == MAT_METAL) {
        const float fuzz = mrow[2];
        float fx, fy, fz;
        unit_vector(u8[2], u8[3], fx, fy, fz);
        s_d[0] = rx + fuzz * fx; s_d[1] = ry + fuzz * fy; s_d[2] = rz + fuzz * fz;
      } else {
        const float ir = mrow[3];
        const float ratio = rec.front ? 1.0f / ir : ir;
        const float cos_theta = fminp(-uix * nx + -uiy * ny + -uiz * nz, 1.0f);
        const float sin_theta =
            sqrtf(clampf(1.0f - cos_theta * cos_theta, 1e-12f, 1.0f));
        const bool cannot_refract = ratio * sin_theta > 1.0f;
        const float q = (1.0f - ratio) / (1.0f + ratio);
        const float r0 = q * q;
        const float m = 1.0f - cos_theta;
        const float m2 = m * m;
        const float m5 = m * (m2 * m2);
        const float reflectance = r0 + (1.0f - r0) * m5;
        if (cannot_refract || reflectance > u8[4]) {
          s_d[0] = rx; s_d[1] = ry; s_d[2] = rz;
        } else {
          const float ppx = ratio * (uix + cos_theta * nx);
          const float ppy = ratio * (uiy + cos_theta * ny);
          const float ppz = ratio * (uiz + cos_theta * nz);
          const float par =
              -sqrtf(fmaxp(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz), 1e-12f));
          s_d[0] = ppx + par * nx; s_d[1] = ppy + par * ny; s_d[2] = ppz + par * nz;
        }
      }
    } else {
      // Isotropic; also the SSS-simple displacement vector.
      unit_vector(u8[5], u8[6], s_d[0], s_d[1], s_d[2]);
    }
    if (mtype == MAT_DIELECTRIC) {
      s_at[0] = s_at[1] = s_at[2] = 1.0f;
    } else if (scat_ok) {
      const Col alb = eval_texture(a, (int)mrow[1], rec.u, rec.v, rec.px,
                                   rec.py, rec.pz, true, true);
      s_at[0] = alb.r; s_at[1] = alb.g; s_at[2] = alb.b;
      if constexpr (Rec::kOn) {
        tape->albedo(texture_src(a, (int)mrow[1], rec.u, rec.v, rec.px, rec.py,
                                rec.pz, true, true),
                    alb);
      }
    }
    const float n[3] = {nx, ny, nz};
    if (mtype == MAT_SSS_SIMPLE) {
      // Half the exits displaced by scatter_dist * u8[4] along s_d.
      if (u8[7] >= 0.5f) {
        const float amp = mrow[7] * u8[4];
#pragma unroll
        for (int k = 0; k < 3; ++k) s_o[k] = s_o[k] + s_d[k] * amp;
      }
      float f[3];
      unit_vector(u8[2], u8[3], f[0], f[1], f[2]);
      const float sx = nx + f[0], sy = ny + f[1], sz = nz + f[2];
      const bool deg = near_zero(sx, sy, sz);
      s_d[0] = deg ? nx : sx;
      s_d[1] = deg ? ny : sy;
      s_d[2] = deg ? nz : sz;
    } else if (mtype == MAT_SSS_VOLUMETRIC) {
      const float ui[3] = {uix, uiy, uiz};
      const float sigma_t = fmaxp(mrow[5] + mrow[6], 1e-6f);
      const WalkOut w = sss_walk(fold_in(ks, 1u), a.sss_steps, s_o, n, ui,
                                 s_at, sigma_t, mrow[6], mrow[4]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s_o[k] = w.op[k];
        s_d[k] = w.od[k];
        s_at[k] = w.th[k] * s_at[k];
      }
      scat_ok = w.status == 1;
      walk_trips = w.trips;
      // colour^(n+1): n kept trips and the exit trip's final factor.
      if constexpr (Rec::kOn) tape->exponent(w.trips);
    }
    if (mtype == MAT_EMISSIVE) {
      emit = eval_texture(a, (int)mrow[1], rec.u, rec.v, rec.px, rec.py,
                          rec.pz, a.has_noise_emission, a.has_image_emission);
      if constexpr (Rec::kOn) {
        tape->emission_src(texture_src(a, (int)mrow[1], rec.u, rec.v, rec.px,
                                      rec.py, rec.pz, a.has_noise_emission,
                                      a.has_image_emission));
      }
    }
  }

  // --- radiance ---
  if (found) {
    const float surf_f = surface ? 1.0f : 0.0f;
    col[0] = col[0] + surf_f * thr[0] * emit.r;
    col[1] = col[1] + surf_f * thr[1] * emit.g;
    col[2] = col[2] + surf_f * thr[2] * emit.b;
    if constexpr (Rec::kOn) {
      const float e[3] = {surf_f * emit.r, surf_f * emit.g, surf_f * emit.b};
      tape->emission(e);
    }
  } else {
    float bg[3];
    background(a, dx, dy, dz, bg);
#pragma unroll
    for (int k = 0; k < 3; ++k) col[k] = col[k] + thr[k] * bg[k];
    if constexpr (Rec::kOn) tape->emission(bg);
  }

  // --- next segment ---
  const bool scattered = med_scatter || (surface && scat_ok);
  if constexpr (Rec::kOn) {
    if (!scattered) tape->not_scattered();
  }
  const float orig[3] = {ox, oy, oz};
  float n_o[3], n_d[3], at[3];
  if (med_scatter) {
    float ix, iy, iz;
    unit_vector(uniform_at(kiso, 0u), uniform_at(kiso, 1u), ix, iy, iz);
    n_d[0] = ix; n_d[1] = iy; n_d[2] = iz;
    at[0] = med_albedo.r; at[1] = med_albedo.g; at[2] = med_albedo.b;
#pragma unroll
    for (int k = 0; k < 3; ++k) n_o[k] = orig[k] + t_scatter * dirc[k];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) { n_o[k] = s_o[k]; n_d[k] = s_d[k]; at[k] = s_at[k]; }
  }
  float next_o[3], next_d[3];
  const bool keep_dir = passthrough || !scattered;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    next_o[k] = passthrough ? orig[k] + dirc[k] * cont_t
                            : (scattered ? n_o[k] : orig[k]);
    next_d[k] = keep_dir ? dirc[k] : n_d[k];
    if (scattered) thr[k] = thr[k] * at[k];
  }
  int depth = p.depth + (scattered ? 1 : 0);
  bool alive = p.alive && (passthrough || scattered) && depth < a.max_depth;
  if (a.use_rr) {
    const bool rr_active = scattered && depth >= a.rr_min_depth;
    const float survival =
        fminp(fmaxp(fmaxp(thr[0], thr[1]), thr[2]), a.rr_max_prob);
    const bool killed = rr_active && (uniform_at(kr, 0u) > survival);
    const float boost =
        (rr_active && !killed) ? 1.0f / fmaxp(survival, 1e-6f) : 1.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) thr[k] = thr[k] * boost;
    alive = alive && !killed;
    if constexpr (Rec::kOn) tape->boost(boost);
  }
  if constexpr (Rec::kOn) tape->end();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.o[k] = next_o[k];
    p.d[k] = next_d[k];
  }
  p.depth = depth;
  p.iters = p.iters + 1;
  p.alive = alive;
  return walk_trips;
}
