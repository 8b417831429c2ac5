// Hand-derived adjoints (reverse-mode transposes) of the device helpers the
// full adjoint (K6, adjoint.cu) runs through: normalize3, onb,
// cosine_direction, sample_hg and direction_from_cos (sampling.cuh), the
// Perlin noise, its turbulence and the marble texture (texture.cuh), the
// gradient sky (camera.cuh), and the sink the gradients go to.
//
// Each *_adj function takes the forward's inputs, recomputes what it needs
// with the forward's expressions, and adds the adjoint of its inputs given
// the adjoint of its outputs (x̄ += J^T ȳ).  The semantics are those of
// autograd through the plain-torch twins (ops/shade_tiled.py,
// utils/perlin.py, ops/camera.py), which tests/test_torch_grad.py holds
// against jax.grad: torch.clamp passes the cotangent where its input lies
// within [lo, hi] (ends included) and gives 0 outside; floor and integer
// casts have zero derivative; abs has derivative sign(x) (0 at 0).
#pragma once

#include "camera.cuh"
#include "sampling.cuh"
#include "texture.cuh"

// Where K6 adds its gradients: each table's buffer (the block's copy in
// shared memory, or the global one).  Rows of g_prim take one atomic per
// column per group of lanes of a warp that add into the same row.
struct GradSink {
  float *tex, *img, *prim, *mat, *med, *perlin;

  __device__ __forceinline__ static void add(float* base, size_t off,
                                             float v) {
    if (v != 0.0f) atomicAdd(base + off, v);
  }
  __device__ __forceinline__ void tex_(int row, int col, float v) const {
    add(tex, 9 * (size_t)row + col, v);
  }
  __device__ __forceinline__ void img_(int texel, int k, float v) const {
    add(img, 3 * (size_t)texel + k, v);
  }
  __device__ __forceinline__ void mat_(int row, int col, float v) const {
    add(mat, 8 * (size_t)row + col, v);
  }
  __device__ __forceinline__ void med_(int row, int col, float v) const {
    add(med, 2 * (size_t)row + col, v);
  }
  __device__ __forceinline__ void perlin_(int row, int col, float v) const {
    add(perlin, 4 * (size_t)row + col, v);
  }
  // Columns c0 .. c0+n-1 of prim row uid += g[0 .. n-1].  On the card the
  // lanes of a warp that reach this call with the same row (the same
  // primitive type, hence the same c0 and n) sum their values by shuffles
  // and the lowest of them adds the sums: the box ground and the large
  // spheres are hit by most lanes.
  __device__ __forceinline__ void prim_row(int uid, int c0, int n,
                                           const float* g) const {
    float* row = prim + 18 * (size_t)uid + c0;
#ifdef PTT_HOST_EMULATION
    for (int c = 0; c < n; ++c) add(row, c, g[c]);
#else
    const unsigned grp = __match_any_sync(__activemask(), uid);
    const int lane = threadIdx.x & 31;
    for (int c = 0; c < n; ++c) {
      float s = 0.0f;
      for (unsigned m = grp; m != 0u; m &= m - 1u) {
        s += __shfl_sync(grp, g[c], __ffs(m) - 1);
      }
      if (lane == __ffs(grp) - 1) add(row, c, s);
    }
#endif
  }
};

// --- scalars and vectors ---

// c^m by repeated multiplication, in the walk's order (1 * c * c ...).
__device__ __forceinline__ float pow_int(float c, int m) {
  float p = 1.0f;
  for (int i = 0; i < m; ++i) p = p * c;
  return p;
}

__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

// z = x × y: x̄ += y × z̄, ȳ += z̄ × x.
__device__ __forceinline__ void cross_adj(const float* x, const float* y,
                                          const float* zb, float* xb,
                                          float* yb) {
  xb[0] += y[1] * zb[2] - y[2] * zb[1];
  xb[1] += y[2] * zb[0] - y[0] * zb[2];
  xb[2] += y[0] * zb[1] - y[1] * zb[0];
  yb[0] += zb[1] * x[2] - zb[2] * x[1];
  yb[1] += zb[2] * x[0] - zb[0] * x[2];
  yb[2] += zb[0] * x[1] - zb[1] * x[0];
}

// y = x / sqrt(max(x·x, 1e-16)) (normalize3): x̄ += inv ȳ - inv³ (ȳ·x) x,
// the second term only where x·x >= 1e-16.
__device__ __forceinline__ void normalize3_adj(const float* x, const float* yb,
                                               float* xb) {
  const float s = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  const float inv = 1.0f / sqrtf(fmaxp(s, 1e-16f));
  const float k = s >= 1e-16f ? inv * inv * inv * dot3(yb, x) : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) xb[i] += inv * yb[i] - k * x[i];
}

// onb(n) -> (u, v, w): w = normalize(n), v = normalize(w × a) with the
// constant axis a (the |wx| > 0.9 choice), u = w × v.
__device__ __forceinline__ void onb_adj(const float* n, const float* ub,
                                        const float* vb_in, const float* wb_in,
                                        float* nb) {
  float w[3] = {n[0], n[1], n[2]};
  normalize3(w[0], w[1], w[2]);
  const float use_y = fabsf(w[0]) > 0.9f ? 1.0f : 0.0f;
  const float ax[3] = {1.0f - use_y, use_y, 0.0f};
  const float vr[3] = {w[1] * 0.0f - w[2] * ax[1], w[2] * ax[0] - w[0] * 0.0f,
                       w[0] * ax[1] - w[1] * ax[0]};
  float v[3] = {vr[0], vr[1], vr[2]};
  normalize3(v[0], v[1], v[2]);
  float wb[3] = {wb_in[0], wb_in[1], wb_in[2]};
  float vb[3] = {vb_in[0], vb_in[1], vb_in[2]};
  cross_adj(w, v, ub, wb, vb);               // u = w × v
  float vrb[3] = {0.0f, 0.0f, 0.0f};
  normalize3_adj(vr, vb, vrb);               // v = normalize(vr)
  float axb[3] = {0.0f, 0.0f, 0.0f};
  cross_adj(w, ax, vrb, wb, axb);            // vr = w × a
  normalize3_adj(n, wb, nb);                 // w = normalize(n)
}

// cosine_direction(u0, u1, n) = lx u + ly v + lz w of onb(n).
__device__ __forceinline__ void cosine_direction_adj(float u0, float u1,
                                                     const float* n,
                                                     const float* sb,
                                                     float* nb) {
  const float r = sqrtf(u0);
  const float phi = TWO_PI_F * u1;
  const float lx = r * cosf(phi), ly = r * sinf(phi);
  const float lz = sqrtf(fmaxp(1.0f - u0, 0.0f));
  const float ub[3] = {lx * sb[0], lx * sb[1], lx * sb[2]};
  const float vb[3] = {ly * sb[0], ly * sb[1], ly * sb[2]};
  const float wb[3] = {lz * sb[0], lz * sb[1], lz * sb[2]};
  onb_adj(n, ub, vb, wb, nb);
}

// d sample_hg(u, g) / dg: zero in the isotropic branch (|g| < 1e-3) and
// where the clamp to [-1, 1] is active.
__device__ __forceinline__ float sample_hg_dg(float u, float g) {
  if (fabsf(g) < 1e-3f) return 0.0f;
  const float num = 1.0f - g * g;
  const float den = 1.0f - g + 2.0f * g * u;
  const float sq = num / den;
  const float cos_hg = (1.0f + g * g - sq * sq) / (2.0f * g);
  if (!(cos_hg >= -1.0f && cos_hg <= 1.0f)) return 0.0f;
  const float dsq = (-2.0f * g * den - num * (2.0f * u - 1.0f)) / (den * den);
  const float dnum = 2.0f * g - 2.0f * sq * dsq;
  return (dnum - 2.0f * cos_hg) / (2.0f * g);
}

// direction_from_cos(u_phi, c, a) = st cos(phi) u + st sin(phi) v + c w of
// onb(a), st = sqrt(clamp(1 - c², 1e-12, 1)): adds ā and returns c̄.
__device__ __forceinline__ float direction_from_cos_adj(float u_phi, float c,
                                                        const float* a,
                                                        const float* ob,
                                                        float* ab) {
  const float q = 1.0f - c * c;
  const float st = sqrtf(clampf(q, 1e-12f, 1.0f));
  const float phi = TWO_PI_F * u_phi;
  const float cp = cosf(phi), sp = sinf(phi);
  const float sc = st * cp, ss = st * sp;
  float u[3], v[3], w[3];
  onb(a[0], a[1], a[2], u, v, w);
  const float ub[3] = {ob[0] * sc, ob[1] * sc, ob[2] * sc};
  const float vb[3] = {ob[0] * ss, ob[1] * ss, ob[2] * ss};
  const float wb[3] = {ob[0] * c, ob[1] * c, ob[2] * c};
  onb_adj(a, ub, vb, wb, ab);
  float cb = dot3(ob, w);
  const float stb = dot3(ob, u) * cp + dot3(ob, v) * sp;
  if (q >= 1e-12f && q <= 1.0f) cb += stb * (0.5f / st) * (-2.0f * c);
  return cb;
}

// --- textures ---

// perlin_noise at p with adjoint nb of its value: adds p̄ and the gradient
// table's adjoint (rows perlin_vec[hash], columns 0-2).
__device__ __forceinline__ void perlin_noise_adj(const WaveArgs& a, float px,
                                                 float py, float pz, float nb,
                                                 float* pb,
                                                 const GradSink& sink) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float u = px - fx, v = py - fy, w = pz - fz;
  const int ix = (int)fx & 255, iy = (int)fy & 255, iz = (int)fz & 255;
  const int* perm = a.perlin_perm;
  const int hx[2] = {perm[ix], perm[(ix + 1) & 255]};
  const int hy[2] = {perm[256 + iy], perm[256 + ((iy + 1) & 255)]};
  const int hz[2] = {perm[512 + iz], perm[512 + ((iz + 1) & 255)]};
  const float su = u * u * (3.0f - 2.0f * u);
  const float sv = v * v * (3.0f - 2.0f * v);
  const float sw = w * w * (3.0f - 2.0f * w);
  float sub = 0.0f, svb = 0.0f, swb = 0.0f, ub = 0.0f, vb = 0.0f, wb = 0.0f;
  for (int di = 0; di < 2; ++di) {
    const float wu = di ? su : (1.0f - su);
    for (int dj = 0; dj < 2; ++dj) {
      const float wv = dj ? sv : (1.0f - sv);
      for (int dk = 0; dk < 2; ++dk) {
        const float ww = dk ? sw : (1.0f - sw);
        const int row = hx[di] ^ hy[dj] ^ hz[dk];
        const float* g = a.perlin_vec + 4 * row;
        const float du = u - (float)di, dv = v - (float)dj, dw = w - (float)dk;
        const float dot = g[0] * du + g[1] * dv + g[2] * dw;
        const float dotb = nb * (wu * wv * ww);
        const float wub = nb * wv * ww * dot, wvb = nb * wu * ww * dot,
                    wwb = nb * wu * wv * dot;
        sub += di ? wub : -wub;
        svb += dj ? wvb : -wvb;
        swb += dk ? wwb : -wwb;
        sink.perlin_(row, 0, dotb * du);
        sink.perlin_(row, 1, dotb * dv);
        sink.perlin_(row, 2, dotb * dw);
        ub += dotb * g[0];
        vb += dotb * g[1];
        wb += dotb * g[2];
      }
    }
  }
  pb[0] += ub + sub * (6.0f * u - 6.0f * u * u);
  pb[1] += vb + svb * (6.0f * v - 6.0f * v * v);
  pb[2] += wb + swb * (6.0f * w - 6.0f * w * w);
}

// perlin_turb = |sum_k 0.5^k noise(2^k p)| with adjoint tb of its value.
__device__ __forceinline__ void perlin_turb_adj(const WaveArgs& a, float px,
                                                float py, float pz, float tb,
                                                float* pb,
                                                const GradSink& sink) {
  float acc = 0.0f, weight = 1.0f;
  float x = px, y = py, z = pz;
  for (int k = 0; k < 7; ++k) {
    acc = acc + weight * perlin_noise(a, x, y, z);
    weight = weight * 0.5f;
    x = x * 2.0f;
    y = y * 2.0f;
    z = z * 2.0f;
  }
  const float accb = acc > 0.0f ? tb : (acc < 0.0f ? -tb : 0.0f);
  if (accb == 0.0f) return;
  weight = 1.0f;
  float scale = 1.0f;
  x = px; y = py; z = pz;
  for (int k = 0; k < 7; ++k) {
    float qb[3] = {0.0f, 0.0f, 0.0f};
    perlin_noise_adj(a, x, y, z, accb * weight, qb, sink);
#pragma unroll
    for (int i = 0; i < 3; ++i) pb[i] += qb[i] * scale;
    weight = weight * 0.5f;
    scale = scale * 2.0f;
    x = x * 2.0f;
    y = y * 2.0f;
    z = z * 2.0f;
  }
}

// eval_texture's adjoint for colour adjoint cb at (u, v, p): the colour leaf
// it read (c1 or c2 of its row, or an atlas texel) gets cb; the marble
// 0.5(1 + sin(scale pz + 10 turb(p))) adds to tex_scale, p̄ and the Perlin
// table.  The gradient through (u, v) is zero: every texture reads them
// through floor or an integer cast (checker lattice, nearest texel).
__device__ __forceinline__ void texture_adj(const WaveArgs& a, int tex_idx,
                                            float u, float v, float px,
                                            float py, float pz,
                                            bool allow_noise, bool allow_image,
                                            const float* cb, float* pb,
                                            const GradSink& sink) {
  const int ti = clampi(tex_idx, 0, a.n_tex - 1);
  const float* row = a.tex_tab + 9 * ti;
  const int ttype = (int)row[0];
  const float scale = row[7];
  if (ttype == TEX_NOISE && a.has_noise && allow_noise) {
    const float mb = cb[0] + cb[1] + cb[2];
    if (mb == 0.0f) return;
    const float turb = perlin_turb(a, px, py, pz);
    const float argb = mb * 0.5f * cosf(scale * pz + 10.0f * turb);
    sink.tex_(ti, 7, argb * pz);
    pb[2] += argb * scale;
    perlin_turb_adj(a, px, py, pz, 10.0f * argb, pb, sink);
    return;
  }
  const int src = texture_src(a, tex_idx, u, v, px, py, pz, allow_noise,
                              allow_image);
  for (int k = 0; k < 3; ++k) {
    if (src >= 2 * a.n_tex) {
      sink.img_(src - 2 * a.n_tex, k, cb[k]);
    } else {
      sink.tex_(src >> 1, 1 + 3 * (src & 1) + k, cb[k]);
    }
  }
}

// background(d) adjoint: the gradient sky (1 - av) + av c_k with
// av = 0.5 (dy / max(|d|, 1e-12) + 1); a solid background is constant.
__device__ __forceinline__ void background_adj(const WaveArgs& a, float dx,
                                               float dy, float dz,
                                               const float* bgb, float* db) {
  if (a.bg_type != 1) return;
  const float len = sqrtf(dx * dx + dy * dy + dz * dz);
  const float n = fmaxp(len, 1e-12f);
  const float avb = bgb[0] * (0.5f - 1.0f) + bgb[1] * (0.7f - 1.0f) +
                    bgb[2] * (1.0f - 1.0f);
  const float qb = avb * 0.5f;             // of dy / n
  db[1] += qb / n;
  if (len >= 1e-12f) {
    const float lb = -qb * dy / (n * n);
    db[0] += lb * dx / len;
    db[1] += lb * dy / len;
    db[2] += lb * dz / len;
  }
}
