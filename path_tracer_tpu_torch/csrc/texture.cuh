// Texture colour of one hit: solid, checker (lattice parity), image atlas
// (nearest texel, clamped UV, V flipped) and Perlin marble
// 0.5(1 + sin(scale z + 10 turb(p, 7))).  Device copy of
// path_tracer_tpu/ops/shade.py eval_texture_batched (:188), _atlas_rows
// (:107) and utils/perlin.py turb_t/_noise_t (:119-173), in the same
// operation order as the plain-torch twin (ops/shade.py, utils/perlin.py).
#pragma once

#include "common.cuh"

struct Col {
  float r, g, b;
};

__device__ __forceinline__ float perlin_noise(const WaveArgs& a, float px,
                                              float py, float pz) {
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
  float acc = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const float wu = di ? su : (1.0f - su);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float wv = dj ? sv : (1.0f - sv);
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float ww = dk ? sw : (1.0f - sw);
        const float* g = a.perlin_vec + 4 * (hx[di] ^ hy[dj] ^ hz[dk]);
        const float dot = g[0] * (u - (float)di) + g[1] * (v - (float)dj) +
                          g[2] * (w - (float)dk);
        acc = acc + wu * wv * ww * dot;
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float perlin_turb(const WaveArgs& a, float px,
                                             float py, float pz) {
  float acc = 0.0f, weight = 1.0f;
  for (int k = 0; k < 7; ++k) {
    acc = acc + weight * perlin_noise(a, px, py, pz);
    weight = weight * 0.5f;
    px = px * 2.0f;
    py = py * 2.0f;
    pz = pz * 2.0f;
  }
  return fabsf(acc);
}

// Texture tex_idx at (u, v, p); allow_* gate the expensive families as the
// JAX call sites do (emission and medium albedos compile them out).
__device__ __forceinline__ Col eval_texture(const WaveArgs& a, int tex_idx,
                                            float u, float v, float px,
                                            float py, float pz,
                                            bool allow_noise,
                                            bool allow_image) {
  const int ti = clampi(tex_idx, 0, a.n_tex - 1);
  const float* row = a.tex_tab + 9 * ti;
  const int ttype = (int)row[0];
  const float scale = row[7];
  Col out{row[1], row[2], row[3]};
  if (ttype == TEX_CHECKER) {
    const float lat = floorf(scale * px) + floorf(scale * py) + floorf(scale * pz);
    if (((int)lat & 1) != 0) out = Col{row[4], row[5], row[6]};
  } else if (ttype == TEX_IMAGE && a.has_image && allow_image) {
    const int ii = clampi((int)row[8], 0, a.n_img - 1);
    const int h = a.img_hw[2 * ii], w = a.img_hw[2 * ii + 1];
    const int x = clampi((int)(clampf(u, 0.0f, 1.0f) * (float)w), 0, w - 1);
    const int y =
        clampi((int)((1.0f - clampf(v, 0.0f, 1.0f)) * (float)h), 0, h - 1);
    const float* t =
        a.img_data + 3 * (((size_t)ii * a.img_h + y) * a.img_w + x);
    out = Col{t[0], t[1], t[2]};
  } else if (ttype == TEX_NOISE && a.has_noise && allow_noise) {
    const float turb = perlin_turb(a, px, py, pz);
    const float m = 0.5f * (1.0f + sinf(scale * pz + 10.0f * turb));
    out = Col{m, m, m};
  }
  return out;
}

// The colour leaf that eval_texture's result is read from, for the adjoint
// (K6): 2*ti for c1 of texture row ti (solid, even checker cell, or a family
// whose evaluation is compiled out), 2*ti + 1 for c2 (odd checker cell),
// 2*n_tex + texel for an atlas texel (texel = (image*img_h + y)*img_w + x),
// or -1 for marble, which has no colour leaf.  Same branches as eval_texture.
__device__ __forceinline__ int texture_src(const WaveArgs& a, int tex_idx,
                                           float u, float v, float px,
                                           float py, float pz,
                                           bool allow_noise,
                                           bool allow_image) {
  const int ti = clampi(tex_idx, 0, a.n_tex - 1);
  const float* row = a.tex_tab + 9 * ti;
  const int ttype = (int)row[0];
  const float scale = row[7];
  if (ttype == TEX_CHECKER) {
    const float lat = floorf(scale * px) + floorf(scale * py) + floorf(scale * pz);
    return 2 * ti + (((int)lat & 1) != 0 ? 1 : 0);
  }
  if (ttype == TEX_IMAGE && a.has_image && allow_image) {
    const int ii = clampi((int)row[8], 0, a.n_img - 1);
    const int h = a.img_hw[2 * ii], w = a.img_hw[2 * ii + 1];
    const int x = clampi((int)(clampf(u, 0.0f, 1.0f) * (float)w), 0, w - 1);
    const int y =
        clampi((int)((1.0f - clampf(v, 0.0f, 1.0f)) * (float)h), 0, h - 1);
    return 2 * a.n_tex + (ii * a.img_h + y) * a.img_w + x;
  }
  if (ttype == TEX_NOISE && a.has_noise && allow_noise) return -1;
  return 2 * ti;
}
