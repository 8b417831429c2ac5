// Camera rays and the background, shared by K2 (spawn), K3 (shade) and K5
// (megakernel).  Device copy of path_tracer_tpu_torch/ops/camera.py:
// get_rays_t (path_tracer_tpu/ops/camera.py get_ray, :17) on the uniforms
// uniform(fold_in(key_p, 7), (5,)) with key_p = fold(fold(base, sample),
// pixel), the direction normalised as _init_state does (integrator.py:245),
// and background_t (camera.py background_color, :34).
#pragma once

#include "threefry.cuh"

// key_p = fold_in(fold_in(base, sample), pixel), the key of one path.
__device__ __forceinline__ Key path_key(const WaveArgs& a, int smp, int pix) {
  return fold_in(fold_in(Key{a.key0, a.key1}, (uint32_t)smp), (uint32_t)pix);
}

// Primary ray of pixel pix with path key key_p from the camera of c (the
// argument block, or any struct with its camera fields and width): origin
// o, unit direction d, time; the five camera uniforms are written to u5.
template <class C>
__device__ __forceinline__ void camera_ray(const C& c, Key key_p, int pix,
                                           float* o, float* d, float& time,
                                           float* u5) {
  const Key k7 = fold_in(key_p, 7u);
#pragma unroll
  for (int k = 0; k < 5; ++k) u5[k] = uniform_at(k7, (uint32_t)k);
  const float px = (float)(pix % c.width), py = (float)(pix / c.width);
  const float sx = px + u5[0] - 0.5f, sy = py + u5[1] - 0.5f;
  float sm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sm[k] = c.pixel00[k] + sx * c.du[k] + sy * c.dv[k];
  const float r = sqrtf(u5[2]);
  const float phi = TWO_PI_F * u5[3];
  const float kx = r * cosf(phi), ky = r * sinf(phi);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = c.defocus_angle <= 0.0f
               ? c.cam_origin[k]
               : c.cam_origin[k] + kx * c.defocus_u[k] + ky * c.defocus_v[k];
    d[k] = sm[k] - o[k];
  }
  const float ninv =
      1.0f / sqrtf(fmaxp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-16f));
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = d[k] * ninv;
  time = u5[4];
}

// The same from the argument block's camera (K2, K3, K5).
__device__ __forceinline__ void primary_ray(const WaveArgs& a, Key key_p,
                                            int pix, float* o, float* d,
                                            float& time, float* u5) {
  camera_ray(a, key_p, pix, o, d, time, u5);
}

// Background radiance seen along direction (dx, dy, dz).
__device__ __forceinline__ void background(const WaveArgs& a, float dx,
                                           float dy, float dz, float* bg) {
  const float n = fmaxp(sqrtf(dx * dx + dy * dy + dz * dz), 1e-12f);
  const float av = 0.5f * (dy / n + 1.0f);
  const bool grad = a.bg_type == 1;
  bg[0] = grad ? (1.0f - av) + av * 0.5f : a.bg_color[0];
  bg[1] = grad ? (1.0f - av) + av * 0.7f : a.bg_color[1];
  bg[2] = grad ? (1.0f - av) + av * 1.0f : a.bg_color[2];
}
