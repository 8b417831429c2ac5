// Direction samplers of path_tracer_tpu/utils/rng.py on float components,
// in the operation order of the plain-torch twins (ops/shade_tiled.py
// _normalize_t, _unit_vector_t, _onb_t, _cosine_direction_t, _sample_hg_t,
// _direction_from_cos_t).
#pragma once

#include "common.cuh"

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxp(x * x + y * y + z * z, 1e-16f));
  x = x * inv; y = y * inv; z = z * inv;
}

__device__ __forceinline__ void unit_vector(float u0, float u1, float& x,
                                            float& y, float& z) {
  z = 1.0f - 2.0f * u0;
  const float r = sqrtf(fmaxp(1.0f - z * z, 0.0f));
  const float phi = TWO_PI_F * u1;
  x = r * cosf(phi);
  y = r * sinf(phi);
}

__device__ __forceinline__ bool near_zero(float x, float y, float z) {
  return fabsf(x) < 1e-8f && fabsf(y) < 1e-8f && fabsf(z) < 1e-8f;
}

// Orthonormal basis (u, v, w) with w along (nx, ny, nz) (vec.onb_from_w).
__device__ __forceinline__ void onb(float nx, float ny, float nz, float* u,
                                    float* v, float* w) {
  float wx = nx, wy = ny, wz = nz;
  normalize3(wx, wy, wz);
  const float use_y = fabsf(wx) > 0.9f ? 1.0f : 0.0f;
  const float ax = 1.0f - use_y, ay = use_y;
  float vx = wy * 0.0f - wz * ay, vy = wz * ax - wx * 0.0f,
        vz = wx * ay - wy * ax;
  normalize3(vx, vy, vz);
  u[0] = wy * vz - wz * vy;
  u[1] = wz * vx - wx * vz;
  u[2] = wx * vy - wy * vx;
  v[0] = vx; v[1] = vy; v[2] = vz;
  w[0] = wx; w[1] = wy; w[2] = wz;
}

__device__ __forceinline__ void cosine_direction(float u0, float u1, float nx,
                                                 float ny, float nz, float& x,
                                                 float& y, float& z) {
  const float r = sqrtf(u0);
  const float phi = TWO_PI_F * u1;
  const float lx = r * cosf(phi), ly = r * sinf(phi);
  const float lz = sqrtf(fmaxp(1.0f - u0, 0.0f));
  float u[3], v[3], w[3];
  onb(nx, ny, nz, u, v, w);
  x = lx * u[0] + ly * v[0] + lz * w[0];
  y = lx * u[1] + ly * v[1] + lz * w[1];
  z = lx * u[2] + ly * v[2] + lz * w[2];
}

// Henyey–Greenstein cos(theta) for asymmetry g (isotropic for |g| < 1e-3).
__device__ __forceinline__ float sample_hg(float u, float g) {
  const bool small = fabsf(g) < 1e-3f;
  const float sg = small ? 1e-3f : g;
  const float sq = (1.0f - sg * sg) / (1.0f - sg + 2.0f * sg * u);
  const float cos_hg = (1.0f + sg * sg - sq * sq) / (2.0f * sg);
  return clampf(small ? 1.0f - 2.0f * u : cos_hg, -1.0f, 1.0f);
}

// Direction at angle acos(cos_theta) from axis a, azimuth 2 pi u_phi.
__device__ __forceinline__ void direction_from_cos(float u_phi,
                                                   float cos_theta,
                                                   const float* a, float* out) {
  const float sin_theta =
      sqrtf(clampf(1.0f - cos_theta * cos_theta, 1e-12f, 1.0f));
  const float phi = TWO_PI_F * u_phi;
  float u[3], v[3], w[3];
  onb(a[0], a[1], a[2], u, v, w);
  const float sc = sin_theta * cosf(phi), ss = sin_theta * sinf(phi);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = sc * u[k] + ss * v[k] + cos_theta * w[k];
}
