// Ray-primitive tests of the traversal hot path, term for term as
// path_tracer_tpu/ops/intersect.py hit_aabb_s (:166) and hit_prim_row_s
// (:184).
#pragma once

#include "common.cuh"

// Slab test of one child box (6 floats: min xyz, max xyz) → hit, t_near.
__device__ __forceinline__ bool hit_aabb(const float* b, float ox, float oy,
                                         float oz, float ivx, float ivy,
                                         float ivz, float t_min, float t_max,
                                         float& tn) {
  const float tx0 = (b[0] - ox) * ivx, tx1 = (b[3] - ox) * ivx;
  const float ty0 = (b[1] - oy) * ivy, ty1 = (b[4] - oy) * ivy;
  const float tz0 = (b[2] - oz) * ivz, tz1 = (b[5] - oz) * ivz;
  tn = fmaxp(fmaxp(fminp(tx0, tx1), fminp(ty0, ty1)),
             fmaxp(fminp(tz0, tz1), t_min));
  const float tf = fminp(fminp(fmaxp(tx0, tx1), fmaxp(ty0, ty1)),
                         fminp(fmaxp(tz0, tz1), t_max));
  return tn <= tf;
}

// Packed 16-float leaf row (types.PackedBVH): sphere [c0, c1-c0, r^2],
// quad [n, A, B, d, A.Q, B.Q], triangle [v0, e1, e2].  prim_mask bit f says
// family f exists in the scene; a row of an absent family takes the last
// present family, as the JAX select chain does.
__device__ __forceinline__ bool hit_prim_row(const float* r, int prim_mask,
                                             float rox, float roy, float roz,
                                             float rdx, float rdy, float rdz,
                                             float rr, float time,
                                             float t_min, float t_max,
                                             float& t) {
  const float ptype = r[0];
  int fam = ptype < 0.5f ? 0 : (ptype < 1.5f ? 1 : 2);
  if (!((prim_mask >> fam) & 1)) {
    fam = (prim_mask & 4) ? 2 : ((prim_mask & 2) ? 1 : 0);
    if (!prim_mask) { t = t_max; return false; }
  }
  const float a0 = r[2], a1 = r[3], a2 = r[4];
  const float b0 = r[5], b1 = r[6], b2 = r[7];
  const float c0 = r[8], c1 = r[9], c2 = r[10];
  if (fam == 0) {
    const float cx = a0 + b0 * time, cy = a1 + b1 * time, cz = a2 + b2 * time;
    const float ocx = cx - rox, ocy = cy - roy, ocz = cz - roz;
    const float h = rdx * ocx + rdy * ocy + rdz * ocz;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c0;
    const float disc = h * h - rr * cc;
    const float sq = sqrtf(fmaxp(disc, 1e-12f));
    const float root0 = (h - sq) / rr;
    const float root1 = (h + sq) / rr;
    const bool in0 = (root0 > t_min) && (root0 < t_max);
    const bool in1 = (root1 > t_min) && (root1 < t_max);
    t = in0 ? root0 : root1;
    return (disc > 0.0f) && (in0 || in1);
  }
  if (fam == 1) {
    const float denom = a0 * rdx + a1 * rdy + a2 * rdz;
    const bool parallel = denom * denom < 1e-16f * rr;
    const float tq = (r[11] - (a0 * rox + a1 * roy + a2 * roz)) /
                     (parallel ? 1.0f : denom);
    const float alpha = ((b0 * rox + b1 * roy + b2 * roz) - r[12]) +
                        tq * (b0 * rdx + b1 * rdy + b2 * rdz);
    const float beta = ((c0 * rox + c1 * roy + c2 * roz) - r[13]) +
                       tq * (c0 * rdx + c1 * rdy + c2 * rdz);
    const bool interior =
        (alpha >= 0.0f) && (alpha <= 1.0f) && (beta >= 0.0f) && (beta <= 1.0f);
    t = tq;
    return !parallel && (tq > t_min) && (tq < t_max) && interior;
  }
  const float pvx = rdy * c2 - rdz * c1;
  const float pvy = rdz * c0 - rdx * c2;
  const float pvz = rdx * c1 - rdy * c0;
  const float det = b0 * pvx + b1 * pvy + b2 * pvz;
  const bool par = fabsf(det) < 1e-9f;
  const float inv_det = 1.0f / (par ? 1.0f : det);
  const float tvx = rox - a0, tvy = roy - a1, tvz = roz - a2;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * b2 - tvz * b1;
  const float qvy = tvz * b0 - tvx * b2;
  const float qvz = tvx * b1 - tvy * b0;
  const float vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
  t = (c0 * qvx + c1 * qvy + c2 * qvz) * inv_det;
  return !par && (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= 1.0f) &&
         (t > t_min) && (t < t_max);
}
