// BVH closest-hit traversal shared by K1 (trace_step, the suspended walk of
// the wavefront) and the per-ray walks to completion of K5 (megakernel), K6
// (adjoint), K7 (closest_hit) and K9 (ring_hop), for BVH4 and BVH8 rows.
//
// One step, term for term as path_tracer_tpu/ops/traverse.py
// traversal_step (:183) / _step_tiled (:334), templated on the node width K
// (PackedBVH.branching): one node row (96 floats at K = 4, 184 at K = 8),
// K slab tests, inline tests of leaf children from their embedded 16-float
// rows, the front-to-back compare-swap network of _SORT_NET[K] (:43-50; 5
// comparators at K = 4, 19 at K = 8, in JAX's order, swapping on a strict
// >), pushes of the far interior children K-1 .. 1 and descent into the
// nearest.  A push at a full stack is dropped exactly as in the JAX step
// and counted.  The query start (traversal_init, :164 / :280) resolves the
// single-prim root-leaf case and does not depend on K.
#pragma once

#include "intersect.cuh"

// Per-query constants of one ray.
struct TravRay {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, rr, time, t_min;
};

__device__ __forceinline__ TravRay trav_ray(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float time, float t_min) {
  return TravRay{ox, oy, oz, dx, dy, dz, 1.0f / dx, 1.0f / dy, 1.0f / dz,
                 dx * dx + dy * dy + dz * dz, time, t_min};
}

__device__ __forceinline__ void cswap(float* ct, int* cp, int x, int y) {
  if (ct[x] > ct[y]) {
    const float tt = ct[x]; ct[x] = ct[y]; ct[y] = tt;
    const int pp = cp[x]; cp[x] = cp[y]; cp[y] = pp;
  }
}

// The compare-swap network of _SORT_NET[K]: ascending t, invalid children
// (t = PTT_INF) last; ties keep their order as in JAX (swap on a strict >).
template <int K>
__device__ __forceinline__ void sort_children(float* ct, int* cp) {
  if constexpr (K == 4) {
    const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
    for (int k = 0; k < 5; ++k) cswap(ct, cp, net[k][0], net[k][1]);
  } else {
    const int net[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7},
                            {0, 2}, {1, 3}, {4, 6}, {5, 7},
                            {1, 2}, {5, 6}, {0, 4}, {3, 7},
                            {1, 5}, {2, 6}, {1, 4}, {3, 6},
                            {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
    for (int k = 0; k < 19; ++k) cswap(ct, cp, net[k][0], net[k][1]);
  }
}

// One step from node `cur` of a K-wide BVH; `stack` holds `sd` entries.
template <int K>
__device__ __forceinline__ void trav_step(const WaveArgs& a, const TravRay& r,
                                          int& cur, int* stack, int& sp,
                                          float& best_t, int& best_pt,
                                          int& best_pi, int& ovf) {
  using L = NodeLayout<K>;
  const float* row = a.nodes + (size_t)cur * L::row;
  float ct[K];
  int cp[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int ptr = (int)row[L::ptr + c];
    float tn;
    bool hi = hit_aabb(row + 6 * c, r.ox, r.oy, r.oz, r.ivx, r.ivy, r.ivz,
                       r.t_min, best_t, tn);
    hi = hi && ptr < PTT_EMPTY_SLOT;
    const bool is_leaf = ptr < 0;
    if (hi && is_leaf) {
      const float* pr = row + L::pay + PTT_PRIM_ROW * c;
      float lt;
      if (hit_prim_row(pr, a.prim_mask, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                       r.rr, r.time, r.t_min, best_t, lt) && lt < best_t) {
        best_t = lt;
        best_pt = (int)pr[0];
        best_pi = (int)pr[1];
      }
    }
    ct[c] = (hi && !is_leaf) ? tn : PTT_INF;
    cp[c] = ptr;
  }
  sort_children<K>(ct, cp);
#pragma unroll
  for (int k = K - 1; k >= 1; --k) {
    if (ct[k] < PTT_INF) {
      if (sp < a.sd) stack[sp] = cp[k]; else ++ovf;
      sp = sp + 1 < a.sd ? sp + 1 : a.sd;
    }
  }
  if (ct[0] < PTT_INF) {
    cur = cp[0];
  } else if (sp > 0) {
    cur = stack[sp - 1];
    --sp;
  } else {
    cur = PTT_DONE;
  }
}

// trav_step term for term, with the node row read in 16-byte loads through
// the read-only cache and the child loop over pairs of children: a pair's
// two boxes are 12 floats, three aligned float4s at K = 4 and K = 8 (rows
// of 96 and 184 floats, boxes from 0, NodeLayout), its two pointers half
// of one float4, a hit leaf child's 16-float payload four.  Each pair
// tests its two children in order (slab test, then the leaf test against
// the best_t the earlier children left) and shifts their (t, pointer) into
// the last two places of ct / cp, so that after the K / 2 pairs the
// children stand in order in registers for the compare-swap network.  With
// kRolled the pair loop stays a loop: the walk holds one copy of the pair's
// code (two inline leaf tests) instead of K (K5, whose two walks and bounce
// outgrow the instruction cache otherwise); K7 runs it unrolled.
template <int K, bool kRolled = true>
__device__ __forceinline__ void trav_step16(const WaveArgs& a,
                                            const TravRay& r, int& cur,
                                            int* stack, int& sp, float& best_t,
                                            int& best_pt, int& best_pi,
                                            int& ovf) {
  using L = NodeLayout<K>;
  const float4* row4 =
      reinterpret_cast<const float4*>(a.nodes + (size_t)cur * L::row);
  float ct[K];
  int cp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ct[k] = PTT_INF;
    cp[k] = 0;
  }
#pragma unroll(kRolled ? 1 : K / 2)
  for (int q = 0; q < K / 2; ++q) {
    const float4 b0 = ldg4(row4 + 3 * q), b1 = ldg4(row4 + 3 * q + 1),
                 b2 = ldg4(row4 + 3 * q + 2);
    const float4 pq = ldg4(row4 + L::ptr / 4 + q / 2);
    const float box[12] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y,
                           b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
    const int ptr[2] = {(int)((q & 1) ? pq.z : pq.x),
                        (int)((q & 1) ? pq.w : pq.y)};
    float tq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tn;
      bool hi = hit_aabb(box + 6 * h, r.ox, r.oy, r.oz, r.ivx, r.ivy, r.ivz,
                         r.t_min, best_t, tn);
      hi = hi && ptr[h] < PTT_EMPTY_SLOT;
      const bool is_leaf = ptr[h] < 0;
      if (hi && is_leaf) {
        const float4* p4 = row4 + L::pay / 4 + 4 * (2 * q + h);
        const float4 p0 = ldg4(p4), p1 = ldg4(p4 + 1), p2 = ldg4(p4 + 2),
                     p3 = ldg4(p4 + 3);
        const float pr[16] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                              p2.x, p2.y, p2.z, p2.w, p3.x, p3.y, p3.z, p3.w};
        float lt;
        if (hit_prim_row(pr, a.prim_mask, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                         r.rr, r.time, r.t_min, best_t, lt) && lt < best_t) {
          best_t = lt;
          best_pt = (int)pr[0];
          best_pi = (int)pr[1];
        }
      }
      tq[h] = (hi && !is_leaf) ? tn : PTT_INF;
    }
#pragma unroll
    for (int k = 0; k + 2 < K; ++k) {
      ct[k] = ct[k + 2];
      cp[k] = cp[k + 2];
    }
    ct[K - 2] = tq[0];
    ct[K - 1] = tq[1];
    cp[K - 2] = ptr[0];
    cp[K - 1] = ptr[1];
  }
  sort_children<K>(ct, cp);
#pragma unroll
  for (int k = K - 1; k >= 1; --k) {
    if (ct[k] < PTT_INF) {
      if (sp < a.sd) stack[sp] = cp[k]; else ++ovf;
      sp = sp + 1 < a.sd ? sp + 1 : a.sd;
    }
  }
  if (ct[0] < PTT_INF) {
    cur = cp[0];
  } else if (sp > 0) {
    cur = stack[sp - 1];
    --sp;
  } else {
    cur = PTT_DONE;
  }
}

// Start a closest-hit query from (o, d, time) over (t_min, t_max): the
// first node, or PTT_DONE with the root leaf already tested.
__device__ __forceinline__ void trav_start(const WaveArgs& a, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float time,
                                           float t_min, float t_max, int& cur,
                                           float& best_t, int& best_pt,
                                           int& best_pi) {
  best_t = t_max;
  best_pt = -1;
  best_pi = -1;
  cur = a.root;
  if (a.root < 0) {
    const int uid = clampi(-a.root - 1, 0, a.n_prims - 1);
    const float* row = a.prims + (size_t)uid * PTT_PRIM_ROW;
    const float rr = dx * dx + dy * dy + dz * dz;
    float lt;
    if (hit_prim_row(row, a.prim_mask, ox, oy, oz, dx, dy, dz, rr, time,
                     t_min, best_t, lt) && lt < best_t) {
      best_t = lt;
      best_pt = (int)row[0];
      best_pi = (int)row[1];
    }
    cur = PTT_DONE;
  }
}

// trav_start for wavefront slot i (K2, K3).  The stack is not cleared:
// entries above sp are never read.
__device__ __forceinline__ void trav_init(const WaveArgs& a, int i, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float time,
                                          float t_min) {
  int cur, best_pt, best_pi;
  float best_t;
  trav_start(a, ox, oy, oz, dx, dy, dz, time, t_min, a.t_max, cur, best_t,
             best_pt, best_pi);
  a.cur[i] = cur;
  a.sp[i] = 0;
  a.best_t[i] = best_t;
  a.best_pt[i] = best_pt;
  a.best_pi[i] = best_pi;
}
