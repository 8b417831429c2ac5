// K3 shade: the shading half of the wavefront control step.
//
// Replaces, for one slot per thread, path_tracer_tpu/ops/wavefront.py
// control (:268-335) with what it calls: prim_medium_front_t
// (shade_tiled.py:145, the PH_MAIN -> PH_EXIT volume-exit transition, B9),
// wave_rng (:701, B2), bounce_shade_t (:773, B4; bounce.cuh) with the
// textures of B5 (texture.cuh) and the SSS walk of B6 (sss.cuh), and the
// restart of continuing paths (traversal init).  Finished paths get
// FL_FINISHED for K4; the walking trips of the SSS walk are added to
// ctr[C_WALK_STEPS].
//
// Bound: per shaded lane a few hundred flops of transcendental-heavy math
// plus ~4 scattered row reads (prim, material, texture, atlas/Perlin rows);
// only the ready lanes (a fraction of the pool each control wave) do work,
// so the kernel is bound by divergence and gather latency, not by bytes.
// An SSS-volumetric lane walks up to sss_steps trips while its warp waits.
#include "bounce.cuh"
#include "traverse.cuh"

__device__ __forceinline__ void shade_lane(const WaveArgs& a, int i) {
  if (!a.occupied[i] || a.cur[i] != PTT_DONE) return;
  const float ox = a.origin[3 * i], oy = a.origin[3 * i + 1],
              oz = a.origin[3 * i + 2];
  const float dx = a.direction[3 * i], dy = a.direction[3 * i + 1],
              dz = a.direction[3 * i + 2];
  const float time = a.time[i];
  const float best_t = a.best_t[i];
  const int best_pt = a.best_pt[i], best_pi = a.best_pi[i];

  // --- volume phase transition (B9) ---
  bool found, exit_found = false, exit_is_medium = false;
  int r_pt, r_pi;
  const float t_exit = best_t;
  if (a.has_medium) {
    const float* row = prim_row(a, best_pt, best_pi);
    const int medium = best_pt >= 0 ? (int)row[1] : -1;
    if (a.phase[i] == PH_MAIN) {
      const float px = ox + best_t * dx, py = oy + best_t * dy,
                  pz = oz + best_t * dz;
      const float cx = row[2] + (row[5] - row[2]) * time;
      const float cy = row[3] + (row[6] - row[3]) * time;
      const float cz = row[4] + (row[7] - row[4]) * time;
      const bool is_s = best_pt == 0;
      const float nx = is_s ? px - cx : row[11];
      const float ny = is_s ? py - cy : row[12];
      const float nz = is_s ? pz - cz : row[13];
      const bool front = dx * nx + dy * ny + dz * nz < 0.0f;
      const bool m_found = best_pt >= 0;
      a.hit_found[i] = m_found;
      a.hit_pt[i] = best_pt;
      a.hit_pi[i] = best_pi;
      a.hit_t[i] = best_t;
      if (m_found && medium >= 0 && front) {
        a.phase[i] = PH_EXIT;
        trav_init(a, i, ox, oy, oz, dx, dy, dz, time, best_t + 1e-4f);
        return;
      }
      found = m_found; r_pt = best_pt; r_pi = best_pi;
    } else {
      exit_found = best_pt >= 0;
      exit_is_medium = medium >= 0;
      found = a.hit_found[i]; r_pt = a.hit_pt[i]; r_pi = a.hit_pi[i];
    }
  } else {
    found = best_pt >= 0; r_pt = best_pt; r_pi = best_pi;
  }

  // --- the bounce; uniforms fold base -> sample -> pixel -> iters ---
  PathRegs p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.o[k] = a.origin[3 * i + k];
    p.d[k] = a.direction[3 * i + k];
    p.col[k] = a.color[3 * i + k];
    p.thr[k] = a.throughput[3 * i + k];
  }
  p.time = time;
  p.depth = a.depth[i];
  p.iters = a.iters[i];
  p.alive = a.alive[i];
  const Key kit = fold_in(fold_in(fold_in(Key{a.key0, a.key1},
                                          (uint32_t)a.sample[i]),
                                  (uint32_t)a.pixel[i]),
                          (uint32_t)p.iters);
  const int trips = bounce(a, p, found, r_pt, r_pi, exit_found, t_exit,
                           exit_is_medium, kit);
  if (trips) {
    atomicAdd((unsigned long long*)a.ctr + C_WALK_STEPS,
              (unsigned long long)trips);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.origin[3 * i + k] = p.o[k];
    a.direction[3 * i + k] = p.d[k];
    a.color[3 * i + k] = p.col[k];
    a.throughput[3 * i + k] = p.thr[k];
  }
  a.depth[i] = p.depth;
  a.iters[i] = p.iters;
  a.alive[i] = p.alive;
  if (p.alive && p.iters < a.iters_cap) {
    trav_init(a, i, p.o[0], p.o[1], p.o[2], p.d[0], p.d[1], p.d[2], time,
              a.t_min);
    a.phase[i] = PH_MAIN;
  } else {
    a.flag[i] = FL_FINISHED;
  }
}

#ifndef PTT_HOST_EMULATION
__global__ void shade_kernel(WaveArgs a) {
  if (a.ctr[C_DO_CTRL] == 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.R) shade_lane(a, i);
}

extern "C" int ptt_launch_shade(const WaveArgs* a, void* stream) {
  const int block = 128;
  const int grid = (a->R + block - 1) / block;
  shade_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
#endif
