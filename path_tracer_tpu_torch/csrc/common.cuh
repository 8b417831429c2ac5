// Shared definitions of the kernels (K1 trace_step, K2 spawn, K3 shade,
// K4 retire, K5 megakernel, K6 adjoint): the argument block every launcher takes, the
// constants mirrored from path_tracer_tpu_torch/ops/types.py, and float
// helpers with JAX's semantics (NaN-propagating min/max).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (see
// ops/kernels.py).  --fmad=false keeps a*b+c as two IEEE ops, so the
// kernels round exactly like the plain-torch twins they are checked against.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef PTT_HOST_EMULATION
#include <cuda_runtime.h>
#endif

// --- constants (ops/types.py) ---
#define PTT_DONE (-(1 << 30))
#define PTT_EMPTY_SLOT (1 << 23)
#define PTT_NODE_ROW 96
#define PTT_PTR_OFF 24
#define PTT_PAYLOAD 32
#define PTT_PRIM_ROW 16
#define PTT_INF 1e30f

#define PH_MAIN 0
#define PH_EXIT 1
#define FL_NONE 0
#define FL_FINISHED 1
#define FL_RESAMPLE 2

#define MAT_LAMBERTIAN 0
#define MAT_METAL 1
#define MAT_DIELECTRIC 2
#define MAT_EMISSIVE 3
#define MAT_ISOTROPIC 4
#define MAT_SSS_SIMPLE 5
#define MAT_SSS_VOLUMETRIC 6
#define TEX_CHECKER 1
#define TEX_IMAGE 2
#define TEX_NOISE 3

#define C_SPAWNED 0
#define C_DONE 1
#define C_RAYS 2
#define C_DEPTH_SUM 3
#define C_WAVES 4
#define C_CTRLS 5
#define C_OCC_SUM 6
#define C_TRAV_STEPS 7
#define C_EXEC_STEPS 8
#define C_N_READY 9
#define C_N_WALK 10
#define C_N_OCC 11
#define C_DO_CTRL 12
#define C_TICKET 13
#define C_STACK_OVF 14
#define C_WAVE_MAX 15
#define C_WALK_STEPS 16

// Everything a wave kernel reads or writes.  Mirrored field for field by
// ops/kernels.py:WaveArgs (ctypes); ptt_wave_args_layout() below exports
// every field's name and offset so the wrapper checks the two layouts agree
// field by field when it loads a kernel library.
struct WaveArgs {
  // per-slot state (R lanes)
  float* origin; float* direction; float* time; float* color;
  float* throughput; int* depth; int* iters; bool* alive;
  int* cur; int* stack; int* sp; float* best_t; int* best_pt; int* best_pi;
  int* phase; bool* hit_found; int* hit_pt; int* hit_pi; float* hit_t;
  int* pixel; int* sample; int* last; bool* occupied; int* flag;
  // frame and counters
  float* accum; int* pix_paths; int* depth_hist; long long* ctr;
  // scene tables (read-only)
  const float* nodes; const float* prims; const float* prim_tab;
  const float* mat_tab; const float* med_tab; const float* tex_tab;
  const float* img_data; const int* img_hw; const float* perlin_vec;
  const int* perlin_perm;
  // optional: spawn writes each renewed slot's 5 camera uniforms here
  float* u5_out;
  long long items_total;
  // sizes and knobs
  int R, sd, steps, ctrl_den, root, n_prims, n_sph, n_qd, n_prim_rows;
  int n_mat, n_med, n_tex, n_img, img_h, img_w;
  int prim_mask, has_medium, has_noise, has_image;
  int has_noise_emission, has_noise_medium, has_image_emission,
      has_image_medium;
  int width, max_depth, iters_cap, rr_min_depth, use_rr, sss_steps;
  int npix, stride, multi, start_sample, n_samples;
  unsigned int key0, key1;
  float rr_max_prob, t_min, t_max;
  float cam_origin[3], pixel00[3], du[3], dv[3], defocus_u[3], defocus_v[3];
  float defocus_angle, bg_color[3];
  int bg_type;
  // adjoint (K6): dL/d(image) per pixel (npix, 3), and the gradient buffers
  // of the colour leaves, (n_tex, 6) as tex_tab columns 1-6 and
  // (n_img * img_h * img_w, 3) as img_data
  const float* delta; float* g_tex; float* g_img;
};

// Every field of WaveArgs in declaration order.  A name missing from the
// struct fails to compile; a field missing here, or a ctypes field out of
// place, fails the wrapper's check.
#define PTT_WAVE_ARGS_FIELDS(X)                                              \
  X(origin) X(direction) X(time) X(color) X(throughput) X(depth) X(iters)    \
  X(alive) X(cur) X(stack) X(sp) X(best_t) X(best_pt) X(best_pi) X(phase)    \
  X(hit_found) X(hit_pt) X(hit_pi) X(hit_t) X(pixel) X(sample) X(last)       \
  X(occupied) X(flag) X(accum) X(pix_paths) X(depth_hist) X(ctr) X(nodes)    \
  X(prims) X(prim_tab) X(mat_tab) X(med_tab) X(tex_tab) X(img_data)          \
  X(img_hw) X(perlin_vec) X(perlin_perm) X(u5_out) X(items_total) X(R)       \
  X(sd) X(steps) X(ctrl_den) X(root) X(n_prims) X(n_sph) X(n_qd)             \
  X(n_prim_rows) X(n_mat) X(n_med) X(n_tex) X(n_img) X(img_h) X(img_w)       \
  X(prim_mask) X(has_medium) X(has_noise) X(has_image)                       \
  X(has_noise_emission) X(has_noise_medium) X(has_image_emission)            \
  X(has_image_medium) X(width) X(max_depth) X(iters_cap) X(rr_min_depth)     \
  X(use_rr) X(sss_steps) X(npix) X(stride) X(multi) X(start_sample) X(n_samples) X(key0)  \
  X(key1) X(rr_max_prob) X(t_min) X(t_max) X(cam_origin) X(pixel00) X(du)    \
  X(dv) X(defocus_u) X(defocus_v) X(defocus_angle) X(bg_color) X(bg_type)   \
  X(delta) X(g_tex) X(g_img)

// Fills names[k], offsets[k] for each field when the arrays are given;
// returns the number of fields.  Each kernel library exports its own copy.
extern "C" int ptt_wave_args_layout(const char** names, long long* offsets) {
#define PTT_FIELD_NAME(f) #f,
#define PTT_FIELD_OFFSET(f) (long long)offsetof(WaveArgs, f),
  static const char* const kNames[] = {PTT_WAVE_ARGS_FIELDS(PTT_FIELD_NAME)};
  static const long long kOffsets[] = {PTT_WAVE_ARGS_FIELDS(PTT_FIELD_OFFSET)};
#undef PTT_FIELD_NAME
#undef PTT_FIELD_OFFSET
  const int n = (int)(sizeof(kOffsets) / sizeof(kOffsets[0]));
  for (int k = 0; names != nullptr && k < n; ++k) {
    names[k] = kNames[k];
    offsets[k] = kOffsets[k];
  }
  return n;
}

extern "C" int ptt_wave_args_size() { return (int)sizeof(WaveArgs); }

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN.
__device__ __forceinline__ float fmaxp(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a > b ? a : b);
}
__device__ __forceinline__ float fminp(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a < b ? a : b);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminp(fmaxp(x, lo), hi);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float bits_as_float(uint32_t b) {
#ifdef PTT_HOST_EMULATION
  float f;
  memcpy(&f, &b, sizeof(f));
  return f;
#else
  return __uint_as_float(b);
#endif
}

// f32 roundings of the constants the JAX code spells as Python doubles.
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f
