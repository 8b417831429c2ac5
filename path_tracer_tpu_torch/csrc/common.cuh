// Shared definitions of the kernels (K1 trace_step, K2 spawn, K3 shade,
// K4 retire, K5 megakernel, K6 adjoint, K7 closest_hit, K8 tiled_trip, K9
// ring_hop): the argument block every launcher takes, the
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
#define PTT_PRIM_ROW 16
#define PTT_INF 1e30f
#define PTT_FULL_WARP 0xffffffffu
// Per-thread arrays of the walking kernels (K5, K6, K7, K9) kept in local
// memory up to these sizes; beyond them a launch takes the instantiation
// whose arrays live in the wrapper's per-lane buffers (WaveArgs stack, tape,
// walk).
#define PTT_MEGA_STACK 64
#define PTT_TAPE_MAX 64
#define PTT_WALK_MAX 64

// Node-row layout of a K-wide BVH (ops/types.py bvh_layout): K boxes
// [0, 6K), K child pointers from `ptr`, K embedded 16-float leaf payloads
// from `pay` (7K rounded up to a multiple of 8); `row` floats in all.
// K = 4: 24 / 32 / 96; K = 8: 48 / 56 / 184.
template <int K>
struct NodeLayout {
  static_assert(K == 4 || K == 8, "BVH4 or BVH8 rows");
  static constexpr int ptr = 6 * K;
  static constexpr int pay = (7 * K + 7) / 8 * 8;
  static constexpr int row = pay + PTT_PRIM_ROW * K;
};

// Floats per hit record of the pipeline mode: t, p(3), n(3), front, u, v,
// mat, medium (ops/integrator_tiled.py REC_FIELDS).
#define PTT_REC 12

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
#define C_N_ACT_END 13
#define C_STACK_OVF 14
#define C_N_ACT_END_B 15
#define C_WALK_STEPS 16
#define C_N_READY_B 17
#define C_N_WALK_B 18
#define C_TICKET 19
#define C_FETCH 20
#define PTT_N_COUNTERS 21  // the counter vector's length (N_COUNTERS)

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
  int R, sd, branching, steps, chunk, exit_den, ctrl_den, root, n_prims,
      n_sph, n_qd, n_prim_rows;
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
  // in the layout of the tables they differentiate: g_tex (n_tex, 9) as
  // tex_tab, g_img (n_img * img_h * img_w, 3) as img_data, g_prim
  // (n_prim_rows, 18) as prim_tab, g_mat (n_mat, 8) as mat_tab, g_med
  // (n_med, 2) as med_tab and g_perlin (256, 4) as perlin_vec (the colour
  // instantiation writes only g_tex and g_img)
  const float* delta; float* g_tex; float* g_img;
  float* g_prim; float* g_mat; float* g_med; float* g_perlin;
  // tiled engine (K7, K8, K9): per-lane query start (null: t_min) and mask
  // (null: every lane); the exit query's result; an override of the exit
  // hit's medium flag (null: K8 looks it up from exit_pt/exit_pi); the
  // (R, PTT_REC) hit records of the pipeline mode (K9 writes, K8's rec
  // variant reads)
  const float* q_tmin; const bool* q_active;
  const bool* exit_found; const int* exit_pt; const int* exit_pi;
  const float* exit_t; const bool* exit_med; float* rec;
  // first frame pixel of a pixel block (K2, K4, K5, K6; npix is its size)
  int pix_offset;
  // start_sample in device memory (null: start_sample): the tiled kernels'
  // sample and K2's first sample, so that one captured trip graph replays
  // every sample and one wave loop graph every batch
  const int* sample_dev;
  // per-lane buffers of the walking kernels' arrays beyond the local sizes
  // above (null when the launch fits them): the walk's stack is `stack`
  // (R x sd ints, as K1's); K6's trip record (npix x iters_cap entries of
  // TapeEntry or TripIn, adjoint.cu) and SSS walk record (npix x sss_steps
  // x 4 floats, sss_adj.cuh)
  void* tape; float* walk;
  // K7's volume-exit launch: the main query's hit per lane (null: none); a
  // lane walks only where that hit's primitive has a medium (prim_tab,
  // n_sph, n_qd, n_prim_rows then point at the shade table)
  const int* gate_pt; const int* gate_pi;
  // the device wave loop (csrc/wave_loop.cu): the condition handle of its
  // WHILE node (cudaGraphConditionalHandle), which K1 clears where
  // loop_graph is 1 (K1 captured into the loop's graph; 0 for a K1 launched
  // from the host), and the wave bound (<= 0: none).  The g++ build writes
  // the condition's value into h_while instead.
  mutable unsigned long long h_while;
  long long max_waves;
  int loop_graph;
  // K8's live lists (null: K8 runs every lane): two lists of R lane
  // indices and live_n = {count of list 0, count of list 1, ticket}; a trip
  // runs the lanes of list live_parity and appends the lanes that stay
  // alive to the other list (tiled_trip.cu)
  int* live; int* live_n; int live_parity;
  // the frame's base key and camera in card memory (null: key0, key1 and
  // cam_origin .. defocus_angle above): PTT_FRAME_WORDS words, key0, key1,
  // then those 19 floats' bits, which tiled_spawn and K8 read, so that a
  // kept trip graph renders a new key or view without a new capture
  const unsigned int* frame_dev;
  // K2's spawn order (null: the identity): a work item's block pixel p
  // (id % npix) spawns block pixel spawn_order[p], a permutation of
  // [0, npix) (wavefront.tile_spawn_order)
  const int* spawn_order;
};

#define PTT_FRAME_WORDS 21

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
  X(sd) X(branching) X(steps) X(chunk) X(exit_den) X(ctrl_den) X(root) X(n_prims)         \
  X(n_sph) X(n_qd) X(n_prim_rows) X(n_mat) X(n_med) X(n_tex) X(n_img)        \
  X(img_h) X(img_w)                                                          \
  X(prim_mask) X(has_medium) X(has_noise) X(has_image)                       \
  X(has_noise_emission) X(has_noise_medium) X(has_image_emission)            \
  X(has_image_medium) X(width) X(max_depth) X(iters_cap) X(rr_min_depth)     \
  X(use_rr) X(sss_steps) X(npix) X(stride) X(multi) X(start_sample) X(n_samples) X(key0)  \
  X(key1) X(rr_max_prob) X(t_min) X(t_max) X(cam_origin) X(pixel00) X(du)    \
  X(dv) X(defocus_u) X(defocus_v) X(defocus_angle) X(bg_color) X(bg_type)   \
  X(delta) X(g_tex) X(g_img) X(g_prim) X(g_mat) X(g_med) X(g_perlin)        \
  X(q_tmin) X(q_active) X(exit_found) X(exit_pt) X(exit_pi) X(exit_t)        \
  X(exit_med) X(rec) X(pix_offset) X(sample_dev) X(tape) X(walk)            \
  X(gate_pt) X(gate_pi) X(h_while) X(max_waves) X(loop_graph)      \
  X(live) X(live_n) X(live_parity) X(frame_dev) X(spawn_order)

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

// A 16-byte load of read-only data (the node table), through the
// read-only data cache on the card.
#ifdef PTT_HOST_EMULATION
struct alignas(16) float4 {
  float x, y, z, w;
};
#endif
__device__ __forceinline__ float4 ldg4(const float4* p) {
#ifdef PTT_HOST_EMULATION
  return *p;
#else
  return __ldg(p);
#endif
}

// f32 roundings of the constants the JAX code spells as Python doubles.
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f
