// K6 adjoint: the gradient of one sample of every pixel with respect to the
// scene's colour leaves (tex_c1, tex_c2, img_data), contracted with
// delta = dL/d(image).
//
// Replaces the backward that jax.grad takes through
// path_tracer_tpu/ops/integrator.py trace_ray_scan (:268) and the backward
// wavefront (ops/wavefront.py:520 render_batch_diff): the transpose of the
// bounce (B4, shade_tiled.py:773) with its textures (B5) and SSS walk (B6)
// for the colour leaves.  Those enter a path linearly: with thr_j the
// throughput before trip j, E_j its emission or background term, a_j its
// attenuation (a texture colour c, c^(n+1) after the SSS walk's n kept
// trips, 1 when the trip does not scatter) and b_j the roulette boost (a
// constant, as under JAX's stop_gradient), the radiance is
// C = sum_j thr_j E_j with thr_{j+1} = thr_j a_j b_j.  So, with
// R_j = E_j + a_j b_j R_{j+1}:
//   dC/dE_j = thr_j,   dC/dc_j = thr_j b_j R_{j+1} m c^(m-1).
// Visibility, coins and directions do not depend on a colour, so the path
// is the forward's.
//
// One thread per pixel, one launch per sample, as K5: the thread replays
// its path with K5's code (path.cuh, bounce.cuh with a recorder) and the
// same key folds, recording one tape entry per trip in local memory (at
// most iters_cap <= PTT_TAPE_MAX), then sweeps the tape in reverse.  No
// division by a colour that may be 0 is needed.
//
// Contributions go to the block's copy of the gradient tables in shared
// memory where they fit (a Cornell frame has four texture rows: 640,000
// threads would otherwise add into the same 12 floats; the 8x8 atlas fits
// too), then one atomicAdd per non-zero entry per block; larger tables take
// global atomics.  Float add order therefore differs from the plain
// version's and from run to run: comparisons use a tolerance.
//
// Bound: the replay is K5's work (dependent node-row gathers and
// divergence, ~220 fp32 ops per traversal step, ~1,920 per bounce); the
// sweep adds a few dozen ops per trip.  The tape adds to K6's stack frame,
// not to K5's.
#include "path.cuh"

#define PTT_TAPE_MAX 64
#define PTT_ADJ_SMEM_FLOATS 12288   // 48 KB of shared gradient table

struct TapeEntry {
  float thr[3], e[3], c[3];
  float boost;
  int src_e, src_a, m;
};

// The recorder bounce() reports to (bounce.cuh).
struct Tape {
  static constexpr bool kOn = true;
  TapeEntry* t;
  int n;
  __device__ __forceinline__ void begin(const float* thr) {
    TapeEntry& e = t[n];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e.thr[k] = thr[k];
      e.e[k] = 0.0f;
      e.c[k] = 1.0f;
    }
    e.boost = 1.0f;
    e.src_e = e.src_a = -1;
    e.m = 1;
  }
  __device__ __forceinline__ void albedo(int src, Col c) {
    TapeEntry& e = t[n];
    e.src_a = src;
    e.c[0] = c.r; e.c[1] = c.g; e.c[2] = c.b;
  }
  __device__ __forceinline__ void exponent(int m) { t[n].m = m; }
  __device__ __forceinline__ void emission_src(int src) { t[n].src_e = src; }
  __device__ __forceinline__ void emission(const float* e) {
#pragma unroll
    for (int k = 0; k < 3; ++k) t[n].e[k] = e[k];
  }
  __device__ __forceinline__ void not_scattered() {
    TapeEntry& e = t[n];
    e.src_a = -1;
    e.c[0] = e.c[1] = e.c[2] = 1.0f;
    e.m = 1;
  }
  __device__ __forceinline__ void boost(float b) { t[n].boost = b; }
  __device__ __forceinline__ void end() { ++n; }
};

// c^m by repeated multiplication, in the walk's order (1 * c * c ...).
__device__ __forceinline__ float pow_int(float c, int m) {
  float p = 1.0f;
  for (int i = 0; i < m; ++i) p = p * c;
  return p;
}

// Offset of component k of leaf `src` (texture_src) in g_tex (n_tex x 6)
// or, with `in_img` set, in g_img (texels x 3).
__device__ __forceinline__ int grad_offset(const WaveArgs& a, int src, int k,
                                           bool& in_img) {
  in_img = src >= 2 * a.n_tex;
  return in_img ? (src - 2 * a.n_tex) * 3 + k : (src >> 1) * 6 + (src & 1) * 3 + k;
}

// Replay sample a.start_sample of pixel pix and add its colour-leaf
// gradients through add(src, k, value).
template <class Add>
__device__ __forceinline__ void adjoint_pixel(const WaveArgs& a, int pix,
                                              int* stack, TapeEntry* tape,
                                              Add add) {
  MegaCount c{0, 0, 0};
  Tape rec{tape, 0};
  PathRegs p;
  trace_path(a, pix, stack, c, p, &rec);
  const float d[3] = {a.delta[3 * (size_t)pix], a.delta[3 * (size_t)pix + 1],
                      a.delta[3 * (size_t)pix + 2]};
  float R[3] = {0.0f, 0.0f, 0.0f};
  for (int j = rec.n - 1; j >= 0; --j) {
    const TapeEntry& e = tape[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (e.src_a >= 0) {
        const float dm = (float)e.m * pow_int(e.c[k], e.m - 1);
        const float g = d[k] * e.thr[k] * e.boost * R[k] * dm;
        if (g != 0.0f) add(e.src_a, k, g);
      }
      if (e.src_e >= 0) {
        const float g = d[k] * e.thr[k];
        if (g != 0.0f) add(e.src_e, k, g);
      }
      R[k] = e.e[k] + pow_int(e.c[k], e.m) * e.boost * R[k];
    }
  }
}

#ifndef PTT_HOST_EMULATION
// s_tex / s_img: floats of g_tex / g_img kept in shared memory (0: global).
__global__ void adjoint_kernel(WaveArgs a, int s_tex, int s_img) {
  extern __shared__ float s_g[];
  for (int i = threadIdx.x; i < s_tex + s_img; i += blockDim.x) s_g[i] = 0.0f;
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < a.npix) {
    int stack[PTT_MEGA_STACK];
    TapeEntry tape[PTT_TAPE_MAX];
    adjoint_pixel(a, pix, stack, tape, [&](int src, int k, float v) {
      bool in_img;
      const int off = grad_offset(a, src, k, in_img);
      float* dst = in_img ? (s_img ? s_g + s_tex + off : a.g_img + off)
                          : (s_tex ? s_g + off : a.g_tex + off);
      atomicAdd(dst, v);
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s_tex; i += blockDim.x) {
    if (s_g[i] != 0.0f) atomicAdd(a.g_tex + i, s_g[i]);
  }
  for (int i = threadIdx.x; i < s_img; i += blockDim.x) {
    if (s_g[s_tex + i] != 0.0f) atomicAdd(a.g_img + i, s_g[s_tex + i]);
  }
}

extern "C" int ptt_launch_adjoint(const WaveArgs* a, void* stream) {
  if (a->sd > PTT_MEGA_STACK || a->iters_cap > PTT_TAPE_MAX)
    return (int)cudaErrorInvalidValue;
  const int n_tex = a->n_tex * 6;
  const int n_img = a->n_img * a->img_h * a->img_w * 3;
  const int s_tex = n_tex <= PTT_ADJ_SMEM_FLOATS ? n_tex : 0;
  const int s_img = s_tex + n_img <= PTT_ADJ_SMEM_FLOATS ? n_img : 0;
  const int block = 128;
  const int grid = (a->npix + block - 1) / block;
  const size_t smem = sizeof(float) * (size_t)(s_tex + s_img);
  adjoint_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(*a, s_tex, s_img);
  return (int)cudaGetLastError();
}
#endif
