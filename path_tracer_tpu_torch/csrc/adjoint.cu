// K6 adjoint: the gradient of one sample of every pixel with respect to the
// scene's leaves, contracted with delta = dL/d(image).  Two instantiations
// of one kernel template:
//
// * colour (adjoint_kernel): the colour leaves tex_c1, tex_c2, img_data.
//   Those enter a path linearly: with thr_j the throughput before trip j,
//   E_j its emission or background term, a_j its attenuation (a texture
//   colour c, c^(n+1) after the SSS walk's n kept trips, 1 when the trip
//   does not scatter) and b_j the roulette boost (a constant, as under
//   JAX's stop_gradient), the radiance is C = sum_j thr_j E_j with
//   thr_{j+1} = thr_j a_j b_j.  So, with R_j = E_j + a_j b_j R_{j+1}:
//     dC/dE_j = thr_j,   dC/dc_j = thr_j b_j R_{j+1} m c^(m-1).
//   Visibility, coins and directions do not depend on a colour, so the path
//   is the forward's.  No division by a colour that may be 0 is needed.
// * full (adjoint_full_kernel): every floating leaf of SceneArrays (B13'):
//   geometry, materials, media, textures and the Perlin table.  The replay
//   records each trip's bounce inputs (TripIn, 14 words: origin, direction,
//   throughput, the hit query's result, the exit query's result, depth);
//   the reverse sweep recomputes trip j's bounce from its entry with the
//   forward's code and applies its transpose (bounce_adj.cuh), carrying the
//   adjoint of (origin, direction, throughput) from trip j+1 to trip j; the
//   radiance's adjoint is delta on every trip.  The camera ray depends on no
//   leaf, so the sweep ends at trip 0.  The colour leaves fall out of the
//   same sweep (texture_adj).
//
// Replaces the backward that jax.grad takes through
// path_tracer_tpu/ops/integrator.py trace_ray_scan (:268) and the backward
// wavefront (ops/wavefront.py:520 render_batch_diff): the transpose of the
// bounce (B4, shade_tiled.py:773) with its textures (B5), SSS walk (B6) and
// refine_hit (traverse.py:558).
//
// One thread per pixel of a block (frame pixels pix_offset .. + npix; delta
// is the block's (npix, 3)), one launch per sample, as K5: the thread replays
// its path with K5's code (path.cuh, bounce.cuh with a recorder) and the
// same key folds, recording one tape entry per trip, then sweeps the tape in
// reverse.  Each instantiation is one of the node width K (4 or 8,
// WaveArgs.branching) and of where the per-thread arrays live: local
// memory when the walk's stack (sd), the tape (iters_cap entries) and, for
// the full instantiation, the SSS walk record (sss_steps trips) fit
// PTT_MEGA_STACK / PTT_TAPE_MAX / PTT_WALK_MAX, else the wrapper's
// per-pixel buffers WaveArgs.stack, tape and walk (kGlobal; the wrapper
// splits a frame whose buffers would not fit its budget into pixel blocks).
//
// Contributions go to the block's copy of the small gradient tables in
// shared memory where they fit (48 KB: textures, then materials, media, the
// Perlin table and the atlas; a Cornell frame has four texture rows that
// 640,000 threads would otherwise add into), then one atomicAdd per non-zero
// entry per block; what does not fit, and the primitive rows, take global
// atomics (the primitive rows aggregated per warp, GradSink::prim_row).
// Float add order therefore differs from the plain version's and from run
// to run: comparisons use a tolerance.
//
// Bound: the replay is K5's work (dependent node-row gathers and
// divergence, ~220 fp32 ops per traversal step, ~1,920 per bounce); the
// colour sweep adds a few dozen ops per trip, the full sweep a bounce's
// recompute and its transpose per trip (several thousand ops on a marble
// hit, whose turbulence is re-evaluated with its adjoint).  The tape adds to
// K6's stack frame, not to K5's.
#include "bounce_adj.cuh"
#include "path.cuh"

#define PTT_ADJ_SMEM_FLOATS 12288   // 48 KB of shared gradient tables

struct TapeEntry {
  float thr[3], e[3], c[3];
  float boost;
  int src_e, src_a, m;
};

// The colour instantiation's recorder: bounce() tells it each trip's
// colour events (bounce.cuh).
struct Tape {
  static constexpr bool kOn = true;
  static constexpr bool kTrips = false;
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

// The full instantiation's recorder: trace_path hands it each trip's bounce
// inputs; bounce() records nothing (kOn false compiles its hooks out).
struct TripTape {
  static constexpr bool kOn = false;
  static constexpr bool kTrips = true;
  TripIn* t;
  int n;
  __device__ __forceinline__ void trip(const PathRegs& p, bool found,
                                       int r_pt, int r_pi, bool exit_found,
                                       float t_exit, bool exit_is_medium) {
    TripIn& e = t[n++];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e.o[k] = p.o[k];
      e.d[k] = p.d[k];
      e.thr[k] = p.thr[k];
    }
    e.t_exit = t_exit;
    e.r_pt = r_pt;
    e.r_pi = r_pi;
    e.bits = (found ? 1 : 0) | (exit_found ? 2 : 0) |
             (exit_is_medium ? 4 : 0) | (p.depth << 3);
  }
};

// Replay sample a.start_sample of pixel pix and add its colour-leaf
// gradients to the sink.
template <int K>
__device__ __forceinline__ void adjoint_pixel(const WaveArgs& a, int pix,
                                              int* stack, TapeEntry* tape,
                                              const GradSink& sink) {
  MegaCount c{0, 0, 0};
  Tape rec{tape, 0};
  PathRegs p;
  trace_path<K>(a, a.pix_offset + pix, stack, c, p, &rec);
  const float d[3] = {a.delta[3 * (size_t)pix], a.delta[3 * (size_t)pix + 1],
                      a.delta[3 * (size_t)pix + 2]};
  // Colour leaf src (texture.cuh texture_src), component k.
  auto add = [&](int src, int k, float v) {
    if (src >= 2 * a.n_tex) {
      sink.img_(src - 2 * a.n_tex, k, v);
    } else {
      sink.tex_(src >> 1, 1 + 3 * (src & 1) + k, v);
    }
  };
  float R[3] = {0.0f, 0.0f, 0.0f};
  for (int j = rec.n - 1; j >= 0; --j) {
    const TapeEntry& e = tape[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (e.src_a >= 0) {
        const float dm = (float)e.m * pow_int(e.c[k], e.m - 1);
        add(e.src_a, k, d[k] * e.thr[k] * e.boost * R[k] * dm);
      }
      if (e.src_e >= 0) add(e.src_e, k, d[k] * e.thr[k]);
      R[k] = e.e[k] + pow_int(e.c[k], e.m) * e.boost * R[k];
    }
  }
}

// Replay sample a.start_sample of pixel pix and add the gradients of every
// leaf to the sink; with kGlobal the SSS walks record into `wrec`.
template <int K, bool kGlobal>
__device__ __forceinline__ void adjoint_pixel_full(const WaveArgs& a, int pix,
                                                   int* stack, TripIn* trips,
                                                   const GradSink& sink,
                                                   float* wrec) {
  MegaCount c{0, 0, 0};
  TripTape rec{trips, 0};
  PathRegs p;
  trace_path<K>(a, a.pix_offset + pix, stack, c, p, &rec);
  const Key key_p = path_key(a, a.start_sample, a.pix_offset + pix);
  const float d[3] = {a.delta[3 * (size_t)pix], a.delta[3 * (size_t)pix + 1],
                      a.delta[3 * (size_t)pix + 2]};
  PathAdj adj;
#pragma unroll
  for (int k = 0; k < 3; ++k) adj.o[k] = adj.d[k] = adj.thr[k] = 0.0f;
  for (int j = rec.n - 1; j >= 0; --j) {
    bounce_adj<kGlobal>(a, trips[j], p.time, fold_in(key_p, (uint32_t)j), d,
                        adj, sink, wrec);
  }
}

// Offsets (in floats) of the gradient tables kept in shared memory, -1 for
// a table left in global memory; `floats` is the total.
struct SmemPlan {
  int tex, img, mat, med, perlin, floats;
};

// The global buffers as a sink.
__device__ __forceinline__ GradSink global_sink(const WaveArgs& a) {
  return GradSink{a.g_tex, a.g_img, a.g_prim, a.g_mat, a.g_med, a.g_perlin};
}

// Whether a launch takes the instantiation with per-pixel buffers (the
// wrapper's rule too: ops/adjoint.py).
__host__ __device__ __forceinline__ bool adjoint_global(const WaveArgs& a,
                                                       bool full) {
  return a.sd > PTT_MEGA_STACK || a.iters_cap > PTT_TAPE_MAX ||
         (full && a.sss_steps > PTT_WALK_MAX);
}

// Pixel pix of the block (full or colour, local or per-pixel arrays).
template <int K, bool kGlobal, bool kFull>
__device__ __forceinline__ void adjoint_lane(const WaveArgs& a, int pix,
                                             const GradSink& sink) {
  if constexpr (kGlobal) {
    int* stack = a.stack + (size_t)pix * a.sd;
    if constexpr (kFull) {
      TripIn* trips = (TripIn*)a.tape + (size_t)pix * a.iters_cap;
      adjoint_pixel_full<K, true>(a, pix, stack, trips, sink,
                                  a.walk + (size_t)pix * a.sss_steps * 4);
    } else {
      TapeEntry* tape = (TapeEntry*)a.tape + (size_t)pix * a.iters_cap;
      adjoint_pixel<K>(a, pix, stack, tape, sink);
    }
  } else {
    int stack[PTT_MEGA_STACK];
    if constexpr (kFull) {
      TripIn trips[PTT_TAPE_MAX];
      adjoint_pixel_full<K, false>(a, pix, stack, trips, sink, nullptr);
    } else {
      TapeEntry tape[PTT_TAPE_MAX];
      adjoint_pixel<K>(a, pix, stack, tape, sink);
    }
  }
}

// Bytes of one tape entry of the colour (full 0) or the full instantiation:
// the wrapper sizes WaveArgs.tape by it.
extern "C" int ptt_adjoint_entry_bytes(int full) {
  return full ? (int)sizeof(TripIn) : (int)sizeof(TapeEntry);
}

#ifndef PTT_HOST_EMULATION
__device__ __forceinline__ void flush_table(const float* s, float* g, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (s[i] != 0.0f) atomicAdd(g + i, s[i]);
  }
}

template <int K, bool kGlobal, bool kFull>
__device__ __forceinline__ void adjoint_block(const WaveArgs& a,
                                              const SmemPlan& plan) {
  extern __shared__ float s_g[];
  for (int i = threadIdx.x; i < plan.floats; i += blockDim.x) s_g[i] = 0.0f;
  __syncthreads();
  GradSink sink = global_sink(a);
  if (plan.tex >= 0) sink.tex = s_g + plan.tex;
  if (plan.img >= 0) sink.img = s_g + plan.img;
  if (plan.mat >= 0) sink.mat = s_g + plan.mat;
  if (plan.med >= 0) sink.med = s_g + plan.med;
  if (plan.perlin >= 0) sink.perlin = s_g + plan.perlin;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < a.npix) adjoint_lane<K, kGlobal, kFull>(a, pix, sink);
  __syncthreads();
  if (plan.tex >= 0) flush_table(s_g + plan.tex, a.g_tex, a.n_tex * 9);
  if (plan.img >= 0) {
    flush_table(s_g + plan.img, a.g_img, a.n_img * a.img_h * a.img_w * 3);
  }
  if (plan.mat >= 0) flush_table(s_g + plan.mat, a.g_mat, a.n_mat * 8);
  if (plan.med >= 0) flush_table(s_g + plan.med, a.g_med, a.n_med * 2);
  if (plan.perlin >= 0) flush_table(s_g + plan.perlin, a.g_perlin, 256 * 4);
}

template <int K, bool kGlobal>
__global__ void adjoint_kernel(WaveArgs a, SmemPlan plan) {
  adjoint_block<K, kGlobal, false>(a, plan);
}

template <int K, bool kGlobal>
__global__ void adjoint_full_kernel(WaveArgs a, SmemPlan plan) {
  adjoint_block<K, kGlobal, true>(a, plan);
}

// Tables in order of priority, each kept in shared memory if it still fits.
static SmemPlan plan_smem(const WaveArgs* a, bool full) {
  SmemPlan p{-1, -1, -1, -1, -1, 0};
  auto place = [&](int& off, int n) {
    if (n > 0 && p.floats + n <= PTT_ADJ_SMEM_FLOATS) {
      off = p.floats;
      p.floats += n;
    }
  };
  place(p.tex, a->n_tex * 9);
  if (full) {
    place(p.mat, a->n_mat * 8);
    place(p.med, a->n_med * 2);
    if (a->has_noise) place(p.perlin, 256 * 4);
  }
  place(p.img, a->n_img * a->img_h * a->img_w * 3);
  return p;
}

template <int K, bool kGlobal>
static void launch_adjoint_k(const WaveArgs* a, void* stream, bool full) {
  const SmemPlan plan = plan_smem(a, full);
  const int block = 128;
  const int grid = (a->npix + block - 1) / block;
  const size_t smem = sizeof(float) * (size_t)plan.floats;
  if (full) {
    adjoint_full_kernel<K, kGlobal>
        <<<grid, block, smem, (cudaStream_t)stream>>>(*a, plan);
  } else {
    adjoint_kernel<K, kGlobal>
        <<<grid, block, smem, (cudaStream_t)stream>>>(*a, plan);
  }
}

static int launch_adjoint(const WaveArgs* a, void* stream, bool full) {
  const bool global = adjoint_global(*a, full);
  if ((global && (a->stack == nullptr || a->tape == nullptr ||
                  (full && a->sss_steps > 0 && a->walk == nullptr))) ||
      (a->branching != 4 && a->branching != 8))
    return (int)cudaErrorInvalidValue;
  if (a->npix == 0) return 0;
  if (a->branching == 4) {
    if (global) launch_adjoint_k<4, true>(a, stream, full);
    else launch_adjoint_k<4, false>(a, stream, full);
  } else {
    if (global) launch_adjoint_k<8, true>(a, stream, full);
    else launch_adjoint_k<8, false>(a, stream, full);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptt_launch_adjoint(const WaveArgs* a, void* stream) {
  return launch_adjoint(a, stream, false);
}

extern "C" int ptt_launch_adjoint_full(const WaveArgs* a, void* stream) {
  return launch_adjoint(a, stream, true);
}
#endif
