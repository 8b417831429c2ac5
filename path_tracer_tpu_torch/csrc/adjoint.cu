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
// One launch per sample, as K5, over the npix pixels of a block (frame
// pixels pix_offset .. + npix; delta is the block's (npix, 3)).  A lane
// replays a pixel's path with K5's code (path.cuh path_trip, bounce.cuh
// with a recorder) and the same key folds, recording one tape entry per
// trip, then sweeps the tape in reverse.  Each instantiation is one of the
// node width K (4 or 8, WaveArgs.branching) and of where the per-thread
// arrays live: local memory when the walk's stack (sd), the tape (iters_cap
// entries) and, for the full instantiation, the SSS walk record (sss_steps
// trips) fit PTT_MEGA_STACK / PTT_TAPE_MAX / PTT_WALK_MAX, else the
// wrapper's per-pixel buffers WaveArgs.stack, tape and walk (kGlobal; rows
// indexed by block pixel; the wrapper splits a frame whose buffers would
// not fit its budget into pixel blocks).
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
// hit, whose turbulence is re-evaluated with its adjoint).  Measured on the
// full instantiation (PERF.md): the sweep is ~72% of a launch, the replay
// ~28%, the sink's atomics under the spread (16% on mesh_perlin_sss, whose
// marble adds into the Perlin table).  The design:
// - The replay's walks run trav_step16 with the pair loop rolled, as K5's
//   (the kernel holds two walks, the bounce and the sweep).
// - Work is fetched per pixel (fetch.cuh, K5's scheme): the grid is as
//   many blocks as fit on the card at once, and each lane, when its
//   pixel's sweep ends, takes the next pixel from ctr[C_FETCH] (one atomic
//   per warp); the last block clears the counter.
// - A lane runs its pixel as two loops, the replay's trips and then the
//   sweep, so the lanes of a warp meet between them and each loop runs one
//   kind of work at a time.
// - Each resident block zeroes its shared tables once and flushes them
//   once, at its end.
// Measured slower and not used (PERF.md): the pixel as one loop of units
// with a fetch after every unit (lanes that replay and lanes that sweep
// diverge) or after the pixel; the pair loop unrolled; the 4-byte step;
// the shared-table adds summed per warp first (__match_any_sync); the
// texture adjoint as one called function.  Four blocks per SM (128
// registers) were faster but spill, and no instantiation may.
#include "bounce_adj.cuh"
#include "fetch.cuh"
#include "path.cuh"

#define PTT_ADJ_SMEM_FLOATS 12288   // 48 KB of shared gradient tables
#define PTT_ADJ_BLOCK 128
// Blocks an SM holds at least (launch bounds): a register cap of 255.  With
// the block size alone ptxas held the full instantiation to 128 registers
// and spilled.
#define PTT_ADJ_MIN_BLOCKS 2

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

// The full instantiation's recorder: path_trip hands it each trip's bounce
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

// A tape entry of the colour (TapeEntry) or the full instantiation (TripIn).
template <bool kFull>
struct AdjEntry {
  using T = TapeEntry;
};
template <>
struct AdjEntry<true> {
  using T = TripIn;
};

// Where one lane stands in its pixel's work: the replay, trip by trip, one
// tape entry per trip; then the sweep of the tape from its last entry.  In
// the full sweep p.o / p.d / p.thr carry the adjoint of the next trip's
// inputs (p.time stays the path's time).
struct AdjLane {
  int pix;      // block pixel
  int n;        // tape entries recorded; in the sweep, entries left
  bool sweep;
  Key key_p;
  PathRegs p;
};

// Start block pixel pix: its key and camera ray; a path that takes no trip
// is done at once.
__device__ __forceinline__ void adj_begin(const WaveArgs& a, int pix,
                                          AdjLane& l) {
  l.pix = pix;
  l.n = 0;
  path_begin(a, a.pix_offset + pix, l.key_p, l.p);
  l.sweep = !path_runs(a, l.p);
}

// A replay trip of lane l's pixel, recorded on its tape (one entry); when
// the path ends, the sweep starts (the full one from a zero adjoint).
template <int K, bool kFull>
__device__ __forceinline__ void adj_trip(const WaveArgs& a, AdjLane& l,
                                         int* stack,
                                         typename AdjEntry<kFull>::T* tape) {
  PathRegs& p = l.p;
  MegaCount c{0, 0, 0};
  if constexpr (kFull) {
    TripTape rec{tape, l.n};
    path_trip<K, kStep16>(a, l.key_p, stack, c, p, &rec);
    l.n = rec.n;
  } else {
    Tape rec{tape, l.n};
    path_trip<K, kStep16>(a, l.key_p, stack, c, p, &rec);
    l.n = rec.n;
  }
  if (!path_runs(a, p)) {
    l.sweep = true;
    if constexpr (kFull) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p.o[k] = p.d[k] = p.thr[k] = 0.0f;
    }
  }
}

// The colour sweep, whole (a few dozen operations per entry): the colour
// leaves' gradients of lane l's pixel.
__device__ __forceinline__ void adj_colour_sweep(const WaveArgs& a,
                                                 AdjLane& l,
                                                 const TapeEntry* tape,
                                                 const GradSink& sink) {
  const float* dp = a.delta + 3 * (size_t)l.pix;
  const float d[3] = {dp[0], dp[1], dp[2]};
  // Colour leaf src (texture.cuh texture_src), component k.
  auto add = [&](int src, int k, float v) {
    if (src >= 2 * a.n_tex) {
      sink.img_(src - 2 * a.n_tex, k, v);
    } else {
      sink.tex_(src >> 1, 1 + 3 * (src & 1) + k, v);
    }
  };
  float R[3] = {0.0f, 0.0f, 0.0f};
  for (int j = l.n - 1; j >= 0; --j) {
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
  l.n = 0;
}

// One entry of the full sweep: the transpose of lane l's last unswept trip,
// every leaf's gradients added; with kGlobal the SSS walks record into
// `wrec`.
template <bool kGlobal>
__device__ __forceinline__ void adj_full_sweep(const WaveArgs& a, AdjLane& l,
                                               const TripIn* trips,
                                               float* wrec,
                                               const GradSink& sink) {
  PathRegs& p = l.p;
  const float* dp = a.delta + 3 * (size_t)l.pix;
  const float d[3] = {dp[0], dp[1], dp[2]};
  PathAdj adj;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    adj.o[k] = p.o[k];
    adj.d[k] = p.d[k];
    adj.thr[k] = p.thr[k];
  }
  --l.n;
  bounce_adj<kGlobal>(a, trips[l.n], p.time, fold_in(l.key_p, (uint32_t)l.n),
                      d, adj, sink, wrec);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.o[k] = adj.o[k];
    p.d[k] = adj.d[k];
    p.thr[k] = adj.thr[k];
  }
}

// The arrays of lane l's pixel: the lane's local ones (stack_l, tape_l) or,
// with kGlobal, the pixel's rows of the per-pixel buffers.
template <bool kGlobal, bool kFull>
struct AdjArrays {
  using E = typename AdjEntry<kFull>::T;
  int* stack;
  E* tape;
  float* wrec;
  __device__ __forceinline__ AdjArrays(const WaveArgs& a, int pix,
                                       int* stack_l, E* tape_l)
      : stack(kGlobal ? a.stack + (size_t)pix * a.sd : stack_l),
        tape(kGlobal ? (E*)a.tape + (size_t)pix * a.iters_cap : tape_l),
        wrec(kGlobal && kFull ? a.walk + (size_t)pix * a.sss_steps * 4
                              : nullptr) {}
};

// Lane l's pixel to its end, as two loops (the kernel's lane): the replay,
// then the sweep.  The lanes of a warp meet between the two, so each loop
// runs one kind of unit at a time (one loop of units diverges between
// lanes that replay and lanes that sweep).
template <int K, bool kGlobal, bool kFull>
__device__ __forceinline__ void adj_pixel(
    const WaveArgs& a, AdjLane& l, int* stack_l,
    typename AdjEntry<kFull>::T* tape_l, const GradSink& sink) {
  const AdjArrays<kGlobal, kFull> r(a, l.pix, stack_l, tape_l);
  while (!l.sweep) adj_trip<K, kFull>(a, l, r.stack, r.tape);
  if constexpr (kFull) {
    while (l.n > 0) adj_full_sweep<kGlobal>(a, l, r.tape, r.wrec, sink);
  } else {
    adj_colour_sweep(a, l, r.tape, sink);
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

// A resident block: its shared tables zeroed, its lanes' pixels fetched
// and worked through, the tables flushed, the fetch counter closed.
template <int K, bool kGlobal, bool kFull>
__device__ __forceinline__ void adjoint_block(const WaveArgs& a,
                                              const SmemPlan& plan) {
  using E = typename AdjEntry<kFull>::T;
  extern __shared__ float s_g[];
  for (int i = threadIdx.x; i < plan.floats; i += blockDim.x) s_g[i] = 0.0f;
  __syncthreads();
  GradSink sink = global_sink(a);
  if (plan.tex >= 0) sink.tex = s_g + plan.tex;
  if (plan.img >= 0) sink.img = s_g + plan.img;
  if (plan.mat >= 0) sink.mat = s_g + plan.mat;
  if (plan.med >= 0) sink.med = s_g + plan.med;
  if (plan.perlin >= 0) sink.perlin = s_g + plan.perlin;
  int stack_l[kGlobal ? 1 : PTT_MEGA_STACK];
  E tape_l[kGlobal ? 1 : PTT_TAPE_MAX];
  AdjLane l;
  bool more = true;   // pixels may be left to take
  for (;;) {
    const unsigned int m = __ballot_sync(PTT_FULL_WARP, more);
    if (m == 0u) break;
    const long long q = warp_fetch(a, m);
    if (more) {
      if (q < a.npix) {
        adj_begin(a, (int)q, l);
        adj_pixel<K, kGlobal, kFull>(a, l, stack_l, tape_l, sink);
      } else {
        more = false;
      }
    }
  }
  __syncthreads();
  if (plan.tex >= 0) flush_table(s_g + plan.tex, a.g_tex, a.n_tex * 9);
  if (plan.img >= 0) {
    flush_table(s_g + plan.img, a.g_img, a.n_img * a.img_h * a.img_w * 3);
  }
  if (plan.mat >= 0) flush_table(s_g + plan.mat, a.g_mat, a.n_mat * 8);
  if (plan.med >= 0) flush_table(s_g + plan.med, a.g_med, a.n_med * 2);
  if (plan.perlin >= 0) flush_table(s_g + plan.perlin, a.g_perlin, 256 * 4);
  if (threadIdx.x == 0) fetch_close(a);
}

template <int K, bool kGlobal>
__global__ void __launch_bounds__(PTT_ADJ_BLOCK, PTT_ADJ_MIN_BLOCKS)
adjoint_kernel(WaveArgs a, SmemPlan plan) {
  adjoint_block<K, kGlobal, false>(a, plan);
}

template <int K, bool kGlobal>
__global__ void __launch_bounds__(PTT_ADJ_BLOCK, PTT_ADJ_MIN_BLOCKS)
adjoint_full_kernel(WaveArgs a, SmemPlan plan) {
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

// As many blocks as fit on the card at once (asked once per instantiation
// and shared-table size), at most one pixel per thread.
template <class F>
static int launch_resident(F kernel, const WaveArgs* a, const SmemPlan& plan,
                           void* stream, int& resident, int& resident_smem) {
  const size_t smem = sizeof(float) * (size_t)plan.floats;
  if ((int)smem != resident_smem) {
    resident = resident_blocks(kernel, PTT_ADJ_BLOCK, smem);
    if (resident == 0) return (int)cudaErrorInvalidConfiguration;
    resident_smem = (int)smem;
  }
  const int need = (a->npix + PTT_ADJ_BLOCK - 1) / PTT_ADJ_BLOCK;
  const int grid = need < resident ? need : resident;
  kernel<<<grid, PTT_ADJ_BLOCK, smem, (cudaStream_t)stream>>>(*a, plan);
  return (int)cudaGetLastError();
}

template <int K, bool kGlobal>
static int launch_adjoint_k(const WaveArgs* a, void* stream, bool full) {
  static int resident[2] = {0, 0}, resident_smem[2] = {-1, -1};
  const SmemPlan plan = plan_smem(a, full);
  if (full) {
    return launch_resident(adjoint_full_kernel<K, kGlobal>, a, plan, stream,
                           resident[1], resident_smem[1]);
  }
  return launch_resident(adjoint_kernel<K, kGlobal>, a, plan, stream,
                         resident[0], resident_smem[0]);
}

static int launch_adjoint(const WaveArgs* a, void* stream, bool full) {
  const bool global = adjoint_global(*a, full);
  if ((global && (a->stack == nullptr || a->tape == nullptr ||
                  (full && a->sss_steps > 0 && a->walk == nullptr))) ||
      (a->branching != 4 && a->branching != 8))
    return (int)cudaErrorInvalidValue;
  if (a->npix == 0) return 0;
  if (a->branching == 4) {
    return global ? launch_adjoint_k<4, true>(a, stream, full)
                  : launch_adjoint_k<4, false>(a, stream, full);
  }
  return global ? launch_adjoint_k<8, true>(a, stream, full)
                : launch_adjoint_k<8, false>(a, stream, full);
}

extern "C" int ptt_launch_adjoint(const WaveArgs* a, void* stream) {
  return launch_adjoint(a, stream, false);
}

extern "C" int ptt_launch_adjoint_full(const WaveArgs* a, void* stream) {
  return launch_adjoint(a, stream, true);
}
#endif
