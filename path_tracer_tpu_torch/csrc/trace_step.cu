// K1 trace_step: one wave of suspended closest-hit traversal of a BVH4 or a
// BVH8 (one instantiation per node width, chosen by WaveArgs.branching),
// with the adaptive wave exit.
//
// Replaces path_tracer_tpu/ops/traverse.py _step_tiled (:334) driven by
// traversal_steps_batched(adaptive=True) (:408, the exit at :459-490), plus
// the wave's control predicate (ops/wavefront.py:451-462).  A wave walks in
// chunks of `chunk` steps (JAX's _unroll(): 4 on an accelerator); the first
// chunk always runs, and chunk i+1 runs only while i+chunk < steps and more
// than R / exit_den lanes are still walking.  The rule needs a grid-wide
// count after every chunk, so a wave is one cooperative launch, which a
// CUDA graph can hold (csrc/wave_loop.cu).  Its last chunk evaluates the
// control predicate into ctr[C_DO_CTRL], which K3/K4/K2 read in the same
// wave.  K1 also decides the device wave loop (wavefront.py:464-465): a
// wave with no work left, or past the loop's wave bound, clears the loop's
// WHILE condition and runs nothing (wave_runs); a wave that runs sets
// nothing, so no device runtime call delays block 0 ahead of the grid's
// barriers.
// Like JAX, every lane whose node pointer is not done walks and
// counts, occupied or not (an empty slot's pointer is done).  The stack
// lives in device memory (R x sd ints, L1/L2-resident); a push at a full
// stack is dropped exactly as in the JAX step and counted in
// ctr[C_STACK_OVF], which the renderer requires to be 0.
//
// Bound: dependent node-row fetches (384 bytes at K = 4, 736 at K = 8)
// from the 50 MB L2, one per step of each walking lane, so the time of a
// wave is the latency of its longest walks' steps (the P0 probe,
// scripts/bench_gather.py).  The
// design shortens the chain around them:
// - 16-byte row loads: a step reads the K boxes and pointers as 1.5K +
//   K/4 float4s and a hit leaf child's 16-float payload as four (rows are
//   multiples of 16 bytes; the wrapper checks the table's base), through
//   the read-only data cache; traverse.cuh:trav_step reads them a float at
//   a time.
// - One grid barrier per chunk: chunk q adds its lane counts into buffer
//   q & 1 of the chunk counters, cumulatively within a wave; after the
//   barrier every block reads the buffer, takes the chunk's counts as the
//   difference from its previous reading and decides itself whether the
//   next chunk runs.  Chunk q + 2 adds into the same buffer only after the
//   next barrier, which every block reaches after its reading; so a buffer
//   cannot be cleared within the wave, and the wave's last block to finish
//   (a ticket) clears both.
// - The grid covers every slot once (R threads, resident), so each thread
//   keeps its slot's ray and traversal state in registers for the whole
//   wave and writes it back at the end; a grid the card cannot hold at
//   once strides over the slots and reloads them per chunk.
// Measured slower and not used (PERF.md): 4 or 8 threads per slot, each
// testing K / 4 or K / 8 children, the results met by warp shuffles.
#include "traverse.cuh"

#ifndef PTT_HOST_EMULATION
#include <cooperative_groups.h>
#endif

#define PTT_K1_BLOCK 128

// K1's chunk counters in ctr, buffer b: lanes walking at the chunk's end,
// ready occupied slots, walking occupied slots (zero between waves).
__device__ __forceinline__ int chunk_ctr(int b, int f) {
  return b == 0 ? (f == 0 ? C_N_ACT_END : (f == 1 ? C_N_READY : C_N_WALK))
                : (f == 0 ? C_N_ACT_END_B : (f == 1 ? C_N_READY_B : C_N_WALK_B));
}

// Lane counts of one chunk: walking at the chunk's start and end (every
// lane), ready and walking occupied slots after the chunk, dropped pushes.
struct ChunkCount {
  int act, act_end, ready, walk, ovf;
};

// The device wave loop's WHILE condition after this wave's start: on the
// card K1 inside the loop's graph clears the graph's handle where no wave
// runs (each launch of the graph starts it at 1); the g++ build writes the
// value of every wave into h_while.
__device__ __forceinline__ void set_loop(const WaveArgs& a, bool go) {
#ifdef PTT_HOST_EMULATION
  a.h_while = go ? 1ull : 0ull;
#else
  if (!go && a.loop_graph)
    cudaGraphSetConditional((cudaGraphConditionalHandle)a.h_while, 0u);
#endif
}

// One step from node `cur` of a K-wide BVH: traverse.cuh:trav_step term
// for term, with the row read in 16-byte loads (the K boxes and pointers
// at once, a hit leaf child's 16-float payload as four).
template <int K>
__device__ __forceinline__ void k1_step(const WaveArgs& a, const TravRay& r,
                                        int& cur, int* stack, int& sp,
                                        float& best_t, int& best_pt,
                                        int& best_pi, int& ovf) {
  using L = NodeLayout<K>;
  const float4* row4 =
      reinterpret_cast<const float4*>(a.nodes + (size_t)cur * L::row);
  float box[6 * K];
#pragma unroll
  for (int q = 0; q < 6 * K / 4; ++q) {
    const float4 f = ldg4(row4 + q);
    box[4 * q] = f.x;
    box[4 * q + 1] = f.y;
    box[4 * q + 2] = f.z;
    box[4 * q + 3] = f.w;
  }
  int ptr[K];
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 f = ldg4(row4 + L::ptr / 4 + q);
    ptr[4 * q] = (int)f.x;
    ptr[4 * q + 1] = (int)f.y;
    ptr[4 * q + 2] = (int)f.z;
    ptr[4 * q + 3] = (int)f.w;
  }
  float ct[K];
  int cp[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float tn;
    bool hi = hit_aabb(box + 6 * c, r.ox, r.oy, r.oz, r.ivx, r.ivy, r.ivz,
                       r.t_min, best_t, tn);
    hi = hi && ptr[c] < PTT_EMPTY_SLOT;
    const bool is_leaf = ptr[c] < 0;
    if (hi && is_leaf) {
      const float4* p4 = row4 + L::pay / 4 + 4 * c;
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
    ct[c] = (hi && !is_leaf) ? tn : PTT_INF;
    cp[c] = ptr[c];
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

// A slot's ray and traversal state.
struct LaneState {
  TravRay r;
  int cur, sp, best_pt, best_pi;
  float best_t;
  bool occupied, walked;
};

__device__ __forceinline__ void load_lane(const WaveArgs& a, int i,
                                          LaneState& s) {
  s.cur = a.cur[i];
  s.occupied = a.occupied[i];
  s.walked = s.cur != PTT_DONE;
  if (!s.walked) return;
  s.r = trav_ray(a.origin[3 * i], a.origin[3 * i + 1], a.origin[3 * i + 2],
                 a.direction[3 * i], a.direction[3 * i + 1],
                 a.direction[3 * i + 2], a.time[i],
                 a.phase[i] == PH_EXIT ? a.hit_t[i] + 1e-4f : a.t_min);
  s.sp = a.sp[i];
  s.best_t = a.best_t[i];
  s.best_pt = a.best_pt[i];
  s.best_pi = a.best_pi[i];
}

__device__ __forceinline__ void store_lane(const WaveArgs& a, int i,
                                           const LaneState& s) {
  if (!s.walked) return;
  a.cur[i] = s.cur;
  a.sp[i] = s.sp;
  a.best_t[i] = s.best_t;
  a.best_pt[i] = s.best_pt;
  a.best_pi[i] = s.best_pi;
}

// One chunk of slot i's walk.
template <int K>
__device__ __forceinline__ void walk_chunk(const WaveArgs& a, int i,
                                           LaneState& s, ChunkCount& n) {
  if (s.cur != PTT_DONE) {
    ++n.act;
    int* stack = a.stack + (size_t)i * a.sd;
    for (int k = 0; k < a.chunk && s.cur != PTT_DONE; ++k)
      k1_step<K>(a, s.r, s.cur, stack, s.sp, s.best_t, s.best_pt, s.best_pi,
                 n.ovf);
  }
  if (s.cur != PTT_DONE) ++n.act_end;
  if (s.occupied) {
    if (s.cur == PTT_DONE) ++n.ready; else ++n.walk;
  }
}

// Wave bookkeeping and the control predicate, from the last chunk's ready
// and walking occupied slots.
__device__ __forceinline__ void wave_epilogue(const WaveArgs& a,
                                              long long n_ready,
                                              long long n_walk, int chunks) {
  volatile long long* c = a.ctr;
  const long long n_occ = c[C_N_OCC];
  const long long spawned =
      c[C_SPAWNED] < a.items_total ? c[C_SPAWNED] : a.items_total;
  const long long n_empty = a.R - n_occ;
  const bool can_spawn = spawned < a.items_total && n_empty > 0;
  const bool do_ctrl =
      (n_ready + (can_spawn ? n_empty : 0)) * a.ctrl_den >= a.R || n_walk == 0;
  c[C_EXEC_STEPS] = c[C_EXEC_STEPS] + (long long)chunks * a.chunk;
  c[C_WAVES] = c[C_WAVES] + 1;
  c[C_OCC_SUM] = c[C_OCC_SUM] + n_occ;
  c[C_CTRLS] = c[C_CTRLS] + (do_ctrl ? 1 : 0);
  c[C_DO_CTRL] = do_ctrl ? 1 : 0;
}

// A block's chunk counts: walking steps and dropped pushes into their
// counters, the rest into buffer b.
__device__ __forceinline__ void chunk_commit(const WaveArgs& a, int b,
                                             const ChunkCount& n) {
  unsigned long long* c = (unsigned long long*)a.ctr;
  if (n.act)
    atomicAdd(c + C_TRAV_STEPS, (unsigned long long)n.act * a.chunk);
  if (n.ovf) atomicAdd(c + C_STACK_OVF, (unsigned long long)n.ovf);
  if (n.act_end) atomicAdd(c + chunk_ctr(b, 0), (unsigned long long)n.act_end);
  if (n.ready) atomicAdd(c + chunk_ctr(b, 1), (unsigned long long)n.ready);
  if (n.walk) atomicAdd(c + chunk_ctr(b, 2), (unsigned long long)n.walk);
}

// What one block has read of the two buffers so far in this wave.
struct ChunkSeen {
  long long v0[3], v1[3];
};

// After the barrier of chunk q (starting at step i): the chunk's grid-wide
// counts from buffer q & 1 into n, and whether the next chunk runs.
__device__ __forceinline__ bool chunk_go(const WaveArgs& a, int q, int i,
                                         ChunkSeen& seen, long long* n) {
  volatile long long* c = a.ctr;
  const int b = q & 1;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const long long v = c[chunk_ctr(b, f)];
    n[f] = v - (b ? seen.v1[f] : seen.v0[f]);
    if (b) seen.v1[f] = v; else seen.v0[f] = v;
  }
  return i + a.chunk < a.steps && n[0] * a.exit_den > a.R;
}

// The wave's end, once per block: the last block to get here clears the
// chunk buffers and the ticket (every block has read them before it).
__device__ __forceinline__ void chunk_close(const WaveArgs& a, int blocks) {
  unsigned long long* c = (unsigned long long*)a.ctr;
  if (atomicAdd(c + C_TICKET, 1ull) + 1 != (unsigned long long)blocks) return;
  volatile long long* v = a.ctr;
  for (int b = 0; b < 2; ++b)
    for (int f = 0; f < 3; ++f) v[chunk_ctr(b, f)] = 0;
  v[C_TICKET] = 0;
}

__device__ __forceinline__ bool wave_is_live(const WaveArgs& a) {
  const long long spawned =
      a.ctr[C_SPAWNED] < a.items_total ? a.ctr[C_SPAWNED] : a.items_total;
  return spawned < a.items_total || a.ctr[C_N_OCC] > 0;
}

// Whether the wave runs: work is left and the wave bound is not reached.
// The writer sets the loop's WHILE condition to that; a wave that does not
// run also clears the control flag, so K3, K4 and K2 after it do nothing.
__device__ __forceinline__ bool wave_runs(const WaveArgs& a, bool writer) {
  const bool go = wave_is_live(a) &&
                  (a.max_waves <= 0 || a.ctr[C_WAVES] < a.max_waves);
  if (writer) {
    set_loop(a, go);
    if (!go) a.ctr[C_DO_CTRL] = 0;
  }
  return go;
}

#ifndef PTT_HOST_EMULATION
// One wave (see the top of the file).  The card reports how many blocks an
// SM holds (resident_blocks; three on the H100 at either node width, with
// 130 and 162 registers), and the renderer sizes the pool to that grid
// (ptt_trace_step_resident_lanes); the bound of two lets ptxas go past 128
// registers, where the loop's device call otherwise makes it spill.
template <int K>
__global__ void __launch_bounds__(PTT_K1_BLOCK, 2)
    trace_step_kernel(WaveArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (!wave_runs(a, first) || a.steps <= 0) return;
  __shared__ int s_act, s_act_end, s_ready, s_walk, s_ovf, s_go;
  const int slot0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const bool resident = stride >= a.R;
  LaneState own;
  if (resident && slot0 < a.R) load_lane(a, slot0, own);
  ChunkSeen seen{};          // thread 0's readings of the chunk buffers
  long long last[3] = {0, 0, 0};
  int q = 0;
  for (int i = 0;; i += a.chunk, ++q) {
    if (threadIdx.x == 0) s_act = s_act_end = s_ready = s_walk = s_ovf = 0;
    __syncthreads();
    ChunkCount n{0, 0, 0, 0, 0};
    if (resident) {
      if (slot0 < a.R) walk_chunk<K>(a, slot0, own, n);
    } else {
      for (int slot = slot0; slot < a.R; slot += stride) {
        LaneState s;
        load_lane(a, slot, s);
        walk_chunk<K>(a, slot, s, n);
        store_lane(a, slot, s);
      }
    }
    if (n.act) atomicAdd(&s_act, n.act);
    if (n.act_end) atomicAdd(&s_act_end, n.act_end);
    if (n.ready) atomicAdd(&s_ready, n.ready);
    if (n.walk) atomicAdd(&s_walk, n.walk);
    if (n.ovf) atomicAdd(&s_ovf, n.ovf);
    __syncthreads();
    if (threadIdx.x == 0)
      chunk_commit(a, q & 1, ChunkCount{s_act, s_act_end, s_ready, s_walk, s_ovf});
    grid.sync();
    if (threadIdx.x == 0) s_go = chunk_go(a, q, i, seen, last);
    __syncthreads();
    if (!s_go) break;
  }
  if (resident && slot0 < a.R) store_lane(a, slot0, own);
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) wave_epilogue(a, last[1], last[2], q + 1);
    __threadfence();
    chunk_close(a, gridDim.x);
  }
}

// The blocks of the node width's instantiation that fit resident on the
// card (asked once per instantiation), or a negative CUDA error.
template <int K>
static int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trace_step_kernel<K>, PTT_K1_BLOCK, 0);
    if (err != cudaSuccess) return -(int)err;
    blocks = per_sm * sms;
  }
  return blocks;
}

// A cooperative launch: as many blocks as the slots need, at most
// as many of the node width's instantiation as fit resident on the card
// (the wrapper counts one launch).
template <int K>
static int launch_trace_step(const WaveArgs* a, void* stream) {
  const int resident = resident_blocks<K>();
  if (resident < 0) return -resident;
  const int need = (a->R + PTT_K1_BLOCK - 1) / PTT_K1_BLOCK;
  const int grid = need < resident ? need : resident;
  void* args[] = {(void*)a};
  return (int)cudaLaunchCooperativeKernel((void*)trace_step_kernel<K>,
                                          dim3(grid), dim3(PTT_K1_BLOCK),
                                          args, 0, (cudaStream_t)stream);
}

// The slots K1 keeps resident at node width `branching`: resident blocks x
// PTT_K1_BLOCK, the pool that fills K1's resident grid; a negative
// CUDA error, or -cudaErrorInvalidValue for another width.
extern "C" int ptt_trace_step_resident_lanes(int branching) {
  const int blocks = branching == 4   ? resident_blocks<4>()
                     : branching == 8 ? resident_blocks<8>()
                                      : -(int)cudaErrorInvalidValue;
  return blocks < 0 ? blocks : blocks * PTT_K1_BLOCK;
}

extern "C" int ptt_launch_trace_step(const WaveArgs* a, void* stream) {
  if (a->chunk <= 0) return (int)cudaErrorInvalidValue;
  if (a->branching == 4) return launch_trace_step<4>(a, stream);
  if (a->branching == 8) return launch_trace_step<8>(a, stream);
  return (int)cudaErrorInvalidValue;
}
#endif
