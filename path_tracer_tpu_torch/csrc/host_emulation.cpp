// CPU build of the kernels' per-slot code, for tests.
//
// The CUDA sources keep each kernel's per-slot work in a __device__
// function (trace_lane, shade_lane, retire_lane, spawn_lane, mega_pixel,
// adjoint_pixel)
// and only the grid plumbing in the __global__ wrapper.  Compiled by a host C++ compiler
// with PTT_HOST_EMULATION defined, the same per-slot code runs here in a
// loop over slots, so the CPU test suite holds the kernel sources — not only
// their plain-torch twins — against the JAX package's engine.
//   g++ -O1 -std=c++17 -ffp-contract=off -shared -fPIC -o emu.so host_emulation.cpp
#define PTT_HOST_EMULATION
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __global__
template <class T>
static T atomicAdd(T* p, T v) {
  T old = *p;
  *p = old + v;
  return old;
}
#include "trace_step.cu"
#include "shade.cu"
#include "retire.cu"
#include "spawn.cu"
#include "megakernel.cu"
#include "adjoint.cu"

extern "C" void emu_trace_step(WaveArgs* a) {
  if (!wave_is_live(*a)) {
    a->ctr[C_DO_CTRL] = 0;
    return;
  }
  long long longest = 0;
  for (int i = 0; i < a->R; ++i) {
    int ready, walk, steps, ovf;
    trace_lane(*a, i, ready, walk, steps, ovf);
    a->ctr[C_N_READY] += ready;
    a->ctr[C_N_WALK] += walk;
    a->ctr[C_TRAV_STEPS] += steps;
    a->ctr[C_STACK_OVF] += ovf;
    if (steps > longest) longest = steps;
  }
  a->ctr[C_WAVE_MAX] = longest;
  wave_epilogue(*a);
}

extern "C" void emu_shade(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return;
  for (int i = 0; i < a->R; ++i) shade_lane(*a, i);
}

extern "C" void emu_retire(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return;
  for (int i = 0; i < a->R; ++i) retire_lane(*a, i);
}

extern "C" void emu_spawn(WaveArgs* a) {
  if (a->ctr[C_DO_CTRL] == 0) return;
  for (int i = 0; i < a->R; ++i) spawn_lane(*a, i);
}

extern "C" void emu_megakernel(WaveArgs* a) {
  for (int pix = 0; pix < a->npix; ++pix) {
    int stack[PTT_MEGA_STACK];
    MegaCount c{0, 0, 0};
    mega_pixel(*a, pix, stack, c);
    const int dc = clampi(a->depth[pix], 0, a->max_depth);
    a->depth_hist[dc] += 1;
    a->ctr[C_DONE] += 1;
    a->ctr[C_RAYS] += a->iters[pix];
    a->ctr[C_DEPTH_SUM] += dc;
    a->ctr[C_TRAV_STEPS] += c.trav_steps;
    a->ctr[C_WALK_STEPS] += c.walk_trips;
    a->ctr[C_STACK_OVF] += c.ovf;
  }
}

extern "C" void emu_adjoint(WaveArgs* a) {
  for (int pix = 0; pix < a->npix; ++pix) {
    int stack[PTT_MEGA_STACK];
    TapeEntry tape[PTT_TAPE_MAX];
    adjoint_pixel(*a, pix, stack, tape, [&](int src, int k, float v) {
      bool in_img;
      const int off = grad_offset(*a, src, k, in_img);
      (in_img ? a->g_img : a->g_tex)[off] += v;
    });
  }
}
