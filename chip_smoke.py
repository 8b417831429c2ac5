"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device     — require CUDA; print the card's name and power limit.
2. build      — compile the CUDA kernels (one nvcc per source, all
                started together; adjoint.cu holds K6's two
                instantiations) and print the build seconds and ptxas
                resources.  The last phase line before the JSON lines
                gives chip_smoke's total seconds.
3. kernels    — at the full configuration's shapes (vol2_final_scene,
                800x450, depth 10, 32 steps per wave, the pool phase 4's
                Renderer runs: K1's resident lanes on the card) hold each
                wavefront kernel against its plain-torch twin on the same
                wave state (K1 with JAX's adaptive wave exit at chunk 4:
                lanes and counters exact, one cooperative launch per
                wave); hold K5
                (megakernel) against its twin on one 800x450 sample, per
                pixel; hold K3 (shade) against its twin
                on a mid-flight wave state of mesh_perlin_sss at 400x225,
                and K5 against its twin on one 400x225 sample of it: both
                run the SSS walk there; time each (CUDA events, median of
                25 launches, host launch work included), and K3, K4, K2
                (on the control wave's state) and P0 in device ms per
                call, K4 and P0 beside their library calls (index_add_,
                index_select): 20 calls captured in one CUDA graph and
                replayed.
4. main       — render vol2_final_scene(sphere_cluster=1000) at 800x450,
                10 spp, depth 10 through Renderer(engine="wavefront") (K1-K4
                in the device wave loop) after a warm-up; print wall time,
                Mrays/s, waves and host reads, three frame walls, and
                per-kernel device time of another frame (torch.profiler)
                with the device idle share.
5. main-mega  — the same frame through Renderer(engine="megakernel").
   loop       — (after phase 5) the same frame through the kept device
                wave loop (render_batch) and the per-wave host loop of the
                CUDA kernels (run_waves): image, counters, depth histogram
                and per-pixel paths bit-identical, each kernel launched
                once a wave (the device loop once more: the empty wave
                whose K1 ends it; the loop has no kernel of its own); the
                device loop's walls and host reads, launches and idle share
                of each, each profiled
                frame's kernel runs equal to its launch counts; the image
                against K5's under the graded rule; the same frame with the
                adaptive exit off (the exit's device-time cost).
6. main-sss   — mesh_perlin_sss at 400x225, 64 spp, depth 12, through both
                engines, with the SSS walk counter.
                Then K6 (adjoint) against its plain version at 160x90,
                2 spp, on cornell_box (tex_c1), the texture-demo scene
                (img_data), vol2_final_scene (image texture, marble,
                media) and mesh_perlin_sss (the SSS exponent); K6's full
                instantiation (adjoint_full, every floating leaf) against
                its plain version at 160x90, 2 spp, on vol2_final_scene,
                mesh_perlin_sss, cornell_smoke and the triangle scene, per
                leaf, and on one 800x450 vol2_final and one 400x225
                mesh_perlin_sss sample, each timed beside K5 and the
                colour K6 on the same sample; then the full K6's gradients
                against central differences of the K5 forward on the
                solo-sphere and fuzz-plate setups of tests/test_grad.py.
7. agree      — kernel paths vs twin paths on the card at 160x90, 2 spp: the
                graded image agreement of tools/bench_ab.py and exact
                counters, for the wavefront on vol2_final and
                mesh_perlin_sss and the megakernel on both; and the
                megakernel's image against the wavefront kernels' image.
8. train      — make_train_step (unbiased, K1-K4 forward, K6 backward) on
                cornell_box at 800x800 (tex_c1 rows 1 and 2 perturbed as
                tools/train_demo.py does; 4 spp, depth 6) and on the
                texture-demo scene at 800x800 (img_data; 8 spp, depth 5):
                three steps each with loss, forward and backward ms (CUDA
                events around each forward render and around the K6
                backward), step wall and K6 launches; then K6 against its
                plain version on one 800x800 cornell_box sample.  Then the
                train step on leaves that move rays (the full K6): on
                vol2_final_scene at 800x450, depth 10 (mat_fuzz, mat_ir,
                med_density, tex_scale, sph_c0/sph_c1 of the moving
                sphere) and on mesh_perlin_sss at 400x225, depth 12
                (mat_g, mat_sigma_s, mat_sigma_a, mat_scatter_dist, tr_v0,
                perlin_vec), 4 spp per render, three steps each.  Then
                the same vol2_final step on the tiled engine
                (engine="megakernel": K7 + K8 forward, K6 backward), its
                first step's gradients against the wavefront step's, its
                renders through one kept trip graph (one capture).
9. tiled      — (run after phase 6) render_tiled on the vol2_final frame
                (one captured trip graph replayed per sample): wall,
                Mrays/s, per-kernel device time, K8's device ms per trip
                beside the trip's live lanes and bound, the image against
                K5's under the graded rule and bit-identical to the eager
                loop's (render_sample_tiled, every launch from the host);
                the trip graph kept across frames: one capture for two
                frames, the second bit-identical to the first, and for
                frames of a new key and a moved camera, each bit-identical
                to the eager loop's frame of that key and view.
9b. bvh8     — (after phase 8) vol2_final over a BVH8
                (build_from_scene(branching=8)): K1 (lanes, stack and
                counters exact), K5, K7, K9 (torus knot shard) and both K6
                instantiations at K = 8 against their plain versions at the
                full configuration, timed; the 800x450, 10-spp frame through
                the megakernel, the device wave loop and the tiled engine at
                K = 4 and K = 8 (three walls, Mrays/s, traversal steps per
                segment, dropped pushes, device ms per kernel, launches and
                instantiation launches held against the profiler's kernel
                runs), each K = 8 frame under the graded rule of the K = 4
                frame and each engine at K = 8 against its plain path at
                160x90; the vol2_final train step at K = 8 (colour and full
                K6), its gradients against the BVH4 step's.
9c. stack     — the per-thread arrays beyond their local 64 entries: K5 and
                K7 with a 70-entry stack (max_stack raised) bit-equal to
                the local stack, the full K6 with stack, tape and walk
                record in per-pixel buffers against its plain version, and a
                Cornell train step at max_depth 60 (68 trips, the colour K6's
                tape in the per-pixel buffer).
10. parallel  — ranks of a gloo job sharing the card, each a process
                (this script with --rank): 2-rank data-parallel wavefront
                on the vol2_final frame (image against the one-rank frame,
                summed counters exact), megakernel (render_sharded, image
                against phase 5's) and train step (gradients against one
                rank's), 2-rank tensor- and pipeline-parallel renders
                of the 102,400-triangle torus knot at 800x800 (against the
                one-rank tiled image, tests/test_tp_scale.py's graded
                rule), the same two modes over BVH8 shards, and DP x TP on a
                2x2 grid on vol2_final at 400x225.
10b. entry    — the entry points users start from, at the main
                configuration: (a) a Renderer checkpointed at 4 spp
                (batches of 2, a metrics file) and a new one resumed to
                10, against one uninterrupted render (bit-identical),
                five metrics lines, a mesh_perlin_sss checkpoint refused;
                (b) autotune's probe, prediction, timed candidates and
                choice, the tuned frame against the preset frame (graded,
                paths and rays exact); (c) K2 with tile_spawn_order(800,
                450) against its twin on control waves (exact), the frame
                with the order against the default (graded, paths and
                rays exact), both frames' walls and K1 device ms (data,
                not gated: the profiler's runs printed beside the
                launches); (d)
                OrbitCamera.rotate(40, 0), restart and 2 spp, bit-identical
                to a fresh Renderer at the moved camera; (e) the CLI as a
                subprocess (800x800, 10 spp, batch 2, checkpoint, metrics,
                autotune, torch.profiler trace holding the wave kernels);
                (f) 2 gloo ranks through the CLI against the one-rank frame
                (tests/test_multihost.py:81-82's rule), and 4 samples of
                the 10-spp job (render_distributed(spp=4)) resumed by the
                CLI to 10, bit-identical to the uninterrupted run.
10c. ladder   — scripts/bench_ladder.py's five BASELINE.json configs at
                their own sizes through the device loop: finite, paths =
                pixels x spp, no stack overflow, the image against K5's
                (graded), one JSON line each.
10d. golden   — scripts/golden.py: the eight cases of tests/test_golden.py
                through the wavefront (K1-K4, device loop) and the
                megakernel (K5), each against the JAX package's stored
                image (tests/golden/<name>.npz) under JAX's rule, and
                vol2_final_mid under its own rule (golden.vol2_final_close);
                each card wavefront image against the CPU twins' image of
                the case (graded; vol2_final_mid's twin run is skipped,
                minutes on the host).
10e. ab       — scripts/bench_ab.py on wavefront_comparison and
                vol2_final_scene at 400 wide, 8 spp, depth 10: both
                engines' walls and the graded agreement of their images.
10f. demo     — scripts/train_demo.py: run_demo at tests/test_train_demo.py's
                configuration (both rows within 5%, the loss halved, every
                path integrated at every step), run_texture_demo at its
                defaults (texel mean |err| < 0.03, PSNR > 22 dB), and the
                first 3 steps of a 24x24 run_demo on the card against the
                CPU twins (losses and parameters within atol 2e-5 / rtol
                1e-3); the demo's PNGs and JSONL in chiprun_out/.
10g. scaling  — scripts/bench_scaling.py at tools/bench_scaling.py's
                defaults (wavefront_comparison 256x144, 2 spp, depth 8,
                the wavefront engine) over 1, 2 and 4 gloo ranks sharing
                the card, each size a job of its own: JAX's line per size,
                each frame within 1e-5 of the one-rank frame and finite,
                paths = 256 x 144 x 2 at every size, K1-K4 launched on
                every rank, the phase's seconds.
10h. kept loop — the wavefront's loop graph kept across batches: a
                vol2_final and a mesh_perlin_sss frame batch by batch through
                render_batch (one capture for the frame, none for a second)
                against the same frame with a capture per batch (counters
                equal batch by batch, the frames within the benchmark's
                frame_l1_gap limit), the reset kernel alone on the drained
                state against init_state, and a scene leaf changed between
                two render_batch_diff steps (a capture a step, the changed
                scene's image).  `python3 chip_smoke.py --kept-loop` runs
                the device, the build and this phase alone.
11. the JSON kernel table (every kernel, then every instantiation timed in
    phases 9b-9c: ``<kernel>_k8``, ``<kernel>_k4_global``, with its ptxas
    registers, stack frame and spills, and ``device_ms``, its device time
    per launch: a kernel of a profiled frame, its device time there over
    its runs; any other, launches queued behind a spin kernel and timed
    with CUDA events where it is timed, or the CUDA graph above), then the
    JSON result line.

Phase 3 also holds the tiled engine's kernels against their plain
versions: K7 (closest_hit; its main query, and its volume-exit query as the
engine walks it, on the lanes whose hit has a medium, each timed apart), K8
(tiled_trip; over every lane, and on live lists as every tiled frame runs
it: bit-identical to the every-lane launch, the list it writes the next
live lanes, each once) and the tiled spawn on every lane of an 800x450
vol2_final sample after three trips (the spawn also on the kept trip
graph's argument block and frame memory loaded with a new key and view,
its sample read from card memory, against spawn_paths of that frame, and
on NL - 7 scattered lanes into new rows and into rows 4 bytes off 16-byte
alignment; its ptxas line, SASS instruction count and an estimate of the
integer issue of its draws on the phase line), K9 (ring_hop; the two hops
of a 2-stage ring, each also bit-equal to the hop walked to t_max as JAX
walks it) and K8's rec variant over the torus knot sharded two ways; and
the P0 row gather (gather_rows) against torch.index_select at P0's shape,
with the empty kernel on its grid (its launch floor) and its ptxas line.
The gather
phase holds P0 equal to index_select at every shape of
scripts/bench_gather.py and on out-of-range indices (clamped).  Every K6
launch must leave the counters it fetches pixels from at 0.

Each main phase sets the launch counts to 0 just before it runs and reads
them just after; the table's ``launches`` come from those runs.  Every
frame profiled under torch.profiler must show, for each kernel, as many
runs as its wrapper counted (``profile_run``): the counts of launches that
a CUDA graph replays are measured, not only derived from the waves run.  The build
phase also holds K3, K5, K7, K1, K4, K2, K6, K9, K8, the tiled spawn and
the wave loop's reset at their recorded ptxas resources (``PTXAS_EXPECT``: K6's recorder must compile to nothing in K3
and K5), fails on a spill in any walking kernel's instantiation, and
prints K1's global loads by width from its SASS (``cuobjdump -sass``).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from path_tracer_tpu_torch.utils.image import graded_agreement

RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # fp32 outside the tensor cores

KERNELS = {
    "trace_step": ("path_tracer_tpu_torch/csrc/trace_step.cu",
                   "path_tracer_tpu/ops/traverse.py:334"),
    "spawn": ("path_tracer_tpu_torch/csrc/spawn.cu",
              "path_tracer_tpu/ops/wavefront.py:216"),
    "shade": ("path_tracer_tpu_torch/csrc/shade.cu",
              "path_tracer_tpu/ops/shade_tiled.py:773"),
    "retire": ("path_tracer_tpu_torch/csrc/retire.cu",
               "path_tracer_tpu/ops/wavefront.py:268"),
    "megakernel": ("path_tracer_tpu_torch/csrc/megakernel.cu",
                   "path_tracer_tpu/ops/integrator.py:253"),
    "adjoint": ("path_tracer_tpu_torch/csrc/adjoint.cu",
                "path_tracer_tpu/ops/wavefront.py:520"),
    "adjoint_full": ("path_tracer_tpu_torch/csrc/adjoint.cu",
                     "path_tracer_tpu/ops/integrator.py:268"),
    "closest_hit": ("path_tracer_tpu_torch/csrc/closest_hit.cu",
                    "path_tracer_tpu/ops/integrator_tiled.py:46"),
    "tiled_trip": ("path_tracer_tpu_torch/csrc/tiled_trip.cu",
                   "path_tracer_tpu/ops/integrator_tiled.py:91"),
    "tiled_spawn": ("path_tracer_tpu_torch/csrc/tiled_trip.cu",
                    "path_tracer_tpu/ops/shade_tiled.py:741"),
    "ring_hop": ("path_tracer_tpu_torch/csrc/closest_hit.cu",
                 "path_tracer_tpu/parallel/pipeline.py:63"),
    "tiled_trip_rec": ("path_tracer_tpu_torch/csrc/tiled_trip.cu",
                       "path_tracer_tpu/parallel/pipeline.py:140"),
    "wave_loop": ("path_tracer_tpu_torch/csrc/wave_loop.cu",
                  "path_tracer_tpu/ops/wavefront.py:427"),
    "gather_rows": ("path_tracer_tpu_torch/csrc/gather.cu",
                    "tools/bench_gather.py:119"),
}
TILED_KERNELS = ("closest_hit", "tiled_trip", "tiled_spawn")
STATE_BYTES = 61                # one lane's path state (PathState)
SPIN_CYCLES = 50_000_000        # device_ms's spin kernel, which lasts at
SPIN_MS_MIN = 10.0              # least this long (50M cycles at <= 5 GHz)
REFINE_OPS = 150                # refine_hit of one primitive
WAVE_KERNELS = ("trace_step", "spawn", "shade", "retire")
THREEFRY_OPS = 110             # fp32-equivalent ops of one threefry2x32
THREEFRY_INT = 70              # its least integer instructions: 20 rounds
#                                of add, rotate, xor; 5 key injections
BOUNCE_OPS = 600 + 12 * THREEFRY_OPS   # fp32 ops of one bounce
WALK_TRIP_OPS = 3 * 110 + 60   # one SSS walk trip
SWEEP_OPS = 60                 # K6's reverse sweep, per tape entry
# fp32 ops of one traversal step by node width: K slab tests, K inline leaf
# tests and the compare-swap network (5 comparators at K = 4, 19 at 8);
# the K = 8 step does twice the per-child work of the K = 4 one.
STEP_OPS = {4: 220, 8: 440}
# What the gradient needs beyond the forward (counted as K5's replay): per
# tape entry the bounce's transpose (about as many operations as the
# bounce), per SSS walk trip the walk's reverse.  The full K6's recompute of
# each bounce and its re-runs of the walk are its design's overhead above
# the bound, not part of it.
FULL_SWEEP_OPS = BOUNCE_OPS
FULL_WALK_OPS = WALK_TRIP_OPS
# (registers, stack frame bytes) of K3, K5, K7, K1, K4, K2, K6, K9, K8 and the
# tiled spawn as recorded in PERF.md (Findings); a key names a kernel or one of its
# INSTANCES.  K5 and K6 walk trav_step16 rolled, K7 and K9 unrolled
# (csrc/path.cuh); K6's recorder hooks compile to nothing in K3 and K5.
PTXAS_EXPECT = {"shade": (110, 104), "megakernel_k4": (117, 368),
                "megakernel_k8": (118, 368), "megakernel_k4_global": (118, 112),
                "megakernel_k8_global": (119, 112),
                "closest_hit_k4": (64, 256), "closest_hit_k8": (72, 256),
                "closest_hit_k4_global": (65, 0),
                "closest_hit_k8_global": (72, 0),
                "trace_step_k4": (130, 0), "trace_step_k8": (162, 0),
                "tiled_trip": (106, 104), "tiled_spawn": (32, 0),
                "retire": (24, 0), "spawn": (42, 32), "wave_reset": (28, 0),
                "adjoint_k4": (121, 3696), "adjoint_k8": (121, 3696),
                "adjoint_k4_global": (126, 104), "adjoint_k8_global": (126, 104),
                "adjoint_full_k4": (164, 4832), "adjoint_full_k8": (164, 4832),
                "adjoint_full_k4_global": (162, 224),
                "adjoint_full_k8_global": (162, 224),
                "ring_hop_k4": (67, 256), "ring_hop_k8": (75, 256),
                "ring_hop_k4_global": (67, 0), "ring_hop_k8_global": (76, 0)}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


# The walking kernels' instantiations (kernels.instance): each row's name,
# the kernel it instantiates and its template arguments as a demangled name
# spells them.  The first of each kernel is the one earlier tables time.
INSTANCES = {
    "trace_step_k4": ("trace_step", "4"), "trace_step_k8": ("trace_step", "8"),
    **{f"{n}_k{k}{'_global' if g else ''}": (n, f"{k}, {str(g).lower()}")
       for n in ("megakernel", "closest_hit", "ring_hop", "adjoint",
                 "adjoint_full")
       for k in (4, 8) for g in (False, True)},
}


def mangled_targs(targs):
    """Template arguments as the Itanium ABI mangles them: "8, false" ->
    "ILi8ELb0EE"."""
    return "I" + "".join(
        f"Lb{int(a == 'true')}E" if a in ("true", "false") else f"Li{a}E"
        for a in targs.split(", ")) + "E"


def is_kernel(key, name, targs=None):
    """Whether a profiler event is a run of kernel ``name``, of its
    instantiation ``<targs>`` where given (e.g. ``"8, false"``); the name
    demangled (``void megakernel_kernel<8, false>(WaveArgs)``) or not."""
    base = f"{name}_kernel"
    if key.startswith("_Z"):
        head = f"_Z{len(base)}{base}"
        if targs is not None:
            return key.startswith(head + mangled_targs(targs))
        return key.startswith(head) and key[len(head):len(head) + 1] in "I8"
    k = key[5:] if key.startswith("void ") else key
    if targs is not None:
        return k.startswith(f"{base}<{targs}>")
    return k.startswith(base + "(") or k.startswith(base + "<")


def profile_run(prepare, names, kernels, tag, insts=(), seq=None):
    """``prepare()`` (untimed) returns a callable; run it once under
    torch.profiler with the launch counts set to 0 just before and read
    just after → (its result, device ms by kernel, launches by kernel,
    wall s).  The runs of each instantiation in ``insts`` (names of
    ``INSTANCES``) must equal its count in ``kernels.INSTANCES`` too.
    ``seq`` (a dict), where given, receives each kernel's runs' device ms
    in the order they ran.

    The profiler counts the runs of each kernel the card executed, and
    that count must equal the wrappers' LAUNCHES of the same run: inside a
    CUDA graph the wrappers count from what the graph ran (waves or
    replays), and this holds them against the kernels the card ran.  CUPTI
    can lose an activity record (seen once on the H100: 404 of 406 K1
    runs of an SSS frame), so a run whose counts all lie below or at LAUNCHES is
    profiled again, three runs at most; a count above LAUNCHES fails at
    once."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run = prepare()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {n: kernels.LAUNCHES[n] for n in names}
        i_launches = {i: kernels.INSTANCES[i] for i in insts}
        totals, counts = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        i_counts = dict.fromkeys(insts, 0)
        for ev in prof.key_averages():
            for n in names:
                if is_kernel(ev.key, n):
                    totals[n] += ev.device_time_total / 1e3
                    counts[n] += ev.count
            for i in insts:
                if is_kernel(ev.key, *INSTANCES[i]):
                    i_counts[i] += ev.count
        if (counts == launches and i_counts == i_launches) or any(
                counts[n] > launches[n] for n in names):
            break
        phase(tag, f"the profiler saw {counts}, fewer than the launches "
              f"{launches}: profiled again (its kernel names and runs: "
              + ", ".join(f"{ev.key} x{ev.count}" for ev in
                          prof.key_averages() if any(
                              is_kernel(ev.key, n) for n in names)) + ")")
    assert counts == launches, (f"{tag}: the profiler's kernel runs {counts} "
                                f"!= the wrappers' launches {launches}")
    if seq is not None:
        runs = sorted((ev.time_range.start, n, ev.time_range.elapsed_us())
                      for ev in prof.events()
                      if ev.device_type.name == "CUDA"
                      for n in names if is_kernel(ev.name, n))
        for n in names:
            seq[n] = [us / 1e3 for _t, m, us in runs if m == n]
    assert i_counts == i_launches, (
        f"{tag}: the profiler's runs of the instantiations {i_counts} != the "
        f"wrappers' counts {i_launches}")
    return out, totals, launches, wall


def cuda_ms(fn, reps=25, setup=None):
    """Median ms of ``fn`` over ``reps`` runs (CUDA events; setup untimed)."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, setup=None, n=10):
    """Device ms per call of ``fn`` (one kernel launch): ``n`` calls queued
    behind a spin kernel, so that the host has queued them all before the
    first runs, timed with CUDA events (were the host still queueing when
    a 64-fold spin ended, host gaps would be in it: an upper bound);
    ``setup`` (run before each call) is timed alone the same way and taken
    off."""
    def queued(step):
        spin = SPIN_CYCLES
        for _ in range(4):
            torch.cuda.synchronize()
            torch.cuda._sleep(spin)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            host_ms = 1e3 * (time.perf_counter() - t0)
            e1.record()
            torch.cuda.synchronize()
            dev = e0.elapsed_time(e1)
            if host_ms < SPIN_MS_MIN * spin / SPIN_CYCLES:
                return dev / n
            spin *= 4            # the host was not done before the spin ended
        return dev / n           # host gaps included: an upper bound

    def both():
        setup()
        fn()

    if setup is None:
        return queued(fn)
    return queued(both) - queued(setup)


def ptxas_resources(log, name, targs=None, tag=None):
    """(registers, stack frame bytes, spill stores, spill loads) of
    ``<name>_kernel`` in a ptxas -v log: of its instantiation ``<targs>``
    (e.g. ``"8, false"``) where given, else of its only (or last) entry;
    ``tag``, where given, is the part of the mangled name to look for."""
    if tag is None:
        tag = f"{name}_kernel" + (mangled_targs(targs) if targs else "")
    regs = frame = stores = loads = None
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if tag not in line:
            continue
        if "Function properties" in line and i + 1 < len(lines):
            props = lines[i + 1].split(",")
            frame = int(props[0].split("bytes stack frame")[0].split()[-1])
            stores = int(props[1].split("bytes spill stores")[0].split()[-1])
            loads = int(props[2].split("bytes spill loads")[0].split()[-1])
        if "Compiling entry function" in line:
            for nxt in lines[i + 1:]:
                if "Used" in nxt and "registers" in nxt:
                    regs = int(nxt.split("Used")[1].split("registers")[0])
                    break
    return regs, frame, stores, loads


def frame_phase(tag, make, W, H, spp, depth, names, kernels):
    """Warm up, then render one frame with the launch counts set to 0 just
    before and read just after; two more frames for the spread and one
    under torch.profiler for per-kernel device time.  Returns a record."""
    make().render(spp=1)                                   # warm-up
    r = make()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=spp, batch=spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    st = r.stats
    mr_ub = W * H * spp * depth / wall / 1e6
    mr_meas = st.rays / wall / 1e6
    phase(tag, f"{W}x{H} {spp} spp depth {depth}: wall {wall:.4f} s, "
          f"{1000 * wall / spp:.2f} ms/sample, upper-bound {mr_ub:.3f} "
          f"Mrays/s, measured {mr_meas:.3f} Mrays/s ({st.rays} segments), "
          f"walk steps {st.walk_steps}, waves {st.waves}, ctrls {st.ctrls}, "
          f"host reads {st.host_reads}, launches {launches}")
    assert np.isfinite(img).all(), "non-finite pixels"
    assert float(img.mean()) > 0.0, "black image"
    assert st.paths == W * H * spp, f"paths {st.paths} != {W * H * spp}"
    missing = [n for n in names if launches[n] == 0]
    assert not missing, f"kernels not launched on this path: {missing}"
    walls = [wall]
    for _ in range(2):                          # spread of the frame time
        rr_ = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr_.render(spp=spp, batch=spp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    phase(tag, "frame wall s over 3 frames: " + ", ".join(
        f"{w:.4f}" for w in walls) + f" (median {statistics.median(walls):.4f})")
    # Per-kernel device time of one frame: torch.profiler (CUPTI) sums the
    # device time of each kernel by name, and counts its runs, which must
    # equal the launches counted in the profiled frame and in the first.
    def prepare():
        r2 = make()
        return lambda: r2.render(spp=spp, batch=spp)

    _, totals, prof_launches, prof_wall = profile_run(prepare, names, kernels,
                                                      tag)
    assert all(totals[n] > 0.0 for n in names), \
        f"profiler saw no device time for some kernel: {totals}"
    assert prof_launches == {n: launches[n] for n in names}, \
        f"launches differ between two frames: {prof_launches} vs {launches}"
    busy = sum(totals.values())
    idle = 1 - busy / (1e3 * prof_wall)
    phase(tag, "per-kernel device ms over one frame (torch.profiler): "
          + ", ".join(f"{n}={totals[n]:.2f} ({prof_launches[n]} "
                      f"launches, as many runs seen)" for n in names)
          + f"; kernels {busy:.2f} ms of {1e3 * prof_wall:.2f} ms wall under "
          f"the profiler (device idle share {idle:.3f})")
    return dict(r=r, img=img, wall=wall, walls=walls, mrays_ub=mr_ub,
                mrays_measured=mr_meas, rays=st.rays, walk_steps=st.walk_steps,
                waves=st.waves, ctrls=st.ctrls, host_reads=st.host_reads,
                launches=launches, kernel_totals_ms=totals,
                profiled_wall_ms=1e3 * prof_wall, idle_share=idle)


def compiled(world, cam, w, h, spp, depth, dev):
    """(scene, flags, bvh, camera, config) of a world at w x h."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    cam.aspect_ratio, cam.img_width = w / h, w
    sc = ptt.compile_scene(world, device=dev)
    return (sc, SceneFlags.from_scene(sc), ptt.build_from_scene(sc),
            cam.initialize(device=dev),
            RenderConfig(width=w, height=h, samples_per_pixel=spp,
                         max_depth=depth))


def torus_knot(dev, w=800, h=800, spp=1, depth=4):
    """tests/test_tp_scale.py:27-49: a 102,400-triangle torus knot over a
    ground sphere under a light."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.models.geometry import torus_knot as knot
    world = ptt.HittableList()
    world.add(ptt.Sphere.stationary((0, -1000, 0), 1000,
                                    ptt.Lambertian((0.5, 0.5, 0.5))))
    world.add(knot(ptt.Metal((0.75, 0.65, 0.5), 0.05), segments=400,
                   sides=128, tube_radius=0.35, center=(0.0, 1.6, 0.0)))
    world.add(ptt.Sphere.stationary((0, 7, 4), 2.0,
                                    ptt.DiffuseLight((6, 6, 6))))
    cam = ptt.Camera()
    cam.vfov = 35
    cam.lookfrom = np.array([9.0, 4.5, 7.0])
    cam.lookat = np.array([0.0, 1.4, 0.0])
    return compiled(world, cam, w, h, spp, depth, dev)


def vol2(dev, w=800, h=450, spp=10, depth=10):
    import path_tracer_tpu_torch as ptt
    return compiled(*ptt.scenes.vol2_final_scene(sphere_cluster=1000), w, h,
                    spp, depth, dev)


# Rank jobs of the parallel phase: (world size, job names).
RANK_RUNS = ((2, ("dp_wavefront", "dp_mega", "dp_train", "tp", "pp", "tp8",
                  "pp8")),
             (4, ("dp_tp",)))
DP_TP = dict(w=400, h=225, spp=2, depth=10)
TRAIN_SPP, TRAIN_LR = 4, 1e-9


def run_ranks(world, jobs, out_dir, timeout=420):
    """Run this script's ``jobs`` on ``world`` rank processes (the port's
    launcher: a free port, every rank killed as soon as one fails)."""
    from path_tracer_tpu_torch.parallel.launch import run_ranks as launch
    return launch(world, lambda r, port: [
        sys.executable, os.path.abspath(__file__), "--rank", str(r),
        str(world), str(port), out_dir, *jobs], out_dir, timeout)


def rank_main(argv) -> int:
    """One rank of the parallel phase: ``--rank RANK WORLD PORT DIR JOB..``.
    Joins a gloo job on 127.0.0.1:PORT (the ranks share card 0), runs each
    job with the launch counts set to 0 just before and read just after,
    and saves ``DIR/<job>.<rank>.pt``."""
    rank, world, port, out_dir, jobs = (int(argv[0]), int(argv[1]), argv[2],
                                        argv[3], argv[4:])
    import torch.distributed as dist
    from path_tracer_tpu_torch import parallel as par
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.utils import rng
    torch.set_num_threads(2)
    par.init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    dev = torch.device("cuda")
    kernels.build()
    key = rng.key(0, device=dev)
    for job in jobs:
        out = {}
        if job in ("dp_wavefront", "dp_mega", "dp_train"):
            mesh = par.make_mesh(world)
            sc, fl, bvh, ca, cf = vol2(dev)
        if job == "dp_mega":
            par.render_sharded(sc, fl, bvh, ca, cf, key, mesh, 1)
            run = lambda: par.render_sharded(  # noqa: E731
                sc, fl, bvh, ca, cf, key, mesh, cf.samples_per_pixel)
        elif job == "dp_wavefront":
            par.render_sharded_wavefront(sc, fl, bvh, ca, cf, key, mesh, spp=1,
                                         queue_size=32768, steps_per_wave=32)
            run = lambda: par.render_sharded_wavefront(  # noqa: E731
                sc, fl, bvh, ca, cf, key, mesh, spp=cf.samples_per_pixel,
                queue_size=32768, steps_per_wave=32, with_stats=True)
        elif job == "dp_train":
            cf = dataclasses.replace(cf, samples_per_pixel=TRAIN_SPP)
            inp = torch.load(os.path.join(out_dir, "train_inputs.pt"))
            params = {k: v.to(dev) for k, v in inp["params"].items()}
            target = inp["target"].to(dev)
            n_waves = par.calibrate_n_waves(
                dataclasses.replace(sc, **params), fl, bvh, ca, cf, key,
                spp=TRAIN_SPP, queue_size=32768, steps_per_wave=32, mesh=mesh)
            step = par.make_train_step(fl, cf, mesh, spp=TRAIN_SPP,
                                       lr=TRAIN_LR, queue_size=32768,
                                       steps_per_wave=32, n_waves=n_waves,
                                       unbiased=True)
            step(params, sc, bvh, ca, rng.fold_in(key, 99), target)
            out["n_waves"] = n_waves
            run = lambda: step(params, sc, bvh, ca,  # noqa: E731
                               rng.fold_in(key, 0), target)
        elif job in ("tp", "pp", "tp8", "pp8"):
            axis = "t" if job.startswith("tp") else "p"
            mesh = par.make_mesh(world, axis)
            sc, fl, _, ca, cf = torus_knot(dev)
            sc_s, bv_s = par.shard_scene(sc, world,
                                         8 if job.endswith("8") else 4)
            fn = par.render_tp if axis == "t" else par.render_pp
            run = lambda: fn(sc_s, fl, bv_s, ca, cf, key, mesh,  # noqa: E731
                             axis=axis)
        elif job == "dp_tp":
            mesh = par.make_mesh((2, world // 2), ("d", "t"))
            sc, fl, _, ca, cf = vol2(dev, **DP_TP)
            sc_s, bv_s = par.shard_scene(sc, world // 2)
            run = lambda: par.render_dp_tp(  # noqa: E731
                sc_s, fl, bv_s, ca, cf, key, mesh, spp=cf.samples_per_pixel)
        else:
            raise ValueError(f"unknown rank job {job!r}")
        dist.barrier()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
        out["launches"] = dict(kernels.LAUNCHES)
        out["instances"] = dict(kernels.INSTANCES)
        if job == "dp_wavefront":
            out["image"], out["stats"] = res[0].cpu(), {
                k: v.cpu() for k, v in res[1].items()}
        elif job == "dp_train":
            _, loss, grads, aux = res
            out.update(loss=float(loss), aux=aux,
                       grads={k: v.cpu() for k, v in grads.items()})
        else:
            out["image"] = res.cpu()
        torch.save(out, os.path.join(out_dir, f"{job}.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def bound_trip(shade_bytes, lanes, n_live, walk):
    """K8's bound ms for one launch over ``lanes`` lanes with ``n_live``
    live and ``walk`` SSS walk steps: per lane its flag, per live lane its
    state read and written, its pixel and both queries' results, the shade
    tables once; per live lane one bounce, per walk step one walk trip."""
    byts = shade_bytes + lanes + n_live * (2 * STATE_BYTES + 4 + 9 + 13)
    ops = n_live * BOUNCE_OPS + walk * WALK_TRIP_OPS
    return 1e3 * max(byts / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)


def trip_work(itl, scene, flags, bvh, cam_a, cfg, key, spp, c_walk):
    """The tiled frame's K8 work through the eager loop: ``[trip][sample]
    -> (live lanes, walk steps)``."""
    teng = itl.TiledEngine(scene, flags, bvh, cam_a, cfg, key)
    n = cfg.width * cfg.height
    pix = torch.arange(n, dtype=torch.int32, device=bvh.nodes.device)
    t_min = torch.full((n,), cfg.t_min, device=pix.device)
    out = [[] for _ in range(cfg.iters)]
    for smp in range(spp):
        live = itl.new_live_list(n, pix.device)
        st = itl.tiled_spawn(teng, smp, pix, live)
        ctr = itl.new_counters(pix.device)
        for t in range(cfg.iters):
            h_ = itl.closest_hit_batched(bvh, st.origin, st.direction,
                                         st.time, t_min, cfg.t_max,
                                         cfg.stack_depth, active=st.alive)
            e_ = itl.closest_hit_batched(
                bvh, st.origin, st.direction, st.time, h_[3] + 1e-4,
                cfg.t_max, cfg.stack_depth, active=st.alive,
                exit_of=(teng, h_[0], h_[1], h_[2]))
            n_live, w0 = int(st.alive.sum()), int(ctr[c_walk])
            st = itl.tiled_trip(teng, st, smp, pix, h_[:3], e_, ctr=ctr,
                                live=live, parity=t & 1)
            out[t].append((n_live, int(ctr[c_walk]) - w0))
    return out


ENTRY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_entry")   # scratch files of the entry phase


def vol2_renderer(engine="wavefront", w=800, h=450, spp=10, depth=10,
                  cam_=None):
    """A Renderer of vol2_final_scene(sphere_cluster=1000) at w x h (or at
    the camera ``cam_``) on the card."""
    import path_tracer_tpu_torch as ptt
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    if cam_ is None:
        cam.aspect_ratio, cam.img_width = w / h, w
        cam.samples_per_pixel, cam.max_depth = spp, depth
    else:
        cam = cam_
    return ptt.Renderer(world, cam, engine=engine)


# One rank of a 2-rank job that renders the first 4 samples of
# cli_command's 10-spp job (the CLI's scene, camera, seed and engine knobs)
# into a checkpoint; argv: coordinator, rank, checkpoint path.
PART_RUN = """
import sys
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.parallel import render_dist
render_dist.init_distributed(sys.argv[1], 2, int(sys.argv[2]), backend="gloo")
world, cam = ptt.scenes.SCENES["vol2_final_scene"]()
cam.img_width, cam.samples_per_pixel, cam.max_depth = 800, 10, 10
render_dist.render_distributed(world, cam, spp=4, seed=0, batch=2,
                               checkpoint_path=sys.argv[3],
                               checkpoint_every=4)
"""


def cli_command(*args):
    return [sys.executable, "-m", "path_tracer_tpu_torch.render.cli",
            "--scene", "vol2_final_scene", "--width", "800", "--spp", "10",
            "--max-depth", "10", "--batch", "2", *args]


def entry_phase(card):
    """Phase 10b: the entry points users start from, at the main
    configuration.  Returns (ok, record)."""
    import shutil
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels, shade_tiled
    from path_tracer_tpu_torch.ops import wavefront as wf
    from path_tracer_tpu_torch.ops.types import (C_DO_CTRL, C_N_OCC,
                                                 FL_RESAMPLE)
    from path_tracer_tpu_torch.parallel.launch import run_ranks as launch
    from path_tracer_tpu_torch.render.orbit import OrbitCamera, restart
    repo = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    os.makedirs(ENTRY_DIR)
    W, H, SPP = 800, 450, 10
    npix = W * H
    rec, oks = {}, {}
    t_phase = time.perf_counter()

    def launched(tag, need):
        got = dict(kernels.LAUNCHES)
        missing = [n for n in need if got[n] == 0]
        assert not missing, f"{tag}: kernels not launched: {missing}"
        return {n: got[n] for n in need}

    # (a) checkpoint and resume: 4 spp in batches of 2, checkpointed every
    # 2 samples with a metrics file; a new Renderer resumes to 10.
    ck = os.path.join(ENTRY_DIR, "vol2.ckpt.npz")
    met = os.path.join(ENTRY_DIR, "metrics.jsonl")
    torch.cuda.synchronize()
    kernels.reset_launches()
    vol2_renderer().render(spp=4, batch=2, checkpoint_path=ck,
                           checkpoint_every=2, metrics_path=met)
    with np.load(ck) as z:
        first = int(z["samples_done"])
    res = vol2_renderer()
    res.render(spp=SPP, batch=2, checkpoint_path=ck, checkpoint_every=2,
               metrics_path=met)
    torch.cuda.synchronize()
    la = launched("entry", WAVE_KERNELS)
    ref = vol2_renderer()
    ref.render(spp=SPP, batch=2)
    acc_r, acc_u = res.accum.cpu().numpy(), ref.accum.cpu().numpy()
    bit = np.array_equal(acc_r, acc_u)
    g_ok, g_out, g_clean = graded_agreement(acc_r / SPP, acc_u / SPP)
    n_lines = len(open(met).read().splitlines())
    sss_world, sss_cam = ptt.scenes.mesh_perlin_sss()
    sss_cam.aspect_ratio, sss_cam.img_width = W / H, W
    sss_cam.samples_per_pixel, sss_cam.max_depth = SPP, 10
    ck_sss = os.path.join(ENTRY_DIR, "sss.ckpt.npz")
    ptt.Renderer(sss_world, sss_cam, engine="wavefront").save_checkpoint(
        ck_sss)
    try:
        vol2_renderer().load_checkpoint(ck_sss)
        refused = ""
    except ValueError as e:
        refused = str(e)
    oks["a"] = ((bit or g_ok) and first == 4 and res.samples_done == SPP
                and res.stats.paths == npix * (SPP - 4) and n_lines == 5
                and "fingerprint" in refused)
    why = "" if bit else (" (not bit-identical: held to the graded rule; "
                          "the resumed frame differs in float add order)")
    phase("entry", f"(a) checkpoint 4 spp (batch 2, every 2) then a new "
          f"Renderer resumed to {SPP}: bit-identical to one uninterrupted "
          f"render of the same batches {bit}, graded outliers {g_out:.5f} "
          f"clean mean {g_clean:.2e}{why}; checkpoint at {first} samples, "
          f"resumed paths {res.stats.paths}, metrics lines {n_lines} (5 "
          f"expected); mesh_perlin_sss {W}x{H} checkpoint refused: "
          f"{refused[:90]!r}; launches {la} -> "
          f"{'PASS' if oks['a'] else 'FAIL'}")

    # (b) autotune: probe, prediction, the candidates, the choice; the
    # tuned frame against the preset frame.
    kernels.reset_launches()
    rt = vol2_renderer()
    chosen = rt.autotune()
    img_t = rt.render(spp=SPP, batch=SPP)
    torch.cuda.synchronize()
    lb = launched("entry", WAVE_KERNELS)
    rp = vol2_renderer()
    img_p = rp.render(spp=SPP, batch=SPP)
    tb_ok, tb_out, tb_clean = graded_agreement(img_t, img_p)
    tu = rt.tuning
    oks["b"] = (tb_ok and rt.stats.paths == rp.stats.paths == npix * SPP
                and rt.stats.rays == rp.stats.rays
                and chosen in tu["ms_per_sample"])
    rec["autotune"] = dict(probe=tu["probe"], reading=tu["reading"],
                           predicted=tu["predicted"], preset=tu["preset"],
                           ms_per_sample={str(c): v for c, v in
                                          tu["ms_per_sample"].items()},
                           chosen=chosen)
    phase("entry", f"(b) autotune probe {tu['probe']} (occupancy "
          f"{tu['reading']['occ']:.4f}, steps a segment "
          f"{tu['reading']['steps_seg']:.3f}) -> predicted (queue, steps, "
          f"ctrl_den, stride) {tu['predicted']}, preset {tu['preset']}; ms a "
          f"sample " + ", ".join(f"{c} {v:.3f}" for c, v in
                                  tu["ms_per_sample"].items())
          + f"; chosen {chosen}; tuned {SPP}-spp frame vs the preset frame: "
          f"outliers {tb_out:.5f}, clean mean {tb_clean:.2e}, paths "
          f"{rt.stats.paths}/{rp.stats.paths}, rays {rt.stats.rays}/"
          f"{rp.stats.rays}; launches {lb} -> {'PASS' if oks['b'] else 'FAIL'}")

    # (c) the spawn order: K2 with tile_spawn_order(800, 450) against its
    # twin on control waves; the frame with the order against the default.
    sc, fl, bvh, ca, cf = vol2(torch.device("cuda"))
    key = ptt.utils.rng.key(0, device=torch.device("cuda"))
    order = wf.tile_spawn_order(W, H)
    eng = wf.WaveEngine(sc, fl, bvh, ca, cf, 0, SPP, key, 32768, 32, 8,
                        spawn_order=order)
    ws = eng.init_state(torch.zeros((H, W, 3), device="cuda"))
    for _ in range(48):
        for op in wf.KERNELS:
            op(eng, ws)
    k2_ok, n_waves_k2, renewed = True, 0, 0
    while n_waves_k2 < 3:
        wf.trace_step(eng, ws)
        if int(ws.ctr[C_DO_CTRL]) == 0:
            for op in wf.KERNELS[1:]:
                op(eng, ws)
            continue
        shade_tiled.shade(eng, ws)
        wf.retire(eng, ws)
        snap = ws.clone()
        k2, p2 = snap.clone(), snap.clone()
        kernels.launch("spawn", eng, k2)
        wf.spawn_plain(eng, p2)
        torch.cuda.synchronize()
        mk = (snap.flag == FL_RESAMPLE) | (~snap.occupied & k2.occupied)
        mp = (snap.flag == FL_RESAMPLE) | (~snap.occupied & p2.occupied)
        ik = k2.sample[mk].long() * npix + k2.pixel[mk].long()
        ip = p2.sample[mp].long() * npix + p2.pixel[mp].long()
        eq = torch.equal(torch.sort(ik).values, torch.sort(ip).values)
        if eq:
            a_, b_ = torch.argsort(ik), torch.argsort(ip)
            eq = all(torch.equal(getattr(k2, f)[mk][a_], getattr(p2, f)[mp][b_])
                     for f in ("origin", "direction", "time", "sample",
                               "pixel", "last", "throughput"))
            eq = eq and torch.equal(k2.ctr[C_N_OCC], p2.ctr[C_N_OCC])
        k2_ok = k2_ok and eq
        renewed += int(mk.sum())
        n_waves_k2 += 1
        ws = k2
    del ws, snap, k2, p2, eng
    torch.cuda.empty_cache()

    def frame(order_):
        return wf.render_batch(sc, fl, bvh, ca, cf, torch.zeros(
            (H, W, 3), device="cuda"), 0, SPP, key, queue_size=32768,
            steps_per_wave=32, with_stats=True, spawn_order=order_)

    frame(None)
    frame(order)
    walls = {"default": [], "tiled order": []}
    for _ in range(2):
        for name, o_ in (("default", None), ("tiled order", order)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img_, st_ = frame(o_)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if name == "default":
                img_d, st_d = img_.cpu().numpy(), st_
            else:
                img_o, st_o = img_.cpu().numpy(), st_
    # K1's device ms a frame, data for a later PR and no gate: the runs the
    # profiler saw are printed beside the launches (it lost 4 of 517 of
    # every wave kernel, three profiles in a row, late in one session).
    from torch.profiler import ProfilerActivity, profile
    k1 = {}
    for name, o_ in (("default", None), ("tiled order", order)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frame(o_)
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if is_kernel(ev.key, "trace_step")]
        k1[name] = (sum(ev.device_time_total for ev in evs) / 1e3,
                    sum(ev.count for ev in evs), kernels.LAUNCHES["trace_step"])
    c_ok, c_out, c_clean = graded_agreement(img_o / SPP, img_d / SPP)
    oks["c"] = (k2_ok and c_ok and int(st_o["paths"]) == int(st_d["paths"])
                == npix * SPP and int(st_o["rays"]) == int(st_d["rays"])
                and (st_o["pixel_paths"] == SPP).all().item())
    rec["spawn_order"] = dict(walls=walls, k1_device_ms=k1,
                              waves={"default": int(st_d["waves"]),
                                     "tiled order": int(st_o["waves"])})
    phase("entry", f"(c) spawn order: K2 with tile_spawn_order({W}, {H}) vs "
          f"its twin on {n_waves_k2} control waves ({renewed} renewed slots): "
          f"items, rays and counters exact {k2_ok}; the {SPP}-spp frame with "
          f"the order vs the default frame: outliers {c_out:.5f}, clean mean "
          f"{c_clean:.2e}, paths {int(st_o['paths'])}/{int(st_d['paths'])}, "
          f"rays {int(st_o['rays'])}/{int(st_d['rays'])}, waves "
          f"{int(st_o['waves'])}/{int(st_d['waves'])}; walls s (alternating) "
          f"default {', '.join(f'{w:.4f}' for w in walls['default'])}, order "
          f"{', '.join(f'{w:.4f}' for w in walls['tiled order'])}; K1 device "
          f"ms a frame (torch.profiler) default {k1['default'][0]:.3f} "
          f"({k1['default'][1]} runs seen of {k1['default'][2]} launched), "
          f"order {k1['tiled order'][0]:.3f} ({k1['tiled order'][1]} of "
          f"{k1['tiled order'][2]}) -> {'PASS' if oks['c'] else 'FAIL'}")
    del sc, bvh

    # (d) orbit: rotate(40, 0), restart, 2 spp against a fresh Renderer.
    ro = vol2_renderer()
    ro.render(spp=2, batch=2)
    OrbitCamera(ro.camera).rotate(40, 0)
    kernels.reset_launches()
    restart(ro)
    ro.render(spp=2, batch=2)
    torch.cuda.synchronize()
    ld = launched("entry", WAVE_KERNELS)
    fresh = vol2_renderer(cam_=ro.camera)
    fresh.render(spp=2, batch=2)
    oks["d"] = (ro.samples_done == 2 and torch.equal(ro.accum, fresh.accum)
                and bool(torch.isfinite(ro.accum).all()))
    phase("entry", f"(d) orbit rotate(40, 0), restart, 2 spp: lookfrom "
          f"{np.round(ro.camera.lookfrom, 4).tolist()}, bit-identical to a "
          f"fresh Renderer at the moved camera {oks['d']}; launches {ld} -> "
          f"{'PASS' if oks['d'] else 'FAIL'}")
    del ro, fresh, rt, rp, res, ref
    torch.cuda.empty_cache()

    # (e) the CLI as a subprocess on the card, profiled.
    env = dict(os.environ, PYTHONPATH=repo)
    ck_e, met_e = (os.path.join(ENTRY_DIR, "cli.ckpt.npz"),
                   os.path.join(ENTRY_DIR, "cli.jsonl"))
    prof_dir = os.path.join(ENTRY_DIR, "profile")
    png = os.path.join(RUN_DIR, "cli.png")
    t0 = time.perf_counter()
    p = subprocess.run(cli_command("--checkpoint", ck_e, "--metrics", met_e,
                                   "--autotune", "--profile", prof_dir,
                                   "--out", png),
                       capture_output=True, text=True, env=env, cwd=repo,
                       timeout=300)
    cli_s = time.perf_counter() - t0
    summary = {}
    if p.returncode == 0:
        summary = json.loads(p.stdout.strip().splitlines()[-1])
    with open(os.path.join(RUN_DIR, "cli.log"), "w") as f:
        f.write(p.stdout + p.stderr)
    trace = ""
    if os.path.exists(os.path.join(prof_dir, "trace.json")):
        trace = open(os.path.join(prof_dir, "trace.json")).read()
    in_trace = {n: f"{n}_kernel" in trace for n in WAVE_KERNELS}
    oks["e"] = (p.returncode == 0 and summary.get("samples") == SPP
                and summary.get("rays_traced", 0) > 0 and all(in_trace.values())
                and os.path.exists(png))
    rec["cli"] = dict(rc=p.returncode, seconds=cli_s, summary=summary)
    phase("entry", f"(e) CLI (--width 800: the scene's aspect, 800x800; "
          f"{SPP} spp, batch 2, --checkpoint --metrics --autotune --profile) "
          f"as a subprocess: exit {p.returncode} in {cli_s:.1f} s, samples "
          f"{summary.get('samples')}, rays_traced "
          f"{summary.get('rays_traced')}, wall_s {summary.get('wall_s')} "
          f"(under the profiler); wave kernels in its trace {in_trace}; "
          f"{png} -> {'PASS' if oks['e'] else 'FAIL'}")

    # (f) the distributed CLI: 2 gloo ranks sharing the card.
    def dist_run(tag, spp, ckpt):
        out = os.path.join(ENTRY_DIR, f"{tag}.npz")
        secs = launch(2, lambda r, port: cli_command(
            "--spp", str(spp), "--checkpoint", ckpt, "--checkpoint-every",
            "4", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
            "2", "--process-id", str(r), "--backend", "gloo", "--out", out),
            ENTRY_DIR, 300, env=env, cwd=repo)
        with open(os.path.join(ENTRY_DIR, "rank2_0.log")) as f:
            log = f.read()
        with open(os.path.join(RUN_DIR, f"cli_{tag}.log"), "w") as f:
            f.write(log)
        with np.load(out) as z:
            return z["img"], secs, log

    img_a, secs_a, log_a = dist_run("dist", SPP,
                                    os.path.join(ENTRY_DIR, "dist.ckpt.npz"))
    # The partial run renders 4 samples of the CLI's 10-spp job through
    # render_distributed(spp=4), which leaves the configuration (and so the
    # fingerprint) the CLI's: the CLI's --spp sets the camera's sample
    # count, and a checkpoint of another --spp is refused, as in JAX.
    ck_b = os.path.join(ENTRY_DIR, "resume.ckpt.npz")
    secs_b1 = launch(2, lambda r, port: [
        sys.executable, "-c", PART_RUN, f"127.0.0.1:{port}", str(r), ck_b],
        ENTRY_DIR, 300, env=env, cwd=repo)
    img_b, secs_b2, log_b = dist_run("resumed", SPP, ck_b)
    one = vol2_renderer(w=800, h=800)
    img_1 = one.render(spp=SPP, batch=2)
    d = np.abs(img_a - img_1)
    mh_mean, mh_frac = float(d.mean()), float((d.max(-1) > 1e-4).mean())
    f_bit = np.array_equal(img_a, img_b)
    oks["f"] = (mh_mean < 3e-5 and mh_frac <= 0.01 and f_bit
                and "backend gloo" in log_a and "resuming at sample 4" in log_b
                and bool(np.isfinite(img_a).all()))
    rec["dist"] = dict(seconds=[secs_a, secs_b1, secs_b2], mean=mh_mean,
                       frac=mh_frac, bit=f_bit)
    phase("entry", f"(f) 2 gloo ranks on the card through the CLI (800x800, "
          f"{SPP} spp, batch 2, --checkpoint-every 4): vs the one-rank "
          f"Renderer frame mean |d| {mh_mean:.2e} (< 3e-5), pixels beyond "
          f"1e-4 {mh_frac:.5f} (<= 0.01); render_distributed(spp=4) of the "
          f"{SPP}-spp job then the CLI resumed to {SPP} bit-identical to the uninterrupted run {f_bit}; runs "
          f"{secs_a:.1f}, {secs_b1:.1f}, {secs_b2:.1f} s -> "
          f"{'PASS' if oks['f'] else 'FAIL'}")
    del one
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    rec["ok"] = oks
    ok = all(oks.values())
    phase("entry", f"{rec['seconds']:.1f} s; parts {oks} -> "
          f"{'PASS' if ok else 'FAIL'} ({card})")
    return ok, rec


def ladder_phase(card):
    """Phase 10c: scripts/bench_ladder.py's five BASELINE.json configs
    through the device loop, each image against K5's.  Returns (ok, rows)."""
    from path_tracer_tpu_torch.ops import integrator, kernels
    from path_tracer_tpu_torch.scripts import bench_ladder
    t_phase = time.perf_counter()
    rows, ok = [], True
    for c in bench_ladder.CONFIGS:
        name, W, H, spp = c[0], c[2], c[3], c[4]
        torch.cuda.synchronize()
        kernels.reset_launches()
        row, img, (sc, fl, bvh, ca, cf, key) = bench_ladder.run_config(*c)
        launches = {n: kernels.LAUNCHES[n] for n in WAVE_KERNELS}
        mega = integrator.render_batch(sc, fl, bvh, ca, cf, torch.zeros(
            (H, W, 3), device="cuda"), 0, spp, key) / spp
        a_ok, outl, clean = graded_agreement(img.cpu().numpy(),
                                             mega.cpu().numpy())
        ok_c = (bool(torch.isfinite(img).all()) and row["paths"] == W * H * spp
                and row["stack_overflows"] == 0 and a_ok
                and all(v > 0 for v in launches.values()))
        row.update(k5_outliers=outl, k5_clean_mean=clean, launches=launches,
                   ok=ok_c)
        rows.append(row)
        print(json.dumps(row), flush=True)
        phase("ladder", f"{name} {W}x{H} {spp} spp: finite, paths "
              f"{row['paths']} (= pixels x spp), stack overflows "
              f"{row['stack_overflows']}, vs K5: outliers {outl:.5f}, clean "
              f"mean {clean:.2e}; {row['mrays_ub']:.3f} upper-bound / "
              f"{row['mrays_measured']:.3f} measured Mrays/s, wall "
              f"{row['wall_s']:.4f} s, waves {row['waves']} -> "
              f"{'PASS' if ok_c else 'FAIL'}")
        ok = ok and ok_c
        del img, mega, sc, bvh
        torch.cuda.empty_cache()
    phase("ladder", f"{time.perf_counter() - t_phase:.1f} s ({card}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return ok, rows


def golden_phase(card):
    """Phase 10d: the JAX package's golden images through both engines on
    the card, and each card wavefront image against the CPU twins' image.
    Returns (ok, rows)."""
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.scripts import golden
    t_phase = time.perf_counter()
    rows, ok = [], True
    for name in golden.CASES:
        imgs = {}
        for engine, need in (("wavefront", WAVE_KERNELS),
                             ("megakernel", ("megakernel",))):
            torch.cuda.synchronize()
            kernels.reset_launches()
            imgs[engine] = golden.render(name, engine)
            torch.cuda.synchronize()
            launched = {n: kernels.LAUNCHES[n] for n in need}
            g_ok, reading = golden.check(name, imgs[engine])
            g_ok = g_ok and all(v > 0 for v in launched.values())
            reading.update(engine=engine, launches=launched, ok=g_ok)
            rows.append(reading)
            extra = ("" if reading["rule"] == "jax" else
                     f", clean mean {reading['clean_mean']:.2e}, share over "
                     f"1e-4 <= {reading['outlier_limit']:.4f}, signed from "
                     f"the outliers {reading['signed_from_outliers']:.3e} "
                     f"(se {reading['signed_se']:.1e})")
            phase("golden", f"{name} {engine}: trimmed mean "
                  f"{reading['trimmed_mean']:.3e} (< 3e-5 under JAX's rule), "
                  f"pixels beyond 1e-4 {reading['outlier_frac']:.5f}, signed "
                  f"mean {reading['signed_mean']:.3e}; rule "
                  f"{reading['rule']}{extra}; launches {launched} -> "
                  f"{'PASS' if g_ok else 'FAIL'}")
            ok = ok and g_ok
        if name == "vol2_final_mid":
            phase("golden", f"{name}: the CPU twins' image skipped (its twin "
                  "run takes minutes on the host)")
            continue
        twin = golden.render(name, "wavefront", device="cpu")
        t_ok, outl, clean = graded_agreement(imgs["wavefront"], twin)
        rows.append(dict(case=name, engine="wavefront vs twins", ok=t_ok,
                         outliers=outl, clean_mean=clean))
        phase("golden", f"{name}: card wavefront vs the CPU twins: outliers "
              f"{outl:.5f}, clean mean {clean:.2e} -> "
              f"{'PASS' if t_ok else 'FAIL'}")
        ok = ok and t_ok
    phase("golden", f"{time.perf_counter() - t_phase:.1f} s ({card}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return ok, rows


def ab_phase(card):
    """Phase 10e: scripts/bench_ab.py, JAX's CLI defaults, on two scenes.
    Returns (ok, results)."""
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.scripts import bench_ab
    t_phase = time.perf_counter()
    out, ok = {}, True
    for scene in ("wavefront_comparison", "vol2_final_scene"):
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = bench_ab.run(scene, 400, 8, 10)
        launched = {n: kernels.LAUNCHES[n]
                    for n in WAVE_KERNELS + ("megakernel",)}
        a_ok = res["images_agree"] and all(v > 0 for v in launched.values())
        out[scene] = dict(res, launches=launched)
        print(json.dumps({"scene": scene, **res}), flush=True)
        phase("ab", f"{scene} 400 wide, 8 spp, depth 10: megakernel "
              f"{res['megakernel']['total_s']} s, wavefront "
              f"{res['wavefront']['total_s']} s, speed-up "
              f"{res['speedup_wavefront']}; outliers beyond 1e-3 "
              f"{res['image_outlier_frac']} (<= 0.01), clean mean "
              f"{res['image_clean_mean_diff']:.2e} (< 1e-5), beyond 1e-2 "
              f"{res['image_outlier_frac_1e2']}, beyond 1e-1 "
              f"{res['image_outlier_frac_1e1']}; launches {launched} -> "
              f"{'PASS' if a_ok else 'FAIL'}")
        ok = ok and a_ok
    phase("ab", f"{time.perf_counter() - t_phase:.1f} s ({card}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return ok, out


# tests/test_train_demo.py:34-37; JAX's recorded finals (docs/assets/
# train_demo.jsonl step 349, train_texture.jsonl step 259).
DEMO = dict(steps=350, width=48, height=48, spp=6, target_spp=384,
            max_depth=6, lr=0.1, seed=0, queue_size=2048, steps_per_wave=8,
            log_every=50, decay_alpha=0.02, polish_steps=60, polish_spp=18)
JAX_DEMO = {"err_albedo": 0.0099, "err_emission": 0.0014, "psnr": 30.1}


def demo_phase(card):
    """Phase 10f: the inverse-rendering demos on the card.  Returns (ok,
    record)."""
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.scripts import train_demo
    t_phase = time.perf_counter()
    rec, oks = {}, {}

    # Every step's paths_done == paths_total is asserted inside the demo.
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        d = train_demo.run_demo(verbose=False, **DEMO)
    except AssertionError as e:
        phase("demo", f"run_demo: {e} -> FAIL")
        return False, {"run_demo": str(e)}
    launched = {n: kernels.LAUNCHES[n] for n in WAVE_KERNELS + ("adjoint",)}
    loss0 = d["history"][0]["loss"]
    loss10 = sum(h["loss"] for h in d["history"][-10:]) / 10
    ms_step = 1e3 * d["wall_s"] / DEMO["steps"]
    oks["demo"] = (bool((d["rel_err"] < 0.05).all()) and loss10 < 0.5 * loss0
                   and all(v > 0 for v in launched.values()))
    with open(os.path.join(RUN_DIR, "train_demo.jsonl"), "w") as f:
        for h in d["history"]:
            f.write(json.dumps(h) + "\n")
    train_demo.write_curve_png(d["history"],
                               os.path.join(RUN_DIR, "train_demo.png"))
    rec["demo"] = dict(rel_err=d["rel_err"].tolist(), wall_s=d["wall_s"],
                       ms_step=ms_step, loss_first=loss0, loss_last10=loss10,
                       recovered=d["recovered"].tolist(), launches=launched,
                       adjoint_per_step=launched["adjoint"] / DEMO["steps"])
    phase("demo", f"run_demo {DEMO['steps']} steps 48x48 spp 6 (+60 at 18): "
          f"albedo err {100 * d['rel_err'][0]:.2f}%, emission err "
          f"{100 * d['rel_err'][1]:.2f}% (< 5%; JAX's recorded "
          f"{100 * JAX_DEMO['err_albedo']:.2f}% / "
          f"{100 * JAX_DEMO['err_emission']:.2f}%), loss {loss0:.3e} -> "
          f"{loss10:.3e} (last 10, < half), wall {d['wall_s']:.2f} s, "
          f"{ms_step:.2f} ms a step, launches {launched} ({card}) -> "
          f"{'PASS' if oks['demo'] else 'FAIL'}")

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = train_demo.run_texture_demo(verbose=False)
    launched_t = {n: kernels.LAUNCHES[n] for n in WAVE_KERNELS + ("adjoint",)}
    err = t["err"]
    oks["texture"] = (err["mean_abs"] < 0.03 and err["psnr"] > 22.0
                      and all(v > 0 for v in launched_t.values()))
    with open(os.path.join(RUN_DIR, "train_texture.jsonl"), "w") as f:
        for h in t["history"]:
            f.write(json.dumps(h) + "\n")
    train_demo.write_texture_pair_png(
        t["true"], t["recovered"], os.path.join(RUN_DIR, "train_texture.png"))
    rec["texture"] = dict(err=err, wall_s=t["wall_s"],
                          ms_step=1e3 * t["wall_s"] / 260,
                          launches=launched_t)
    phase("demo", f"run_texture_demo 260 steps 48x48 spp 8: texel mean "
          f"|err| {err['mean_abs']:.4f} (< 0.03), max {err['max_abs']:.4f}, "
          f"PSNR {err['psnr']:.2f} dB (> 22; JAX's recorded "
          f"{JAX_DEMO['psnr']} dB), wall {t['wall_s']:.2f} s, "
          f"{rec['texture']['ms_step']:.2f} ms a step, launches {launched_t} "
          f"({card}) -> {'PASS' if oks['texture'] else 'FAIL'}")

    # The first 3 steps on the card and on the CPU twins.
    small = dict(steps=3, width=24, height=24, spp=2, target_spp=8,
                 max_depth=6, verbose=False)
    card_run = train_demo.run_demo(**small)
    cpu_run = train_demo.run_demo(device="cpu", **small)
    lc = np.array([h["loss"] for h in card_run["history"]])
    lp = np.array([h["loss"] for h in cpu_run["history"]])
    loss_ok = bool(np.allclose(lc, lp, rtol=1e-3, atol=2e-5))
    par_ok = bool(np.allclose(card_run["recovered"], cpu_run["recovered"],
                              rtol=1e-3, atol=2e-5))
    oks["steps"] = loss_ok and par_ok
    rec["steps"] = dict(card_loss=lc.tolist(), cpu_loss=lp.tolist(),
                        param_max_diff=float(np.abs(
                            card_run["recovered"] - cpu_run["recovered"]).max()))
    phase("demo", f"run_demo 3 steps 24x24 spp 2, card vs CPU twins: losses "
          f"{lc.tolist()} vs {lp.tolist()}, parameters max |d| "
          f"{rec['steps']['param_max_diff']:.2e} (atol 2e-5, rtol 1e-3) -> "
          f"{'PASS' if oks['steps'] else 'FAIL'}")
    ok = all(oks.values())
    phase("demo", f"{time.perf_counter() - t_phase:.1f} s ({card}); parts "
          f"{oks} -> {'PASS' if ok else 'FAIL'}")
    return ok, rec


# scripts/bench_scaling.py at tools/bench_scaling.py's defaults (width 256,
# 2 spp, depth 8, the wavefront engine) over 1, 2 and 4 ranks.
SCALING = dict(max_devices=4, width=256, engine="wavefront")


def scaling_phase(card):
    """Phase 10g: scripts/bench_scaling.py on the card, its sizes' ranks
    gloo ranks sharing it.  Gates every size's frame against the one-rank
    frame (1e-5), finite, every pixel's paths once, K1-K4 on every rank.
    Returns (ok, record); a rank that fails raises."""
    from path_tracer_tpu_torch.scripts import bench_scaling
    t_phase = time.perf_counter()
    log_dir = os.path.join(RUN_DIR, "ranks", "scaling")
    os.makedirs(log_dir, exist_ok=True)
    lines = []

    def out(text):
        lines.append(text)
        phase("scaling", text)

    rows = bench_scaling.run(**SCALING, device="cuda", log_dir=log_dir,
                             out=out)
    w, h = bench_scaling.config(SCALING["width"])
    ref = rows[0]["image"]
    ok = [r["n"] for r in rows] == [1, 2, 4]
    rec = []
    for r in rows:
        err = float(np.abs(r["image"] - ref).max())
        launched = all(o[n] > 0 for o in r["launches"] for n in WAVE_KERNELS)
        r_ok = (err <= 1e-5 and bool(np.isfinite(r["image"]).all())
                and r["paths"] == w * h * bench_scaling.SPP and launched)
        ok = ok and r_ok
        rec.append({k: v for k, v in r.items() if k != "image"}
                   | {"max_abs_err": err, "ok": r_ok})
        phase("scaling", f"{r['n']} ranks: rank walls "
              + ", ".join(f"{x:.4f}" for x in r["rank_walls"])
              + f" s, waves {r['waves']}, paths {r['paths']} "
              f"({w}x{h}x{bench_scaling.SPP}), frame max abs diff vs one "
              f"rank {err:.2e} (<= 1e-5), K1-K4 on every rank {launched} -> "
              f"{'PASS' if r_ok else 'FAIL'}")
    secs = time.perf_counter() - t_phase
    phase("scaling", f"{secs:.1f} s (7 rank processes, gloo ranks sharing "
          f"one card: {card}) -> {'PASS' if ok else 'FAIL'}")
    return ok, {"rows": rec, "lines": lines, "seconds": secs}


FRAME_L1_GAP = 5e-3    # benchmark/limits/<cell>.json's frame_l1_gap
KEPT_BATCH = 8         # samples a batch, as the benchmark's traffic


def l1_gap(a, b) -> float:
    """sum |a - b| / sum |b|: the benchmark's frame_l1_gap."""
    return float((a - b).abs().sum() / b.abs().sum())


def kept_loop_phase(card):
    """Phase 10h: the wavefront's loop graph kept across batches
    (``wavefront.wave_loop``).  For a vol2_final frame (800x600, 32 spp,
    depth 10) and a mesh_perlin_sss frame (400x224, 32 spp, depth 12),
    rendered batch by batch (8 samples a batch) through ``render_batch``
    with the kept loop, against the same frame with a loop graph captured
    for each batch (``clear_wave_loops`` before each ``render_batch``):
    paths, spawned, stack overflows, rays, waves and depth histogram equal
    batch by batch, the frames within the benchmark's frame_l1_gap limit,
    one capture for the frame and none for a second frame; the reset
    kernel launched on its own on the drained state gives init_state's
    state, accum untouched.  On vol2_final at 1 spp: a scene leaf changed
    in place between two ``render_batch_diff`` steps recaptures, and the
    second step's image is the changed scene's.  Returns (ok, record)."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.ops import wavefront as wf
    from path_tracer_tpu_torch.render.renderer import wave_preset
    from path_tracer_tpu_torch.utils import rng
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    ok, rec = True, {}
    cases = (("vol2_final", vol2(dev, 800, 600, 32, 10)),
             ("mesh_perlin_sss", compiled(*ptt.scenes.mesh_perlin_sss(), 400,
                                          224, 32, 12, dev)))
    for name, (scene, flags, bvh, cam_a, cfg) in cases:
        key = rng.key(7, device=dev)
        # the pool and steps the Renderer runs for a batch of KEPT_BATCH
        q, s, _ = wave_preset(cfg, bvh.nodes.shape[0],
                              KEPT_BATCH * cfg.width * cfg.height,
                              kernels.resident_lanes(dev, bvh.branching))
        kw = dict(queue_size=q, steps_per_wave=s, ctrl_den=8)
        shape = (cfg.height, cfg.width, 3)
        starts = range(0, cfg.samples_per_pixel, KEPT_BATCH)

        def frame(per_batch):
            acc, sts, walls = torch.zeros(shape, device=dev), [], []
            for s0 in starts:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if per_batch:
                    wf.clear_wave_loops()
                acc, st = wf.render_batch(scene, flags, bvh, cam_a, cfg, acc,
                                          s0, KEPT_BATCH, key,
                                          with_stats=True, **kw)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
                sts.append({k: int(st[k]) for k in (
                    "paths", "spawned", "stack_overflows", "rays",
                    "waves")} | {"depth_hist": st["depth_hist"].tolist()})
            return acc, sts, walls

        wf.clear_wave_loops()
        c0 = wf.CAPTURES
        k_img, k_sts, k_walls = frame(False)
        captures = wf.CAPTURES - c0
        kept = wf._KEPT
        # the reset on its own, on the drained state
        drained = kept.ws.clone()
        kernels.launch_args("wave_reset", kept.args, dev)
        fresh = kept.eng.init_state(drained.accum)
        reset_ok = all(torch.equal(getattr(kept.ws, f), getattr(fresh, f))
                       for f in fresh.__dataclass_fields__)
        reset_acted = not torch.equal(drained.ctr, kept.ws.ctr)

        def reset():
            kernels.launch_args("wave_reset", kept.args, dev)
        reset_ms = dict(event_ms=cuda_ms(reset), device_ms=device_ms(reset),
                        init_state_event_ms=cuda_ms(
                            lambda: kept.eng.init_state(drained.accum)))
        c1 = wf.CAPTURES
        k2_img, k2_sts, k2_walls = frame(False)
        captures2 = wf.CAPTURES - c1
        p_img, p_sts, p_walls = frame(True)
        gap, gap2 = l1_gap(k_img, p_img), l1_gap(k2_img, p_img)
        same = k_sts == p_sts and k2_sts == p_sts
        paths = sum(s["paths"] for s in k_sts)
        case_ok = (same and gap <= FRAME_L1_GAP and gap2 <= FRAME_L1_GAP
                   and captures == 1 and captures2 == 0 and reset_ok
                   and reset_acted and all(s["stack_overflows"] == 0
                                           for s in k_sts)
                   and paths == cfg.width * cfg.height
                   * cfg.samples_per_pixel)
        ok = ok and case_ok
        rec[name] = dict(
            batches=len(starts), captures=captures,
            captures_second_frame=captures2, counters_equal=same,
            frame_l1_gap=gap, frame_l1_gap_second=gap2,
            bit_identical=bool(torch.equal(k_img, p_img)),
            reset_equals_init_state=reset_ok, reset_ms=reset_ms,
            stats=k_sts,
            batch_ms={"kept": k_walls, "kept_second": k2_walls,
                      "capture_per_batch": p_walls}, ok=case_ok)
        phase("kept loop", f"{name} {cfg.width}x{cfg.height} "
              f"{cfg.samples_per_pixel} spp in batches of {KEPT_BATCH}: "
              f"kept loop vs a capture per batch: paths, spawned, stack "
              f"overflows, rays, waves, depth histogram equal batch by "
              f"batch {same}; frame_l1_gap {gap:.3e} and {gap2:.3e} (second "
              f"frame) <= {FRAME_L1_GAP}, bit-identical "
              f"{rec[name]['bit_identical']}; captures {captures} (frame), "
              f"{captures2} (second frame); reset kernel on the drained "
              f"state = init_state {reset_ok} (event ms "
              f"{reset_ms['event_ms']:.4f}, device ms "
              f"{reset_ms['device_ms']:.4f}; init_state event ms "
              f"{reset_ms['init_state_event_ms']:.4f}); batch ms (synced) kept "
              + ", ".join(f"{x:.2f}" for x in k2_walls) + "; a capture per "
              "batch " + ", ".join(f"{x:.2f}" for x in p_walls)
              + f" -> {'PASS' if case_ok else 'FAIL'}")
        if name != "vol2_final":
            continue
        # render_batch_diff: a leaf changed in place between two steps
        leaf = scene.tex_c1.clone().requires_grad_()
        sc_d = dataclasses.replace(scene, tex_c1=leaf)
        zero = torch.zeros(shape, device=dev)
        c0 = wf.CAPTURES
        imgs = []
        for _ in range(2):
            img, _st = wf.render_batch_diff(sc_d, flags, bvh, cam_a, cfg,
                                            zero, 0, 1, key,
                                            n_waves=wf.MAX_WAVES, **kw)
            imgs.append(img.detach())
            with torch.no_grad():
                leaf.mul_(0.5)                 # the optimiser's step
        recaptures = wf.CAPTURES - c0
        changed = dataclasses.replace(scene, tex_c1=leaf.detach() * 2.0)
        want = wf.render_batch(changed, flags, bvh, cam_a, cfg, zero, 0, 1,
                               key, **kw)
        gap_new, gap_old = l1_gap(imgs[1], want), l1_gap(imgs[0], want)
        diff_ok = (recaptures == 2 and gap_new <= FRAME_L1_GAP
                   and gap_old > 10 * FRAME_L1_GAP)
        ok = ok and diff_ok
        rec["diff_steps"] = dict(captures=recaptures, frame_l1_gap=gap_new,
                                 frame_l1_gap_first_step=gap_old, ok=diff_ok)
        phase("kept loop", f"vol2_final 1 spp, tex_c1 halved in place "
              f"between two render_batch_diff steps: captures {recaptures} "
              f"(one a step), the second step's image vs the changed "
              f"scene's: frame_l1_gap {gap_new:.3e}, the first step's "
              f"{gap_old:.3e} -> {'PASS' if diff_ok else 'FAIL'}")
    wf.clear_wave_loops()
    secs = time.perf_counter() - t_phase
    phase("kept loop", f"{secs:.1f} s ({card}) -> {'PASS' if ok else 'FAIL'}")
    rec["seconds"] = secs
    return ok, rec


def kept_loop_main() -> int:
    """``python3 chip_smoke.py --kept-loop``: the device, the build and
    phase 10h alone; the record in RUN_DIR's chip_smoke_kept_loop.json."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    phase("device", card)
    from path_tracer_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.build()
    phase("build", f"{time.perf_counter() - t0:.1f} s wall")
    for n in ("spawn", "wave_reset"):
        src = kernels.SOURCE_OF[n]
        if src in kernels.BUILD_LOG:
            phase("build", f"{n}: (registers, stack frame, spill stores, "
                  f"spill loads) "
                  f"{ptxas_resources(kernels.BUILD_LOG[src], n)}")
    os.makedirs(RUN_DIR, exist_ok=True)
    ok, rec = kept_loop_phase(card)
    with open(os.path.join(RUN_DIR, "chip_smoke_kept_loop.json"), "w") as f:
        json.dump({"card": card, "kept_loop": rec}, f, indent=1, default=str)
    return 0 if ok else 1


def main() -> int:
    t_main = time.perf_counter()
    # --- 1. device ---
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    phase("device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    os.makedirs(RUN_DIR, exist_ok=True)

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import adjoint, gather, integrator, kernels
    from path_tracer_tpu_torch.ops import wavefront as wf
    from path_tracer_tpu_torch.parallel import (calibrate_n_waves,
                                                make_train_step)
    from path_tracer_tpu_torch.ops import shade_tiled, traverse
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.parallel import pipeline, scene_shard
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import (C_DEPTH_SUM, C_DO_CTRL,
                                                 C_DONE, C_EXEC_STEPS,
                                                 C_FETCH, C_N_OCC, C_RAYS,
                                                 C_STACK_OVF, C_TICKET,
                                                 C_TRAV_STEPS,
                                                 C_WALK_STEPS, FL_FINISHED,
                                                 FL_RESAMPLE, MAT_DIELECTRIC,
                                                 MAT_METAL, MAT_SSS_SIMPLE,
                                                 MAT_SSS_VOLUMETRIC, PH_EXIT,
                                                 TEX_NOISE, RenderConfig)
    from path_tracer_tpu_torch.render.renderer import Renderer, wave_preset
    from path_tracer_tpu_torch.scripts.graph_timer import N_GRAPH, graph_ms
    from path_tracer_tpu_torch.utils import rng

    # --- 2. build ---
    t0 = time.perf_counter()
    secs = kernels.build()
    phase("build", f"{time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{n}={s:.1f}s" for n, s in secs.items()))
    for n, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                phase("build", f"{n}: {line.strip()}")
    ptxas = {}
    for n, want in PTXAS_EXPECT.items():
        kern, targs = INSTANCES.get(n, (n, None))
        src = kernels.SOURCE_OF[kern]
        if src not in kernels.BUILD_LOG:
            phase("build", f"{n}: built earlier in this process, not checked")
            continue
        got = ptxas_resources(kernels.BUILD_LOG[src], kern, targs)[:2]
        phase("build", f"{n}: (registers, stack frame) {got}, recorded {want} "
              f"{'PASS' if got == want else 'FAIL'}")
        assert got == want, f"{n} ptxas resources changed: {got} != {want}"
    # K1 reads its node rows in 16-byte loads: its global loads by width.
    k1_loads = {}
    sass = kernels.sass_global_loads(kernels.library_path("trace_step"))
    for inst in ("trace_step_k4", "trace_step_k8"):
        tag = "_Z17trace_step_kernel" + mangled_targs(INSTANCES[inst][1])
        k1_loads[inst] = next(v for f, v in sass.items() if f.startswith(tag))
        phase("build", f"{inst}: global loads in its SASS (cuobjdump -sass): "
              f"{k1_loads[inst].get(128, 0)} of 16 bytes, "
              f"{k1_loads[inst].get(32, 0)} of 4 bytes, all by bits "
              f"{dict(sorted(k1_loads[inst].items()))}")
    for n in ("tiled_trip", "tiled_trip_rec", "tiled_spawn"):
        src = kernels.SOURCE_OF[n]
        if src in kernels.BUILD_LOG:
            phase("build", f"{n}: (registers, stack frame) "
                  f"{ptxas_resources(kernels.BUILD_LOG[src], n)[:2]}")
    # Every instantiation of the walking kernels: registers, stack frame and
    # spills (a spill is recorded, not hidden).
    for inst, (n, targs) in INSTANCES.items():
        src = kernels.SOURCE_OF[n]
        if src in kernels.BUILD_LOG:
            ptxas[inst] = ptxas_resources(kernels.BUILD_LOG[src], n, targs)
            phase("build", f"{inst} ({n}_kernel<{targs}>): (registers, stack "
                  f"frame, spill stores, spill loads) {ptxas[inst]}")
            assert ptxas[inst][0] is not None, f"no ptxas entry for {inst}"
            assert ptxas[inst][2:] == (0, 0), f"{inst} spills: {ptxas[inst]}"

    # --- 3. kernel vs twin at the full configuration's shapes ---
    dev = torch.device("cuda")
    W, H, SPP, DEPTH = 800, 450, 10, 10
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    cam.samples_per_pixel, cam.max_depth = SPP, DEPTH
    scene = ptt.compile_scene(world, device=dev)
    flags = SceneFlags.from_scene(scene)
    assert flags.has_image, "earth texture did not load (magenta fallback)"
    bvh = ptt.build_from_scene(scene)
    cam_a = cam.initialize(device=dev)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH)
    key = rng.key(0, device=dev)
    # the pool and steps phase 4's Renderer runs for its one-batch frame
    # (on the H100: K1's resident lanes, stride 1)
    POOL, STEPS, _ = wave_preset(cfg, bvh.nodes.shape[0], SPP * W * H,
                                 kernels.resident_lanes(dev, bvh.branching))
    eng = wf.WaveEngine(scene, flags, bvh, cam_a, cfg, 0, SPP, key,
                        queue_size=POOL, steps_per_wave=STEPS, ctrl_den=8)
    phase("kernels", f"R={eng.R} stride={eng.stride} sd={eng.sd} "
          f"nodes={tuple(bvh.nodes.shape)} max_stack={bvh.max_stack}")
    ws = eng.init_state(torch.zeros((H, W, 3), device=dev))
    for _ in range(48):                       # a mid-flight pool
        for op in wf.KERNELS:
            op(eng, ws)
    torch.cuda.synchronize()
    # the node rows K1 fetches here: P0's vol2_final case
    k1_rows = (bvh.nodes.contiguous(),
               ws.cur[ws.cur != traverse._DONE].contiguous())

    results = {}
    fields_int = ("cur", "sp", "best_pt", "best_pi")

    def restore(dst, src):
        for f in src.__dataclass_fields__:
            getattr(dst, f).copy_(getattr(src, f))

    def kernel_graph_ms(name, snap_):
        """Device ms per launch of ``name`` on ``snap_``: N_GRAPH launches
        on as many copies in one CUDA graph, each copy restored first."""
        copies = [snap_.clone() for _ in range(N_GRAPH)]
        c_args = [kernels.make_args(eng, c) for c in copies]
        ms_ = graph_ms([lambda c=c, a_=a_: kernels.launch(name, eng, c,
                                                          args=a_)
                        for c, a_ in zip(copies, c_args)],
                       lambda: [restore(c, snap_) for c in copies])
        del copies, c_args
        return ms_

    def time_pair(name, plain_fn, snap, work):
        ms = cuda_ms(lambda: kernels.launch(name, eng, work),
                     setup=lambda: restore(work, snap))
        pms = cuda_ms(lambda: plain_fn(eng, work), reps=5,
                      setup=lambda: restore(work, snap))
        return ms, pms

    # K1 trace_step
    snap = ws.clone()
    k_ws, p_ws = snap.clone(), snap.clone()
    kernels.launch("trace_step", eng, k_ws)
    traverse.trace_step_plain(eng, p_ws)
    torch.cuda.synchronize()
    eq = torch.stack([getattr(k_ws, f) == getattr(p_ws, f)
                      for f in fields_int]).all(0)
    frac = float(eq.float().mean())
    rel = ((k_ws.best_t - p_ws.best_t).abs()
           / p_ws.best_t.abs().clamp(min=1e-6))[eq]
    err = float((k_ws.best_t - p_ws.best_t)[eq].abs().max())
    steps = int(k_ws.ctr[C_TRAV_STEPS] - snap.ctr[C_TRAV_STEPS])
    # The adaptive exit at chunk 4 (JAX's accelerator chunk): every lane's
    # traversal state and every counter exact, the stack too.
    exact = (frac == 1.0 and torch.equal(k_ws.best_t, p_ws.best_t)
             and torch.equal(k_ws.stack, p_ws.stack)
             and torch.equal(k_ws.ctr, p_ws.ctr))
    ok = exact and eng.chunk == 4
    exec_k1 = int(k_ws.ctr[C_EXEC_STEPS] - snap.ctr[C_EXEC_STEPS])
    work = snap.clone()
    ms, pms = time_pair("trace_step", traverse.trace_step_plain, snap, work)
    # Bytes the walk must move: a walking lane reads its ray (origin,
    # direction, time, phase; hit_t in the exit phase) and traversal state
    # (occupied, cur, sp, best_t/pt/pi) and writes the traversal state back;
    # of its stack only the entries that differ between start and end
    # (|sp_end - sp_start|) must be read or written.  A finished lane reads
    # occupied and cur, an empty one occupied.  The node rows are read once.
    walking = snap.occupied & (snap.cur != traverse._DONE)
    n_walk = int(walking.sum())
    n_exit = int((walking & (snap.phase == PH_EXIT)).sum())
    n_done = int((snap.occupied & ~walking).sum())
    n_empty = eng.R - n_walk - n_done
    stack_entries = int((k_ws.sp - snap.sp)[walking].abs().sum())
    node_bytes = bvh.nodes.shape[0] * bvh.nodes.shape[1] * 4
    byts = (node_bytes + n_walk * (32 + 21 + 20) + n_exit * 4
            + n_done * 5 + n_empty * 1 + stack_entries * 4)
    ops = steps * 220
    results["trace_step"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms,
                                 bytes=byts, ops=ops, library_ms=None)
    phase("kernels", f"trace_step (chunk {eng.chunk}): match {frac:.6f} of "
          f"lanes, best_t max rel {float(rel.max()):.2e}, lanes, stack and "
          f"counters exact {exact}, steps run {exec_k1} of {eng.steps} "
          f"(one cooperative launch), {ms:.3f} ms (twin {pms:.2f} ms) "
          f"{'PASS' if ok else 'FAIL'}; bound inputs: walking lanes {n_walk} "
          f"({n_exit} in the exit phase), finished {n_done}, empty {n_empty}, "
          f"walking steps {steps}, stack entries changed {stack_entries}, "
          f"node bytes {node_bytes}, total bytes {byts}, fp32 ops {ops}")

    # K3 shade, on the state after trace_step with the control flag on
    snap = k_ws.clone()
    snap.ctr[C_DO_CTRL] = 1
    k3, p3 = snap.clone(), snap.clone()
    kernels.launch("shade", eng, k3)
    shade_tiled.shade_plain(eng, p3)
    torch.cuda.synchronize()
    ready = snap.occupied & (snap.cur == traverse._DONE)
    n_ready = int(ready.sum())
    same = (k3.alive == p3.alive) & (k3.depth == p3.depth) & (k3.flag == p3.flag)
    frac = float(same[ready].float().mean())
    rest = ready & same
    err = max(float((getattr(k3, f) - getattr(p3, f))[rest].abs().max())
              for f in ("origin", "direction", "color", "throughput"))
    ok = frac >= 0.999 and all(
        torch.allclose(getattr(k3, f)[rest], getattr(p3, f)[rest],
                       rtol=1e-4, atol=1e-4)
        for f in ("origin", "direction", "color", "throughput"))
    work = snap.clone()
    ms, pms = time_pair("shade", shade_tiled.shade_plain, snap, work)
    dev_ms = kernel_graph_ms("shade", snap)
    byts = n_ready * (2 * 96 + 72 + 32 + 36 + 12)
    ops = n_ready * (600 + 12 * 110)
    results["shade"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms, bytes=byts,
                            ops=ops, library_ms=None, graph_device_ms=dev_ms)
    phase("kernels", f"shade: {n_ready} ready lanes, alive/depth/flag match "
          f"{frac:.6f}, float max abs err {err:.2e}, {ms:.3f} ms "
          f"(twin {pms:.2f} ms); device ms per call in a CUDA graph of "
          f"{N_GRAPH} on this control wave's state {dev_ms:.5f} "
          f"{'PASS' if ok else 'FAIL'}")

    # K4 retire, on the kernel's shaded state
    snap = k3.clone()
    k4, p4 = snap.clone(), snap.clone()
    kernels.launch("retire", eng, k4)
    wf.retire_plain(eng, p4)
    torch.cuda.synchronize()
    fin = snap.flag == FL_FINISHED
    n_fin = int(fin.sum())
    err = float((k4.accum - p4.accum).abs().max())
    ok = (torch.allclose(k4.accum, p4.accum, rtol=1e-4, atol=1e-6)
          and torch.equal(k4.ctr, p4.ctr)
          and torch.equal(k4.depth_hist, p4.depth_hist)
          and torch.equal(k4.pix_paths, p4.pix_paths)
          and torch.equal(k4.flag, p4.flag)
          and torch.equal(k4.occupied, p4.occupied))
    work = snap.clone()
    ms, pms = time_pair("retire", wf.retire_plain, snap, work)
    retire_m = fin & ~(snap.sample < snap.last)
    idx = snap.pixel[retire_m].long()
    src = snap.color[retire_m]
    lib_acc = snap.accum.clone()
    lms = cuda_ms(lambda: lib_acc.index_add_(0, idx, src))
    # Device time per call without the host's launch work: N_GRAPH
    # launches of K4 on as many copies of the state, and N_GRAPH index_add_
    # calls, each set captured in one CUDA graph.
    dev_ms = kernel_graph_ms("retire", snap)
    accs = [snap.accum.clone() for _ in range(N_GRAPH)]
    lib_dev_ms = graph_ms([lambda acc=acc: acc.index_add_(0, idx, src)
                           for acc in accs])
    del accs
    byts = n_fin * (4 + 12 + 4 * 5) + int(retire_m.sum()) * 24
    ops = n_fin * 10
    results["retire"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms, bytes=byts,
                             ops=ops, library_ms=lms, graph_device_ms=dev_ms,
                             library_device_ms=lib_dev_ms)
    phase("kernels", f"retire: {n_fin} finished, accum max abs err {err:.2e}, "
          f"counters/hist exact {ok}, {ms:.4f} ms (twin {pms:.2f} ms, "
          f"index_add_ {lms:.4f} ms); device ms per call in a CUDA graph of "
          f"{N_GRAPH}: K4 {dev_ms:.5f}, index_add_ {lib_dev_ms:.5f} "
          f"{'PASS' if ok else 'FAIL'}")

    # K2 spawn, on the retired state; compare per work item (slot order differs)
    snap = k4.clone()
    k2, p2 = snap.clone(), snap.clone()
    u5 = torch.zeros((eng.R, 5), device=dev)
    args = kernels.make_args(eng, k2, u5_out=u5)
    kernels.launch("spawn", eng, k2, args=args)
    wf.spawn_plain(eng, p2)
    torch.cuda.synchronize()

    def renewed(st):
        return (snap.flag == FL_RESAMPLE) | (~snap.occupied & st.occupied)

    mk, mp = renewed(k2), renewed(p2)
    item_k = (k2.sample[mk].long() * eng.npix + k2.pixel[mk].long())
    item_p = (p2.sample[mp].long() * eng.npix + p2.pixel[mp].long())
    ok_items = torch.equal(torch.sort(item_k).values, torch.sort(item_p).values)
    ok = ok_items
    err = 0.0
    if ok_items:
        ok_ = torch.argsort(item_k)
        op_ = torch.argsort(item_p)
        u5_t = shade_tiled.spawn_rng(eng.key, p2.sample[mp], p2.pixel[mp])
        u_eq = torch.equal(u5[mk][ok_], u5_t[op_])
        o_err = float((k2.origin[mk][ok_] - p2.origin[mp][op_]).abs().max())
        d_err = float((k2.direction[mk][ok_] - p2.direction[mp][op_]).abs().max())
        err = max(o_err / max(float(p2.origin.abs().max()), 1.0), d_err)
        ok = u_eq and err <= 1e-6 and torch.equal(
            k2.ctr[C_N_OCC], p2.ctr[C_N_OCC])
    work = snap.clone()
    ms, pms = time_pair("spawn", wf.spawn_plain, snap, work)
    dev_ms = kernel_graph_ms("spawn", snap)
    n_new = int(mk.sum())
    byts = n_new * (12 * 4 + 4 * 10 + 4)
    ops = n_new * (6 * 110 + 60)
    results["spawn"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms, bytes=byts,
                            ops=ops, library_ms=None, graph_device_ms=dev_ms)
    phase("kernels", f"spawn: {n_new} renewed slots, items equal {ok_items}, "
          f"uniforms bit-equal and rays rel err {err:.2e}, {ms:.3f} ms "
          f"(twin {pms:.2f} ms); device ms per call in a CUDA graph of "
          f"{N_GRAPH} on this control wave's state {dev_ms:.5f} "
          f"{'PASS' if ok else 'FAIL'}")
    del ws, snap, k_ws, p_ws, k3, p3, k4, p4, k2, p2, work
    torch.cuda.empty_cache()

    # P0 gather_rows at the probe's shape (tools/bench_gather.py:105-145):
    # a (512, 80) table, 16384 random rows, against torch.index_select.
    g0 = torch.Generator(device=dev).manual_seed(0)
    gtab = torch.randn((512, 80), device=dev, generator=g0)
    gidx = torch.randint(0, 512, (16384,), device=dev, generator=g0,
                         dtype=torch.int32)
    glib = torch.index_select(gtab, 0, gidx)
    gerr = float((gather.gather_rows(gtab, gidx) - glib).abs().max())
    g_ok = torch.equal(gather.gather_rows(gtab, gidx), glib)
    gms = cuda_ms(lambda: gather.gather_rows(gtab, gidx))
    gpms = cuda_ms(lambda: gather.gather_rows_plain(gtab, gidx))
    glms = cuda_ms(lambda: torch.index_select(gtab, 0, gidx))
    g_dev = graph_ms([lambda: gather.gather_rows(gtab, gidx)] * N_GRAPH)
    gl_dev = graph_ms([lambda: torch.index_select(gtab, 0, gidx)] * N_GRAPH)
    gf_dev = graph_ms([lambda: gather.gather_rows_floor(gtab, gidx, glib)]
                      * N_GRAPH)
    ptx_g = ptxas_resources(kernels.BUILD_LOG.get("gather", ""), "gather_rows",
                            tag="gather_rows_kernelI6float4E")
    results["gather_rows"] = dict(
        ok=g_ok, err=gerr, ms=gms, plain_ms=gpms, library_ms=glms, ops=0,
        bytes=gtab.numel() * 4 + gidx.numel() * 4 + glib.numel() * 4,
        device_ms=g_dev, library_device_ms=gl_dev, floor_device_ms=gf_dev,
        ptxas=list(ptx_g))
    phase("kernels", f"gather_rows: (512, 80) table, 16384 random rows, equal "
          f"to index_select {g_ok}, {gms:.4f} ms (plain {gpms:.4f} ms, "
          f"index_select {glms:.4f} ms, bound "
          f"{results['gather_rows']['bytes'] / H100_BYTES_PER_S * 1e3:.5f} ms); "
          f"device ms per call in a CUDA graph of {N_GRAPH}: gather_rows "
          f"{g_dev:.5f}, index_select {gl_dev:.5f}, an empty kernel on "
          f"gather_rows' grid {gf_dev:.5f}; ptxas (registers, stack frame, "
          f"spill stores, spill loads) {ptx_g} {'PASS' if g_ok else 'FAIL'}")

    def mega_pair(meng, w, h):
        """K5 and its twin on sample 0 from a zero frame: the share of pixels
        with equal iters and depth, the graded colour rule, the counters and
        depth histogram (exact: both sides round alike, --fmad=false, the same
        libdevice functions); then K5's time."""
        zero = torch.zeros((h, w, 3), device=dev)
        mk, mp = meng.init_state(zero), meng.init_state(zero)
        mk_args = integrator.mega_args(meng, mk)
        integrator.megakernel(meng, mk, 0, mk_args)
        pms = cuda_ms(lambda: integrator.megakernel_plain(meng, mp, 0), reps=1)
        same = (mk.iters == mp.iters) & (mk.depth == mp.depth)
        frac = float(same.float().mean())
        img_ok, outl, clean = graded_agreement(mk.color.cpu().numpy(),
                                               mp.color.cpu().numpy())
        err = float((mk.color - mp.color)[same].abs().max())
        ctr_ok = (torch.equal(mk.ctr, mp.ctr)
                  and torch.equal(mk.depth_hist, mp.depth_hist)
                  and int(mk.ctr[C_DONE]) == w * h
                  and int(mk.ctr[C_STACK_OVF]) == 0)
        out = dict(ok=frac >= 0.999 and img_ok and ctr_ok, frac=frac,
                   outliers=outl, clean_mean=clean, err=err, ctr_ok=ctr_ok,
                   plain_ms=pms, **{n: int(mk.ctr[i]) for n, i in (
                       ("paths", C_DONE), ("rays", C_RAYS),
                       ("depth_sum", C_DEPTH_SUM), ("trav_steps", C_TRAV_STEPS),
                       ("walk_steps", C_WALK_STEPS))})
        out["ms"] = cuda_ms(lambda: integrator.megakernel(meng, mk, 0,
                                                          mk_args))
        return out

    def mega_line(tag, m):
        return (f"megakernel: {tag} one sample, iters/depth match "
                f"{m['frac']:.6f} of pixels, colour outliers {m['outliers']:.5f}"
                f" clean mean {m['clean_mean']:.2e} max abs err {m['err']:.2e}, "
                f"counters/hist exact {m['ctr_ok']} (paths {m['paths']}, rays "
                f"{m['rays']}, depth_sum {m['depth_sum']}, traversal steps "
                f"{m['trav_steps']}, walk steps {m['walk_steps']}), "
                f"{m['ms']:.3f} ms (twin {m['plain_ms']:.1f} ms)")

    # K5 megakernel: one 800x450 sample against its twin, pixel by pixel
    meng = integrator.MegaEngine(scene, flags, bvh, cam_a, cfg, key)
    m = mega_pair(meng, W, H)
    # Bytes: the node rows and shade rows once; per pixel its colour, iters
    # and depth written and its frame entry read and written.  Operations:
    # ~220 per traversal step, one bounce per loop trip (as K3's count),
    # the camera ray (8 threefry) per pixel and the SSS walk trips.
    prim_bytes = meng.tabs.prim.numel() * 4
    byts = node_bytes + prim_bytes + W * H * (12 + 4 + 4 + 24)
    ops = (m["trav_steps"] * 220 + m["rays"] * BOUNCE_OPS
           + m["walk_steps"] * WALK_TRIP_OPS + W * H * (8 * 110 + 60))
    results["megakernel"] = dict(ok=m["ok"], err=m["err"], ms=m["ms"],
                                 plain_ms=m["plain_ms"], bytes=byts, ops=ops,
                                 library_ms=None)
    phase("kernels", mega_line("vol2_final 800x450", m)
          + f" {'PASS' if m['ok'] else 'FAIL'}; bound inputs: node bytes "
          f"{node_bytes}, shade-row bytes {prim_bytes}, total bytes {byts}, "
          f"fp32 ops {ops}")
    del meng

    # K3 on a mid-flight wave state of mesh_perlin_sss: the SSS walk
    QW, QH, QSPP, QDEPTH = 400, 225, 64, 12
    world_q, cam_q = ptt.scenes.mesh_perlin_sss()
    cam_q.aspect_ratio, cam_q.img_width = QW / QH, QW
    cam_q.samples_per_pixel, cam_q.max_depth = QSPP, QDEPTH
    sc_q = ptt.compile_scene(world_q, device=dev)
    fl_q = SceneFlags.from_scene(sc_q)
    assert fl_q.has_sss and fl_q.has_noise
    bv_q = ptt.build_from_scene(sc_q)
    ca_q = cam_q.initialize(device=dev)
    cf_q = RenderConfig(width=QW, height=QH, samples_per_pixel=QSPP,
                        max_depth=QDEPTH)
    # the pool and steps of phase 6's one-batch frame through the Renderer
    q_q, s_q, _ = wave_preset(cf_q, bv_q.nodes.shape[0], QSPP * QW * QH,
                              kernels.resident_lanes(dev, bv_q.branching))
    qeng = wf.WaveEngine(sc_q, fl_q, bv_q, ca_q, cf_q, 0, QSPP, key,
                         queue_size=q_q, steps_per_wave=s_q, ctrl_den=8)
    qws = qeng.init_state(torch.zeros((QH, QW, 3), device=dev))
    for _ in range(24):                       # a mid-flight pool
        for op in wf.KERNELS:
            op(qeng, qws)
    kernels.launch("trace_step", qeng, qws)
    torch.cuda.synchronize()
    snap = qws.clone()
    snap.ctr[C_DO_CTRL] = 1
    ready = snap.occupied & (snap.cur == traverse._DONE)
    hit_mat = shade_tiled._prim_rows(qeng.tabs, snap.best_pt, snap.best_pi)[0]
    mtype = qeng.tabs.mat[hit_mat.long(), 0].long()
    hit = ready & (snap.best_pt >= 0)
    n_sv = int((hit & (mtype == MAT_SSS_VOLUMETRIC)).sum())
    n_ss = int((hit & (mtype == MAT_SSS_SIMPLE)).sum())
    k3, p3 = snap.clone(), snap.clone()
    kernels.launch("shade", qeng, k3)
    shade_tiled.shade_plain(qeng, p3)
    torch.cuda.synchronize()
    same = (k3.alive == p3.alive) & (k3.depth == p3.depth) & (k3.flag == p3.flag)
    frac = float(same[ready].float().mean())
    rest = ready & same
    err_q = max(float((getattr(k3, f) - getattr(p3, f))[rest].abs().max())
                for f in ("origin", "direction", "color", "throughput"))
    walk_k = int(k3.ctr[C_WALK_STEPS] - snap.ctr[C_WALK_STEPS])
    walk_p = int(p3.ctr[C_WALK_STEPS] - snap.ctr[C_WALK_STEPS])
    ok_q = (frac >= 0.999 and n_sv > 0 and n_ss > 0 and walk_k == walk_p > 0
            and all(torch.allclose(getattr(k3, f)[rest], getattr(p3, f)[rest],
                                   rtol=1e-4, atol=1e-4)
                    for f in ("origin", "direction", "color", "throughput")))
    work = snap.clone()
    ms_q = cuda_ms(lambda: kernels.launch("shade", qeng, work),
                   setup=lambda: restore(work, snap))
    pms_q = cuda_ms(lambda: shade_tiled.shade_plain(qeng, work), reps=5,
                    setup=lambda: restore(work, snap))
    res = results["shade"]
    res.update(ok=res["ok"] and ok_q, err=max(res["err"], err_q),
               sss=dict(ok=ok_q, ms=ms_q, plain_ms=pms_q, ready=int(ready.sum()),
                        sss_volumetric=n_sv, sss_simple=n_ss, walk_steps=walk_k))
    phase("kernels", f"shade on mesh_perlin_sss 400x225 mid-flight: "
          f"{int(ready.sum())} ready lanes, {n_sv} SSS-volumetric and {n_ss} "
          f"SSS-simple, alive/depth/flag match {frac:.6f}, float max abs err "
          f"{err_q:.2e}, walk steps {walk_k} (twin {walk_p}), {ms_q:.3f} ms "
          f"(twin {pms_q:.2f} ms) {'PASS' if ok_q else 'FAIL'}")
    del qws, snap, k3, p3, work
    torch.cuda.empty_cache()

    # K5 on one 400x225 sample of mesh_perlin_sss, where it runs the walk
    mq = mega_pair(integrator.MegaEngine(sc_q, fl_q, bv_q, ca_q, cf_q, key),
                   QW, QH)
    ok_mq = mq["ok"] and mq["walk_steps"] > 0
    res = results["megakernel"]
    res.update(ok=res["ok"] and ok_mq, err=max(res["err"], mq["err"]),
               sss=dict(mq, ok=ok_mq))
    phase("kernels", mega_line("mesh_perlin_sss 400x225", mq)
          + f" {'PASS' if ok_mq else 'FAIL'}")
    torch.cuda.empty_cache()

    # The tiled engine's kernels on every lane of an 800x450 vol2_final
    # sample: the tiled spawn (B3) against spawn_paths, then after three
    # trips of the kernels K7 (closest_hit, the main and the volume-exit
    # query) and K8 (tiled_trip) against their plain versions on one state.
    def clone_state(st_):
        return itl.PathState(*(x.clone() for x in st_))

    def restore_state(dst, src):
        for d_, s_ in zip(dst, src):
            d_.copy_(s_)

    def trip_check(kst_, pst_, live_, snap_):
        """K8's state against the plain trip's on the live lanes, dead
        lanes frozen → (ok, share of live lanes alike, max abs err).  Every
        live lane must agree on alive and depth."""
        same_ = (kst_.alive == pst_.alive) & (kst_.depth == pst_.depth)
        frac_ = float(same_[live_].float().mean())
        rest_ = same_ & live_
        fl_f = ("origin", "direction", "color", "throughput")
        err_ = max(float((getattr(kst_, f) - getattr(pst_, f))[rest_].abs()
                         .max()) for f in fl_f)
        frozen = all(torch.equal(x[~live_], y[~live_])
                     for x, y in zip(kst_, snap_))
        ok_ = frac_ == 1.0 and frozen and all(
            torch.allclose(getattr(kst_, f)[rest_], getattr(pst_, f)[rest_],
                           rtol=1e-4, atol=1e-4) for f in fl_f)
        return ok_, frac_, err_

    NL = W * H
    teng = itl.TiledEngine(scene, flags, bvh, cam_a, cfg, key)
    tpix = torch.arange(NL, dtype=torch.int32, device=dev)
    t_min_v = torch.full((NL,), cfg.t_min, device=dev)
    shade_bytes = 4 * sum(x.numel() for x in (teng.tabs.prim, teng.tabs.mat,
                                              teng.tabs.tex, teng.tabs.med))

    def query(st_, tmin_, act_, plain=False, ctr=None, bvh_=bvh,
              exit_of=None):
        """K7 (or its plain version) on the lanes act_; with exit_of, the
        engine's volume-exit query (the kernel gated on the main hit's
        medium, the plain version on exit_lanes' mask)."""
        if plain:
            if exit_of is not None:
                act_ = itl.exit_lanes(exit_of[0], act_, *exit_of[1:])
            return itl.closest_hit_plain(bvh_, st_.origin, st_.direction,
                                         st_.time, tmin_, cfg.t_max,
                                         cfg.stack_depth, active=act_,
                                         ctr=ctr)
        return itl.closest_hit_batched(bvh_, st_.origin, st_.direction,
                                       st_.time, tmin_, cfg.t_max,
                                       cfg.stack_depth, active=act_, ctr=ctr,
                                       exit_of=exit_of)

    def spawn_check(got, want):
        """(ok, err) of a spawned state against spawn_paths': rays within
        rel 1e-6, time and the fresh state exact."""
        err_ = max(float((got.origin - want.origin).abs().max())
                   / max(float(want.origin.abs().max()), 1.0),
                   float((got.direction - want.direction).abs().max()))
        return err_ <= 1e-6 and torch.equal(got.time, want.time) and all(
            torch.equal(getattr(got, f), getattr(want, f))
            for f in ("color", "throughput", "depth", "iters", "alive")), err_

    sk = itl.tiled_spawn(teng, 0, tpix)
    sp_ = shade_tiled.spawn_paths(cam_a, cfg, key, torch.zeros_like(tpix), tpix)
    ok_s, err_s = spawn_check(sk, sp_)
    # frame_dev set: the spawn on the kept trip graph's argument block and
    # frame memory after it was loaded with a new key and a moved camera,
    # sample 3 read from card memory, with the live list
    cam_m = copy.copy(cam)
    cam_m.lookfrom = np.asarray(cam.lookfrom, float) + np.array(
        [0.25, 0.0, 0.0])
    cam_ma, key_m = cam_m.initialize(device=dev), rng.fold_in(key, 5)
    itl.clear_trip_graphs()
    tg0 = itl.trip_graph(teng, NL)
    tg = itl.trip_graph(itl.TiledEngine(scene, flags, bvh, cam_ma, cfg, key_m),
                        NL)
    tg.sample.fill_(3)
    live_s = itl.new_live_list(NL, dev)
    ok_f, err_f = spawn_check(
        itl.tiled_spawn(tg.eng, tg.sample, tpix, live_s),
        shade_tiled.spawn_paths(cam_ma, cfg, key_m, torch.full_like(tpix, 3),
                                tpix))
    ok_f = ok_f and tg is tg0 and torch.equal(live_s[0][0], tpix) and (
        live_s[1].tolist() == [NL, 0, 0])
    del tg0, tg, live_s
    itl.clear_trip_graphs()
    # A ragged lane count (NL - 7 scattered pixels, a partial last warp),
    # into new rows (whole warps in 16-byte stores, the last in 4-byte ones)
    # and into rows 4 bytes past 16-byte alignment (every lane in 4-byte
    # stores).
    NR = NL - 7
    rpix = torch.randperm(NL, generator=torch.Generator().manual_seed(13))
    rpix = rpix[:NR].sort().values.to(device=dev, dtype=torch.int32)
    sp_r = shade_tiled.spawn_paths(cam_a, cfg, key, torch.zeros_like(rpix),
                                   rpix)

    def off4(*shape):
        """An empty float32 tensor whose data starts 4 bytes past 16."""
        n_ = math.prod(shape)
        return torch.empty(n_ + 4, device=dev)[1:n_ + 1].view(shape)
    st_u = itl.PathState(
        origin=off4(NR, 3), direction=off4(NR, 3), time=off4(NR),
        color=off4(NR, 3), throughput=off4(NR, 3),
        depth=torch.empty(NR, dtype=torch.int32, device=dev),
        iters=torch.empty(NR, dtype=torch.int32, device=dev),
        alive=torch.empty(NR, dtype=torch.bool, device=dev))
    ok_r, err_r = spawn_check(itl.tiled_spawn(teng, 0, rpix), sp_r)
    ok_u, err_u = spawn_check(itl.tiled_spawn(teng, 0, rpix, out=st_u), sp_r)
    ok_u = ok_u and st_u.origin.data_ptr() % 16 == 4
    del sp_r, st_u
    ms_s = cuda_ms(lambda: itl.tiled_spawn(teng, 0, tpix))
    pms_s = cuda_ms(lambda: shade_tiled.spawn_paths(
        cam_a, cfg, key, torch.zeros_like(tpix), tpix), reps=5)
    # Integer issue beside the bound, on the phase line only (an estimate,
    # not a measurement): the lanes' 7 threefry evaluations of at least
    # THREEFRY_INT integer instructions each (the block's shared fold left
    # out), and the SASS's static count of integer instructions (both store
    # branches in it), each at 64 a clock an SM (CUDA Programming Guide,
    # compute capability 9.0 throughput table) and the card's top SM clock.
    mix = next(c for f, c in kernels.sass_opcodes(
        kernels.library_path("tiled_trip")).items()
        if "tiled_spawn_kernel" in f)
    int_lane = kernels.sass_classes(mix)["integer"]
    int_rate = (64 * torch.cuda.get_device_properties(0).multi_processor_count
                * sm_hz / 1e3)
    int_ms = NL * 7 * THREEFRY_INT / int_rate
    ptx_s = ptxas_resources(kernels.BUILD_LOG.get("tiled_trip", ""),
                            "tiled_spawn")
    ok_sp = ok_s and ok_f and ok_r and ok_u
    results["tiled_spawn"] = dict(
        ok=ok_sp, err=max(err_s, err_f, err_r, err_u), ms=ms_s,
        plain_ms=pms_s,
        bytes=NL * (4 + STATE_BYTES + 4),   # pixel; state; list entry
        ops=NL * (7 * THREEFRY_OPS + 60) + THREEFRY_OPS, library_ms=None,
        int_ops_lane=int_lane, ptxas=list(ptx_s))
    phase("kernels", f"tiled_spawn: {NL} lanes, rays rel err {err_s:.2e}, "
          f"time and fresh state exact {ok_s}; frame_dev of the kept trip "
          f"graph loaded with a new key and view, sample 3 from card memory: "
          f"rel err {err_f:.2e}, exact {ok_f}, list 0 every lane; {NR} "
          f"scattered lanes: rel err {err_r:.2e}, exact {ok_r}; into rows 4 "
          f"bytes off 16-byte alignment: rel err {err_u:.2e}, exact {ok_u}; "
          f"{ms_s:.3f} ms (plain {pms_s:.2f} ms); ptxas (registers, stack "
          f"frame, spill stores, spill loads) {ptx_s}; SASS {sum(mix.values())}"
          f" instructions, {int_lane} integer (static); integer issue "
          f"estimated at {sm_hz / 1e6:.0f} MHz: the draws {int_ms:.4f} ms, "
          f"the static count {NL * int_lane / int_rate:.4f} ms; bytes "
          f"{results['tiled_spawn']['bytes'] / H100_BYTES_PER_S * 1e3:.4f} ms "
          f"{'PASS' if ok_sp else 'FAIL'}")
    tst = sk
    for _ in range(3):                        # mid-frame lanes
        h_ = query(tst, t_min_v, tst.alive)
        e_ = query(tst, h_[3] + 1e-4, tst.alive & h_[0])
        tst = itl.tiled_trip(teng, tst, 0, tpix, h_[:3], e_)
    live = tst.alive.clone()
    n_live = int(live.sum())
    c_k, c_p = itl.new_counters(dev), itl.new_counters(dev)
    hk = query(tst, t_min_v, live, ctr=c_k)
    hp = query(tst, t_min_v, live, plain=True, ctr=c_p)
    steps7 = int(c_k[C_TRAV_STEPS])
    # The exit query as the engine walks it: on the live lanes whose hit
    # has a medium (itl.exit_lanes; the kernel reads the hit's medium).
    ex_of = (teng, hk[0], hk[1], hk[2])
    emask = itl.exit_lanes(teng, live, hk[0], hk[1], hk[2])
    ek = query(tst, hk[3] + 1e-4, live, ctr=c_k, exit_of=ex_of)
    ep = query(tst, hk[3] + 1e-4, live, plain=True, ctr=c_p, exit_of=ex_of)
    eq = torch.cat([(a_[0] == b_[0]) & (a_[1] == b_[1]) & (a_[2] == b_[2])
                    for a_, b_ in ((hk, hp), (ek, ep))])
    tk_, tp_ = torch.cat([hk[3], ek[3]]), torch.cat([hp[3], ep[3]])
    frac7 = float(eq.float().mean())
    rel7 = float(((tk_ - tp_).abs() / tp_.abs().clamp(min=1e-6))[eq].max())
    err7 = float((tk_ - tp_)[eq].abs().max())
    ok7 = frac7 == 1.0 and rel7 <= 1e-5
    ms7 = cuda_ms(lambda: query(tst, t_min_v, live))
    ms7e = cuda_ms(lambda: query(tst, hk[3] + 1e-4, live, exit_of=ex_of))
    dev7 = device_ms(lambda: query(tst, t_min_v, live))
    dev7e = device_ms(lambda: query(tst, hk[3] + 1e-4, live, exit_of=ex_of))
    pms7 = cuda_ms(lambda: query(tst, t_min_v, live, plain=True), reps=1)
    # Bytes: the node rows once; per lane its mask read and its result (13
    # B) written, per live lane its ray (32 B) read.  Operations: ~220 per
    # traversal step of the main query.
    byts7 = node_bytes + NL * 14 + n_live * 32
    results["closest_hit"] = dict(ok=ok7, err=err7, ms=ms7, plain_ms=pms7,
                                  bytes=byts7, ops=steps7 * 220,
                                  library_ms=None, exit_ms=ms7e,
                                  exit_device_ms=dev7e, main_device_ms=dev7,
                                  exit_lanes=int(emask.sum()))
    phase("kernels", f"closest_hit: vol2_final 800x450 sample 0 after 3 "
          f"trips, {n_live} live lanes ({int(emask.sum())} with a medium hit "
          f"walk the exit query): main and exit queries match "
          f"{frac7:.6f} of lanes, t max rel {rel7:.2e}, traversal steps "
          f"{int(c_k[C_TRAV_STEPS])} (plain {int(c_p[C_TRAV_STEPS])}; main "
          f"query {steps7}), {ms7:.3f} ms per main query, {ms7e:.3f} ms per "
          f"exit query (plain {pms7:.1f} ms); device ms per launch: main "
          f"{dev7:.4f}, exit {dev7e:.4f}; bound inputs: bytes {byts7}, fp32 "
          f"ops {steps7 * 220} {'PASS' if ok7 else 'FAIL'}")
    snap8 = clone_state(tst)
    ks, c8k, c8p = clone_state(snap8), itl.new_counters(dev), itl.new_counters(dev)
    itl.tiled_trip(teng, ks, 0, tpix, hk[:3], ek, ctr=c8k)
    ps = itl.tiled_trip_plain(teng, snap8, 0, tpix, hk[:3], ek, ctr=c8p)
    ok8, frac8, err8 = trip_check(ks, ps, live, snap8)
    walk8 = int(c8k[C_WALK_STEPS])
    ok8 = ok8 and walk8 == int(c8p[C_WALK_STEPS])
    # The same trip on live lists, as every tiled frame runs K8: list 0 the
    # live lanes, the survivors appended to list 1.  Against the plain trip
    # as above and bit-identical to the every-lane launch, counters
    # included; list 1 holds the next state's live lanes, each once; the
    # count it read and the ticket are back at 0.
    lists8 = itl.new_live_list(NL, dev)
    live_idx = live.nonzero()[:, 0].to(torch.int32)
    lists8[0][0][:n_live] = live_idx
    counts8 = torch.tensor([n_live, 0, 0], dtype=torch.int32, device=dev)
    lists8[1].copy_(counts8)
    kl, c8l = clone_state(snap8), itl.new_counters(dev)
    itl.tiled_trip(teng, kl, 0, tpix, hk[:3], ek, ctr=c8l, live=lists8,
                   parity=0)
    okl, fracl, errl = trip_check(kl, ps, live, snap8)
    n_out = int(lists8[1][1])
    list_set = torch.equal(torch.sort(lists8[0][1][:n_out]).values,
                           kl.alive.nonzero()[:, 0].to(torch.int32))
    list_same = (all(torch.equal(x, y) for x, y in zip(kl, ks))
                 and torch.equal(c8l, c8k))
    list_clear = int(lists8[1][0]) == 0 and int(lists8[1][2]) == 0
    ok8 = ok8 and okl and list_same and list_set and list_clear
    work8 = clone_state(snap8)

    def restore_lists():
        restore_state(work8, snap8)
        lists8[1].copy_(counts8)

    ms8 = cuda_ms(lambda: itl.tiled_trip(teng, work8, 0, tpix, hk[:3], ek,
                                         live=lists8, parity=0),
                  setup=restore_lists)
    ms8_all = cuda_ms(lambda: itl.tiled_trip(teng, work8, 0, tpix, hk[:3],
                                             ek),
                      setup=lambda: restore_state(work8, snap8))
    dev8 = device_ms(lambda: itl.tiled_trip(teng, work8, 0, tpix, hk[:3], ek,
                                            live=lists8, parity=0),
                     setup=restore_lists)
    dev8_all = device_ms(lambda: itl.tiled_trip(teng, work8, 0, tpix, hk[:3],
                                                ek),
                         setup=lambda: restore_state(work8, snap8))
    pms8 = cuda_ms(lambda: itl.tiled_trip_plain(teng, snap8, 0, tpix, hk[:3],
                                                ek), reps=1)
    # Bytes: per lane its flag, per live lane its state read and written,
    # its pixel and both queries' results; the shade tables once.
    byts8 = shade_bytes + NL + n_live * (2 * STATE_BYTES + 4 + 9 + 13)
    ops8 = n_live * BOUNCE_OPS + walk8 * WALK_TRIP_OPS
    results["tiled_trip"] = dict(ok=ok8, err=max(err8, errl), ms=ms8,
                                 ms_every_lane=ms8_all,
                                 state_device_ms=dev8,
                                 state_device_ms_every_lane=dev8_all,
                                 plain_ms=pms8,
                                 bytes=byts8, ops=ops8, library_ms=None)
    phase("kernels", f"tiled_trip: {n_live} live lanes; over every lane: "
          f"alive/depth match {frac8:.6f}, dead lanes frozen, float max abs "
          f"err {err8:.2e}, walk steps {walk8}, {ms8_all:.3f} ms (device "
          f"{dev8_all:.4f}); on live "
          f"lists: alive/depth match {fracl:.6f}, float max abs err "
          f"{errl:.2e}, state and counters bit-identical to the every-lane "
          f"launch {list_same}, list 1 = the next live lanes, each once "
          f"{list_set} ({n_out}), count read and ticket cleared "
          f"{list_clear}, {ms8:.3f} ms (device {dev8:.4f}; plain "
          f"{pms8:.1f} ms), bound inputs: "
          f"bytes {byts8}, fp32 ops {ops8} {'PASS' if ok8 else 'FAIL'}")
    del teng, sk, sp_, tst, snap8, ks, ps, work8, hk, hp, ek, ep, kl, lists8
    torch.cuda.empty_cache()

    # K9 (ring_hop) and K8's rec variant over the torus knot sharded two
    # ways, every camera ray of an 800x800 frame: the two hops of a 2-stage
    # ring (shard 0 from the empty bundle, shard 1 with its bundle), then
    # the bounce of the carried record.  Each hop against its plain version
    # (found, t and counters exact) and against the hop as JAX takes it, the
    # walk to t_max (the bundle bit-equal: K9's walk ends at the carried
    # best, which prunes nothing that is merged).
    sc_k, fl_k, bv_k, ca_k, cf_k = torus_knot(dev)
    sc_kt, bv_kt = scene_shard.shard_scene(sc_k, 2)
    KL = cf_k.width * cf_k.height
    kpix = torch.arange(KL, dtype=torch.int32, device=dev)
    kt_min = torch.full((KL,), cf_k.t_min, device=dev)
    carry0 = (torch.zeros((KL,), dtype=torch.bool, device=dev),
              torch.full((KL,), 1e30, device=dev),
              pipeline._empty_rec(KL, dev))

    def hop_unbounded(eng_, ray_, carry_):
        """One hop as JAX takes it (parallel/pipeline.py:80-90)."""
        ro, rd, tm, tmin, act = ray_
        fnd, tb, rc = carry_
        found, pt, pi, t = itl.closest_hit_plain(
            eng_.bvh, ro, rd, tm, tmin, eng_.cfg.t_max, eng_.cfg.stack_depth,
            act)
        loc = shade_tiled.refine_hit_t(eng_.tabs, pt, pi, *ro.unbind(-1),
                                       *rd.unbind(-1), tm, tmin)
        better = found & (t < tb)
        return (fnd | better, torch.where(better, t, tb),
                torch.where(better[:, None], itl.rec_to_rows(loc), rc))

    def ring_hops(bv_t, sc_t):
        """K9's two hops of the ring: per hop its checks, ms and bound
        inputs; the bundle after hop 0, shard 0's engine and its rays'
        path state."""
        engs_ = []
        for r_ in range(2):
            sc_l_, bv_l_ = scene_shard.local_shard(sc_t, bv_t, r_)
            engs_.append(itl.TiledEngine(sc_l_, fl_k, bv_l_, ca_k, cf_k, key))
        st_ = itl.tiled_spawn(engs_[0], 0, kpix)
        ray_ = (st_.origin, st_.direction, st_.time, kt_min, st_.alive)
        carry, hops, after0 = carry0, [], None
        for h_, eng_ in enumerate(engs_):
            kk_ = tuple(x.clone() for x in carry)
            kp_ = tuple(x.clone() for x in carry)
            c_k, c_p = itl.new_counters(dev), itl.new_counters(dev)
            pipeline.ring_hop(eng_, *ray_, *kk_, ctr=c_k)
            pipeline.ring_hop_plain(eng_, *ray_, *kp_, ctr=c_p)
            ref_ = hop_unbounded(eng_, ray_, carry)
            exact = (torch.equal(kk_[0], kp_[0]) and torch.equal(kk_[1], kp_[1])
                     and torch.equal(c_k, c_p)
                     and torch.allclose(kk_[2], kp_[2], rtol=1e-4, atol=1e-4))
            same = all(torch.equal(x, y) for x, y in zip(kp_, ref_))
            work_ = tuple(x.clone() for x in carry)
            base = carry
            ms_ = cuda_ms(lambda: pipeline.ring_hop(eng_, *ray_, *work_),
                          setup=lambda: restore_state(work_, base))
            dev_ = device_ms(lambda: pipeline.ring_hop(eng_, *ray_, *work_),
                             setup=lambda: restore_state(work_, base))
            pms_ = cuda_ms(lambda: pipeline.ring_hop_plain(eng_, *ray_,
                                                           *work_),
                           setup=lambda: restore_state(work_, base), reps=1)
            # the hits of this stage that win the merge
            n_win = int((kk_[1] != carry[1]).sum())
            hops.append(dict(
                ok=exact and same, exact=exact, same_as_unbounded=same,
                err=float((kk_[2] - kp_[2]).abs().max()), ms=ms_,
                device_ms=dev_, plain_ms=pms_, wins=n_win,
                steps=int(c_k[C_TRAV_STEPS]),
                node_bytes=eng_.bvh.nodes.numel() * 4))
            if h_ == 0:
                after0 = kk_
            carry = kk_
        return hops, after0, engs_[0], st_

    def hop_row(hops, width):
        """The kernel-line row of K9: per launch the mean of its two hops
        (a 2-stage ring runs each as often).  Bytes: the shard's node rows
        once, per lane its ray and mask read (33 B), the carried best t
        read (4 B); per winning hit the primitive row (64 B) and found, t
        and the record written (53 B).  Operations: its traversal steps and
        a refine per winning hit."""
        byts = [h_["node_bytes"] + KL * 37 + h_["wins"] * (64 + 53)
                for h_ in hops]
        ops = [h_["steps"] * STEP_OPS[width] + h_["wins"] * REFINE_OPS
               for h_ in hops]
        mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
        return dict(ok=all(h_["ok"] for h_ in hops),
                    err=max(h_["err"] for h_ in hops),
                    ms=mean([h_["ms"] for h_ in hops]),
                    plain_ms=mean([h_["plain_ms"] for h_ in hops]),
                    device_ms=mean([h_["device_ms"] for h_ in hops]),
                    bytes=mean(byts), ops=mean(ops), library_ms=None,
                    hop_bytes=byts, hop_ops=ops,
                    hop_device_ms=[h_["device_ms"] for h_ in hops],
                    hop_steps=[h_["steps"] for h_ in hops])

    hops9, kk, keng, kst = ring_hops(bv_kt, sc_kt)
    results["ring_hop"] = hop_row(hops9, 4)
    ok9 = results["ring_hop"]["ok"]
    phase("kernels", f"ring_hop: torus knot sharded 2 ways, {KL} camera "
          "rays, hop 0 (shard 0, empty bundle) and hop 1 (shard 1): "
          + "; ".join(f"hop {i}: found, t and counters exact {h['exact']}, "
                      f"bundle bit-equal to the unbounded hop's "
                      f"{h['same_as_unbounded']}, record max abs err "
                      f"{h['err']:.2e}, {h['wins']} hits merged, traversal "
                      f"steps {h['steps']}, {h['ms']:.3f} ms (device "
                      f"{h['device_ms']:.4f} ms, plain {h['plain_ms']:.1f} ms)"
                      for i, h in enumerate(hops9))
          + f"; bound inputs per launch: bytes {results['ring_hop']['bytes']:.0f}"
          f", fp32 ops {results['ring_hop']['ops']:.0f} "
          f"{'PASS' if ok9 else 'FAIL'}")
    zi = torch.zeros((KL,), dtype=torch.int32, device=dev)
    hit_r = (kk[0], zi, zi)
    snap_r = clone_state(kst)
    kr = clone_state(snap_r)
    itl.tiled_trip(keng, kr, 0, kpix, hit_r, rec=kk[2])
    pr = itl.tiled_trip_plain(keng, snap_r, 0, kpix, hit_r, rec=kk[2])
    ok_r, frac_r, err_r = trip_check(kr, pr, snap_r.alive, snap_r)
    work_r = clone_state(snap_r)
    ms_r = cuda_ms(lambda: itl.tiled_trip(keng, work_r, 0, kpix, hit_r,
                                          rec=kk[2]),
                   setup=lambda: restore_state(work_r, snap_r))
    dev_r = device_ms(lambda: itl.tiled_trip(keng, work_r, 0, kpix, hit_r,
                                             rec=kk[2]),
                      setup=lambda: restore_state(work_r, snap_r))
    pms_r = cuda_ms(lambda: itl.tiled_trip_plain(keng, snap_r, 0, kpix, hit_r,
                                                 rec=kk[2]), reps=1)
    n_live_r = int(snap_r.alive.sum())
    byts_r = (4 * (keng.tabs.mat.numel() + keng.tabs.tex.numel()) + KL
              + n_live_r * (2 * STATE_BYTES + 4 + 1 + 4 * 12))
    results["tiled_trip_rec"] = dict(ok=ok_r, err=err_r, ms=ms_r,
                                     device_ms=dev_r,
                                     plain_ms=pms_r, bytes=byts_r,
                                     ops=n_live_r * BOUNCE_OPS,
                                     library_ms=None)
    phase("kernels", f"tiled_trip_rec: the carried records of {n_live_r} "
          f"lanes, alive/depth match {frac_r:.6f}, float max abs err "
          f"{err_r:.2e}, {ms_r:.3f} ms (plain {pms_r:.1f} ms) "
          f"{'PASS' if ok_r else 'FAIL'}")
    del keng, kst, kk, snap_r, kr, pr, work_r, sc_kt, bv_kt
    torch.cuda.empty_cache()

    # K6 adjoint against its plain version (autograd of the twin's replay)
    def prepare(world_, cam_, w, h, spp, depth, branching=4):
        cam_.aspect_ratio, cam_.img_width = w / h, w
        sc_ = ptt.compile_scene(world_, device=dev)
        fl_ = SceneFlags.from_scene(sc_)
        cf_ = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_depth=depth)
        return (sc_, fl_, ptt.build_from_scene(sc_, branching),
                cam_.initialize(device=dev), cf_)

    def adjoint_pair(sc_, fl_, bv_, ca_, cf_, samples, seed, full=False):
        """K6 (the colour or the ``full`` instantiation) and its plain
        version over ``samples`` with one random delta: relative L2 error
        (with ``full`` per leaf) and max abs error of the gradient vector,
        the buffers, K6's ms for one launch (median of 25), the plain ms for
        all samples, and K5's counters and ms on the first sample (the
        bound's input, and the replay's cost alone); with ``full`` also the
        colour K6's ms there."""
        aeng = integrator.MegaEngine(sc_, fl_, bv_, ca_, cf_, key)
        npx = aeng.npix
        ams = aeng.init_state(torch.zeros((npx, 3), device=dev))
        delta = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (npx, 3)).astype(np.float32)).to(dev)
        gk, gp = adjoint.grad_buffers(sc_), adjoint.grad_buffers(sc_)
        for s_ in samples:
            adjoint.adjoint(aeng, ams, s_, delta, gk, full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s_ in samples:
            adjoint.adjoint_plain(aeng, ams, s_, delta, gp, full)
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
        vk = torch.cat([g.flatten() for g in gk])
        vp = torch.cat([g.flatten() for g in gp])
        rel = float((vk - vp).norm() / vp.norm().clamp(min=1e-30))
        err = float((vk - vp).abs().max())
        # K6 takes its pixels from ctr[C_FETCH]; each launch leaves the
        # counter and the ticket at 0 again.
        clean = int(ams.ctr[C_FETCH]) == 0 and int(ams.ctr[C_TICKET]) == 0
        out = dict(rel=rel, err=err, plain_ms=pms, ctr_clean=clean)
        if full:
            K, P = adjoint.leaf_grads(sc_, gk), adjoint.leaf_grads(sc_, gp)
            out["leaf_rel"] = {
                n: float((K[n] - P[n]).norm() / P[n].norm().clamp(min=1e-30))
                for n in adjoint.FLOAT_LEAVES if float(P[n].norm()) > 0
                or float(K[n].norm()) > 0}
            out["rel"] = max(out["leaf_rel"].values(), default=0.0)
        scratch = adjoint.grad_buffers(sc_)
        out["ms"] = cuda_ms(lambda: adjoint.adjoint(aeng, ams, samples[0],
                                                    delta, scratch, full))
        out["device_ms"] = device_ms(lambda: adjoint.adjoint(
            aeng, ams, samples[0], delta, scratch, full))
        if full:
            out["colour_ms"] = cuda_ms(lambda: adjoint.adjoint(
                aeng, ams, samples[0], delta, scratch))
        mst = aeng.init_state(torch.zeros((npx, 3), device=dev))
        mst_args = integrator.mega_args(aeng, mst)
        integrator.megakernel(aeng, mst, samples[0], mst_args)
        torch.cuda.synchronize()
        ctr = {n: int(mst.ctr[i]) for n, i in (
            ("rays", C_RAYS), ("trav_steps", C_TRAV_STEPS),
            ("walk_steps", C_WALK_STEPS))}
        out["k5_ms"] = cuda_ms(lambda: integrator.megakernel(
            aeng, mst, samples[0], mst_args))
        # Bytes: node and shade rows once (with the material, medium and
        # texture rows for the full sweep), delta read, the gradient buffers
        # read and written once.  Operations: K5's replay of the sample plus
        # the sweep (one tape entry per loop trip; the full sweep also
        # reverses each SSS walk).
        g_bytes = sum(g.numel() for g in gk) * 4
        tab_bytes = (bv_.nodes.numel() + aeng.tabs.prim.numel()) * 4
        if full:
            tab_bytes += (aeng.tabs.mat.numel() + aeng.tabs.med.numel()
                          + aeng.tabs.tex.numel()) * 4
        out["bytes"] = tab_bytes + npx * 12 + 2 * g_bytes
        sweep, walk = ((FULL_SWEEP_OPS, WALK_TRIP_OPS + FULL_WALK_OPS) if full
                       else (SWEEP_OPS, WALK_TRIP_OPS))
        out["ops"] = (ctr["trav_steps"] * STEP_OPS[bv_.branching]
                      + ctr["rays"] * (BOUNCE_OPS + sweep)
                      + ctr["walk_steps"] * walk + npx * (8 * 110 + 60))
        return dict(out, g=gk, **ctr)

    def bound_ms(byts, ops):
        return max(byts / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S) * 1e3

    adj_ok = True
    adj_rows = {}
    for label, build_fn, depth in (
            ("cornell_box", ptt.scenes.cornell_box, 6),
            ("texture_demo", ptt.scenes.texture_demo, 5),
            ("vol2_final_scene",
             lambda: ptt.scenes.vol2_final_scene(sphere_cluster=1000), DEPTH),
            ("mesh_perlin_sss", ptt.scenes.mesh_perlin_sss, QDEPTH)):
        sc_, fl_, bv_, ca_, cf_ = prepare(*build_fn(), 160, 90, 2, depth)
        r = adjoint_pair(sc_, fl_, bv_, ca_, cf_, (0, 1), 1)
        g = adjoint.leaf_grads(sc_, r.pop("g"))
        mat_t = sc_.mat_type.cpu().numpy()
        sss_tex = sc_.mat_tex.cpu().numpy()[mat_t == MAT_SSS_VOLUMETRIC]
        covered = {
            "cornell_box": bool(g["tex_c1"].abs().sum() > 0),
            "texture_demo": bool(g["img_data"].abs().sum() > 0),
            "vol2_final_scene": bool(g["img_data"].abs().sum() > 0
                                     and g["tex_c1"].abs().sum() > 0),
            "mesh_perlin_sss": bool(len(sss_tex) and r["walk_steps"] > 0
                                    and g["tex_c1"][sss_tex].abs().sum() > 0),
        }[label]
        finite = all(bool(torch.isfinite(x).all()) for x in g.values())
        ok = r["rel"] <= 1e-3 and covered and finite and r["ctr_clean"]
        adj_ok = adj_ok and ok
        adj_rows[label] = dict(r, ok=ok, covered=covered,
                               bound_ms=bound_ms(r["bytes"], r["ops"]))
        phase("kernels", f"adjoint: {label} 160x90 2 spp depth {depth}: K6 vs "
              f"plain rel L2 {r['rel']:.2e} max abs {r['err']:.2e}, leaves "
              f"covered {covered}, finite {finite}, fetch counter left at 0 "
              f"{r['ctr_clean']}, {r['ms']:.3f} ms per "
              f"launch (bound {adj_rows[label]['bound_ms']:.5f} ms; rays "
              f"{r['rays']}, traversal steps {r['trav_steps']}, walk steps "
              f"{r['walk_steps']}), K5 on the same sample {r['k5_ms']:.3f} "
              f"ms, plain {r['plain_ms']:.1f} ms for 2 samples "
              f"{'PASS' if ok else 'FAIL'}")
    torch.cuda.empty_cache()

    # K6's full instantiation against its plain version, per leaf.  The
    # leaves each scene exercises (non-zero gradient) at 160x90, 2 spp, key
    # 0; every other leaf must agree too (zero on both sides).
    exercised = {
        "vol2_final_scene": ("sph_c0", "sph_c1", "sph_rad", "qd_n", "qd_d",
                             "mat_ir", "tex_c1", "tex_scale", "img_data",
                             "med_density", "perlin_vec"),
        "mesh_perlin_sss": ("sph_c0", "sph_c1", "sph_rad", "tr_v0", "tr_e1",
                            "tr_e2", "tr_n", "mat_fuzz", "mat_sigma_s",
                            "mat_sigma_a", "mat_scatter_dist", "tex_c1",
                            "tex_scale", "perlin_vec"),
        "cornell_smoke": ("tex_c1",),
        "triangles": ("sph_c0", "sph_c1", "sph_rad", "tr_v0", "tr_e1",
                      "tr_e2", "tr_n", "tex_c1", "tex_scale", "img_data",
                      "perlin_vec"),
    }

    def full_line(tag, r):
        return (f"adjoint_full: {tag}: K6 vs plain max per-leaf rel L2 "
                f"{r['rel']:.2e}, fetch counter left at 0 {r['ctr_clean']}, "
                f"{r['ms']:.3f} ms per launch (bound {r['bound_ms']:.5f} ms; "
                f"rays {r['rays']}, traversal steps {r['trav_steps']}, walk "
                f"steps {r['walk_steps']}), colour K6 {r['colour_ms']:.3f} ms "
                f"and K5 {r['k5_ms']:.3f} ms on the same sample, plain "
                f"{r['plain_ms']:.1f} ms")

    full_ok = True
    full_rows = {}
    for label, build_fn, depth in (
            ("vol2_final_scene",
             lambda: ptt.scenes.vol2_final_scene(sphere_cluster=1000), DEPTH),
            ("mesh_perlin_sss", ptt.scenes.mesh_perlin_sss, QDEPTH),
            ("cornell_smoke", ptt.scenes.cornell_smoke, 6),
            ("triangles", ptt.scenes.triangles, DEPTH)):
        sc_, fl_, bv_, ca_, cf_ = prepare(*build_fn(), 160, 90, 2, depth)
        r = adjoint_pair(sc_, fl_, bv_, ca_, cf_, (0, 1), 1, full=True)
        g = adjoint.leaf_grads(sc_, r.pop("g"))
        r["bound_ms"] = bound_ms(r["bytes"], r["ops"])
        finite = all(bool(torch.isfinite(x).all()) for x in g.values())
        zero = [n for n in exercised[label] if float(g[n].abs().sum()) == 0]
        bad = {n: v for n, v in r["leaf_rel"].items() if not v <= 1e-3}
        ok = finite and not zero and not bad and r["ctr_clean"]
        full_ok = full_ok and ok
        full_rows[label] = dict(r, ok=ok, zero=zero)
        per_leaf = ", ".join(f"{n} {v:.1e}" for n, v in r["leaf_rel"].items())
        phase("kernels", full_line(f"{label} 160x90 2 spp depth {depth}", r)
              + f"; per leaf: {per_leaf}; finite {finite}, exercised leaves "
              f"zero {zero} {'PASS' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    # one full-size sample of each main configuration
    for label, args in (
            ("vol2_final 800x450", (scene, flags, bvh, cam_a, cfg)),
            ("mesh_perlin_sss 400x225", (sc_q, fl_q, bv_q, ca_q, cf_q))):
        r = adjoint_pair(*args, (0,), 3, full=True)
        g = adjoint.leaf_grads(args[0], r.pop("g"))
        r["bound_ms"] = bound_ms(r["bytes"], r["ops"])
        finite = all(bool(torch.isfinite(x).all()) for x in g.values())
        ok = finite and r["rel"] <= 1e-3 and r["ctr_clean"]
        full_ok = full_ok and ok
        full_rows[label] = dict(r, ok=ok)
        phase("kernels", full_line(f"{label} one sample", r)
              + f", finite {finite} {'PASS' if ok else 'FAIL'}")
        torch.cuda.empty_cache()
    rv = full_rows["vol2_final 800x450"]
    results["adjoint_full"] = dict(
        ok=full_ok, err=max(x["err"] for x in full_rows.values()),
        ms=rv["ms"], plain_ms=rv["plain_ms"], bytes=rv["bytes"],
        ops=rv["ops"], library_ms=None, rows=full_rows,
        device_ms=rv["device_ms"])

    # The full K6's gradients against central differences of the K5
    # forward (tests/test_grad.py: the solo-sphere and fuzz-plate setups,
    # their keys, eps and tolerances; the BVH rebuilt at each FD point).
    def solo(mat, lookfrom=(0.0, 0.0, 3.0), spp=4):
        w_ = ptt.HittableList()
        w_.add(ptt.Sphere.stationary((0, 0, 0), 1.0, mat))
        c_ = ptt.Camera()
        c_.aspect_ratio, c_.img_width = 1.5, 16
        c_.lookfrom = np.array(lookfrom, np.float64)
        c_.lookat = np.array([0.0, 0.0, 0.0])
        return w_, c_, RenderConfig(width=16, height=10, samples_per_pixel=spp,
                                    max_depth=4, use_russian_roulette=False), 7

    def plate():
        w_ = ptt.HittableList()
        w_.add(ptt.Quad((-5, -5, -2), (10, 0, 0), (0, 10, 0),
                        ptt.Metal((0.9, 0.9, 0.9), 0.3)))
        c_ = ptt.Camera()
        c_.aspect_ratio, c_.img_width = 1.5, 24
        c_.lookfrom = np.array([0.0, 0.0, 5.0])
        c_.lookat = np.array([0.0, 0.0, 0.0])
        return w_, c_, RenderConfig(width=24, height=16, samples_per_pixel=8,
                                    max_depth=3, use_russian_roulette=False), 5

    vol = lambda: solo(ptt.SubsurfaceVolumetric((0.8, 0.7, 0.6), 2.0, 0.4,  # noqa: E731
                                                g=0.3), spp=2)
    metal0 = lambda: solo(ptt.Metal((0.9, 0.85, 0.8), 0.0),  # noqa: E731
                          lookfrom=(0.0, 0.0, 1.05))
    # (setup, leaf, tied leaves, index, eps, rtol, atol).  Some atol values
    # exceed the gradients checked (1.6e-5 to 2.9e-4 on the card), so both
    # the kernel's value and the difference must also exceed FD_LEAST and
    # agree in sign: a zero gradient fails.
    FD_LEAST = 1e-5
    fd_cases = (
        (plate, "mat_fuzz", (), 0, 1e-3, 0.15, 5e-4),
        (lambda: solo(ptt.Dielectric(1.5)), "mat_ir", (), 0, 2e-3, 0.12,
         5e-5),
        (lambda: solo(ptt.SubsurfaceSimple((0.8, 0.6, 0.5), 0.2)),
         "mat_scatter_dist", (), 0, 1e-3, 0.12, 1e-3),
        (vol, "mat_g", (), 0, 1e-3, 0.25, 2e-3),
        (vol, "mat_sigma_s", (), 0, 1e-3, 0.25, 2e-3),
        (vol, "mat_sigma_a", (), 0, 1e-3, 0.25, 2e-3),
        (metal0, "sph_c0", ("sph_c1",), 2, 1e-3, 0.12, 1e-3),
        (metal0, "sph_rad", (), 0, 1e-3, 0.12, 1e-3),
    )
    fd_ok = True
    fd_rows = []
    for setup, leaf, tied, idx, eps, rtol, atol in fd_cases:
        w_, c_, cf_, seed_ = setup()
        sc_ = ptt.compile_scene(w_, device=dev)
        fl_ = SceneFlags.from_scene(sc_)
        ca_ = c_.initialize(device=dev)
        k_ = rng.key(seed_, device=dev)

        def with_leaf(v):
            return dataclasses.replace(sc_, **{n: v for n in (leaf, *tied)})

        x = getattr(sc_, leaf).clone().requires_grad_()
        kernels.reset_launches()
        img = integrator.render(with_leaf(x), fl_, ptt.build_from_scene(sc_),
                                ca_, cf_, k_, differentiable=True)
        (img.sum() / img.numel()).backward()
        ad = float(x.grad.reshape(-1)[idx])
        full_launches = kernels.LAUNCHES["adjoint_full"]

        def fd_loss(v):
            s2 = with_leaf(v)
            im = integrator.render(s2, fl_, ptt.build_from_scene(s2), ca_, cf_,
                                   k_)
            return float(im.double().sum() / im.numel())

        unit = torch.zeros_like(x).reshape(-1)
        unit[idx] = 1.0
        unit = unit.reshape(x.shape)
        x0 = x.detach()
        fd = (fd_loss(x0 + eps * unit) - fd_loss(x0 - eps * unit)) / (2 * eps)
        ok = (bool(torch.isfinite(x.grad).all()) and full_launches > 0
              and bool(np.isclose(fd, ad, rtol=rtol, atol=atol))
              and min(abs(fd), abs(ad)) > FD_LEAST
              and np.sign(fd) == np.sign(ad))
        fd_ok = fd_ok and ok
        fd_rows.append(dict(leaf=leaf, index=idx, fd=fd, ad=ad, eps=eps,
                            rtol=rtol, atol=atol, ok=ok))
        phase("kernels", f"adjoint_full vs finite differences: {leaf}[{idx}]"
              f"{' (tied ' + ', '.join(tied) + ')' if tied else ''}: K6 "
              f"{ad:.6g}, central FD of K5 (eps {eps:g}) {fd:.6g}, rtol "
              f"{rtol:g} atol {atol:g}, full K6 launches {full_launches} "
              f"{'PASS' if ok else 'FAIL'}")
    results["adjoint_full"]["ok"] = results["adjoint_full"]["ok"] and fd_ok
    results["adjoint_full"]["fd"] = fd_rows

    # --- 4. the main path through the public entry points ---
    rec = {}
    rec["main"] = frame_phase(
        "main", lambda: Renderer(world, cam, engine="wavefront", device=dev),
        W, H, SPP, DEPTH, WAVE_KERNELS, kernels)
    # The device loop: each kernel once a wave and once more (the empty
    # wave whose K1 ends the loop); the loop has no kernel of its own.
    ml = rec["main"]["launches"]
    assert (all(ml[n] == rec["main"]["waves"] + 1 for n in WAVE_KERNELS)
            and ml["wave_loop"] == 0), f"device loop launches {ml}"
    png = os.path.join(RUN_DIR, "vol2_final_800x450_10spp.png")
    rec["main"].pop("r").write_image(png)
    main_img = rec["main"].pop("img")
    phase("main", f"image mean {float(main_img.mean()):.5f}, written to {png}")

    # --- 5. the megakernel on the same frame ---
    rec["main-mega"] = frame_phase(
        "main-mega",
        lambda: Renderer(world, cam, engine="megakernel", device=dev),
        W, H, SPP, DEPTH, ("megakernel",), kernels)
    png = os.path.join(RUN_DIR, "vol2_final_800x450_10spp_mega.png")
    rec["main-mega"].pop("r").write_image(png)
    mega_img = rec["main-mega"].pop("img")
    phase("main-mega", f"image mean {float(mega_img.mean()):.5f}, written to "
          f"{png}")

    # --- 5b. the device wave loop against the per-wave host loop ---
    zero = torch.zeros((H, W, 3), device=dev)
    pool = dict(queue_size=POOL, steps_per_wave=STEPS, ctrl_den=8)

    def kept_frame():
        """One vol2_final frame through the kept loop graph (``render_batch``)
        → (image, stats)."""
        return wf.render_batch(scene, flags, bvh, cam_a, cfg, zero, 0, SPP,
                               key, with_stats=True, **pool)

    def host_frame():
        """A fresh pool → a callable running the same frame on it through
        the host loop of the CUDA kernels (``run_waves``) → (image,
        stats)."""
        e = wf.WaveEngine(scene, flags, bvh, cam_a, cfg, 0, SPP, key, **pool)
        w = e.init_state(zero)

        def run():
            wf.run_waves(e, w)
            return w.accum.reshape(H, W, 3), wf._stats(w, e)
        return run

    def wave_frame(run):
        """One frame through ``run``, the launch counts set to 0 just
        before → (image, stats, wall, launches)."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        img, st = run()
        torch.cuda.synchronize()
        return img, st, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    def profiled_frame(prepare, tag):
        """The frame of ``prepare()`` (untimed) under torch.profiler, its
        kernel runs held against its launch counts → (image, stats,
        launches, device ms by kernel, wall)."""
        (img, st), totals, launches, wall = profile_run(
            prepare, WAVE_KERNELS, kernels, tag)
        return img, st, launches, totals, wall

    def loop_stats(st):
        return {k: int(st[k]) for k in ("paths", "rays", "depth_sum", "waves",
                                        "ctrls", "occ_sum", "trav_steps",
                                        "exec_steps", "walk_steps", "spawned",
                                        "stack_overflows")}

    g_img, g_sts, g_wall, g_launch = wave_frame(kept_frame)
    # the kept loop's engine and drained state, for the empty wave below
    ge, gw = wf._KEPT.eng, wf._KEPT.ws
    h_img, h_sts, _, h_launch = wave_frame(host_frame())
    g_walls = [g_wall, wave_frame(kept_frame)[2]]
    g_st, h_st = loop_stats(g_sts), loop_stats(h_sts)
    g_reads = int(g_sts["host_reads"])
    same_img = torch.equal(g_img, h_img)
    same_ctr = (g_st == h_st
                and torch.equal(g_sts["depth_hist"].cpu(),
                                h_sts["depth_hist"].cpu())
                and torch.equal(g_sts["pixel_paths"], h_sts["pixel_paths"]))
    waves = g_st["waves"]
    host_waves = h_launch["shade"]          # waves the host loop queued
    # The device loop: each kernel waves + 1 (the last wave's K1 finds no
    # work and ends the loop), no kernel of the loop's own; the host loop
    # queues all four every wave.
    launch_ok = (all(g_launch[n] == waves + 1 for n in WAVE_KERNELS)
                 and g_launch["wave_loop"] == 0
                 and g_launch["wave_reset"] == 1
                 and all(h_launch[n] == host_waves for n in WAVE_KERNELS)
                 and h_launch["wave_loop"] == 0 and host_waves >= waves)
    # Profiled, each frame's kernel runs equal its launch counts
    # (profile_run), so the graph's counts are measured, not inferred.
    prof_runs = {n: profiled_frame(f, f"loop {n}")
                 for n, f in (("graph", lambda: kept_frame),
                              ("host", host_frame))}
    prof_ok = (prof_runs["graph"][2] == {n: g_launch[n] for n in WAVE_KERNELS}
               and prof_runs["host"][2] == {n: h_launch[n]
                                            for n in WAVE_KERNELS})
    idle = {n: 1 - sum(r[3].values()) / (1e3 * r[4])
            for n, r in prof_runs.items()}
    loop_img = (g_img / SPP).cpu().numpy()
    l_ok, l_outl, l_clean = graded_agreement(loop_img, mega_img)
    # The adaptive exit's cost: the same frame in the device loop with the
    # exit off (one chunk of 32 steps per wave, JAX's ADAPTIVE_WAVE=False;
    # another loop key, so another capture).
    traverse.ADAPTIVE_WAVE = False
    try:
        off = profiled_frame(lambda: kept_frame, "loop exit off")
        off_walls = [off[4]] + [wave_frame(kept_frame)[2] for _ in range(2)]
    finally:
        traverse.ADAPTIVE_WAVE = True
    off_st = loop_stats(off[1])
    off_img_same = bool(torch.equal(off[0], g_img))
    loop_ok = (same_img and same_ctr and launch_ok and prof_ok
               and g_reads == 1 and l_ok
               and off_st["paths"] == g_st["paths"]
               and off_st["rays"] == g_st["rays"])
    rec["loop"] = dict(
        walls=g_walls, reads=g_reads,
        launches={"graph": g_launch, "host": h_launch}, stats=g_st,
        host_waves=host_waves,
        device_ms={n: r[3] for n, r in prof_runs.items()},
        profiled_wall_ms={n: 1e3 * r[4] for n, r in prof_runs.items()},
        idle_share=idle, outliers=l_outl, clean_mean=l_clean,
        exit_off=dict(stats=off_st, walls=off_walls, device_ms=off[3],
                      profiled_wall_ms=1e3 * off[4],
                      image_equal=off_img_same),
        ok=loop_ok)
    phase("loop", f"vol2_final {W}x{H} {SPP} spp: kept device loop vs host "
          f"loop: image bit-identical {same_img}, counters/histogram/"
          f"per-pixel paths identical {same_ctr} ({g_st}); device loop "
          f"{waves} waves: launches {g_launch} (each kernel waves + 1, the "
          f"loop's own 0), host loop {host_waves} waves queued, one launch "
          f"per kernel per wave: {launch_ok}; profiled frames' kernel runs "
          f"equal to these launches: {prof_ok}")
    phase("loop", "device loop frame walls s: " + ", ".join(
        f"{x:.4f}" for x in g_walls) + f"; host reads {g_reads}; under the "
        f"profiler device ms "
        + "; ".join(f"{n}: " + ", ".join(f"{k}={v:.2f}" for k, v in
                                         r[3].items())
                    + f" of {1e3 * r[4]:.2f} ms (idle {idle[n]:.3f})"
                    for n, r in prof_runs.items()))
    phase("loop", f"exit off (one 32-step chunk per wave): {off_st['waves']} "
          f"waves, exec_steps {off_st['exec_steps']}, trav_steps "
          f"{off_st['trav_steps']}, image bit-identical {off_img_same}; walls "
          + ", ".join(f"{x:.4f}" for x in off_walls) + "; device ms "
          + ", ".join(f"{k}={v:.2f}" for k, v in off[3].items())
          + f" of {1e3 * off[4]:.2f} ms; device loop image vs K5's: "
          f"outliers {l_outl:.5f}, clean mean {l_clean:.2e} -> "
          f"{'PASS' if loop_ok else 'FAIL'}")
    # The plain version of the loop predicate: a host read of the counters
    # and the live test, as the host loop pays per wave.
    t0 = time.perf_counter()
    for _ in range(25):
        ge.live(gw.ctr.cpu())
    live_host_ms = (time.perf_counter() - t0) / 25 * 1e3
    # The loop has no kernel of its own (0 launches; its row passes on the
    # device loop's bit-identity to the host loop).  What it costs on the
    # card is the empty wave that ends it: K1, K3, K4 and K2 launched on
    # the drained frame's state, timed here; the bound is the predicate's
    # (three counters read, one flag written).
    def empty_wave():
        for n_ in wf.WAVE_NAMES:
            kernels.launch(n_, ge, gw)

    results["wave_loop"] = dict(
        ok=loop_ok, err=float((g_img - h_img).abs().max()),
        ms=cuda_ms(empty_wave), device_ms=device_ms(empty_wave),
        plain_ms=live_host_ms, library_ms=None, ops=4, bytes=28,
        no_kernel=True,
        measures="the empty wave that ends the loop: K1, K3, K4 and K2 "
                 "on the drained state")
    del prof_runs, off, ge, gw, g_img, h_img, g_sts, h_sts
    wf.clear_wave_loops()
    torch.cuda.empty_cache()

    # --- 6. mesh_perlin_sss through both engines ---
    for engine, names in (("wavefront", WAVE_KERNELS),
                          ("megakernel", ("megakernel",))):
        tag = f"main-sss {engine}"
        rec[tag] = frame_phase(
            tag, lambda e=engine: Renderer(world_q, cam_q, engine=e, device=dev),
            QW, QH, QSPP, QDEPTH, names, kernels)
        assert rec[tag]["walk_steps"] > 0, "no SSS walk steps"
        rec[tag].pop("r")
        rec[tag].pop("img")

    # --- 9. the tiled engine on the vol2_final frame ---
    def tiled_frame():
        out = ptt.render_tiled(scene, flags, bvh, cam_a, cfg, key, spp=SPP,
                               with_stats=True)
        torch.cuda.synchronize()
        return out

    ptt.render_tiled(scene, flags, bvh, cam_a, cfg, key, spp=1)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    timg, tstats = tiled_frame()
    wall = time.perf_counter() - t0
    tl_frame = dict(kernels.LAUNCHES)
    walls = [wall]
    for _ in range(2):
        t0 = time.perf_counter()
        tiled_frame()
        walls.append(time.perf_counter() - t0)
    # Profiled: the replays' kernel runs equal the counted launches; K8's
    # device ms per trip (each trip's mean over the frame's samples).
    t_seq = {}
    _, totals, prof_launches, prof_wall = profile_run(
        lambda: tiled_frame, TILED_KERNELS, kernels, "tiled", seq=t_seq)
    assert prof_launches == {n: tl_frame[n] for n in TILED_KERNELS}
    k8_trip_ms = [statistics.mean(t_seq["tiled_trip"][t::cfg.iters])
                  for t in range(cfg.iters)]
    # The same frame's K8 work, trip by trip, from the eager loop: live
    # lanes and walk steps of every (sample, trip), and each launch's bound
    # (as phase 3 counts K8's: the larger of bytes and fp32 ops).
    work = trip_work(itl, scene, flags, bvh, cam_a, cfg, key, SPP,
                     C_WALK_STEPS)
    k8_bound = [[bound_trip(shade_bytes, W * H, n_, w_) for n_, w_ in tr]
                for tr in work]
    k8_bound_trip = [statistics.mean(b_) for b_ in k8_bound]
    k8_bound_frame = sum(map(sum, k8_bound))
    phase("tiled", f"K8 per trip (device ms, torch.profiler, mean of the "
          f"frame's {SPP} samples; live lanes of sample 0; bound ms of that "
          f"work): " + "; ".join(
              f"{t + 1}: {k8_trip_ms[t]:.4f} ({work[t][0][0]} live, bound "
              f"{k8_bound_trip[t]:.4f})" for t in range(cfg.iters))
          + f"; per frame {totals['tiled_trip']:.3f} ms against a bound of "
          f"{k8_bound_frame:.3f} ms on the same work")
    # The same frame through the eager loop (render_sample_tiled: every
    # launch queued from the host), which the graph replaces.
    def eager_frame(key_=key, cam_=cam_a, spp_=SPP):
        e_ = itl.TiledEngine(scene, flags, bvh, cam_, cfg, key_)
        c_ = itl.new_counters(dev)
        acc = 0.0
        for s_ in range(spp_):
            acc = acc + itl.render_sample_tiled(scene, flags, bvh, cam_, cfg,
                                                s_, key_, eng=e_, ctr=c_)
        torch.cuda.synchronize()
        return acc / spp_, c_

    def same_as_eager(img_, st_, eimg_, ectr_):
        return (torch.equal(img_, eimg_)
                and int(st_["trav_steps"]) == int(ectr_[C_TRAV_STEPS])
                and int(st_["walk_steps"]) == int(ectr_[C_WALK_STEPS]))

    # The trip graph kept across frames: one capture for two frames, the
    # kept graph's frame bit-identical to the freshly captured one's; then
    # frames of a new key, and of that key from a moved camera, replay the
    # same graph (the key and camera are read from card memory), each
    # bit-identical to the eager loop's frame of that key and view.
    itl.clear_trip_graphs()
    caps0 = itl.CAPTURES
    img_a, st_a = tiled_frame()
    img_b, st_b = tiled_frame()
    captures = itl.CAPTURES - caps0
    cam_m = copy.copy(cam)
    cam_m.lookfrom = np.asarray(cam.lookfrom, float) + np.array([1.0, 0.5, 0.0])
    views = {"new key": (rng.fold_in(key, 7), cam_a),
             "moved camera": (rng.fold_in(key, 7), cam_m.initialize(device=dev))}
    view_same = {}
    for tag_, (k_, c_) in views.items():
        img_v, st_v = ptt.render_tiled(scene, flags, bvh, c_, cfg, k_, spp=2,
                                       with_stats=True)
        view_same[tag_] = same_as_eager(img_v, st_v, *eager_frame(k_, c_, 2))
    captures_views = itl.CAPTURES - caps0
    kept_ok = (captures == 1 and captures_views == 1
               and torch.equal(img_a, img_b)
               and torch.equal(st_a["ctr"], st_b["ctr"])
               and all(view_same.values()))
    phase("tiled", f"trip graph captures over two frames: {captures}; "
          f"second frame (the kept graph) bit-identical "
          f"to the first: {bool(torch.equal(img_a, img_b))}; frames of a new "
          f"key and a moved camera: captures still {captures_views}, each "
          f"bit-identical to the eager loop's: "
          f"{view_same} -> {'PASS' if kept_ok else 'FAIL'}")
    del img_a, img_b, img_v
    idle = 1 - sum(totals.values()) / (1e3 * prof_wall)
    timg_np = timg.detach().cpu().numpy()
    t_ok, t_outl, t_clean = graded_agreement(timg_np, mega_img)

    # Where a graphed frame's host time goes: the capture, then the replays.
    e_ = itl.TiledEngine(scene, flags, bvh, cam_a, cfg, key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tg_ = itl.TripGraph(e_, W * H, itl.new_counters(dev))
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    all_pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for s_ in range(SPP):
        tg_.run(s_, all_pix)
    torch.cuda.synchronize()
    t_replays = time.perf_counter() - t0
    del tg_, e_
    eager_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eimg, ectr = eager_frame()
        eager_walls.append(time.perf_counter() - t0)
    _, e_totals, _, e_prof_wall = profile_run(
        lambda: eager_frame, TILED_KERNELS, kernels, "tiled eager")
    e_idle = 1 - sum(e_totals.values()) / (1e3 * e_prof_wall)
    graph_eager = same_as_eager(timg, tstats, eimg, ectr)
    t_ok = t_ok and graph_eager
    want = {"closest_hit": 2 * cfg.iters * SPP, "tiled_trip": cfg.iters * SPP,
            "tiled_spawn": SPP}
    launch_ok = all(tl_frame[n] == v for n, v in want.items()) and all(
        tl_frame[n] == 0 for n in WAVE_KERNELS + ("megakernel",))
    tiled_ok = (t_ok and launch_ok and kept_ok
                and bool(np.isfinite(timg_np).all())
                and float(timg_np.mean()) > 0)
    rec["tiled"] = dict(wall=wall, walls=walls,
                        mrays_ub=W * H * SPP * DEPTH / wall / 1e6,
                        trav_steps=int(tstats["trav_steps"]),
                        walk_steps=int(tstats["walk_steps"]),
                        launches=tl_frame, kernel_totals_ms=totals,
                        profiled_wall_ms=1e3 * prof_wall, idle_share=idle,
                        outliers=t_outl, clean_mean=t_clean, ok=tiled_ok,
                        eager=dict(walls=eager_walls, kernel_totals_ms=e_totals,
                                   profiled_wall_ms=1e3 * e_prof_wall,
                                   idle_share=e_idle, identical=graph_eager),
                        capture_s=t_capture, replays_s=t_replays,
                        k8_trip_ms=k8_trip_ms, k8_bound_trip_ms=k8_bound_trip,
                        k8_bound_frame_ms=k8_bound_frame,
                        k8_live=[[n_ for n_, _w in tr] for tr in work],
                        k8_walk=[[w_ for _n, w_ in tr] for tr in work],
                        captures_two_frames=captures,
                        captures_new_views=captures_views,
                        new_views_same=view_same)
    phase("tiled", f"render_tiled vol2_final {W}x{H} {SPP} spp depth {DEPTH} "
          f"({cfg.iters} trips): wall {wall:.4f} s, upper-bound "
          f"{rec['tiled']['mrays_ub']:.3f} Mrays/s, traversal steps "
          f"{rec['tiled']['trav_steps']}, launches {tl_frame}; frame walls "
          + ", ".join(f"{w_:.4f}" for w_ in walls)
          + f" (median {statistics.median(walls):.4f}; megakernel "
          f"{statistics.median(rec['main-mega']['walls']):.4f}, wavefront "
          f"{statistics.median(rec['main']['walls']):.4f}); device ms "
          + ", ".join(f"{n}={v:.2f}" for n, v in totals.items())
          + f" of {1e3 * prof_wall:.2f} ms under the profiler (idle "
          f"{idle:.3f}); image vs K5's: outliers {t_outl:.5f}, clean mean "
          f"{t_clean:.2e}, launches as expected {launch_ok} -> "
          f"{'PASS' if tiled_ok else 'FAIL'}")
    phase("tiled", f"graphed frame vs the eager loop: image and counters "
          f"bit-identical {graph_eager}; a graph's capture {t_capture:.4f} s, "
          f"its {SPP} replays {t_replays:.4f} s; eager walls "
          + ", ".join(f"{w_:.4f}" for w_ in eager_walls)
          + f" (median {statistics.median(eager_walls):.4f}); eager device ms "
          + ", ".join(f"{n}={v:.2f}" for n, v in e_totals.items())
          + f" of {1e3 * e_prof_wall:.2f} ms under the profiler (idle "
          f"{e_idle:.3f})")
    # K8's row on the frame's work: its device ms per launch over the frame
    # (the table's device_ms) beside the bound of that work per launch.
    results["tiled_trip"]["frame_bound_ms"] = (k8_bound_frame
                                               / tl_frame["tiled_trip"])
    del timg, tstats, eimg
    torch.cuda.empty_cache()

    # --- 9b. BVH8 rows: the walking kernels at K = 8, K = 4 beside them ---
    bv8 = ptt.build_from_scene(scene, branching=8)
    assert bv8.branching == 8 and bv8.nodes.shape[1] == 184
    node8 = bv8.nodes.numel() * 4
    phase("bvh8", f"vol2_final BVH8 {tuple(bv8.nodes.shape)} rows, "
          f"max_stack {bv8.max_stack} (BVH4 {tuple(bvh.nodes.shape)}, "
          f"max_stack {bvh.max_stack}); node bytes {node8} (BVH4 "
          f"{node_bytes})")
    inst_rows = {}    # kernel-table rows of the instantiations timed here

    # The frame through each engine over the BVH4 and the BVH8: walls,
    # Mrays/s, traversal steps per segment, dropped pushes, device ms per
    # kernel and launches against the profiler's kernel runs.
    def k_frame(engine, bvh_):
        names = {"wavefront": WAVE_KERNELS, "megakernel": ("megakernel",),
                 "tiled": TILED_KERNELS}[engine]
        insts = [f"{n}_k{bvh_.branching}" for n in
                 {"wavefront": ("trace_step",), "megakernel": ("megakernel",),
                  "tiled": ("closest_hit",)}[engine]]

        def run():
            if engine == "tiled":
                return ptt.render_tiled(scene, flags, bvh_, cam_a, cfg, key,
                                        spp=SPP, with_stats=True)
            if engine == "wavefront":
                img_, st_ = wf.render_batch(
                    scene, flags, bvh_, cam_a, cfg, zero, 0, SPP, key,
                    queue_size=32768, steps_per_wave=32, with_stats=True)
            else:
                img_, st_ = integrator.render_batch(
                    scene, flags, bvh_, cam_a, cfg, zero, 0, SPP, key,
                    with_stats=True)
            return img_ / SPP, st_

        run()                                       # warm-up
        walls = []
        for i in range(3):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            img_, st_ = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                img0 = img_
                stats_ = {k_: int(v) for k_, v in st_.items()
                          if torch.is_tensor(v) and v.ndim == 0}
                launches_ = {n: kernels.LAUNCHES[n] for n in names}
                inst_ = {n: kernels.INSTANCES[n] for n in insts}
        _, totals, prof_launches, prof_wall = profile_run(
            lambda: run, names, kernels,
            f"bvh8 {engine} K={bvh_.branching}", insts)
        return dict(img=img0, stats=stats_, walls=walls, launches=launches_,
                    instances=inst_, device_ms=totals,
                    profiled_launches=prof_launches,
                    profiled_wall_ms=1e3 * prof_wall,
                    idle_share=1 - sum(totals.values()) / (1e3 * prof_wall))

    rec8, bvh8_ok = {}, True
    for engine in ("wavefront", "megakernel", "tiled"):
        rec8[engine] = {k_: k_frame(engine, b_) for k_, b_ in ((4, bvh),
                                                               (8, bv8))}
        for k_, r_ in rec8[engine].items():
            st_ = r_["stats"]
            rays = (st_["rays"] if engine != "tiled"  # tiled: K5's samples
                    else rec8["megakernel"][k_]["stats"]["rays"])
            wall_ = statistics.median(r_["walls"])
            r_.update(rays=rays, wall=wall_,
                      mrays_ub=W * H * SPP * DEPTH / wall_ / 1e6,
                      mrays_measured=rays / wall_ / 1e6,
                      steps_per_segment=st_["trav_steps"] / rays)
            ok_ = (st_["stack_overflows"] == 0
                   and r_["launches"] == r_["profiled_launches"]
                   and all(v > 0 for v in r_["instances"].values())
                   and bool(torch.isfinite(r_["img"]).all()))
            bvh8_ok = bvh8_ok and ok_
            phase("bvh8", f"{engine} K={k_} 800x450 {SPP} spp: walls "
                  + ", ".join(f"{w_:.4f}" for w_ in r_["walls"])
                  + f" s (median {wall_:.4f}), upper-bound "
                  f"{r_['mrays_ub']:.3f} Mrays/s, measured "
                  f"{r_['mrays_measured']:.3f} Mrays/s ({rays} segments), "
                  f"trav_steps {st_['trav_steps']} = "
                  f"{r_['steps_per_segment']:.4f} per segment, "
                  f"stack_overflows {st_['stack_overflows']}; device ms "
                  + ", ".join(f"{n}={v:.3f}" for n, v in
                              r_["device_ms"].items())
                  + f" (idle {r_['idle_share']:.3f}); launches "
                  f"{r_['launches']} {r_['instances']} = the profiler's "
                  f"kernel runs -> {'PASS' if ok_ else 'FAIL'}")
        a_, b_ = (rec8[engine][k_].pop("img").cpu().numpy() for k_ in (4, 8))
        g_ok, outl, clean = graded_agreement(b_, a_)
        # One sample set, and every query's t equal at both widths (below):
        # a pixel moves only where a path met an exact tie of two
        # primitives, which the two trees break in another order.  The
        # clean pixels must agree as the graded rule asks.
        c_ok = clean < 1e-5
        bvh8_ok = bvh8_ok and c_ok
        rec8[engine]["k8_vs_k4"] = dict(graded_rule=g_ok, outliers=outl,
                                        clean_mean=clean, ok=c_ok)
        phase("bvh8", f"{engine}: K=8 frame vs K=4 frame (one sample set): "
              f"outliers {outl:.5f} (graded rule {g_ok}), clean mean "
              f"{clean:.2e} -> {'PASS' if c_ok else 'FAIL'}")
        torch.cuda.empty_cache()

    # Only exact ties move a hit: K7 over the BVH4 and over the BVH8 on the
    # same lanes, the camera rays and three more trips of every pixel of
    # the frame: found and t equal on every lane; where the primitive
    # differs, t is the same, so the two trees broke a tie differently.
    teng4 = itl.TiledEngine(scene, flags, bvh, cam_a, cfg, key)
    tst = itl.tiled_spawn(teng4, 0, tpix)
    n_q = n_tie = 0
    tie_ok = True
    for _ in range(4):
        h4 = query(tst, t_min_v, tst.alive)
        h8 = query(tst, t_min_v, tst.alive, bvh_=bv8)
        tie_ok = (tie_ok and torch.equal(h4[0], h8[0])
                  and torch.equal(h4[3], h8[3]))
        n_q += int(tst.alive.sum())
        n_tie += int(((h4[1] != h8[1]) | (h4[2] != h8[2])).sum())
        e4 = query(tst, h4[3] + 1e-4, tst.alive & h4[0])
        tst = itl.tiled_trip(teng4, tst, 0, tpix, h4[:3], e4)
    bvh8_ok = bvh8_ok and tie_ok
    rec8["ties"] = dict(ok=tie_ok, queries=n_q, other_primitive=n_tie)
    phase("bvh8", f"K7 over the BVH4 and the BVH8 on the same {n_q} queries "
          f"(camera rays and 3 trips of every pixel): found and t equal on "
          f"every lane {tie_ok}; {n_tie} queries ({n_tie / n_q:.5f}) took "
          f"another primitive at the same t (exact ties) -> "
          f"{'PASS' if tie_ok else 'FAIL'}")
    del teng4, tst, h4, h8, e4
    torch.cuda.empty_cache()

    # Each engine at K = 8 against its own plain path at 160x90, 2 spp (the
    # tiled engine integrates the megakernel's sample set: its plain path
    # is the megakernel twin).
    sc_8, fl_8, bv_8, ca_8, cf_8 = prepare(
        *ptt.scenes.vol2_final_scene(sphere_cluster=1000), 160, 90, 2, DEPTH,
        branching=8)
    z8 = torch.zeros((90, 160, 3), device=dev)
    small8 = {}
    for plain in (False, True):
        small8[("wavefront", plain)] = wf.render_batch(
            sc_8, fl_8, bv_8, ca_8, cf_8, z8, 0, 2, key, queue_size=32768,
            steps_per_wave=32, with_stats=True, plain=plain)
        small8[("megakernel", plain)] = integrator.render_batch(
            sc_8, fl_8, bv_8, ca_8, cf_8, z8, 0, 2, key, with_stats=True,
            plain=plain)
    small8[("tiled", False)] = ptt.render_tiled(sc_8, fl_8, bv_8, ca_8, cf_8,
                                                key, spp=2, with_stats=True)
    small8[("tiled", False)] = (small8[("tiled", False)][0] * 2,
                                small8[("tiled", False)][1])
    small8[("tiled", True)] = small8[("megakernel", True)]
    for engine in ("wavefront", "megakernel", "tiled"):
        (ik, sk_), (ip, sp_) = small8[(engine, False)], small8[(engine, True)]
        g_ok, outl, clean = graded_agreement(ik.cpu().numpy() / 2,
                                             ip.cpu().numpy() / 2)
        same = [k_ for k_ in ("paths", "rays", "trav_steps", "walk_steps",
                              "stack_overflows")
                if int(sk_[k_]) != int(sp_[k_])]
        if engine == "tiled":      # it counts no paths or rays, and its
            same = [k_ for k_ in same  # walks differ from K5's
                    if k_ == "stack_overflows"]
        ok_ = g_ok and not same
        bvh8_ok = bvh8_ok and ok_
        rec8[f"{engine} 160x90"] = dict(ok=ok_, outliers=outl,
                                        clean_mean=clean, counters_differ=same)
        phase("bvh8", f"{engine} K=8 160x90 2 spp vs its plain path: "
              f"outliers {outl:.5f}, clean mean {clean:.2e}, counters "
              f"that differ {same} -> {'PASS' if ok_ else 'FAIL'}")
    del small8, sc_8, bv_8
    torch.cuda.empty_cache()

    # K1 at K = 8 on a mid-flight pool: lanes, stack and counters exact.
    eng8 = wf.WaveEngine(scene, flags, bv8, cam_a, cfg, 0, SPP, key,
                         queue_size=32768, steps_per_wave=32, ctrl_den=8)
    ws8 = eng8.init_state(torch.zeros((H, W, 3), device=dev))
    for _ in range(48):
        for op in wf.KERNELS:
            op(eng8, ws8)
    torch.cuda.synchronize()
    snap = ws8.clone()
    k_ws, p_ws = snap.clone(), snap.clone()
    kernels.launch("trace_step", eng8, k_ws)
    traverse.trace_step_plain(eng8, p_ws)
    torch.cuda.synchronize()
    exact8 = all(torch.equal(getattr(k_ws, f), getattr(p_ws, f))
                 for f in ("cur", "sp", "best_pt", "best_pi", "best_t",
                           "stack", "ctr"))
    steps8 = int(k_ws.ctr[C_TRAV_STEPS] - snap.ctr[C_TRAV_STEPS])
    work = snap.clone()
    ms1 = cuda_ms(lambda: kernels.launch("trace_step", eng8, work),
                  setup=lambda: restore(work, snap))
    pms1 = cuda_ms(lambda: traverse.trace_step_plain(eng8, work), reps=5,
                   setup=lambda: restore(work, snap))
    walking = snap.occupied & (snap.cur != traverse._DONE)
    n_walk = int(walking.sum())
    n_exit = int((walking & (snap.phase == PH_EXIT)).sum())
    n_done = int((snap.occupied & ~walking).sum())
    stack_entries = int((k_ws.sp - snap.sp)[walking].abs().sum())
    byts = (node8 + n_walk * (32 + 21 + 20) + n_exit * 4 + n_done * 5
            + (eng8.R - n_walk - n_done) + stack_entries * 4)
    inst_rows["trace_step_k8"] = dict(ok=exact8, err=0.0, ms=ms1,
                                      plain_ms=pms1, bytes=byts,
                                      ops=steps8 * STEP_OPS[8],
                                      library_ms=None)
    phase("bvh8", f"trace_step K=8 (chunk {eng8.chunk}): lanes, stack and "
          f"counters exact {exact8}, walking lanes {n_walk}, steps "
          f"{steps8}, {ms1:.4f} ms (twin {pms1:.2f} ms) "
          f"{'PASS' if exact8 else 'FAIL'}")
    del ws8, snap, k_ws, p_ws, work
    torch.cuda.empty_cache()

    # K5 at K = 8: one 800x450 sample against its twin.
    m8 = mega_pair(integrator.MegaEngine(scene, flags, bv8, cam_a, cfg, key),
                   W, H)
    byts = node8 + prim_bytes + W * H * (12 + 4 + 4 + 24)
    ops = (m8["trav_steps"] * STEP_OPS[8] + m8["rays"] * BOUNCE_OPS
           + m8["walk_steps"] * WALK_TRIP_OPS + W * H * (8 * 110 + 60))
    inst_rows["megakernel_k8"] = dict(ok=m8["ok"], err=m8["err"], ms=m8["ms"],
                                      plain_ms=m8["plain_ms"], bytes=byts,
                                      ops=ops, library_ms=None)
    phase("bvh8", mega_line("K=8 vol2_final 800x450", m8)
          + f" (K=4: {m['trav_steps']} steps, {m['ms']:.3f} ms) "
          f"{'PASS' if m8['ok'] else 'FAIL'}")

    # K7 at K = 8 after three trips of the tiled engine, as phase 3.
    steps7_k4, steps9_k4 = steps7, [h['steps'] for h in hops9]
    teng8 = itl.TiledEngine(scene, flags, bv8, cam_a, cfg, key)
    tst = itl.tiled_spawn(teng8, 0, tpix)
    for _ in range(3):
        h_ = query(tst, t_min_v, tst.alive, bvh_=bv8)
        e_ = query(tst, h_[3] + 1e-4, tst.alive & h_[0], bvh_=bv8)
        tst = itl.tiled_trip(teng8, tst, 0, tpix, h_[:3], e_)
    live = tst.alive.clone()
    c_k, c_p = itl.new_counters(dev), itl.new_counters(dev)
    hk = query(tst, t_min_v, live, ctr=c_k, bvh_=bv8)
    hp = query(tst, t_min_v, live, plain=True, ctr=c_p, bvh_=bv8)
    eq7 = all(torch.equal(a_, b_) for a_, b_ in zip(hk, hp))
    ok7 = eq7 and torch.equal(c_k, c_p)
    ms7 = cuda_ms(lambda: query(tst, t_min_v, live, bvh_=bv8))
    pms7 = cuda_ms(lambda: query(tst, t_min_v, live, plain=True, bvh_=bv8),
                   reps=1)
    steps7 = int(c_k[C_TRAV_STEPS])
    inst_rows["closest_hit_k8"] = dict(
        ok=ok7, err=float((hk[3] - hp[3]).abs().max()), ms=ms7,
        plain_ms=pms7, bytes=node8 + NL * 14 + int(live.sum()) * 32,
        ops=steps7 * STEP_OPS[8], library_ms=None)
    phase("bvh8", f"closest_hit K=8: {int(live.sum())} live lanes after 3 "
          f"trips, hits, t and counters exact {ok7}, traversal steps {steps7}"
          f" (K=4: {steps7_k4}), {ms7:.4f} ms (plain {pms7:.1f} ms) "
          f"{'PASS' if ok7 else 'FAIL'}")
    del teng8, tst, hk, hp, live
    torch.cuda.empty_cache()

    # K9 at K = 8: the two hops of the ring over BVH8 shards, as phase 3.
    sc_kt8, bv_kt8 = scene_shard.shard_scene(sc_k, 2, branching=8)
    hops9_8 = ring_hops(bv_kt8, sc_kt8)[0]
    inst_rows["ring_hop_k8"] = hop_row(hops9_8, 8)
    ok9 = inst_rows["ring_hop_k8"]["ok"]
    phase("bvh8", "ring_hop K=8: torus knot sharded 2 ways, hops 0 and 1: "
          + "; ".join(f"hop {i}: found, t and counters exact {h['exact']}, "
                      f"bit-equal to the unbounded hop's "
                      f"{h['same_as_unbounded']}, {h['wins']} hits merged, "
                      f"steps {h['steps']} (K=4: {steps9_k4[i]}), "
                      f"{h['ms']:.4f} ms (plain {h['plain_ms']:.1f} ms)"
                      for i, h in enumerate(hops9_8))
          + f" {'PASS' if ok9 else 'FAIL'}")
    del sc_kt8, bv_kt8
    torch.cuda.empty_cache()

    # K6 at K = 8: the colour and the full instantiation on one 800x450
    # sample against the plain path.
    r8c = adjoint_pair(scene, flags, bv8, cam_a, cfg, (0,), 3)
    r8c.pop("g")
    r8f = adjoint_pair(scene, flags, bv8, cam_a, cfg, (0,), 3, full=True)
    r8f.pop("g")
    for inst, r_ in (("adjoint_k8", r8c), ("adjoint_full_k8", r8f)):
        ok_ = r_["rel"] <= 1e-3 and r_["ctr_clean"]
        inst_rows[inst] = dict(ok=ok_, err=r_["err"], ms=r_["ms"],
                               plain_ms=r_["plain_ms"], bytes=r_["bytes"],
                               ops=r_["ops"], library_ms=None,
                               device_ms=r_["device_ms"])
        phase("bvh8", f"{inst}: vol2_final 800x450 one sample, K6 vs plain "
              f"rel L2 {r_['rel']:.2e}, {r_['ms']:.3f} ms (bound "
              f"{bound_ms(r_['bytes'], r_['ops']):.5f} ms; traversal steps "
              f"{r_['trav_steps']}), K5 on the same sample {r_['k5_ms']:.3f} "
              f"ms, plain {r_['plain_ms']:.1f} ms {'PASS' if ok_ else 'FAIL'}")


    # --- the P0 probe: gather_rows at P0's shape and the node-row widths ---
    kernels.reset_launches()
    probe = []
    for label, tab_, idx_ in (
            ("P0 random", gtab, gidx),
            ("P0 sorted", gtab, torch.sort(gidx).values.contiguous()),
            *((f"width {w_}", torch.randn((4096, w_), device=dev,
                                          generator=g0),
               torch.randint(0, 4096, (16384,), device=dev, generator=g0,
                             dtype=torch.int32)) for w_ in (80, 96, 184)),
            ("vol2_final K1 rows", *k1_rows),
            ("P0 out of range", gtab, torch.where(
                torch.arange(16384, device=dev) % 3 == 0,
                gidx * 7 - 1800, gidx).to(torch.int32).contiguous())):
        out_ = gather.gather_rows(tab_, idx_)
        probe.append((label, tuple(tab_.shape), bool(torch.equal(
            out_, torch.index_select(tab_, 0, idx_.clamp(
                0, tab_.shape[0] - 1))))))
    gather_launches = kernels.LAUNCHES["gather_rows"]
    probe_ok = all(p_[2] for p_ in probe) and gather_launches == len(probe)
    results["gather_rows"]["ok"] = results["gather_rows"]["ok"] and probe_ok
    phase("gather", f"P0 probe: {probe}, {gather_launches} launches -> "
          f"{'PASS' if probe_ok else 'FAIL'} (times: "
          f"path_tracer_tpu_torch/scripts/bench_gather.py)")

    # --- 7. whole-image agreement, kernels vs twins on the card ---
    ws_, hs_ = 160, 90
    zero_s = torch.zeros((hs_, ws_, 3), device=dev)

    def small(name, **kw):
        world_s, cam_s = getattr(ptt.scenes, name)(**kw)
        cam_s.aspect_ratio, cam_s.img_width = ws_ / hs_, ws_
        sc_s = ptt.compile_scene(world_s, device=dev)
        return (sc_s, SceneFlags.from_scene(sc_s), ptt.build_from_scene(sc_s),
                cam_s.initialize(device=dev))

    def wave_counts(sts):
        c = {k: int(sts[k]) for k in ("paths", "spawned", "rays", "walk_steps",
                                      "stack_overflows")}
        c["depth_hist"] = sts["depth_hist"].tolist()
        c["pixel_paths_all_2"] = bool((sts["pixel_paths"] == 2).all())
        return c

    def mega_counts(sts):
        c = {k: int(sts[k]) for k in ("paths", "rays", "depth_sum",
                                      "walk_steps", "trav_steps",
                                      "stack_overflows")}
        c["depth_hist"] = sts["depth_hist"].tolist()
        return c

    agree = True
    for name, kw, depth in (("vol2_final_scene", {"sphere_cluster": 1000}, DEPTH),
                            ("mesh_perlin_sss", {}, QDEPTH)):
        sc_s, fl_s, bv_s, ca_s = small(name, **kw)
        cf_s = RenderConfig(width=ws_, height=hs_, samples_per_pixel=2,
                            max_depth=depth)
        imgs, counts = {}, {}
        for plain in (False, True):
            imgs[plain], sts = wf.render_batch(
                sc_s, fl_s, bv_s, ca_s, cf_s, zero_s, 0, 2, key,
                queue_size=32768, steps_per_wave=32, with_stats=True,
                plain=plain)
            counts[plain] = wave_counts(sts)
            phase("agree", f"{name} wavefront {'twin' if plain else 'kernels'}: "
                  f"{counts[plain]}")
        img_ok, outl, clean = graded_agreement(imgs[False].cpu().numpy(),
                                               imgs[True].cpu().numpy())
        # The (sample, pixel) set is fixed by the RNG folds and both sides
        # round alike (--fmad=false), so the counters must match exactly.
        counters_ok = (counts[False] == counts[True]
                       and counts[False]["paths"] == ws_ * hs_ * 2
                       and counts[False]["pixel_paths_all_2"]
                       and counts[False]["stack_overflows"] == 0)
        ok_w = img_ok and counters_ok
        phase("agree", f"{name} wavefront 160x90 2 spp: paths/spawned/rays/"
              f"walk/depth_hist equal, per-pixel paths == 2 and no stack "
              f"overflow: {counters_ok}; outlier fraction {outl:.5f}, "
              f"clean-pixel mean diff {clean:.2e} -> {'PASS' if ok_w else 'FAIL'}")
        megs, mcounts = {}, {}
        for plain in (False, True):
            megs[plain], sts = integrator.render_batch(
                sc_s, fl_s, bv_s, ca_s, cf_s, zero_s, 0, 2, key,
                with_stats=True, plain=plain)
            mcounts[plain] = mega_counts(sts)
            phase("agree", f"{name} megakernel {'twin' if plain else 'K5'}: "
                  f"{mcounts[plain]}")
        m_ok, m_outl, m_clean = graded_agreement(megs[False].cpu().numpy(),
                                                 megs[True].cpu().numpy())
        m_ok = (m_ok and mcounts[False] == mcounts[True]
                and mcounts[False]["paths"] == ws_ * hs_ * 2
                and mcounts[False]["stack_overflows"] == 0)
        e_ok, e_outl, e_clean = graded_agreement(
            megs[False].cpu().numpy() / 2, imgs[False].cpu().numpy() / 2)
        e_ok = e_ok and mcounts[False]["rays"] == counts[False]["rays"]
        phase("agree", f"{name} megakernel 160x90 2 spp: K5 vs twin counters "
              f"equal, outliers {m_outl:.5f}, clean mean {m_clean:.2e} -> "
              f"{'PASS' if m_ok else 'FAIL'}; K5 image vs K1-K4 image "
              f"(engine oracle) outliers {e_outl:.5f}, clean mean "
              f"{e_clean:.2e}, rays equal -> {'PASS' if e_ok else 'FAIL'}")
        agree = agree and ok_w and m_ok and e_ok

    # --- 8. the train step at full size ---
    def timed(fn, bucket):
        """``fn`` with its CUDA-event time appended to ``bucket``."""
        def wrapped(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            bucket.append((e0, e1))
            return out
        return wrapped

    def train_phase(tag, world_, cam_, w, h, spp, depth, inits, lr,
                    engine="wavefront", branching=4):
        """Three make_train_step steps after a warm-up on the leaves of
        ``inits`` ({leaf: its start from the truth}) over a BVH of
        ``branching``-wide nodes; the launch counts are set to 0 just
        before the three and read just after (``launches`` also holds the
        walking kernels' instantiations).  The forward time is the engine's
        renders (``render_batch`` or ``render_tiled``)."""
        sc_, fl_, bv_, ca_, cf_ = prepare(world_, cam_, w, h, spp, depth,
                                          branching)
        zero_ = torch.zeros((h, w, 3), device=dev)
        target = wf.render_batch(sc_, fl_, bv_, ca_, cf_, zero_, 0, 32,
                                 rng.key(10_000, device=dev),
                                 queue_size=32768, steps_per_wave=32) / 32
        params = {n: f(getattr(sc_, n)) for n, f in inits.items()}
        n_waves = calibrate_n_waves(dataclasses.replace(sc_, **params), fl_,
                                    bv_, ca_, cf_, key, spp=spp,
                                    queue_size=32768, steps_per_wave=32)
        step = make_train_step(fl_, cf_, None, spp=spp, lr=lr, engine=engine,
                               queue_size=32768, steps_per_wave=32,
                               n_waves=n_waves, unbiased=True)
        step(params, sc_, bv_, ca_, rng.fold_in(key, 99), target)  # warm-up
        fwd, bwd = [], []
        fmod, fname = ((wf, "render_batch") if engine == "wavefront"
                       else (itl, "render_tiled"))
        real_rb, real_vjp = getattr(fmod, fname), adjoint.kernel_vjp
        setattr(fmod, fname, timed(real_rb, fwd))
        adjoint.kernel_vjp = timed(real_vjp, bwd)
        rows = []
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            for i in range(3):
                fwd.clear()
                bwd.clear()
                t0 = time.perf_counter()
                params, loss, grads, aux = step(params, sc_, bv_, ca_,
                                                rng.fold_in(key, i), target)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                f_ms = sum(a.elapsed_time(b) for a, b in fwd)
                b_ms = sum(a.elapsed_time(b) for a, b in bwd)
                rows.append(dict(loss=float(loss), fwd_ms=f_ms, bwd_ms=b_ms,
                                 wall_s=wall, renders=len(fwd),
                                 paths_done=aux["paths_done"],
                                 paths_total=aux["paths_total"],
                                 grad_finite=all(bool(torch.isfinite(g).all())
                                                 for g in grads.values()),
                                 grads=grads))
            launches_ = dict(kernels.LAUNCHES, **kernels.INSTANCES)
        finally:
            setattr(fmod, fname, real_rb)
            adjoint.kernel_vjp = real_vjp
        for i, r in enumerate(rows):
            phase(tag, f"step {i}: loss {r['loss']:.6g}, forward "
                  f"{r['fwd_ms']:.2f} ms ({r['renders']} renders), backward "
                  f"(K6) {r['bwd_ms']:.2f} ms, step wall {r['wall_s']:.4f} s, "
                  f"paths {r['paths_done']}/{r['paths_total']}, grad finite "
                  f"{r['grad_finite']}")
        phase(tag, f"launches over 3 steps: {launches_}")
        return sc_, fl_, bv_, ca_, cf_, rows, launches_

    train_rec = {}
    train_ok = True
    world_c, cam_c = ptt.scenes.cornell_box()

    def perturb_rows(c1):
        c1 = c1.clone()
        c1[1] = torch.tensor([0.4, 0.4, 0.4], device=dev)   # red wall
        c1[2] = 0.5 * c1[2]                                 # light x0.5
        return c1

    sc_c, fl_c, bv_c, ca_c, cf_c, rows, tl = train_phase(
        "train", world_c, cam_c, 800, 800, 4, 6, {"tex_c1": perturb_rows},
        0.08)
    for r in rows:
        g = r.pop("grads")["tex_c1"]
        r["grad_rows_nonzero"] = bool((g[1].abs() > 0).all()
                                      and (g[2].abs() > 0).all())
        ok = (r["paths_done"] == r["paths_total"] == 2 * 800 * 800 * 4
              and r["grad_finite"] and r["grad_rows_nonzero"])
        train_ok = train_ok and ok
    k6_per_step = tl["adjoint"] / 3
    train_ok = train_ok and tl["adjoint"] == 3 * 4 and all(
        tl[n] > 0 for n in WAVE_KERNELS)
    phase("train", f"cornell_box 800x800: paths_done == paths_total, finite "
          f"gradients non-zero on rows 1 and 2, K6 launches per step "
          f"{k6_per_step:g} (4 expected) -> {'PASS' if train_ok else 'FAIL'}")
    train_rec["cornell_box"] = dict(rows=rows, launches=tl)

    world_t, cam_t = ptt.scenes.texture_demo()
    sc_t, _, _, _, _, rows_t, tl_t = train_phase(
        "train-texture", world_t, cam_t, 800, 800, 8, 5,
        {"img_data": lambda x: torch.full_like(x, 0.5)}, 0.02)
    ok_t = tl_t["adjoint"] == 3 * 8
    for r in rows_t:
        g = r.pop("grads")["img_data"]
        r["texels_nonzero"] = float((g.abs().sum(-1) > 0).float().mean())
        ok_t = ok_t and (r["paths_done"] == r["paths_total"]
                         == 2 * 800 * 800 * 8 and r["grad_finite"]
                         and r["texels_nonzero"] > 0.5)
    phase("train-texture", f"texture_demo 800x800 img_data "
          f"{tuple(sc_t.img_data.shape)}: texels with a gradient "
          f"{[r['texels_nonzero'] for r in rows_t]}, K6 launches per step "
          f"{tl_t['adjoint'] / 3:g} -> {'PASS' if ok_t else 'FAIL'}")
    train_ok = train_ok and ok_t
    train_rec["texture_demo"] = dict(rows=rows_t, launches=tl_t)

    # The train step on leaves that move rays: the full K6.  Each leaf starts
    # perturbed from the truth at the rows named (the target is 32 spp at the
    # truth).  One lr serves leaves of very different scales (the fog's
    # density is 1e-4, a sphere centre hundreds of units): it is set so that
    # three steps stay near the start, where n_waves was calibrated (at
    # lr 1e-6 one step thickened vol2_final's fog until a render took 356
    # waves against a budget of 266).
    def rows_of(mask):
        return torch.from_numpy(np.nonzero(mask.cpu().numpy())[0]).to(dev)

    def set_rows(idx, value):
        def init(x):
            x = x.clone()
            x[idx] = value
            return x
        return init

    def shift_rows(idx, by):
        def init(x):
            x = x.clone()
            x[idx] += torch.tensor(by, device=dev)
            return x
        return init

    mt_v = scene.mat_type
    moving = rows_of((scene.sph_c0 != scene.sph_c1).any(-1))
    perturbed_v = {
        "mat_fuzz": rows_of(mt_v == MAT_METAL),
        "mat_ir": rows_of(mt_v == MAT_DIELECTRIC),
        "med_density": rows_of(scene.med_density > 0),
        "tex_scale": rows_of(scene.tex_type == TEX_NOISE),
        "sph_c0": moving, "sph_c1": moving}
    inits_v = {
        "mat_fuzz": set_rows(perturbed_v["mat_fuzz"], 0.7),
        "mat_ir": set_rows(perturbed_v["mat_ir"], 1.3),
        "med_density": lambda x: x * 1.5,
        "tex_scale": set_rows(perturbed_v["tex_scale"], 0.25),
        "sph_c0": shift_rows(moving, (5.0, 0.0, 0.0)),
        "sph_c1": shift_rows(moving, (5.0, 0.0, 0.0))}
    mt_q = sc_q.mat_type
    wax = rows_of(mt_q == MAT_SSS_VOLUMETRIC)
    perturbed_q = {
        "mat_g": wax, "mat_sigma_s": wax, "mat_sigma_a": wax,
        "mat_scatter_dist": rows_of(mt_q == MAT_SSS_SIMPLE),
        "tr_v0": rows_of(sc_q.tr_valid),
        "perlin_vec": torch.arange(256, device=dev)}
    inits_q = {
        "mat_g": set_rows(wax, 0.5), "mat_sigma_s": set_rows(wax, 0.12),
        "mat_sigma_a": set_rows(wax, 0.6),
        "mat_scatter_dist": set_rows(perturbed_q["mat_scatter_dist"], 0.3),
        "tr_v0": shift_rows(perturbed_q["tr_v0"], (0.0, 0.02, 0.0)),
        "perlin_vec": lambda x: x * 1.1}
    grads0 = {}
    for tag, label, world_, cam_, w, h, depth, inits, perturbed, lr in (
            ("train-vol2", "vol2_final",
             *ptt.scenes.vol2_final_scene(sphere_cluster=1000), W, H, DEPTH,
             inits_v, perturbed_v, 1e-9),
            ("train-sss", "mesh_perlin_sss", *ptt.scenes.mesh_perlin_sss(),
             QW, QH, QDEPTH, inits_q, perturbed_q, 1e-7)):
        _, _, _, _, _, rows_f, tl_f = train_phase(
            tag, world_, cam_, w, h, 4, depth, inits, lr)
        ok_f = tl_f["adjoint_full"] == 3 * 4 and tl_f["adjoint"] == 0
        grads0[label] = rows_f[0]["grads"]
        for r in rows_f:
            grads = r.pop("grads")
            r["zero_leaves"] = [n for n, idx in perturbed.items()
                                if float(grads[n][idx].abs().sum()) == 0]
            ok_f = ok_f and (r["paths_done"] == r["paths_total"]
                             == 2 * w * h * 4 and r["grad_finite"]
                             and not r["zero_leaves"]
                             and np.isfinite(r["loss"]) and r["loss"] > 0)
        phase(tag, f"{label} {w}x{h} 4 spp depth {depth}, leaves "
              f"{list(inits)}: leaves with a zero gradient at their perturbed "
              f"rows {[r['zero_leaves'] for r in rows_f]}, full K6 launches "
              f"per step {tl_f['adjoint_full'] / 3:g}, backward/forward "
              f"{[round(r['bwd_ms'] / r['fwd_ms'], 3) for r in rows_f]} -> "
              f"{'PASS' if ok_f else 'FAIL'}")
        train_ok = train_ok and ok_f
        train_rec[label] = dict(rows=rows_f, launches=tl_f)
        torch.cuda.empty_cache()

    # The vol2_final step on the tiled engine (engine="megakernel", as JAX
    # runs it): K7 + K8 forward, the full K6 backward; its first step's
    # gradients against the wavefront step's (same parameters, key and
    # sample set).  Its eight renders (two a step, each of its own key, and
    # new leaf values every step) replay one kept trip graph: one capture.
    caps_tt = itl.CAPTURES
    _, _, _, _, _, rows_tt, tl_tt = train_phase(
        "train-tiled", *ptt.scenes.vol2_final_scene(sphere_cluster=1000), W,
        H, TRAIN_SPP, DEPTH, inits_v, TRAIN_LR, engine="megakernel")
    caps_tt = itl.CAPTURES - caps_tt
    g_t, g_w = rows_tt[0]["grads"], grads0["vol2_final"]
    rel_tt = {n: float((g_t[n] - g_w[n]).norm() / g_w[n].norm().clamp(
        min=1e-30)) for n in g_w}
    ok_tt = (all(v <= 1e-3 for v in rel_tt.values())
             and tl_tt["adjoint_full"] == 3 * TRAIN_SPP
             and all(tl_tt[n] > 0 for n in TILED_KERNELS)
             and all(tl_tt[n] == 0 for n in WAVE_KERNELS)
             and caps_tt == 1
             and all(r["grad_finite"] and np.isfinite(r["loss"])
                     for r in rows_tt))
    for r in rows_tt:
        r.pop("grads")
    phase("train-tiled", f"vol2_final {W}x{H} {TRAIN_SPP} spp, step 0 "
          f"gradients vs the wavefront step's, rel L2 per leaf "
          + ", ".join(f"{n} {v:.2e}" for n, v in rel_tt.items())
          + f"; full K6 launches per step {tl_tt['adjoint_full'] / 3:g}, "
          f"backward/forward {[round(r['bwd_ms'] / r['fwd_ms'], 3) for r in rows_tt]}"
          f"; trip graph captures over the warm-up and 3 steps {caps_tt}"
          f" -> {'PASS' if ok_tt else 'FAIL'}")
    train_ok = train_ok and ok_tt
    train_rec["tiled vol2_final"] = dict(rows=rows_tt, launches=tl_tt,
                                         grad_rel=rel_tt, captures=caps_tt)
    torch.cuda.empty_cache()

    # K6 on one 800x800 cornell_box sample against its plain version
    r6 = adjoint_pair(sc_c, fl_c, bv_c, ca_c, cf_c, (0,), 2)
    r6.pop("g")
    ok6 = r6["rel"] <= 1e-3 and r6["ctr_clean"] and adj_ok
    results["adjoint"] = dict(ok=ok6, err=r6["err"], ms=r6["ms"],
                              plain_ms=r6["plain_ms"], bytes=r6["bytes"],
                              ops=r6["ops"], library_ms=None,
                              device_ms=r6["device_ms"],
                              small=adj_rows, full=r6)
    phase("kernels", f"adjoint: cornell_box 800x800 one sample: K6 vs plain "
          f"rel L2 {r6['rel']:.2e} max abs {r6['err']:.2e}, {r6['ms']:.3f} ms "
          f"(bound {bound_ms(r6['bytes'], r6['ops']):.5f} ms, bytes "
          f"{r6['bytes']}, fp32 ops {r6['ops']}; rays {r6['rays']}, traversal "
          f"steps {r6['trav_steps']}), K5 on the same sample "
          f"{r6['k5_ms']:.3f} ms, plain {r6['plain_ms']:.1f} ms "
          f"{'PASS' if ok6 else 'FAIL'}")

    # --- 9b (continued). The train step at K = 8: vol2_final 4 spp on the
    # colour leaf (the colour K6) and on the leaves that move rays (the full
    # K6).  Step 0's gradients beside the BVH4 step's (one sample set; the
    # paths that meet an exact tie differ, so this is reported, not held:
    # K6 at K = 8 is held against its plain version above).
    _, _, _, _, _, rows8c, tl8c = train_phase(
        "bvh8-train-colour", *ptt.scenes.vol2_final_scene(sphere_cluster=1000),
        W, H, TRAIN_SPP, DEPTH, {"tex_c1": lambda x: 0.9 * x}, 1e-3,
        branching=8)
    _, _, _, _, _, rows8f, tl8f = train_phase(
        "bvh8-train", *ptt.scenes.vol2_final_scene(sphere_cluster=1000), W, H,
        TRAIN_SPP, DEPTH, inits_v, TRAIN_LR, branching=8)
    g8 = rows8f[0]["grads"]
    rel8 = {n: float((g8[n] - g_w[n]).norm() / g_w[n].norm().clamp(min=1e-30))
            for n in g_w}
    train8_ok = (tl8c.get("adjoint_k8", 0) == 3 * TRAIN_SPP
                 and tl8f.get("adjoint_full_k8", 0) == 3 * TRAIN_SPP
                 and tl8f.get("trace_step_k8", 0) > 0
                 and all(r_["paths_done"] == r_["paths_total"]
                         and r_["grad_finite"] and np.isfinite(r_["loss"])
                         for r_ in rows8c + rows8f))
    for r_ in rows8c + rows8f:
        r_.pop("grads")
    bvh8_ok = bvh8_ok and train8_ok
    rec8["train"] = dict(colour=dict(rows=rows8c, launches=tl8c),
                         full=dict(rows=rows8f, launches=tl8f), grad_rel=rel8)
    phase("bvh8-train", f"vol2_final {W}x{H} {TRAIN_SPP} spp K=8: paths done, "
          f"finite gradients; step 0 gradients vs the BVH4 step's, rel L2 "
          f"per leaf "
          + ", ".join(f"{n} {v:.2e}" for n, v in rel8.items())
          + f"; K6 launches per step colour "
          f"{tl8c.get('adjoint_k8', 0) / 3:g}, full "
          f"{tl8f.get('adjoint_full_k8', 0) / 3:g} -> "
          f"{'PASS' if train8_ok else 'FAIL'}")
    torch.cuda.empty_cache()

    # --- 9c. the per-thread arrays beyond their local sizes ---
    # K5, K7, K9 and K6 with a 70-entry stack (max_stack and stack_depth
    # raised; the walk needs no more than the tree's depth), at K = 4 and
    # K = 8: K5, K7 and K9 bit-equal to the local stack; K6 (float atomics
    # add in another order every run) against the plain path at K = 4 and
    # against its local instantiation at K = 8.  Then a Cornell train step
    # at max_depth 60 (68 trips: the tape in the per-pixel buffer).
    DEEP = 70
    stack_ok = True
    deep_ms = {}
    for k_, bv_w in ((4, bvh), (8, bv8)):
        bv_d = dataclasses.replace(bv_w, max_stack=DEEP)
        cfg_d = dataclasses.replace(cfg, stack_depth=DEEP)
        # K5: one 800x450 sample
        meng_l = integrator.MegaEngine(scene, flags, bv_w, cam_a, cfg, key)
        meng_d = integrator.MegaEngine(scene, flags, bv_d, cam_a, cfg_d, key)
        ml, md = meng_l.init_state(zero), meng_d.init_state(zero)
        kernels.reset_launches()
        a_l, a_d = (integrator.mega_args(meng_l, ml),
                    integrator.mega_args(meng_d, md))
        integrator.megakernel(meng_l, ml, 0, a_l)
        integrator.megakernel(meng_d, md, 0, a_d)
        torch.cuda.synchronize()
        inst = f"megakernel_k{k_}_global"
        n_ = kernels.INSTANCES[inst]
        eq = (meng_d.sd == DEEP and n_ == 1 and all(
            torch.equal(getattr(ml, f), getattr(md, f))
            for f in ("color", "iters", "depth", "accum", "depth_hist",
                      "ctr")))
        ms_d = cuda_ms(lambda: integrator.megakernel(meng_d, md, 0, a_d))
        ms_l = cuda_ms(lambda: integrator.megakernel(meng_l, ml, 0, a_l))
        dev_d = device_ms(lambda: integrator.megakernel(meng_d, md, 0, a_d))
        base = results["megakernel"] if k_ == 4 else inst_rows["megakernel_k8"]
        inst_rows[inst] = dict(ok=eq, err=0.0, ms=ms_d, device_ms=dev_d,
                               plain_ms=base["plain_ms"], bytes=base["bytes"],
                               ops=base["ops"], library_ms=None, launches=n_)
        deep_ms[inst] = dict(ms=ms_d, local_ms=ms_l)
        phase("stack", f"{inst}: one 800x450 sample bit-equal to the local "
              f"stack's {eq}, {ms_d:.3f} ms (local {ms_l:.3f} ms) "
              f"{'PASS' if eq else 'FAIL'}")
        stack_ok = stack_ok and eq
        del meng_l, meng_d, ml, md
        # K7: the camera rays of the frame
        teng_l = itl.TiledEngine(scene, flags, bv_w, cam_a, cfg, key)
        stl = itl.tiled_spawn(teng_l, 0, tpix)
        qa = (stl.origin, stl.direction, stl.time, t_min_v, cfg.t_max)
        c_l, c_d = itl.new_counters(dev), itl.new_counters(dev)
        kernels.reset_launches()
        h_l = itl.closest_hit_batched(bv_w, *qa, cfg.stack_depth,
                                      active=stl.alive, ctr=c_l)
        h_d = itl.closest_hit_batched(bv_d, *qa, DEEP, active=stl.alive,
                                      ctr=c_d)
        torch.cuda.synchronize()
        inst = f"closest_hit_k{k_}_global"
        n_ = kernels.INSTANCES[inst]
        eq = (n_ == 1 and torch.equal(c_l, c_d)
              and all(torch.equal(x_, y_) for x_, y_ in zip(h_l, h_d)))
        ms_d = cuda_ms(lambda: itl.closest_hit_batched(
            bv_d, *qa, DEEP, active=stl.alive))
        ms_l = cuda_ms(lambda: itl.closest_hit_batched(
            bv_w, *qa, cfg.stack_depth, active=stl.alive))
        pms_d = cuda_ms(lambda: itl.closest_hit_plain(
            bv_d, *qa, DEEP, active=stl.alive), reps=1)
        dev_d = device_ms(lambda: itl.closest_hit_batched(
            bv_d, *qa, DEEP, active=stl.alive))
        inst_rows[inst] = dict(
            ok=eq, err=0.0, ms=ms_d, plain_ms=pms_d, launches=n_,
            device_ms=dev_d,
            bytes=bv_w.nodes.numel() * 4 + NL * 14 + int(stl.alive.sum()) * 32,
            ops=int(c_d[C_TRAV_STEPS]) * STEP_OPS[k_], library_ms=None)
        deep_ms[inst] = dict(ms=ms_d, local_ms=ms_l)
        phase("stack", f"{inst}: the camera rays of the frame, hits and "
              f"counters bit-equal to the local stack's {eq}, {ms_d:.4f} ms "
              f"(local {ms_l:.4f} ms) {'PASS' if eq else 'FAIL'}")
        stack_ok = stack_ok and eq
        del teng_l, stl, h_l, h_d
        # K9: hop 0 on shard 0 of the torus knot sharded two ways
        sc_s, bv_s = scene_shard.local_shard(
            *scene_shard.shard_scene(sc_k, 2, branching=k_), 0)
        outs = []
        kernels.reset_launches()
        for bv_q, sd_q in ((bv_s, cf_k.stack_depth),
                           (dataclasses.replace(bv_s, max_stack=DEEP), DEEP)):
            keng_q = itl.TiledEngine(
                sc_s, fl_k, bv_q, ca_k,
                dataclasses.replace(cf_k, stack_depth=sd_q), key)
            kst_q = itl.tiled_spawn(keng_q, 0, kpix)
            ray_q = (kst_q.origin, kst_q.direction, kst_q.time, kt_min,
                     kst_q.alive)
            carry_q = tuple(x.clone() for x in carry0)
            c_q = itl.new_counters(dev)
            pipeline.ring_hop(keng_q, *ray_q, *carry_q, ctr=c_q)
            n_ = kernels.INSTANCES[f"ring_hop_k{k_}_global"]
            work_q = tuple(x.clone() for x in carry0)
            outs.append((carry_q, c_q, cuda_ms(
                lambda: pipeline.ring_hop(keng_q, *ray_q, *work_q),
                setup=lambda: restore_state(work_q, carry0))))
        dev_d = device_ms(lambda: pipeline.ring_hop(keng_q, *ray_q, *work_q),
                          setup=lambda: restore_state(work_q, carry0))
        inst = f"ring_hop_k{k_}_global"
        eq = (n_ == 1 and torch.equal(outs[0][1], outs[1][1])
              and all(torch.equal(x_, y_)
                      for x_, y_ in zip(outs[0][0], outs[1][0])))
        base = results["ring_hop"] if k_ == 4 else inst_rows["ring_hop_k8"]
        inst_rows[inst] = dict(ok=eq, err=0.0, ms=outs[1][2], device_ms=dev_d,
                               plain_ms=base["plain_ms"],
                               bytes=base["hop_bytes"][0],
                               ops=base["hop_ops"][0], library_ms=None,
                               launches=n_)
        deep_ms[inst] = dict(ms=outs[1][2], local_ms=outs[0][2])
        phase("stack", f"{inst}: torus knot shard 0, found, t, record and "
              f"counters bit-equal to the local stack's {eq}, "
              f"{outs[1][2]:.4f} ms (local {outs[0][2]:.4f} ms) "
              f"{'PASS' if eq else 'FAIL'}")
        stack_ok = stack_ok and eq
        del outs
        torch.cuda.empty_cache()
        # K6 with stack, tape and walk record in the per-pixel buffers,
        # against its local instantiation (held against the plain path in
        # phases 3 and 9b; float atomics add in another order every run):
        # the full one at K = 4 (the colour one's buffers run in the Cornell
        # step below), both at K = 8.
        delta6 = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (W * H, 3)).astype(np.float32)).to(dev)
        for full in ((True,) if k_ == 4 else (False, True)):
            inst = f"adjoint{'_full' if full else ''}_k{k_}_global"
            gs = []
            kernels.reset_launches()
            for bv_q, cf_q in ((bv_w, cfg), (bv_d, cfg_d)):
                eng_q = integrator.MegaEngine(scene, flags, bv_q, cam_a, cf_q,
                                              key)
                ms_q = eng_q.init_state(zero)
                g_q = adjoint.grad_buffers(scene)
                adjoint.adjoint(eng_q, ms_q, 0, delta6, g_q, full)
                n_ = kernels.INSTANCES[inst]
                scratch = adjoint.grad_buffers(scene)
                gs.append((torch.cat([x.flatten() for x in g_q]), cuda_ms(
                    lambda: adjoint.adjoint(eng_q, ms_q, 0, delta6, scratch,
                                            full), reps=5)))
            dev_d = device_ms(lambda: adjoint.adjoint(eng_q, ms_q, 0, delta6,
                                                      scratch, full))
            rel = float((gs[1][0] - gs[0][0]).norm()
                        / gs[0][0].norm().clamp(min=1e-30))
            ok_ = rel <= 1e-5 and n_ == 1
            base = (results["adjoint_full"] if k_ == 4 else
                    inst_rows["adjoint_full_k8" if full else "adjoint_k8"])
            inst_rows[inst] = dict(ok=ok_, err=float(
                (gs[1][0] - gs[0][0]).abs().max()), ms=gs[1][1],
                device_ms=dev_d,
                plain_ms=base["plain_ms"], bytes=base["bytes"],
                ops=base["ops"], library_ms=None, launches=n_)
            deep_ms[inst] = dict(ms=gs[1][1], local_ms=gs[0][1])
            phase("stack", f"{inst}: vol2_final 800x450 one sample against "
                  f"the local instantiation, rel L2 {rel:.2e} (atomics add in "
                  f"another order), {gs[1][1]:.3f} ms (local {gs[0][1]:.3f} "
                  f"ms) {'PASS' if ok_ else 'FAIL'}")
            stack_ok = stack_ok and ok_
            del gs
            torch.cuda.empty_cache()
    world_c60, cam_c60 = ptt.scenes.cornell_box()
    sc_60, fl_60, bv_60, ca_60, cf_60, rows60, tl60 = train_phase(
        "stack-train", world_c60, cam_c60, 800, 800, 4, 60,
        {"tex_c1": perturb_rows}, 0.08)
    assert cf_60.iters == 68
    del sc_60, bv_60
    # K6 against the plain path on one sample at 400x400 (the plain path's
    # autograd keeps every trip of the 68).
    r60 = adjoint_pair(*prepare(*ptt.scenes.cornell_box(), 400, 400, 4, 60),
                       (0,), 2)
    r60.pop("g")
    n60 = tl60.get("adjoint_k4_global", 0)
    ok60 = (r60["rel"] <= 1e-3 and n60 == 3 * 4
            and all(r_["paths_done"] == r_["paths_total"]
                    and r_["grad_finite"] for r_ in rows60))
    for r_ in rows60:
        r_.pop("grads")
    inst_rows["adjoint_k4_global"] = dict(
        ok=ok60, err=r60["err"], ms=r60["ms"], plain_ms=r60["plain_ms"],
        device_ms=r60["device_ms"],
        bytes=r60["bytes"], ops=r60["ops"], library_ms=None, launches=n60)
    phase("stack-train", f"cornell_box 800x800 4 spp max_depth 60 "
          f"({cf_60.iters} trips): paths_done == paths_total, finite gradients, K6 (tape "
          f"in the per-pixel buffer) launches {n60}; one 400x400 sample K6 "
          f"vs plain rel L2 {r60['rel']:.2e}, {r60['ms']:.3f} ms, plain "
          f"{r60['plain_ms']:.1f} ms -> {'PASS' if ok60 else 'FAIL'}")
    stack_ok = stack_ok and ok60
    rec_stack = dict(train=dict(rows=rows60, launches=tl60), ms=deep_ms)
    torch.cuda.empty_cache()

    # --- 10. ranks of a gloo job sharing the card ---
    rank_dir = os.path.join(RUN_DIR, "ranks")
    os.makedirs(rank_dir, exist_ok=True)
    # The train job's inputs and its one-rank reference step.
    sc_v, fl_v, bv_v, ca_v, cf_v = vol2(dev, spp=TRAIN_SPP)
    params_v = {n: f(getattr(sc_v, n)) for n, f in inits_v.items()}
    target_v = wf.render_batch(sc_v, fl_v, bv_v, ca_v, cf_v,
                               torch.zeros((H, W, 3), device=dev), 0, 32,
                               rng.key(10_000, device=dev), queue_size=32768,
                               steps_per_wave=32) / 32
    torch.save({"params": {k: v.cpu() for k, v in params_v.items()},
                "target": target_v.cpu()},
               os.path.join(rank_dir, "train_inputs.pt"))
    nw_v = calibrate_n_waves(dataclasses.replace(sc_v, **params_v), fl_v, bv_v,
                             ca_v, cf_v, key, spp=TRAIN_SPP, queue_size=32768,
                             steps_per_wave=32)
    step_v = make_train_step(fl_v, cf_v, None, spp=TRAIN_SPP, lr=TRAIN_LR,
                             queue_size=32768, steps_per_wave=32,
                             n_waves=nw_v, unbiased=True)
    _, loss_1, grads_1, aux_1 = step_v(params_v, sc_v, bv_v, ca_v,
                                       rng.fold_in(key, 0), target_v)
    # One-rank tiled references of the torus knot and the DP x TP frame.
    tp_ref = ptt.render_tiled(sc_k, fl_k, bv_k, ca_k, cf_k, key).cpu().numpy()
    sc_d, fl_d, bv_d, ca_d, cf_d = vol2(dev, **DP_TP)
    dptp_ref = ptt.render_tiled(sc_d, fl_d, bv_d, ca_d, cf_d,
                                key).cpu().numpy()
    del sc_v, bv_v, target_v, step_v, sc_d, bv_d
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    par_rec, par_ok = {}, True
    for world_n, jobs in RANK_RUNS:
        secs_ = run_ranks(world_n, jobs, rank_dir)
        phase("parallel", f"{world_n} ranks ran {list(jobs)} in {secs_:.1f} s "
              f"(process start and scene builds included)")
        for job in jobs:
            par_rec[job] = [torch.load(os.path.join(rank_dir, f"{job}.{r}.pt"))
                            for r in range(world_n)]
            for r in range(world_n):     # keep the frames out of RUN_DIR
                os.remove(os.path.join(rank_dir, f"{job}.{r}.pt"))
    os.remove(os.path.join(rank_dir, "train_inputs.pt"))

    def tp_rule(a, b):
        """tests/test_tp_scale.py:63-65: pixels off by more than 1e-4 at
        most 1%, the others' mean below 1e-6."""
        d = np.abs(a - b).max(axis=-1)
        outl = float((d > 1e-4).mean())
        clean = float(d[d <= 1e-4].mean()) if (d <= 1e-4).any() else 0.0
        return outl <= 0.01 and clean < 1e-6, outl, clean

    def summed_launches(job):
        return {n: sum(o["launches"][n] for o in par_rec[job])
                for n in kernels.LAUNCHES}

    # DP wavefront: the image against the one-rank frame of phase 4, the
    # counters summed over the ranks against its counters.
    dpw = par_rec["dp_wavefront"]
    img_d = dpw[0]["image"].numpy()
    st_d = dpw[0]["stats"]
    same_img = all(torch.equal(o["image"], dpw[0]["image"]) for o in dpw)
    err_d = float(np.abs(img_d - main_img).max())
    ok_d = (same_img and np.allclose(img_d, main_img, rtol=1e-5, atol=1e-6)
            and int(st_d["paths"]) == W * H * SPP
            and int(st_d["rays"]) == rec["main"]["rays"]
            and int(st_d["walk_steps"]) == rec["main"]["walk_steps"]
            and int(st_d["stack_overflows"]) == 0
            and all(summed_launches("dp_wavefront")[n] > 0
                    for n in WAVE_KERNELS))
    # DP megakernel: K5 over each rank's block, the same adds per pixel as
    # the one-rank K5 frame of phase 5.
    dpm = par_rec["dp_mega"]
    img_m = dpm[0]["image"].numpy()
    err_m = float(np.abs(img_m - mega_img).max())
    ok_m = (all(torch.equal(o["image"], dpm[0]["image"]) for o in dpm)
            and np.allclose(img_m, mega_img, rtol=1e-6, atol=1e-7)
            and summed_launches("dp_mega")["megakernel"] == 2 * SPP)
    phase("parallel", f"DP megakernel 2 ranks vol2_final {W}x{H} {SPP} spp: "
          f"per-rank wall " + ", ".join(f"{o['wall']:.4f}" for o in dpm)
          + f" s (one rank: {rec['main-mega']['wall']:.4f} s); image max abs "
          f"diff vs one rank {err_m:.2e}, K5 launches "
          f"{summed_launches('dp_mega')['megakernel']} -> "
          f"{'PASS' if ok_m else 'FAIL'}")
    par_ok = par_ok and ok_m
    phase("parallel", f"DP wavefront 2 ranks vol2_final {W}x{H} {SPP} spp: "
          f"per-rank wall " + ", ".join(f"{o['wall']:.4f}" for o in dpw)
          + f" s (one rank: {rec['main']['wall']:.4f} s); image max abs diff "
          f"vs one rank {err_d:.2e}, summed paths {int(st_d['paths'])} rays "
          f"{int(st_d['rays'])} (one rank {rec['main']['rays']}), waves "
          f"{int(st_d['waves'])}, launches {summed_launches('dp_wavefront')} "
          f"-> {'PASS' if ok_d else 'FAIL'}")
    par_ok = par_ok and ok_d
    # DP train step: every rank's loss and gradients against one rank's.
    dtr = par_rec["dp_train"]
    rel_g = {n: max(float((o["grads"][n].to(dev) - g).norm()
                          / g.norm().clamp(min=1e-30)) for o in dtr)
             for n, g in grads_1.items()}
    rel_l = max(abs(o["loss"] - float(loss_1)) / abs(float(loss_1))
                for o in dtr)
    ok_t = (all(v <= 1e-3 for v in rel_g.values()) and rel_l <= 1e-4
            and all(o["aux"]["paths_done"] == o["aux"]["paths_total"]
                    == aux_1["paths_total"] for o in dtr)
            and summed_launches("dp_train")["adjoint_full"] == 2 * TRAIN_SPP)
    phase("parallel", f"DP train step 2 ranks vol2_final {W}x{H} "
          f"{TRAIN_SPP} spp: per-rank step wall "
          + ", ".join(f"{o['wall']:.4f}" for o in dtr)
          + f" s, n_waves per shard {[o['n_waves'] for o in dtr]} (frame "
          f"{nw_v}); loss rel diff {rel_l:.2e}, gradient rel L2 vs one rank "
          + ", ".join(f"{n} {v:.2e}" for n, v in rel_g.items())
          + f", paths {dtr[0]['aux']['paths_done']}/"
          f"{dtr[0]['aux']['paths_total']} -> {'PASS' if ok_t else 'FAIL'}")
    par_ok = par_ok and ok_t
    # TP, PP and DP x TP against the one-rank tiled images.
    expect = {"tp": ("closest_hit", "tiled_trip", "tiled_spawn"),
              "pp": ("ring_hop", "tiled_trip_rec", "tiled_spawn"),
              "dp_tp": ("closest_hit", "tiled_trip", "tiled_spawn"),
              "tp8": ("closest_hit_k8", "tiled_trip", "tiled_spawn"),
              "pp8": ("ring_hop_k8", "tiled_trip_rec", "tiled_spawn")}
    for job, ref_ in (("tp", tp_ref), ("pp", tp_ref), ("dp_tp", dptp_ref),
                      ("tp8", tp_ref), ("pp8", tp_ref)):
        outs = par_rec[job]
        rule_ok, outl, clean = tp_rule(outs[0]["image"].numpy(), ref_)
        lj = summed_launches(job)
        lj.update({i: sum(o["instances"].get(i, 0) for o in outs)
                   for i in INSTANCES})
        lj = {n: v for n, v in lj.items() if v}
        ok_j = (rule_ok and all(torch.equal(o["image"], outs[0]["image"])
                                for o in outs)
                and all(lj.get(n, 0) > 0 for n in expect[job]))
        phase("parallel", f"{job} {len(outs)} ranks: per-rank wall "
              + ", ".join(f"{o['wall']:.4f}" for o in outs)
              + f" s; vs the one-rank tiled image: outliers {outl:.5f}, clean "
              f"mean {clean:.2e}; launches {lj} -> {'PASS' if ok_j else 'FAIL'}")
        par_ok = par_ok and ok_j
    par_summary = {job: dict(walls=[o["wall"] for o in outs],
                             launches=summed_launches(job),
                             instances={i: sum(o["instances"].get(i, 0)
                                               for o in outs)
                                        for i in INSTANCES})
                   for job, outs in par_rec.items()}

    # --- 10b. the entry points; 10c. the config ladder ---
    phase("entry", f"chip_smoke at {time.perf_counter() - t_main:.1f} s "
          f"before the entry and ladder phases")
    entry_ok, entry_rec = entry_phase(card)
    ladder_ok, ladder_rows = ladder_phase(card)
    # --- 10d. the golden images; 10e. the engine A/B; 10f. the demos ---
    golden_ok, golden_rows = golden_phase(card)
    ab_ok, ab_rec = ab_phase(card)
    demo_ok, demo_rec = demo_phase(card)
    # --- 10g. the scaling harness; 10h. the kept wave loop ---
    scaling_ok, scaling_rec = scaling_phase(card)
    kept_ok, kept_rec = kept_loop_phase(card)

    # --- 11. the kernel table ---
    launches = dict(rec["main"]["launches"])
    launches["megakernel"] = rec["main-mega"]["launches"]["megakernel"]
    launches["adjoint"] = train_rec["cornell_box"]["launches"]["adjoint"]
    launches["adjoint_full"] = (
        train_rec["vol2_final"]["launches"]["adjoint_full"])
    for n in TILED_KERNELS:
        launches[n] = rec["tiled"]["launches"][n]
    for n in ("ring_hop", "tiled_trip_rec"):
        launches[n] = par_summary["pp"]["launches"][n]
    launches["gather_rows"] = gather_launches
    # The instantiations timed in phases 9b-9c, each with the launches of
    # the run on its path: the K = 8 frames, train steps and PP job; the
    # Part A runs.
    launches["trace_step_k8"] = rec8["wavefront"][8]["instances"][
        "trace_step_k8"]
    launches["megakernel_k8"] = rec8["megakernel"][8]["instances"][
        "megakernel_k8"]
    launches["closest_hit_k8"] = rec8["tiled"][8]["instances"][
        "closest_hit_k8"]
    launches["ring_hop_k8"] = par_summary["pp8"]["instances"]["ring_hop_k8"]
    launches["adjoint_k8"] = tl8c.get("adjoint_k8", 0)
    launches["adjoint_full_k8"] = tl8f.get("adjoint_full_k8", 0)
    for n, r_ in inst_rows.items():
        results[n] = r_
        if "launches" in r_:
            launches[n] = r_["launches"]
    # Device ms per launch: a kernel of a profiled frame, its device time
    # there over its runs (the K = 8 rows: the K = 8 frames); the others as
    # phase 3 and phases 9b-9c measured them (device_ms, or P0's launches
    # replayed in a CUDA graph, as its and K4's library calls).
    frame_dev = {n: rec["main"]["kernel_totals_ms"][n]
                 / rec["main"]["launches"][n] for n in WAVE_KERNELS}
    frame_dev["megakernel"] = (rec["main-mega"]["kernel_totals_ms"]["megakernel"]
                               / rec["main-mega"]["launches"]["megakernel"])
    for n in TILED_KERNELS:
        frame_dev[n] = (rec["tiled"]["kernel_totals_ms"][n]
                        / rec["tiled"]["launches"][n])
    for inst, engine in (("trace_step_k8", "wavefront"),
                         ("megakernel_k8", "megakernel"),
                         ("closest_hit_k8", "tiled")):
        r8_, n8 = rec8[engine][8], INSTANCES[inst][0]
        frame_dev[inst] = r8_["device_ms"][n8] / r8_["profiled_launches"][n8]
    table = []
    rows_ = [(n, *v) for n, v in KERNELS.items()] + [
        (n, *KERNELS[INSTANCES[n][0]]) for n in inst_rows]
    for n, srcf, repl in rows_:
        res = results[n]
        t_bytes = res["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = res["ops"] / H100_F32_OPS_PER_S * 1e3
        row = {
            "name": n, "route": "cuda", "source": srcf, "replaces": repl,
            "launches": launches[n], "max_abs_err": res["err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": res["library_ms"],
            "device_ms": frame_dev.get(n, res.get("device_ms")),
            "library_device_ms": res.get("library_device_ms"),
            "pass": bool(res["ok"]) and (launches[n] > 0
                                         or res.get("no_kernel", False))}
        for k_ in ("exit_ms", "exit_device_ms", "main_device_ms",
                   "exit_lanes", "hop_device_ms", "hop_steps",
                   "frame_bound_ms", "ms_every_lane", "state_device_ms",
                   "state_device_ms_every_lane", "measures",
                   "int_ops_lane", "floor_device_ms",
                   "ptxas"):
            if k_ in res:
                row[k_] = res[k_]
        if "graph_device_ms" in res:
            row["graph_device_ms"] = res["graph_device_ms"]
        if n in ptxas:
            row["ptxas"] = list(ptxas[n])
        table.append(row)
    with open(os.path.join(RUN_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "frames": rec,
                   "shade_sss": results["shade"]["sss"],
                   "megakernel_sss": results["megakernel"]["sss"],
                   "adjoint": {k: results["adjoint"][k]
                               for k in ("small", "full")},
                   "adjoint_full": {k: results["adjoint_full"][k]
                                    for k in ("rows", "fd")},
                   "train": train_rec, "parallel": par_summary,
                   "bvh8": rec8, "stack": rec_stack, "ptxas": ptxas,
                   "entry": entry_rec, "ladder": ladder_rows,
                   "golden": golden_rows, "ab": ab_rec, "demo": demo_rec,
                   "scaling": scaling_rec, "kept_loop": kept_rec,
                   "kernels": table},
                  f, indent=1, default=str)
    failed = [t["name"] for t in table if not t["pass"]]
    phase("total", f"chip_smoke {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": table}), flush=True)
    tiled_ok = rec["tiled"]["ok"]
    loop_ok = rec["loop"]["ok"]
    if failed or not (agree and train_ok and tiled_ok and par_ok and loop_ok
                      and bvh8_ok and stack_ok and entry_ok and ladder_ok
                      and golden_ok and ab_ok and demo_ok and scaling_ok
                      and kept_ok):
        print(f"chip_smoke: FAILED {failed} agree={agree} train={train_ok} "
              f"tiled={tiled_ok} parallel={par_ok} loop={loop_ok} "
              f"bvh8={bvh8_ok} stack={stack_ok} entry={entry_ok} "
              f"ladder={ladder_ok} golden={golden_ok} ab={ab_ok} "
              f"demo={demo_ok} scaling={scaling_ok} kept_loop={kept_ok}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--kept-loop"]:
        sys.exit(kept_loop_main())
    sys.exit(main())
