"""A/B of K5 (megakernel), K7 (closest_hit) and K8 (tiled_trip) between
checkouts, on one card.

    path_tracer_tpu_torch/scripts/ab_smoke.sh prepare HEAD    # in git
    python path_tracer_tpu_torch/scripts/mega_ab.py build/ab/parent build/ab/change
    python path_tracer_tpu_torch/scripts/mega_ab.py --tiled --rounds 3 DIR ...
    python path_tracer_tpu_torch/scripts/mega_ab.py --traffic --rounds 3 DIR ...
    python path_tracer_tpu_torch/scripts/mega_ab.py --spawn --rounds 3 DIR ...
    python path_tracer_tpu_torch/scripts/mega_ab.py --gather --rounds 3 DIR ...

Each argument is a checkout of the repo (``ab_smoke.sh prepare`` unpacks the
parent and the working tree into ``build/ab/``).  The script builds each
checkout's ``megakernel.cu``, ``closest_hit.cu`` and ``tiled_trip.cu`` from
its own ``csrc/`` (one ``nvcc`` per source, every checkout's builds started
together) and prints their ptxas resources.  Then it runs one process per
checkout in the order 1 .. n, n .. 1; on vol2_final_scene(sphere_cluster=
1000) at 800x450, depth 10, at node widths 4 and 8, each

- launches K5 on sample 0 from a zero frame, with the local and with the
  per-pixel stack (``max_stack`` and ``stack_depth`` 70), and on sample 0 of
  mesh_perlin_sss at 400x225, depth 12: a hash of the colours, iters,
  depth, frame, depth histogram and counters; K5's device ms per launch
  (10 launches queued behind a spin kernel, CUDA events);
- renders the 10-spp frame through the megakernel
  (``integrator.render_batch``): three frame walls, then one frame under
  torch.profiler (K5's device ms and runs);
- runs K7 on the lanes of sample 0 after three trips of the tiled engine:
  the main query on the live lanes, the exit query on the live lanes that
  hit and on those whose hit has a medium: hashes of each query's found,
  pt, pi and t, and device ms per launch of each; where the checkout's
  K7 takes ``exit_of``, the engine's exit query (K7 reading the main hit's
  medium itself), held bit-equal to the masked one, and timed;
- renders the 10-spp frame through ``render_tiled`` (one captured trip
  graph replayed per sample): three frame walls, a hash of the image, the
  traversal steps, then one frame under torch.profiler with K7's device
  ms split between its main and its exit launches (each trip launches
  the main query, then the exit query, in that order) and K8's.

``--tiled`` runs only the tiled engine, at node widths 4 and 8, and splits
K8: the graphed frame's three walls and image hash, K8's device ms per
trip (torch.profiler, each trip's mean over the frame's samples), the
eager loop's live lanes per trip (every sample), the mean live lanes per
warp and the mean distinct families per warp over warps with a live lane,
in lane order and in the order of a block sort by family (128 lanes), the
walk's steps per trip and each trip's bound (the larger of its bytes at
3.35 TB/s and its fp32 ops at 67 TFLOP/s, as chip_smoke counts K8's), K8
on the lanes of sample 0 after three trips (device ms, 10 launches on as
many copies queued behind a spin kernel), a trip graph's capture seconds,
the captures across two frames and, where the checkout keeps its graph, a
kept frame bit-equal to a freshly captured one.  ``--rounds R``: R passes
over the checkouts, every other one reversed (default 2).

``--traffic`` runs the tiled engine under the traffic that renders over and
over (every kernel built): the 10-spp frame with five new keys and from
five camera positions (walls, image hashes, trip graph captures), and the
tiled train step (``make_train_step(engine="megakernel")``, unbiased, 4 spp
a render, ``med_density`` and ``tex_c1``): four step walls after a warm-up,
the first step's loss and the captures; records in
``chiprun_out/mega_ab_traffic.json``.

``--spawn`` builds ``tiled_trip.cu`` alone and times the tiled engine's
spawn (``tiled_spawn``) over the 360,000 lanes of the 800x450 frame: device
ms a launch (20 launches captured in one CUDA graph and replayed) as the
eager loop launches it (``frame_dev`` unset, the sample an int) and as the
trip graph does (``frame_dev`` set, the sample on the card, live lists),
for the frame's own key and camera and for another frame's (a new key, a
moved camera), with a hash of each spawned state, which must match across
checkouts, and the spawn kernel's SASS instructions by class
(``kernels.sass_opcodes``); records in ``chiprun_out/mega_ab_spawn.json``.

``--gather`` builds ``gather.cu`` alone and times P0 (``gather_rows``) on
every case of ``scripts/bench_gather.py`` (made once, by this process, and
read by every run): device ms a call, 20 calls captured in one CUDA graph
and replayed, beside ``index_select`` and, where the checkout has it, the
empty kernel on the gather's grid (``gather_rows_floor``); each output held
equal to ``index_select``; records in ``chiprun_out/mega_ab_gather.json``.
A design of ``gather.cu`` is a copied checkout with that file replaced.

It prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run, a summary (medians per checkout) and, per hash, whether every run of
every checkout gave the first one's; every record goes to
``chiprun_out/mega_ab.json`` (``mega_ab_tiled.json`` with ``--tiled``).
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

from graph_timer import N_GRAPH, graph_ms   # this script's directory

SOURCES = ("megakernel", "closest_hit", "tiled_trip")
NAMES = ("megakernel", "closest_hit", "ring_hop", "tiled_trip",
         "tiled_trip_rec", "tiled_spawn")
W, H, SPP, DEPTH = 800, 450, 10, 10
QW, QH, QDEPTH = 400, 225, 12
DEEP = 70
N_QUEUED = 10
SPIN_CYCLES = 200_000_000
H100_BYTES_PER_S = 3.35e12     # as chip_smoke.py
H100_F32_OPS_PER_S = 67e12
STATE_BYTES = 61               # one lane's path state
BOUNCE_OPS = 600 + 12 * 110    # fp32 ops of one bounce
WALK_TRIP_OPS = 3 * 110 + 60   # one SSS walk trip
SORT_LANES = 128               # a block of K8's family sort
N_TRAFFIC = 5                  # --traffic: frames of new keys, of new views
N_STEPS, TRAIN_SPP = 4, 4      # --traffic: train steps, samples a render
SPAWN_SAMPLE = 3               # --spawn: the sample the lanes take
_HERE = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _these_kernels_only(kernels) -> None:
    """Make ``kernels.build`` compile and load K5's, K7's and K8's sources."""
    kernels.SOURCES = SOURCES
    kernels.NAMES = NAMES
    kernels.OWN_API = {}
    kernels.SOURCE_OF = {n: kernels.SOURCE_OF[n] for n in NAMES}


def _spawn_kernels_only(kernels) -> None:
    """Make ``kernels.build`` compile and load ``tiled_trip.cu`` alone."""
    kernels.SOURCES = ("tiled_trip",)
    kernels.NAMES = ("tiled_trip", "tiled_trip_rec", "tiled_spawn")
    kernels.OWN_API = {}
    kernels.SOURCE_OF = {n: "tiled_trip" for n in kernels.NAMES}


def _gather_kernels_only(kernels) -> None:
    """Make ``kernels.build`` compile and load ``gather.cu`` alone."""
    kernels.SOURCES = ("gather",)
    kernels.NAMES = ()
    kernels.OWN_API = {"gather_rows": "gather"}
    kernels.SOURCE_OF = dict(kernels.OWN_API)


def build_side() -> int:
    from path_tracer_tpu_torch.ops import kernels
    if "--spawn" in sys.argv:
        _spawn_kernels_only(kernels)
    elif "--gather" in sys.argv:
        _gather_kernels_only(kernels)
    elif "--all" not in sys.argv:
        _these_kernels_only(kernels)
    t0 = time.perf_counter()
    kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": {
        n: [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for n, log in kernels.BUILD_LOG.items()
        if n in ("megakernel", "closest_hit", "tiled_trip", "gather")}}),
          flush=True)
    return 0


def _hash(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_ms(fn, n=N_QUEUED):
    """Device ms per call of ``fn``: ``n`` calls queued behind a spin
    kernel, timed with CUDA events."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _profiled(run, names):
    """Run ``run()`` under torch.profiler → ({name: device ms}, {name:
    runs}, [(name, device us) of each run of the kernels in time order])."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ms, runs = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        for n in names:
            if f"{n}_kernel" in ev.key:
                ms[n] += ev.device_time_total / 1e3
                runs[n] += ev.count
    seq = []
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        n = next((n for n in names if f"{n}_kernel" in ev.name), None)
        if n is not None:
            seq.append((ev.time_range.start, n, ev.time_range.elapsed_us()))
    seq.sort()
    return ms, runs, [(n, us) for _s, n, us in seq]


def measure_side() -> int:
    import torch

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import integrator, kernels, shade_tiled
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng
    _these_kernels_only(kernels)
    kernels.build()

    dev = torch.device("cuda")
    key = rng.key(0, device=dev)

    def setup(name, w, h, depth, **kw):
        world, cam = getattr(ptt.scenes, name)(**kw)
        cam.aspect_ratio, cam.img_width = w / h, w
        cam.samples_per_pixel, cam.max_depth = SPP, depth
        scene = ptt.compile_scene(world, device=dev)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=SPP,
                           max_depth=depth)
        return (scene, SceneFlags.from_scene(scene),
                cam.initialize(device=dev), cfg)

    scene, flags, cam_a, cfg = setup("vol2_final_scene", W, H, DEPTH,
                                     sphere_cluster=1000)
    sc_q, fl_q, ca_q, cf_q = setup("mesh_perlin_sss", QW, QH, QDEPTH)
    rec = {"dir": os.getcwd(), "hash": {}, "k5": {}, "k7": {}, "mega": {},
           "tiled": {}}

    def k5_sample(sc, fl, bvh, ca, cf, tag):
        eng = integrator.MegaEngine(sc, fl, bvh, ca, cf, key)
        ms = eng.init_state(torch.zeros((cf.height, cf.width, 3), device=dev))
        # a checkout from before mega_args keeps the block on the state
        args = ((integrator.mega_args(eng, ms),)
                if hasattr(integrator, "mega_args") else ())
        integrator.megakernel(eng, ms, 0, *args)
        torch.cuda.synchronize()
        # every counter but the scratch of the work fetch (C_FETCH, 20)
        rec["hash"][tag] = _hash(ms.color, ms.iters, ms.depth, ms.accum,
                                 ms.depth_hist, ms.ctr[:20])
        rec["k5"][tag] = _device_ms(lambda: integrator.megakernel(eng, ms, 0,
                                                                  *args))

    for K in (4, 8):
        bvh = ptt.build_from_scene(scene, K)
        k5_sample(scene, flags, bvh, cam_a, cfg, f"k5_vol2_k{K}")
        k5_sample(scene, flags, dataclasses.replace(bvh, max_stack=DEEP),
                  cam_a, dataclasses.replace(cfg, stack_depth=DEEP),
                  f"k5_vol2_k{K}_global")
        k5_sample(sc_q, fl_q, ptt.build_from_scene(sc_q, K), ca_q, cf_q,
                  f"k5_sss_k{K}")

        def frame():
            return integrator.render_batch(
                scene, flags, bvh, cam_a, cfg,
                torch.zeros((H, W, 3), device=dev), 0, SPP, key,
                with_stats=True)
        frame()                                      # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ms, runs, _seq = _profiled(frame, ("megakernel",))
        rec["mega"][K] = dict(walls=walls, device_ms=ms["megakernel"],
                              runs=runs["megakernel"])

        # K7 on sample 0 after three trips of the tiled engine
        teng = itl.TiledEngine(scene, flags, bvh, cam_a, cfg, key)
        pix = torch.arange(W * H, dtype=torch.int32, device=dev)
        t_min = torch.full((W * H,), cfg.t_min, device=dev)

        def query(st_, tmin_, act_):
            return itl.closest_hit_batched(bvh, st_.origin, st_.direction,
                                           st_.time, tmin_, cfg.t_max,
                                           cfg.stack_depth, active=act_)
        st = itl.tiled_spawn(teng, 0, pix)
        for _ in range(3):
            h_ = query(st, t_min, st.alive)
            e_ = query(st, h_[3] + 1e-4, st.alive & h_[0])
            st = itl.tiled_trip(teng, st, 0, pix, h_[:3], e_)
        live = st.alive.clone()
        hit = query(st, t_min, live)
        med = shade_tiled.prim_medium_t(teng.tabs, hit[1], hit[2]) >= 0
        masks = {"main": (t_min, live),
                 "exit_found": (hit[3] + 1e-4, live & hit[0]),
                 "exit_medium": (hit[3] + 1e-4, live & hit[0] & med)}
        rec["k7"][K] = {"live": int(live.sum()),
                        "exit_medium_lanes": int((live & hit[0] & med).sum())}
        for tag, (tm, act) in masks.items():
            out = query(st, tm, act)
            torch.cuda.synchronize()
            rec["hash"][f"k7_{tag}_k{K}"] = _hash(*out)
            rec["k7"][K][tag] = _device_ms(lambda tm=tm, act=act:
                                           query(st, tm, act))
        if "exit_of" in inspect.signature(
                itl.closest_hit_batched).parameters:
            # the engine's exit query: K7 reads the main hit's medium itself
            tm = hit[3] + 1e-4

            def gated():
                return itl.closest_hit_batched(
                    bvh, st.origin, st.direction, st.time, tm, cfg.t_max,
                    cfg.stack_depth, active=live,
                    exit_of=(teng, hit[0], hit[1], hit[2]))
            rec["k7"][K]["exit_gate_same"] = (
                _hash(*gated()) == rec["hash"][f"k7_exit_medium_k{K}"])
            rec["k7"][K]["exit_gate"] = _device_ms(gated)
        del teng, st, hit

        # the tiled frame, graphed
        bvh_t = bvh

        def tiled():
            return itl.render_tiled(scene, flags, bvh_t, cam_a, cfg, key,
                                    spp=SPP, with_stats=True)
        tiled()                                      # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stt = tiled()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rec["hash"][f"tiled_image_k{K}"] = _hash(img)
        ms, runs, seq = _profiled(tiled, ("closest_hit", "tiled_trip",
                                          "tiled_spawn"))
        k7_seq = [us for n, us in seq if n == "closest_hit"]
        has_exit = bool(flags.has_medium)
        main_us = k7_seq[0::2] if has_exit else k7_seq
        exit_us = k7_seq[1::2] if has_exit else []
        rec["tiled"][K] = dict(
            walls=walls, trav_steps=int(stt["trav_steps"]),
            device_ms=ms, runs=runs,
            k7_main_ms=sum(main_us) / 1e3, k7_exit_ms=sum(exit_us) / 1e3,
            k7_main_runs=len(main_us), k7_exit_runs=len(exit_us))
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def _families(itl, eng, alive, hit):
    """K8's family key per lane (dead 9, miss 7, medium 8, else the hit's
    material type), computed here so that every checkout is split alike."""
    import torch
    from path_tracer_tpu_torch.ops import shade_tiled
    found, pt, pi = hit
    row = shade_tiled._prim_rows(eng.tabs, pt, pi)
    mat = torch.clamp(row[0].to(torch.int32), 0, eng.tabs.mat.shape[0] - 1)
    key = torch.clamp(eng.tabs.mat[mat.long(), 0].to(torch.int32), 0, 6)
    key = torch.where(found, key, 7)
    if eng.flags.has_medium:
        key = torch.where(found & (row[1].to(torch.int32) >= 0), 8, key)
    return torch.where(alive, key, 9)


def _warp_stats(keys):
    """(mean live lanes, mean distinct families) per warp of 32 positions
    with a live lane; ``keys`` in run order, 9 (or -1 padding) dead."""
    import torch
    n = keys.shape[0]
    k = torch.cat([keys, torch.full((-n % 32,), 9, dtype=keys.dtype,
                                    device=keys.device)]).view(-1, 32)
    live = k != 9
    rows = live.any(1)
    if not bool(rows.any()):
        return 0.0, 0.0
    fam = torch.zeros((k.shape[0], 10), dtype=torch.bool, device=k.device)
    fam.scatter_(1, k.long().clamp(0, 9), True)
    fam[:, 9] = False
    return (float(live.sum(1)[rows].float().mean()),
            float(fam.sum(1)[rows].float().mean()))


def _sorted_keys(keys):
    """Keys in the order of a stable sort by family within blocks of
    SORT_LANES lanes (design (a)'s order)."""
    import torch
    n = keys.shape[0]
    k = torch.cat([keys, torch.full((-n % SORT_LANES,), 9, dtype=keys.dtype,
                                    device=keys.device)]).view(-1, SORT_LANES)
    return torch.sort(k, dim=1, stable=True).values.reshape(-1)


def tiled_side() -> int:
    import torch

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import (C_WALK_STEPS, PathState,
                                                 RenderConfig)
    from path_tracer_tpu_torch.utils import rng
    _these_kernels_only(kernels)
    kernels.build()
    dev = torch.device("cuda")
    key = rng.key(0, device=dev)
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    cam.samples_per_pixel, cam.max_depth = SPP, DEPTH
    scene = ptt.compile_scene(world, device=dev)
    flags = SceneFlags.from_scene(scene)
    cam_a = cam.initialize(device=dev)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH)
    NL = W * H
    pix = torch.arange(NL, dtype=torch.int32, device=dev)
    t_min = torch.full((NL,), cfg.t_min, device=dev)
    rec = {"dir": os.getcwd(), "hash": {}, "tiled": {}}
    has_live = hasattr(itl, "new_live_list")
    for K in (4, 8):
        bvh = ptt.build_from_scene(scene, K)
        teng = itl.TiledEngine(scene, flags, bvh, cam_a, cfg, key)
        tabs = teng.tabs
        shade_bytes = 4 * sum(x.numel() for x in (tabs.prim, tabs.mat,
                                                  tabs.tex, tabs.med))

        def query(st_, tmin_, act_, exit_of=None):
            if exit_of is None:
                return itl.closest_hit_batched(
                    bvh, st_.origin, st_.direction, st_.time, tmin_,
                    cfg.t_max, cfg.stack_depth, active=act_)
            return itl.closest_hit_batched(
                bvh, st_.origin, st_.direction, st_.time, tmin_, cfg.t_max,
                cfg.stack_depth, active=act_, exit_of=exit_of)

        # The eager loop, every sample: live lanes, warp fill, walk steps
        # and the bound of every trip.
        trips = []
        for smp in range(SPP):
            live = itl.new_live_list(NL, dev) if has_live else None
            st = (itl.tiled_spawn(teng, smp, pix, live) if has_live
                  else itl.tiled_spawn(teng, smp, pix))
            ctr = itl.new_counters(dev)
            for t in range(cfg.iters):
                h_ = query(st, t_min, st.alive)
                e_ = query(st, h_[3] + 1e-4, st.alive,
                           exit_of=(teng, h_[0], h_[1], h_[2]))
                keys = _families(itl, teng, st.alive, h_[:3])
                n_live = int(st.alive.sum())
                w0 = int(ctr[C_WALK_STEPS])
                kw = dict(ctr=ctr)
                if has_live:
                    kw.update(live=live, parity=t & 1)
                st = itl.tiled_trip(teng, st, smp, pix, h_[:3], e_, **kw)
                walk = int(ctr[C_WALK_STEPS]) - w0
                if smp == 0:
                    lw, fw = _warp_stats(keys)
                    slw, sfw = _warp_stats(_sorted_keys(keys))
                    trips.append(dict(live=[n_live], walk=[walk],
                                      live_per_warp=lw, fam_per_warp=fw,
                                      sorted_live_per_warp=slw,
                                      sorted_fam_per_warp=sfw))
                else:
                    trips[t]["live"].append(n_live)
                    trips[t]["walk"].append(walk)
        bound = []
        for tr in trips:
            b = 0.0
            for n_live, walk in zip(tr["live"], tr["walk"]):
                byts = shade_bytes + NL + n_live * (2 * STATE_BYTES + 26)
                ops = n_live * BOUNCE_OPS + walk * WALK_TRIP_OPS
                b += max(byts / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)
            bound.append(1e3 * b / len(tr["live"]))
        # K8 on the lanes of sample 0 after three trips, as chip_smoke
        st = itl.tiled_spawn(teng, 0, pix)
        for _ in range(3):
            h_ = query(st, t_min, st.alive)
            e_ = query(st, h_[3] + 1e-4, st.alive & h_[0])
            st = itl.tiled_trip(teng, st, 0, pix, h_[:3], e_)
        hk = query(st, t_min, st.alive)
        ek = query(st, hk[3] + 1e-4, st.alive,
                   exit_of=(teng, hk[0], hk[1], hk[2]))
        copies = [PathState(*(x.clone() for x in st)) for _ in range(N_QUEUED)]
        it_ = iter(copies)
        k8_state_ms = _device_ms(lambda: itl.tiled_trip(
            teng, next(it_), 0, pix, hk[:3], ek))
        three_live = int(st.alive.sum())
        del copies, st, hk, ek

        def tiled():
            return itl.render_tiled(scene, flags, bvh, cam_a, cfg, key,
                                    spp=SPP, with_stats=True)
        tiled()                                      # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stt = tiled()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        rec["hash"][f"tiled_image_k{K}"] = _hash(img)
        rec["hash"][f"tiled_steps_k{K}"] = _hash(stt["trav_steps"],
                                                 stt["walk_steps"])
        caps = getattr(itl, "CAPTURES", None)
        tiled()
        caps2 = getattr(itl, "CAPTURES", None)
        kept_same = None
        if hasattr(itl, "clear_trip_graphs"):
            itl.clear_trip_graphs()
            img2, _ = tiled()
            kept_same = _hash(img2) == _hash(img)
        ms, runs, seq = _profiled(tiled, ("closest_hit", "tiled_trip",
                                          "tiled_spawn"))
        k8_us = [us for n, us in seq if n == "tiled_trip"]
        per_trip = [statistics.mean(k8_us[t::cfg.iters]) / 1e3
                    for t in range(cfg.iters)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        itl.TripGraph(teng, NL, itl.new_counters(dev))
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        rec["tiled"][K] = dict(
            walls=walls, device_ms=ms, runs=runs, k8_per_trip_ms=per_trip,
            k8_bound_per_trip_ms=bound,
            k8_bound_frame_ms=SPP * sum(bound),
            live_per_trip=[tr["live"] for tr in trips],
            walk_per_trip=[tr["walk"] for tr in trips],
            warp=[{k: tr[k] for k in ("live_per_warp", "fam_per_warp",
                                      "sorted_live_per_warp",
                                      "sorted_fam_per_warp")}
                  for tr in trips],
            k8_three_trip_ms=k8_state_ms, three_trip_live=three_live,
            capture_s=capture_s,
            captures_two_frames=(None if caps is None else caps2 - caps),
            kept_frame_same=kept_same)
        del teng
        torch.cuda.empty_cache()
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def spawn_side() -> int:
    import copy

    import numpy as np
    import torch

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng
    _spawn_kernels_only(kernels)
    kernels.build()
    dev = torch.device("cuda")
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    scene = ptt.compile_scene(world, device=dev)
    flags = SceneFlags.from_scene(scene)
    bvh = ptt.build_from_scene(scene)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH)
    moved = copy.copy(cam)
    moved.lookfrom = np.asarray(cam.lookfrom, float) + np.array(
        [0.25, 0.0, 0.0])
    key = rng.key(0, device=dev)
    own = itl.TiledEngine(scene, flags, bvh, cam.initialize(device=dev), cfg,
                          key)
    other = itl.TiledEngine(scene, flags, bvh, moved.initialize(device=dev),
                            cfg, rng.fold_in(key, 5))
    NL = W * H
    pix = torch.arange(NL, dtype=torch.int32, device=dev)
    rec = {"dir": os.getcwd(), "hash": {}, "spawn_ms": {}}
    # the eager loop's spawn (frame_dev unset, an int sample) and the trip
    # graph's (frame_dev set, the sample on the card, live lists), the
    # latter with this frame's words and with another key and view's
    sample_t = torch.full((1,), SPAWN_SAMPLE, dtype=torch.int32, device=dev)
    for tag, eng, frame_of in (("eager", own, None), ("eager_other", other,
                                                       None),
                               ("graph", own, own), ("graph_other", own,
                                                     other)):
        eng._args = None
        live, sample = None, SPAWN_SAMPLE
        if frame_of is not None:
            a = eng.args()
            frame = kernels.frame_words(frame_of.args()).to(dev)
            a.frame_dev, a._keep_frame = kernels._ptr(frame), frame
            live, sample = itl.new_live_list(NL, dev), sample_t
        st = itl.tiled_spawn(eng, sample, pix, live)
        torch.cuda.synchronize()
        rec["hash"][tag] = _hash(*st)
        if live is not None:
            rec["hash"][tag + "_live"] = _hash(live[0][0], live[1])
        rec["spawn_ms"][tag] = graph_ms(
            [lambda: itl.tiled_spawn(eng, sample, pix, live)] * N_GRAPH)
        eng._args = None
    rec["so"] = kernels.library_path("tiled_trip")
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def _spawn_summary(built, runs, ok) -> int:
    from path_tracer_tpu_torch.ops import kernels
    med = statistics.median
    for r in runs:
        r["sass"] = {f: c for f, c in kernels.sass_opcodes(r["so"]).items()
                     if "tiled_spawn_kernel" in f}
    for d in built:
        rs = [r for r in runs if r["dir"] == d]
        if not rs:
            continue
        for tag in rs[0]["spawn_ms"]:
            v = [r["spawn_ms"][tag] for r in rs]
            print(f"summary {os.path.basename(d)} spawn {tag}: device ms a "
                  f"launch " + ", ".join(f"{x:.5f}" for x in v)
                  + f" (median {med(v):.5f})", flush=True)
        for f, mix in rs[0]["sass"].items():
            print(f"summary {os.path.basename(d)} {f} SASS: "
                  f"{sum(mix.values())} instructions, by class "
                  f"{kernels.sass_classes(mix)}", flush=True)
    for r in runs:           # the card's frame words read as the block's own
        same = (r["hash"]["graph"] == r["hash"]["eager"]
                and r["hash"]["graph_other"] == r["hash"]["eager_other"]
                and r["hash"]["eager"] != r["hash"]["eager_other"])
        print(f"{os.path.basename(r['dir'])}: frame_dev spawns equal the "
              f"eager ones, the other frame's differs: {same}", flush=True)
        ok = ok and same
    if runs:
        first = runs[0]["hash"]
        for tag in first:
            same = all(r["hash"].get(tag) == first[tag] for r in runs)
            print(f"bit-equal {tag}: {same} across {len(runs)} runs",
                  flush=True)
            ok = ok and same
    return 0 if ok else 1


def gather_side() -> int:
    import torch

    from path_tracer_tpu_torch.ops import gather, kernels
    _gather_kernels_only(kernels)
    kernels.build()
    probe = torch.load(sys.argv[2], map_location="cuda")
    floor = getattr(gather, "gather_rows_floor", None)
    rec = {"dir": os.getcwd(), "cases": {}}
    for name, table, idx in probe:
        lib = torch.index_select(table, 0, idx)
        got = gather.gather_rows(table, idx)
        out = torch.empty_like(lib)
        torch.cuda.synchronize()
        c = {"shape": [*table.shape, idx.shape[0]],
             "equal": bool(torch.equal(got, lib)),
             "device_ms": graph_ms(
                 [lambda: gather.gather_rows(table, idx)] * N_GRAPH),
             "library_device_ms": graph_ms(
                 [lambda: torch.index_select(table, 0, idx)] * N_GRAPH),
             "floor_device_ms": None}
        if floor is not None:
            floor(table, idx, out)
            c["floor_device_ms"] = graph_ms(
                [lambda: floor(table, idx, out)] * N_GRAPH)
        rec["cases"][name] = c
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def _gather_summary(built, runs, ok) -> int:
    import bench_gather
    med = statistics.median
    for name in (runs[0]["cases"] if runs else ()):
        B, W, R = runs[0]["cases"][name]["shape"]
        print(f"summary {name} ({B}, {W}) x {R}: bound "
              f"{bench_gather.bound_ms(B, W, R):.5f} ms", flush=True)
        for d in built:
            cs = [r["cases"][name] for r in runs if r["dir"] == d]
            if not cs:
                continue
            line = f"  {os.path.basename(d)}:"
            for key in ("device_ms", "floor_device_ms", "library_device_ms"):
                v = [c[key] for c in cs if c[key] is not None]
                if v:
                    line += (f" {key} " + ", ".join(f"{x:.5f}" for x in v)
                             + f" (median {med(v):.5f});")
            equal = all(c["equal"] for c in cs)
            print(f"{line} equal to index_select {equal}", flush=True)
            ok = ok and equal
    return 0 if ok else 1


def traffic_side() -> int:
    import copy

    import numpy as np
    import torch

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng
    kernels.build()                   # every kernel: the step runs K6 too
    dev = torch.device("cuda")
    key = rng.key(0, device=dev)
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    scene = ptt.compile_scene(world, device=dev)
    flags = SceneFlags.from_scene(scene)
    bvh = ptt.build_from_scene(scene)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH)
    cams = []
    for i in range(N_TRAFFIC):
        c = copy.copy(cam)
        c.lookfrom = np.asarray(cam.lookfrom, float) + np.array(
            [0.25 * i, 0.0, 0.0])
        cams.append(c.initialize(device=dev))
    rec = {"dir": os.getcwd(), "hash": {}, "walls": {}, "captures": {}}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def captures():
        return getattr(itl, "CAPTURES", None)

    itl.render_tiled(scene, flags, bvh, cams[0], cfg, key, spp=1)  # warm-up
    for tag, frames in (("keys", [(rng.fold_in(key, i), cams[0])
                                  for i in range(N_TRAFFIC)]),
                        ("views", [(key, c) for c in cams])):
        c0, walls, imgs = captures(), [], []
        for k, c in frames:
            w, img = timed(lambda: itl.render_tiled(scene, flags, bvh, c, cfg,
                                                    k, spp=SPP))
            walls.append(w)
            imgs.append(img)
        rec["walls"][tag] = walls
        rec["hash"][tag] = _hash(*imgs)
        rec["captures"][tag] = None if c0 is None else captures() - c0
    # The tiled train step (vol2_final 800x450, 4 spp a render, two renders
    # a step of their own keys, the full K6 backward).
    cf_t = dataclasses.replace(cfg, samples_per_pixel=TRAIN_SPP)
    target = itl.render_tiled(scene, flags, bvh, cams[0], cf_t,
                              rng.key(10_000, device=dev), spp=8)
    params = {"med_density": scene.med_density * 1.5,
              "tex_c1": scene.tex_c1 * 0.9}
    step = ptt.make_train_step(flags, cf_t, None, spp=TRAIN_SPP, lr=1e-9,
                               engine="megakernel", unbiased=True)
    step(params, scene, bvh, cams[0], rng.fold_in(key, 99), target)
    c0, walls, losses = captures(), [], []
    for i in range(N_STEPS):
        w, out = timed(lambda: step(params, scene, bvh, cams[0],
                                    rng.fold_in(key, i), target))
        params = out[0]
        walls.append(w)
        losses.append(float(out[1]))
    rec["walls"]["train"] = walls
    rec["hash"]["train_loss0"] = repr(losses[0])
    rec["captures"]["train"] = None if c0 is None else captures() - c0
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def _traffic_summary(built, runs, ok) -> int:
    med = statistics.median
    for d in built:
        rs = [r for r in runs if r["dir"] == d]
        for tag in ("keys", "views", "train"):
            ws = [w for r in rs for w in r["walls"][tag]]
            if ws:
                print(f"summary {os.path.basename(d)} {tag}: walls "
                      + ", ".join(f"{w:.4f}" for w in ws)
                      + f" (median {med(ws):.4f}, min {min(ws):.4f}, max "
                      f"{max(ws):.4f}); captures "
                      f"{[r['captures'][tag] for r in rs]}", flush=True)
    if runs:
        first = runs[0]["hash"]
        for tag in first:
            same = all(r["hash"].get(tag) == first[tag] for r in runs)
            print(f"bit-equal {tag}: {same} across {len(runs)} runs",
                  flush=True)
            ok = ok and same
    return 0 if ok else 1


def main(args) -> int:
    tiled = "--tiled" in args
    traffic = "--traffic" in args
    spawn = "--spawn" in args
    gath = "--gather" in args
    rounds = 2
    if "--rounds" in args:
        rounds = int(args[args.index("--rounds") + 1])
        args = args[:args.index("--rounds")] + args[args.index("--rounds") + 2:]
    dirs = [d for d in args
            if d not in ("--tiled", "--traffic", "--spawn", "--gather")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dirs = [os.path.abspath(d) for d in dirs]
    builds = {d: subprocess.Popen([sys.executable, _HERE, "--build"]
                                  + (["--all"] if traffic else
                                     ["--spawn"] if spawn else
                                     ["--gather"] if gath else []), cwd=d,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for d in dirs}
    out_all = {"card": card, "builds": {}, "runs": []}
    built = []
    for d, p in builds.items():
        out, _ = p.communicate()
        print(f"build {d}: rc {p.returncode}\n{out[-6000:]}", flush=True)
        out_all["builds"][d] = out[-6000:]
        if p.returncode == 0:
            built.append(d)
    ok = len(built) == len(dirs)
    order = [x for r in range(rounds) for x in (built if r % 2 == 0
                                                 else built[::-1])]
    side = ["--traffic-side" if traffic else "--spawn-side" if spawn
            else "--gather-side" if gath else "--tiled-side" if tiled
            else "--side"]
    if gath:                     # the cases, made once for every run
        import bench_gather
        import torch
        side.append(os.path.join(_REPO, "build", "gather_cases.pt"))
        os.makedirs(os.path.dirname(side[1]), exist_ok=True)
        torch.save(bench_gather.cases(torch.device("cuda")), side[1])
    for d in order:
        p = subprocess.run([sys.executable, _HERE, *side], cwd=d,
                           capture_output=True, text=True, timeout=900)
        recs = [json.loads(ln[7:]) for ln in p.stdout.splitlines()
                if ln.startswith("RECORD ")]
        if p.returncode != 0 or not recs:
            print(f"run {d}: rc {p.returncode}\n{p.stdout[-2000:]}"
                  f"\n{p.stderr[-4000:]}", flush=True)
            ok = False
            continue
        print(json.dumps(recs[0]), flush=True)
        out_all["runs"].append(recs[0])
    os.makedirs(os.path.join(_REPO, "chiprun_out"), exist_ok=True)
    name = ("mega_ab_traffic.json" if traffic else
            "mega_ab_spawn.json" if spawn else
            "mega_ab_gather.json" if gath else
            "mega_ab_tiled.json" if tiled else "mega_ab.json")
    with open(os.path.join(_REPO, "chiprun_out", name), "w") as f:
        json.dump(out_all, f, indent=1)
    runs = out_all["runs"]
    if traffic:
        return _traffic_summary(built, runs, ok)
    if spawn:
        return _spawn_summary(built, runs, ok)
    if gath:
        return _gather_summary(built, runs, ok)
    if tiled:
        return _tiled_summary(built, runs, ok)
    for d in built:
        rs = [r for r in runs if r["dir"] == d]
        if not rs:
            continue
        name = os.path.basename(d)
        for K in ("4", "8"):
            med = statistics.median
            print(f"summary {name} K={K}: K5 device ms per launch "
                  + ", ".join(f"{t} {med(r['k5'][t] for r in rs):.4f}"
                              for t in rs[0]["k5"] if t.endswith(f"k{K}")
                              or f"k{K}_" in t)
                  + f"; K5 per frame {med(r['mega'][K]['device_ms'] for r in rs):.3f}"
                  f" ms, frame wall median "
                  f"{med(w for r in rs for w in r['mega'][K]['walls']):.4f} s; "
                  "K7 ms per launch " + ", ".join(
                      f"{t} {med(r['k7'][K][t] for r in rs):.4f}"
                      for t in ("main", "exit_found", "exit_medium",
                                "exit_gate") if t in rs[0]["k7"][K])
                  + (f" (gated exit bit-equal to the masked one: "
                     f"{all(r['k7'][K]['exit_gate_same'] for r in rs)})"
                     if "exit_gate" in rs[0]["k7"][K] else "")
                  + f" ({rs[0]['k7'][K]['live']} live lanes, "
                  f"{rs[0]['k7'][K]['exit_medium_lanes']} with a medium hit); "
                  "tiled frame K7 main "
                  f"{med(r['tiled'][K]['k7_main_ms'] for r in rs):.3f} + exit "
                  f"{med(r['tiled'][K]['k7_exit_ms'] for r in rs):.3f} ms, K8 "
                  f"{med(r['tiled'][K]['device_ms']['tiled_trip'] for r in rs):.3f}"
                  f" ms, trav_steps {rs[0]['tiled'][K]['trav_steps']}, wall "
                  f"median {med(w for r in rs for w in r['tiled'][K]['walls']):.4f}"
                  " s", flush=True)
    ok = ok and all(k7.get("exit_gate_same", True) for r in runs
                    for k7 in r["k7"].values())
    if runs:
        first = runs[0]["hash"]
        for tag in first:
            same = all(r["hash"].get(tag) == first[tag] for r in runs)
            print(f"bit-equal {tag}: {same} across {len(runs)} runs",
                  flush=True)
            ok = ok and same
    return 0 if ok else 1


def _tiled_summary(built, runs, ok) -> int:
    med = statistics.median
    for d in built:
        rs = [r for r in runs if r["dir"] == d]
        if not rs:
            continue
        name = os.path.basename(d)
        for K in ("4", "8"):
            t = [r["tiled"][K] for r in rs]
            print(f"summary {name} K={K}: K8 device ms per frame "
                  + ", ".join(f"{x['device_ms']['tiled_trip']:.3f}" for x in t)
                  + f" (bound {t[0]['k8_bound_frame_ms']:.3f}); K7 "
                  + ", ".join(f"{x['device_ms']['closest_hit']:.3f}" for x in t)
                  + "; spawn " + ", ".join(
                      f"{x['device_ms']['tiled_spawn']:.3f}" for x in t)
                  + "; walls " + ", ".join(f"{w:.4f}" for x in t
                                           for w in x["walls"])
                  + f" (median {med(w for x in t for w in x['walls']):.4f})"
                  + "; K8 on the 3-trip state " + ", ".join(
                      f"{x['k8_three_trip_ms']:.4f}" for x in t)
                  + f" ({t[0]['three_trip_live']} live); capture s "
                  + ", ".join(f"{x['capture_s']:.4f}" for x in t)
                  + f"; captures over two frames "
                  f"{[x['captures_two_frames'] for x in t]}, kept frame = "
                  f"fresh {[x['kept_frame_same'] for x in t]}", flush=True)
            print(f"summary {name} K={K} per trip: " + "; ".join(
                f"{i + 1}: {med(x['k8_per_trip_ms'][i] for x in t):.4f} ms "
                f"(bound {t[0]['k8_bound_per_trip_ms'][i]:.4f}), live "
                f"{t[0]['live_per_trip'][i][0]}, per warp "
                f"{t[0]['warp'][i]['live_per_warp']:.1f} / "
                f"{t[0]['warp'][i]['fam_per_warp']:.2f} fam, sorted "
                f"{t[0]['warp'][i]['sorted_live_per_warp']:.1f} / "
                f"{t[0]['warp'][i]['sorted_fam_per_warp']:.2f}"
                for i in range(len(t[0]["k8_per_trip_ms"]))), flush=True)
        ok = ok and all(x.get("kept_frame_same") in (None, True)
                        for r in rs for x in r["tiled"].values())
    if runs:
        first = runs[0]["hash"]
        for tag in first:
            same = all(r["hash"].get(tag) == first[tag] for r in runs)
            print(f"bit-equal {tag}: {same} across {len(runs)} runs",
                  flush=True)
            ok = ok and same
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] in (["--build"], ["--side"], ["--tiled-side"],
                         ["--traffic-side"], ["--spawn-side"],
                         ["--gather-side"]):
        sys.path.insert(0, os.getcwd())
        sys.exit({"--build": build_side, "--side": measure_side,
                  "--tiled-side": tiled_side,
                  "--traffic-side": traffic_side,
                  "--spawn-side": spawn_side,
                  "--gather-side": gather_side}[sys.argv[1]]())
    sys.path.insert(0, _REPO)
    sys.exit(main(sys.argv[1:]))
