"""A/B of K5 (megakernel) and K7 (closest_hit) between checkouts, on one card.

    path_tracer_tpu_torch/scripts/ab_smoke.sh prepare HEAD    # in git
    python path_tracer_tpu_torch/scripts/mega_ab.py build/ab/parent build/ab/change

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

It prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run, a summary (medians per checkout) and, per hash, whether every run of
every checkout gave the first one's; every record goes to
``chiprun_out/mega_ab.json``.  Needs a CUDA card and ``nvcc``.
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

SOURCES = ("megakernel", "closest_hit", "tiled_trip")
NAMES = ("megakernel", "closest_hit", "ring_hop", "tiled_trip",
         "tiled_trip_rec", "tiled_spawn")
W, H, SPP, DEPTH = 800, 450, 10, 10
QW, QH, QDEPTH = 400, 225, 12
DEEP = 70
N_QUEUED = 10
SPIN_CYCLES = 200_000_000
_HERE = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _these_kernels_only(kernels) -> None:
    """Make ``kernels.build`` compile and load K5's, K7's and K8's sources."""
    kernels.SOURCES = SOURCES
    kernels.NAMES = NAMES
    kernels.OWN_API = {}
    kernels.SOURCE_OF = {n: kernels.SOURCE_OF[n] for n in NAMES}


def build_side() -> int:
    from path_tracer_tpu_torch.ops import kernels
    _these_kernels_only(kernels)
    t0 = time.perf_counter()
    kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": {
        n: [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for n, log in kernels.BUILD_LOG.items()
        if n in ("megakernel", "closest_hit")}}), flush=True)
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
        integrator.megakernel(eng, ms, 0)
        torch.cuda.synchronize()
        # every counter but the scratch of the work fetch (C_FETCH, 20)
        rec["hash"][tag] = _hash(ms.color, ms.iters, ms.depth, ms.accum,
                                 ms.depth_hist, ms.ctr[:20])
        rec["k5"][tag] = _device_ms(lambda: integrator.megakernel(eng, ms, 0))

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


def main(dirs) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dirs = [os.path.abspath(d) for d in dirs]
    builds = {d: subprocess.Popen([sys.executable, _HERE, "--build"], cwd=d,
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
    for d in built + built[::-1]:
        p = subprocess.run([sys.executable, _HERE, "--side"], cwd=d,
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
    with open(os.path.join(_REPO, "chiprun_out", "mega_ab.json"), "w") as f:
        json.dump(out_all, f, indent=1)
    runs = out_all["runs"]
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


if __name__ == "__main__":
    if sys.argv[1:2] in (["--build"], ["--side"]):
        sys.path.insert(0, os.getcwd())
        sys.exit(build_side() if sys.argv[1] == "--build" else measure_side())
    sys.path.insert(0, _REPO)
    sys.exit(main(sys.argv[1:]))
