"""A/B of the wavefront's kernels (K1-K4) between checkouts, on one card.

    path_tracer_tpu_torch/scripts/ab_smoke.sh prepare HEAD    # in git
    python path_tracer_tpu_torch/scripts/wave_ab.py build/ab/parent build/ab/change

Each argument is a checkout of the repo (``ab_smoke.sh prepare`` unpacks the
parent and the working tree into ``build/ab/``).  The script builds each
checkout's wavefront kernels from its own ``csrc/`` (``trace_step``,
``shade``, ``retire``, ``spawn`` and ``wave_loop``; one ``nvcc`` per source,
every checkout's builds started together) and counts K1's global loads by
width in its SASS (``cuobjdump -sass``).  Then it runs one process per
checkout in the order 1 .. n, n .. 1; each

- holds K1 (one wave of a mid-frame pool of the main configuration, node
  widths 4 and 8) against its twin: lanes, stack and counters exact; and K4
  on that pool's control wave against its twin: counters, histogram,
  per-pixel paths, flags and occupancy exact, frame allclose;
- times K4 and ``index_add_`` (the frame scatter alone) on that state in
  device ms per launch: 20 launches on 20 copies captured in one CUDA
  graph, the replay timed with CUDA events, median of 5;
- renders vol2_final_scene(sphere_cluster=1000) at 800x450, 10 spp, depth
  10 through the device wave loop (queue 32768, 32 steps per wave) at node
  widths 4 and 8: three frame walls, then one frame under torch.profiler,
  the device ms and runs of each kernel (runs held equal to launches).

It prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run and a summary (medians per checkout), and writes every record to
``chiprun_out/wave_ab.json``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import time

WAVE = ("trace_step", "shade", "retire", "spawn")
KERNEL_NAMES = WAVE + ("wave_loop",)
W, H, SPP, DEPTH = 800, 450, 10, 10
QUEUE, STEPS = 32768, 32
N_GRAPH = 20
_HERE = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _wave_kernels_only(kernels) -> None:
    """Make ``kernels.build`` compile and load the wavefront's sources only."""
    kernels.SOURCES = WAVE + ("wave_loop",)
    kernels.NAMES = WAVE
    kernels.OWN_API = {"wave_loop": "wave_loop"}
    kernels.SOURCE_OF = {n: n for n in WAVE} | kernels.OWN_API


def build_side() -> int:
    from path_tracer_tpu_torch.ops import kernels
    _wave_kernels_only(kernels)
    t0 = time.perf_counter()
    kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": {
        n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for n, log in kernels.BUILD_LOG.items() if n in ("trace_step", "retire")
    }}), flush=True)
    return 0


def _graph_ms(calls, restore=None, reps=5):
    """Device ms per call: ``calls`` captured in one CUDA graph, the replay
    timed with CUDA events (``restore`` untimed before each), median."""
    import torch
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    times = []
    for _ in range(reps):
        if restore is not None:
            restore()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / len(calls))
    return statistics.median(times)


def measure_side() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels, traverse
    from path_tracer_tpu_torch.ops import wavefront as wf
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import (C_DO_CTRL, FL_FINISHED,
                                                 RenderConfig)
    from path_tracer_tpu_torch.utils import rng
    _wave_kernels_only(kernels)
    kernels.build()

    dev = torch.device("cuda")
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    cam.samples_per_pixel, cam.max_depth = SPP, DEPTH
    scene = ptt.compile_scene(world, device=dev)
    flags = SceneFlags.from_scene(scene)
    cam_a = cam.initialize(device=dev)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH)
    key = rng.key(0, device=dev)
    rec = {"dir": os.getcwd(), "k1_exact": {}, "frames": {}}
    for K in (4, 8):
        bvh = ptt.build_from_scene(scene, K)
        eng = wf.WaveEngine(scene, flags, bvh, cam_a, cfg, 0, SPP, key,
                            queue_size=QUEUE, steps_per_wave=STEPS,
                            ctrl_den=8)
        ws = eng.init_state(torch.zeros((H, W, 3), device=dev))
        for _ in range(48):                       # a mid-frame pool
            for op in wf.KERNELS:
                op(eng, ws)
        k1, p1 = ws.clone(), ws.clone()
        kernels.launch("trace_step", eng, k1)
        traverse.trace_step_plain(eng, p1)
        torch.cuda.synchronize()
        rec["k1_exact"][K] = all(torch.equal(getattr(k1, f), getattr(p1, f))
                                 for f in ("cur", "stack", "sp", "best_t",
                                           "best_pt", "best_pi", "ctr"))
        if K == 4:
            # K4 on the control wave of that pool
            k1.ctr[C_DO_CTRL] = 1
            wf.KERNELS[1](eng, k1)
            snap = k1.clone()
            k4, p4 = snap.clone(), snap.clone()
            kernels.launch("retire", eng, k4)
            wf.retire_plain(eng, p4)
            torch.cuda.synchronize()
            rec["k4_exact"] = (
                all(torch.equal(getattr(k4, f), getattr(p4, f)) for f in
                    ("ctr", "depth_hist", "pix_paths", "flag", "occupied"))
                and torch.allclose(k4.accum, p4.accum, rtol=1e-4, atol=1e-6))
            rec["k4_finished"] = int((snap.flag == FL_FINISHED).sum())
            copies = [snap.clone() for _ in range(N_GRAPH)]
            args = [kernels.make_args(eng, c) for c in copies]

            def restore():
                for c in copies:
                    for f in ("flag", "occupied", "ctr", "depth_hist",
                              "pix_paths", "accum"):
                        getattr(c, f).copy_(getattr(snap, f))

            rec["k4_graph_ms"] = _graph_ms(
                [lambda c=c, a=a: kernels.launch("retire", eng, c, args=a)
                 for c, a in zip(copies, args)], restore)
            m = snap.flag == FL_FINISHED                  # paths that retire
            if eng.multi:
                m &= ~(snap.sample < snap.last)
            idx = snap.pixel[m].long()
            src = snap.color[m].contiguous()
            accs = [snap.accum.clone() for _ in range(N_GRAPH)]
            rec["index_add_graph_ms"] = _graph_ms(
                [lambda acc=acc: acc.index_add_(0, idx, src) for acc in accs])
            del copies, args, accs
        del ws, k1, p1

        def frame():
            return wf.render_batch(scene, flags, bvh, cam_a, cfg,
                                   torch.zeros((H, W, 3), device=dev), 0,
                                   SPP, key, queue_size=QUEUE,
                                   steps_per_wave=STEPS, with_stats=True)
        frame()                                   # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = frame()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frame()
            torch.cuda.synchronize()
        ms = dict.fromkeys(KERNEL_NAMES, 0.0)
        runs = dict.fromkeys(KERNEL_NAMES, 0)
        for ev in prof.key_averages():
            for n in KERNEL_NAMES:
                if f"{n}_kernel" in ev.key:
                    ms[n] += ev.device_time_total / 1e3
                    runs[n] += ev.count
        rec["frames"][K] = dict(
            walls=walls, device_ms=ms, runs=runs,
            launches={n: kernels.LAUNCHES[n] for n in KERNEL_NAMES},
            waves=int(st["waves"]), rays=int(st["rays"]),
            trav_steps=int(st["trav_steps"]))
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
    out_all = {"card": card, "builds": {}, "sass": {}, "runs": []}
    ok = True
    for d, p in builds.items():
        out, _ = p.communicate()
        print(f"build {d}: rc {p.returncode}\n{out[-3000:]}", flush=True)
        out_all["builds"][d] = out[-3000:]
        ok = ok and p.returncode == 0
    if not ok:
        return 1
    from path_tracer_tpu_torch.ops import kernels
    for d in dirs:
        so = glob.glob(os.path.join(d, "build", "torch_ext", "trace_step-*.so"))
        out_all["sass"][d] = kernels.sass_global_loads(max(so, key=os.path.getmtime))
        print(f"sass {d}: K1 global loads by bits {out_all['sass'][d]}",
              flush=True)
    for d in dirs + dirs[::-1]:
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
    with open(os.path.join(_REPO, "chiprun_out", "wave_ab.json"), "w") as f:
        json.dump(out_all, f, indent=1)
    for d in dirs:
        rs = [r for r in out_all["runs"] if r["dir"] == d]
        if not rs:
            continue
        for K in ("4", "8"):
            med = {n: statistics.median(r["frames"][K]["device_ms"][n]
                                        for r in rs) for n in KERNEL_NAMES}
            wall = statistics.median(w for r in rs
                                     for w in r["frames"][K]["walls"])
            print(f"summary {os.path.basename(d)} K={K}: device ms per frame "
                  + ", ".join(f"{n} {v:.3f}" for n, v in med.items())
                  + f"; wall median {wall:.4f} s; K1 exact "
                  f"{all(r['k1_exact'][K] for r in rs)}", flush=True)
        print(f"summary {os.path.basename(d)}: K4 exact "
              f"{all(r['k4_exact'] for r in rs)}, graph ms per launch K4 "
              + ", ".join(f"{r['k4_graph_ms']:.4f}" for r in rs)
              + ", index_add_ " + ", ".join(f"{r['index_add_graph_ms']:.4f}"
                                           for r in rs), flush=True)
        ok = ok and all(r["k4_exact"] and all(r["k1_exact"].values())
                        for r in rs)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] in (["--build"], ["--side"]):
        sys.path.insert(0, os.getcwd())
        sys.exit(build_side() if sys.argv[1] == "--build" else measure_side())
    sys.path.insert(0, _REPO)
    sys.exit(main(sys.argv[1:]))
