"""A/B of the wavefront's kernels (K1-K4) between checkouts, on one card.

    path_tracer_tpu_torch/scripts/ab_smoke.sh prepare HEAD    # in git
    python path_tracer_tpu_torch/scripts/wave_ab.py build/ab/parent build/ab/change
    python path_tracer_tpu_torch/scripts/wave_ab.py --states DIR ...   # K3/K2 only
    python path_tracer_tpu_torch/scripts/wave_ab.py --rounds 3 DIR ...

Each argument is a checkout of the repo (``ab_smoke.sh prepare`` unpacks the
parent and the working tree into ``build/ab/``; a design variant is a copy
of one with one line edited).  The script builds each checkout's wavefront
kernels from its own ``csrc/`` (``trace_step``, ``shade``, ``retire``,
``spawn`` and ``wave_loop``; one ``nvcc`` per source, every checkout's
builds started together), counts K1's global loads by width in its SASS
(``cuobjdump -sass``), K3's local loads and stores (``LDL``/``STL``) and
K2's warp votes, population counts, reductions, shuffles and atomics in
the order they appear.  Then it runs one process per checkout in the order
1 .. n, n .. 1 (``--rounds R``: R passes, every other one reversed); each

- makes a mid-frame pool with the plain-torch twins (48 waves and the K1
  wave of the next: the same state in every checkout) and, on its control
  wave, times K3 on that state and K2 on the state after K3 and the twin
  K4: 20 launches on 20 copies in one CUDA graph, the replay timed with
  CUDA events, median of 5, as K4 is timed; it hashes K3's output (every
  field of the ``WaveState``) and holds K2's renewed work items against
  the twin's (the same (sample, pixel) items; the rays' largest
  difference);
- holds K1 (one wave of a mid-frame pool of the main configuration, node
  widths 4 and 8) against its twin: lanes, stack and counters exact; and K4
  on that pool's control wave against its twin: counters, histogram,
  per-pixel paths, flags and occupancy exact, frame allclose;
- times K4 and ``index_add_`` (the frame scatter alone) on that state in
  device ms per launch, in a CUDA graph as above;
- renders vol2_final_scene(sphere_cluster=1000) at 800x450, 10 spp, depth
  10 through the device wave loop (queue 32768, 32 steps per wave) at node
  widths 4 and 8: three frame walls, then one frame under torch.profiler,
  the device ms and runs of each kernel and its launches (the summary
  prints both, with the frame's waves and control waves), and
  hashes of the image and of the integer counters (paths, spawned, rays,
  depth sum, waves, control waves, walk and traversal steps, depth
  histogram, per-pixel paths).

``--states`` builds only K3, K4 and K2 and runs only the twin pool's part:
the mode for variants that break the frame (a split of a kernel's time,
e.g. its bounce compiled out).

It prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run and a summary (medians per checkout; whether every run of every
checkout gave the first run's pool, K3 output and frame hashes), and
writes every record to
``chiprun_out/wave_ab.json``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

from graph_timer import N_GRAPH, graph_ms   # this script's directory

WAVE = ("trace_step", "shade", "retire", "spawn")
CTRL = ("shade", "retire", "spawn")
KERNEL_NAMES = WAVE + ("wave_loop",)
W, H, SPP, DEPTH = 800, 450, 10, 10
QUEUE, STEPS = 32768, 32
N_POOL = 48                 # waves before the measured one
SASS_OPS = ("LDL", "STL", "VOTE", "POPC", "FLO", "REDUX", "SHFL", "ATOMG",
            "ATOM", "ATOMS", "RED", "REDG")
_HERE = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _wave_kernels_only(kernels, states: bool = False) -> None:
    """Make ``kernels.build`` compile and load the wavefront's sources only
    (with ``states``, K3, K4 and K2 alone)."""
    srcs = CTRL if states else WAVE
    kernels.OWN_API = {} if states else {"wave_loop": "wave_loop"}
    kernels.SOURCES = srcs + tuple(kernels.OWN_API)
    kernels.NAMES = srcs
    kernels.SOURCE_OF = {n: n for n in srcs} | kernels.OWN_API


def build_side(states: bool) -> int:
    from path_tracer_tpu_torch.ops import kernels
    _wave_kernels_only(kernels, states)
    t0 = time.perf_counter()
    kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": {
        n: [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "stack frame" in ln
            or "Compiling entry" in ln]
        for n, log in kernels.BUILD_LOG.items()
        if n in WAVE
    }}), flush=True)
    return 0


def sass_ops(so: str) -> dict:
    """Per kernel of the library ``so`` (``cuobjdump -sass``): the count of
    each opcode of ``SASS_OPS`` and the first 64 of them in program order,
    with their modifiers."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    res: dict = {}
    fn = None
    for line in out.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            fn = text.split(":", 1)[1].strip()
            res[fn] = {"counts": collections.Counter(), "order": []}
            continue
        m = re.match(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)"
                     r"((?:\.[A-Z0-9_]+)*)", text)
        if fn is None or m is None or m.group(1) not in SASS_OPS:
            continue
        res[fn]["counts"][m.group(1)] += 1
        if len(res[fn]["order"]) < 64:
            res[fn]["order"].append(m.group(1) + m.group(2))
    return {f: {"counts": dict(v["counts"]), "order": v["order"]}
            for f, v in res.items() if v["counts"]}


def _hash(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _state_hash(ws) -> str:
    """Hash of every field of a wave state."""
    return _hash(*(getattr(ws, f.name) for f in dataclasses.fields(ws)))


def _kernel_graph_ms(kernels, eng, name, snap):
    """Device ms of kernel ``name`` on ``snap``: N_GRAPH launches on as many
    copies in one CUDA graph, every copy restored to ``snap`` before each
    replay."""
    copies = [snap.clone() for _ in range(N_GRAPH)]
    args = [kernels.make_args(eng, c) for c in copies]
    fields = [f.name for f in dataclasses.fields(snap)]

    def restore():
        for c in copies:
            for f in fields:
                getattr(c, f).copy_(getattr(snap, f))

    return graph_ms([lambda c=c, a=a: kernels.launch(name, eng, c, args=a)
                     for c, a in zip(copies, args)], restore)


def control_wave(torch, wf, kernels, traverse, eng, types) -> dict:
    """K3 and K2 on the control wave of a pool made by the twins."""
    ws = eng.init_state(torch.zeros((H, W, 3), device=eng.device))
    for _ in range(N_POOL):
        for op in wf.PLAIN:
            op(eng, ws)
    traverse.trace_step_plain(eng, ws)
    ws.ctr[types.C_DO_CTRL] = 1
    s3 = ws.clone()
    out = {"pool_hash": _state_hash(s3),
           "ready": int((s3.occupied & (s3.cur == traverse._DONE)).sum())}
    k3 = s3.clone()
    kernels.launch("shade", eng, k3)
    torch.cuda.synchronize()
    out["k3_hash"] = _state_hash(k3)
    out["k3_graph_ms"] = _kernel_graph_ms(kernels, eng, "shade", s3)
    s2 = k3.clone()
    wf.retire_plain(eng, s2)
    out["k2_graph_ms"] = _kernel_graph_ms(kernels, eng, "spawn", s2)
    out["k4_graph_ms"] = _kernel_graph_ms(kernels, eng, "retire", k3)
    k2, p2 = s2.clone(), s2.clone()
    kernels.launch("spawn", eng, k2)
    wf.spawn_plain(eng, p2)
    torch.cuda.synchronize()

    def items(st):
        m = (s2.flag == types.FL_RESAMPLE) | (~s2.occupied & st.occupied)
        it = st.sample[m].long() * eng.npix + st.pixel[m].long()
        order = torch.argsort(it)
        return m, it[order], order

    mk, ik, ok_ = items(k2)
    mp, ip, op_ = items(p2)
    out["k2_renewed"] = int(mk.sum())
    out["k2_items_equal"] = bool(torch.equal(ik, ip))
    if out["k2_items_equal"] and out["k2_renewed"]:
        out["k2_ray_err"] = max(
            float((getattr(k2, f)[mk][ok_] - getattr(p2, f)[mp][op_])
                  .abs().max()) for f in ("origin", "direction"))
    del ws, s3, k3, s2, k2, p2
    torch.cuda.empty_cache()
    return out


def measure_side(states: bool) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels, traverse, types
    from path_tracer_tpu_torch.ops import wavefront as wf
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import (C_DO_CTRL, FL_FINISHED,
                                                 RenderConfig)
    from path_tracer_tpu_torch.utils import rng
    _wave_kernels_only(kernels, states)
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
    bvh4 = ptt.build_from_scene(scene, 4)
    eng = wf.WaveEngine(scene, flags, bvh4, cam_a, cfg, 0, SPP, key,
                        queue_size=QUEUE, steps_per_wave=STEPS, ctrl_den=8)
    rec["ctrl"] = control_wave(torch, wf, kernels, traverse, eng, types)
    if states:
        print("RECORD " + json.dumps(rec), flush=True)
        return 0
    for K in (4, 8):
        bvh = bvh4 if K == 4 else ptt.build_from_scene(scene, K)
        eng = wf.WaveEngine(scene, flags, bvh, cam_a, cfg, 0, SPP, key,
                            queue_size=QUEUE, steps_per_wave=STEPS,
                            ctrl_den=8)
        ws = eng.init_state(torch.zeros((H, W, 3), device=dev))
        for _ in range(N_POOL):                   # a mid-frame pool
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

            rec["k4_graph_ms"] = graph_ms(
                [lambda c=c, a=a: kernels.launch("retire", eng, c, args=a)
                 for c, a in zip(copies, args)], restore)
            m = snap.flag == FL_FINISHED                  # paths that retire
            if eng.multi:
                m &= ~(snap.sample < snap.last)
            idx = snap.pixel[m].long()
            src = snap.color[m].contiguous()
            accs = [snap.accum.clone() for _ in range(N_GRAPH)]
            rec["index_add_graph_ms"] = graph_ms(
                [lambda acc=acc: acc.index_add_(0, idx, src) for acc in accs])
            del copies, args, accs
        del ws, k1, p1

        def frame():
            return wf.render_batch(scene, flags, bvh, cam_a, cfg,
                                   torch.zeros((H, W, 3), device=dev), 0,
                                   SPP, key, queue_size=QUEUE,
                                   steps_per_wave=STEPS, with_stats=True)
        frame()                                   # warm-up
        # The device loop's graph launch between two CUDA events: the
        # graph's run on the card, gaps and conditional nodes included; the
        # rest of a frame's wall is host work (the graph's build).
        lib = wf._wave_loop_lib()
        launch, evs = lib.ptt_wave_loop_launch, []

        def timed_launch(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = launch(*a)
            e1.record()
            evs.append((e0, e1))
            return r
        lib.ptt_wave_loop_launch = timed_launch
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, st = frame()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        lib.ptt_wave_loop_launch = launch
        g_ms = [e0.elapsed_time(e1) for e0, e1 in evs]
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
        counts = {n: int(st[n]) for n in ("paths", "spawned", "rays",
                                          "depth_sum", "waves", "ctrls",
                                          "walk_steps", "trav_steps")}
        rec["frames"][K] = dict(
            walls=walls, graph_ms=g_ms, device_ms=ms, runs=runs,
            launches={n: kernels.LAUNCHES[n] for n in KERNEL_NAMES},
            waves=int(st["waves"]), rays=int(st["rays"]),
            trav_steps=int(st["trav_steps"]), counters=counts,
            image_hash=_hash(img),
            counter_hash=_hash(torch.tensor(list(counts.values())),
                               st["depth_hist"], st["pixel_paths"]))
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def _same(runs, get) -> bool:
    """Whether every run gave the first run's value."""
    vals = [get(r) for r in runs]
    return all(v == vals[0] for v in vals)


def main(args) -> int:
    states = "--states" in args
    rounds = 2
    if "--rounds" in args:
        rounds = int(args[args.index("--rounds") + 1])
        args = args[:args.index("--rounds")] + args[args.index("--rounds") + 2:]
    dirs = [os.path.abspath(d) for d in args if d != "--states"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    flag = ["--states"] if states else []
    builds = {d: subprocess.Popen([sys.executable, _HERE, "--build", *flag],
                                  cwd=d, stdout=subprocess.PIPE,
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

    def lib(d, n):
        so = glob.glob(os.path.join(d, "build", "torch_ext", f"{n}-*.so"))
        return max(so, key=os.path.getmtime)

    for d in dirs:
        sass = {n: sass_ops(lib(d, n)) for n in ("shade", "spawn")}
        if not states:
            sass["trace_step_loads"] = kernels.sass_global_loads(
                lib(d, "trace_step"))
        out_all["sass"][d] = sass
        print(f"sass {d}: {json.dumps(sass)}", flush=True)
    order = [x for r in range(rounds) for x in (dirs if r % 2 == 0
                                                else dirs[::-1])]
    for d in order:
        p = subprocess.run([sys.executable, _HERE, "--side", *flag], cwd=d,
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
    runs = out_all["runs"]
    for d in dirs:
        rs = [r for r in runs if r["dir"] == d]
        if not rs:
            continue
        name = os.path.basename(d)
        print(f"summary {name}: control wave ({rs[0]['ctrl']['ready']} ready "
              f"lanes, {rs[0]['ctrl']['k2_renewed']} renewed) graph ms per "
              "launch K3 " + ", ".join(f"{r['ctrl']['k3_graph_ms']:.4f}"
                                       for r in rs)
              + "; K2 " + ", ".join(f"{r['ctrl']['k2_graph_ms']:.4f}"
                                    for r in rs)
              + f"; K2 items equal {all(r['ctrl']['k2_items_equal'] for r in rs)}"
              + "; K4 " + ", ".join(f"{r['ctrl']['k4_graph_ms']:.4f}"
                                    for r in rs), flush=True)
        if states:
            continue
        for K in ("4", "8"):
            med = {n: statistics.median(r["frames"][K]["device_ms"][n]
                                        for r in rs) for n in KERNEL_NAMES}
            wall = statistics.median(w for r in rs
                                     for w in r["frames"][K]["walls"])
            f0 = rs[0]["frames"][K]
            print(f"summary {name} K={K}: device ms per frame "
                  + ", ".join(f"{n} {v:.3f}" for n, v in med.items())
                  + f"; wall median {wall:.4f} s (walls " + ", ".join(
                      f"{w:.4f}" for r in rs for w in r["frames"][K]["walls"])
                  + "); the graph's run ms " + ", ".join(
                      f"{g:.3f}" for r in rs for g in r["frames"][K]["graph_ms"])
                  + f"; K1 exact {all(r['k1_exact'][K] for r in rs)}; "
                  f"waves {f0['counters']['waves']}, ctrls "
                  f"{f0['counters']['ctrls']}, launches {f0['launches']}, "
                  f"profiler runs {f0['runs']}", flush=True)
        print(f"summary {name}: K4 exact "
              f"{all(r['k4_exact'] for r in rs)}, graph ms per launch K4 "
              + ", ".join(f"{r['k4_graph_ms']:.4f}" for r in rs)
              + ", index_add_ " + ", ".join(f"{r['index_add_graph_ms']:.4f}"
                                           for r in rs), flush=True)
        ok = ok and all(r["k4_exact"] and all(r["k1_exact"].values())
                        for r in rs)
    same = {"pool": _same(runs, lambda r: r["ctrl"]["pool_hash"]),
            "k3_output": _same(runs, lambda r: r["ctrl"]["k3_hash"])}
    if not states and runs:
        for K in ("4", "8"):
            same[f"image_k{K}"] = _same(
                runs, lambda r: r["frames"][K]["image_hash"])
            same[f"counters_k{K}"] = _same(
                runs, lambda r: r["frames"][K]["counter_hash"])
    print(f"equal across every run of every checkout: {json.dumps(same)}",
          flush=True)
    ok = ok and all(r["ctrl"]["k2_items_equal"] for r in runs)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] in (["--build"], ["--side"]):
        sys.path.insert(0, os.getcwd())
        states_ = "--states" in sys.argv[2:]
        sys.exit(build_side(states_) if sys.argv[1] == "--build"
                 else measure_side(states_))
    sys.path.insert(0, _REPO)
    sys.exit(main(sys.argv[1:]))
