"""A/B of K6 (adjoint) and K9 (ring_hop) between checkouts, on one card.

    path_tracer_tpu_torch/scripts/ab_smoke.sh prepare HEAD    # in git
    python path_tracer_tpu_torch/scripts/adj_ab.py build/ab/parent build/ab/change

Each argument is a checkout of the repo (``ab_smoke.sh prepare`` unpacks the
parent and the working tree into ``build/ab/``; a design variant is a copy
of one with one ``#define`` or call edited).  The script builds each
checkout's ``adjoint.cu``, ``closest_hit.cu`` and ``tiled_trip.cu`` from its
own ``csrc/`` (one ``nvcc`` per source, every checkout's builds started
together) and prints their ptxas resources.  Then it runs one process per
checkout in the order 1 .. n, n .. 1 (``--once``: 1 .. n); each

- launches K6 on sample 0 with one random delta (seed 3): the colour
  instantiation on cornell_box 800x800 (depth 6) and on vol2_final_scene
  (sphere_cluster=1000) 800x450 (depth 10) at node widths 4 and 8, the full
  one on vol2_final at widths 4 and 8, with the per-pixel buffers
  (``max_stack`` and ``stack_depth`` 70) at width 4, and on mesh_perlin_sss
  400x225 (depth 12): device ms per launch (10 launches queued behind a
  spin kernel, CUDA events), the backward of a 4-spp train step (samples
  0-3) for the colour Cornell and the full vol2_final rows, the counter
  vector's fetch and ticket entries after the launches (0 in a kernel that
  leaves them clean), and the per-leaf gradients;
- runs K9 over the torus knot of ``tests/test_tp_scale.py`` sharded two
  ways, on the camera rays of an 800x800 frame: hop 0 on shard 0 from the
  empty bundle, hop 1 on shard 1 with hop 0's bundle, at widths 4 and 8 and
  with a 70-entry stack at width 4: device ms of each hop (the carried
  bundle restored before each launch, its copy timed alone and taken off),
  traversal steps of each hop, and a hash of the bundle after each.

It prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run, a summary (medians per checkout), K6's per-leaf relative L2 of every
run against the first run (float atomics add in another order every run, so
K6 is compared with a tolerance, not bit for bit) and, per K9 hash and step
count, whether every run of every checkout gave the first one's; the
records go to ``chiprun_out/adj_ab.json``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

SOURCES = ("adjoint", "closest_hit", "tiled_trip")
NAMES = ("adjoint", "adjoint_full", "closest_hit", "ring_hop", "tiled_trip",
         "tiled_trip_rec", "tiled_spawn")
DEEP = 70
N_QUEUED = 10
SPIN_CYCLES = 200_000_000
SPIN_MS_MIN = 40.0          # the spin lasts at least this long (<= 5 GHz)
STEP_SPP = 4                # K6 launches in the backward of a train step
_HERE = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _these_kernels_only(kernels) -> None:
    """Make ``kernels.build`` compile and load K6's, K7/K9's and K8's
    sources."""
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
        if n in ("adjoint", "closest_hit")}}), flush=True)
    return 0


def _hash(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_ms(fn, setup=None, n=N_QUEUED):
    """Device ms per call of ``fn``: ``n`` calls queued behind a spin
    kernel, timed with CUDA events; ``setup`` (run before each call) timed
    alone the same way and taken off."""
    import torch

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
            if host_ms < SPIN_MS_MIN * spin / SPIN_CYCLES:
                break
            spin *= 4            # the host was not done before the spin ended
        return e0.elapsed_time(e1) / n

    if setup is None:
        return queued(fn)

    def both():
        setup()
        fn()
    return queued(both) - queued(setup)


def measure_side(grad_path: str) -> int:
    import numpy as np
    import torch

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.models.geometry import torus_knot
    from path_tracer_tpu_torch.ops import adjoint, integrator, kernels
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import C_FETCH, C_TICKET, RenderConfig
    from path_tracer_tpu_torch.ops.types import C_TRAV_STEPS
    from path_tracer_tpu_torch.parallel import pipeline, scene_shard
    from path_tracer_tpu_torch.utils import rng
    _these_kernels_only(kernels)
    kernels.build()

    dev = torch.device("cuda")
    key = rng.key(0, device=dev)

    def setup(world, cam, w, h, depth):
        cam.aspect_ratio, cam.img_width = w / h, w
        scene = ptt.compile_scene(world, device=dev)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=1,
                           max_depth=depth)
        return (scene, SceneFlags.from_scene(scene),
                cam.initialize(device=dev), cfg)

    rec = {"dir": os.getcwd(), "k6": {}, "k6_step": {}, "k6_ctr": {},
           "k9": {}, "k9_steps": {}, "hash": {}}
    grads = {}

    def k6(tag, scene, flags, bvh, cam, cfg, full, step=False):
        eng = integrator.MegaEngine(scene, flags, bvh, cam, cfg, key)
        ms = eng.init_state(torch.zeros((eng.npix, 3), device=dev))
        delta = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (eng.npix, 3)).astype(np.float32)).to(dev)
        g = adjoint.grad_buffers(scene)
        adjoint.adjoint(eng, ms, 0, delta, g, full)
        torch.cuda.synchronize()
        grads[tag] = {n: v.detach().cpu().clone() for n, v in
                      adjoint.leaf_grads(scene, g).items()}
        scratch = adjoint.grad_buffers(scene)
        rec["k6"][tag] = _device_ms(
            lambda: adjoint.adjoint(eng, ms, 0, delta, scratch, full))
        if step:
            def backward():
                for s in range(STEP_SPP):
                    adjoint.adjoint(eng, ms, s, delta, scratch, full)
            rec["k6_step"][tag] = STEP_SPP * _device_ms(backward, n=2)
        torch.cuda.synchronize()
        rec["k6_ctr"][tag] = [int(ms.ctr[C_FETCH]), int(ms.ctr[C_TICKET])]

    vol = setup(*ptt.scenes.vol2_final_scene(sphere_cluster=1000), 800, 450,
                10)
    for K in (4, 8):
        bvh = ptt.build_from_scene(vol[0], K)
        k6(f"colour_vol2_k{K}", vol[0], vol[1], bvh, vol[2], vol[3], False)
        k6(f"full_vol2_k{K}", vol[0], vol[1], bvh, vol[2], vol[3], True,
           step=K == 4)
        if K == 4:
            k6("full_vol2_k4_global", vol[0], vol[1],
               dataclasses.replace(bvh, max_stack=DEEP), vol[2],
               dataclasses.replace(vol[3], stack_depth=DEEP), True)
    del vol, bvh
    corn = setup(*ptt.scenes.cornell_box(), 800, 800, 6)
    k6("colour_cornell_k4", corn[0], corn[1], ptt.build_from_scene(corn[0]),
       corn[2], corn[3], False, step=True)
    sss = setup(*ptt.scenes.mesh_perlin_sss(), 400, 225, 12)
    k6("full_sss_k4", sss[0], sss[1], ptt.build_from_scene(sss[0]), sss[2],
       sss[3], True)
    del corn, sss
    torch.save(grads, grad_path)
    torch.cuda.empty_cache()

    # K9: two hops of the ring over the torus knot sharded two ways.
    world = ptt.HittableList()
    world.add(ptt.Sphere.stationary((0, -1000, 0), 1000,
                                    ptt.Lambertian((0.5, 0.5, 0.5))))
    world.add(torus_knot(ptt.Metal((0.75, 0.65, 0.5), 0.05), segments=400,
                         sides=128, tube_radius=0.35, center=(0.0, 1.6, 0.0)))
    world.add(ptt.Sphere.stationary((0, 7, 4), 2.0,
                                    ptt.DiffuseLight((6, 6, 6))))
    cam = ptt.Camera()
    cam.vfov = 35
    cam.lookfrom = np.array([9.0, 4.5, 7.0])
    cam.lookat = np.array([0.0, 1.4, 0.0])
    knot, fl_k, ca_k, cf_k = setup(world, cam, 800, 800, 4)
    R = cf_k.width * cf_k.height
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    t_min = torch.full((R,), cf_k.t_min, device=dev)
    for K, sd in ((4, None), (8, None), (4, DEEP)):
        tag = f"k{K}" + ("_global" if sd else "")
        sc_t, bv_t = scene_shard.shard_scene(knot, 2, branching=K)
        cfg = cf_k if sd is None else dataclasses.replace(cf_k,
                                                          stack_depth=sd)
        engs = []
        for r in range(2):
            sc_l, bv_l = scene_shard.local_shard(sc_t, bv_t, r)
            if sd is not None:
                bv_l = dataclasses.replace(bv_l, max_stack=sd)
            engs.append(itl.TiledEngine(sc_l, fl_k, bv_l, ca_k, cfg, key))
        st = itl.tiled_spawn(engs[0], 0, pix)
        ray = (st.origin, st.direction, st.time, t_min, st.alive)
        carry = (torch.zeros((R,), dtype=torch.bool, device=dev),
                 torch.full((R,), 1e30, device=dev),
                 pipeline._empty_rec(R, dev))
        for hop, eng in enumerate(engs):
            work = tuple(x.clone() for x in carry)
            ctr = itl.new_counters(dev)
            pipeline.ring_hop(eng, *ray, *work, ctr=ctr)
            torch.cuda.synchronize()
            rec["hash"][f"hop{hop}_{tag}"] = _hash(*work)
            rec["k9_steps"][f"hop{hop}_{tag}"] = int(ctr[C_TRAV_STEPS])
            timed = tuple(x.clone() for x in carry)

            def restore(timed=timed, carry=carry):
                for x, y in zip(timed, carry):
                    x.copy_(y)
            rec["k9"][f"hop{hop}_{tag}"] = _device_ms(
                lambda eng=eng, timed=timed: pipeline.ring_hop(
                    eng, *ray, *timed), setup=restore)
            carry = work
        del engs, st, sc_t, bv_t
        torch.cuda.empty_cache()
    print("RECORD " + json.dumps(rec), flush=True)
    return 0


def _leaf_rel(a, b):
    """Per-leaf relative L2 of gradient dicts ``a`` against ``b`` (leaves
    zero on both sides left out)."""
    out = {}
    for n, y in b.items():
        x = a[n]
        ny = float(y.norm())
        if ny > 0 or float(x.norm()) > 0:
            out[n] = float((x - y).norm()) / max(ny, 1e-30)
    return out


def main(args) -> int:
    import torch
    once = "--once" in args
    dirs = [os.path.abspath(d) for d in args if d != "--once"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    builds = {d: subprocess.Popen([sys.executable, _HERE, "--build"], cwd=d,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for d in dirs}
    out_all = {"card": card, "builds": {}, "runs": [], "leaf_rel": []}
    built = []
    for d, p in builds.items():
        out, _ = p.communicate()
        print(f"build {d}: rc {p.returncode}\n{out[-6000:]}", flush=True)
        out_all["builds"][d] = out[-6000:]
        if p.returncode == 0:
            built.append(d)
    ok = len(built) == len(dirs)
    grad_dir = os.path.join(_REPO, "build", "ab", "grads")
    os.makedirs(grad_dir, exist_ok=True)
    first = None
    for k, d in enumerate(built if once else built + built[::-1]):
        gpath = os.path.join(grad_dir, f"run{k}.pt")
        p = subprocess.run([sys.executable, _HERE, "--side", gpath], cwd=d,
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
        g = torch.load(gpath)
        if first is None:
            first = g
        rel = {tag: _leaf_rel(g[tag], first[tag]) for tag in first}
        worst = {tag: max(v.values(), default=0.0) for tag, v in rel.items()}
        out_all["leaf_rel"].append({"dir": d, "rel": rel, "worst": worst})
        print(f"K6 per-leaf rel L2 against the first run, worst per row: "
              f"{os.path.basename(d)} {json.dumps(worst)}", flush=True)
        ok = ok and all(v <= 1e-3 for v in worst.values())
    os.makedirs(os.path.join(_REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_REPO, "chiprun_out", "adj_ab.json"), "w") as f:
        json.dump(out_all, f, indent=1)
    runs = out_all["runs"]
    med = statistics.median
    for d in built:
        rs = [r for r in runs if r["dir"] == d]
        if not rs:
            continue
        print(f"summary {os.path.basename(d)}: K6 device ms per launch "
              + ", ".join(f"{t} {med(r['k6'][t] for r in rs):.4f}"
                          for t in rs[0]["k6"])
              + "; K6 backward of a 4-spp step "
              + ", ".join(f"{t} {med(r['k6_step'][t] for r in rs):.4f}"
                          for t in rs[0]["k6_step"])
              + f"; fetch/ticket after K6 {rs[0]['k6_ctr']}; K9 device ms "
              + ", ".join(f"{t} {med(r['k9'][t] for r in rs):.4f}"
                          for t in rs[0]["k9"])
              + f"; K9 steps {rs[0]['k9_steps']}", flush=True)
        ok = ok and all(v == [0, 0] for r in rs for v in r["k6_ctr"].values())
    if runs:
        for field in ("hash", "k9_steps"):
            ref = runs[0][field]
            for tag in ref:
                same = all(r[field].get(tag) == ref[tag] for r in runs)
                print(f"equal {field} {tag}: {same} across {len(runs)} runs",
                      flush=True)
                ok = ok and (same or field == "k9_steps")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] in (["--build"], ["--side"]):
        sys.path.insert(0, os.getcwd())
        sys.exit(build_side() if sys.argv[1] == "--build"
                 else measure_side(sys.argv[2]))
    sys.path.insert(0, _REPO)
    sys.exit(main(sys.argv[1:]))
