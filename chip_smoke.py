"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device     — require CUDA; print the card's name and power limit.
2. build      — compile the five CUDA kernels (one nvcc per source, all
                started together) and print the build seconds and ptxas
                resources.
3. kernels    — at the full configuration's shapes (vol2_final_scene,
                800x450, depth 10, 32768 slots, 32 steps per wave) hold each
                wavefront kernel against its plain-torch twin on the same
                wave state; hold K5 (megakernel) against its twin on one
                800x450 sample, per pixel; hold K3 (shade) against its twin
                on a mid-flight wave state of mesh_perlin_sss at 400x225,
                and K5 against its twin on one 400x225 sample of it: both
                run the SSS walk there; time each (CUDA events, median of
                25 launches).
4. main       — render vol2_final_scene(sphere_cluster=1000) at 800x450,
                10 spp, depth 10 through Renderer(engine="wavefront") after a
                warm-up; print wall time, Mrays/s, waves and host reads,
                three frame walls, and per-kernel device time of another
                frame (torch.profiler) with the device idle share.
5. main-mega  — the same frame through Renderer(engine="megakernel").
6. main-sss   — mesh_perlin_sss at 400x225, 64 spp, depth 12, through both
                engines, with the SSS walk counter.
7. agree      — kernel paths vs twin paths on the card at 160x90, 2 spp: the
                graded image agreement of tools/bench_ab.py and exact
                counters, for the wavefront on vol2_final and
                mesh_perlin_sss and the megakernel on both; and the
                megakernel's image against the wavefront kernels' image.
8. the JSON kernel table, then the JSON result line.

Each main phase sets the launch counts to 0 just before it renders and
reads them just after; the table's ``launches`` come from those runs.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
}
WAVE_KERNELS = ("trace_step", "spawn", "shade", "retire")
BOUNCE_OPS = 600 + 12 * 110    # fp32 ops of one bounce (threefry at 110)
WALK_TRIP_OPS = 3 * 110 + 60   # one SSS walk trip


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def graded_agreement(a, b):
    """tools/bench_ab.py:74-89: outlier pixels (> 1e-3) ≤ 1%, clean mean < 1e-5."""
    per_pix = np.abs(a - b).max(axis=-1)
    outliers = float((per_pix > 1e-3).mean())
    clean = per_pix[per_pix <= 1e-3]
    clean_mean = float(clean.mean()) if clean.size else 0.0
    return outliers <= 0.01 and clean_mean < 1e-5, outliers, clean_mean


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
    if st.pixel_paths is not None:            # the wavefront counts per pixel
        assert (st.pixel_paths == spp).all(), "per-pixel path count != spp"
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
    # device time of each kernel by name.
    from torch.profiler import ProfilerActivity, profile
    r2 = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r2.render(spp=spp, batch=spp)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    totals, counts = {}, {}
    for ev in prof.key_averages():
        for n in names:
            if ev.key.startswith(f"{n}_kernel"):
                totals[n] = totals.get(n, 0.0) + ev.device_time_total / 1e3
                counts[n] = counts.get(n, 0) + ev.count
    assert all(totals.get(n, 0.0) > 0.0 for n in names), \
        f"profiler saw no device time for some kernel: {totals}"
    busy = sum(totals.values())
    idle = 1 - busy / (1e3 * prof_wall)
    phase(tag, "per-kernel device ms over one frame (torch.profiler): "
          + ", ".join(f"{n}={totals.get(n, 0.0):.2f} ({counts.get(n, 0)} "
                      f"launches)" for n in names)
          + f"; kernels {busy:.2f} ms of {1e3 * prof_wall:.2f} ms wall under "
          f"the profiler (device idle share {idle:.3f})")
    return dict(r=r, img=img, wall=wall, walls=walls, mrays_ub=mr_ub,
                mrays_measured=mr_meas, rays=st.rays, walk_steps=st.walk_steps,
                waves=st.waves, ctrls=st.ctrls, host_reads=st.host_reads,
                launches=launches, kernel_totals_ms=totals,
                profiled_wall_ms=1e3 * prof_wall, idle_share=idle)


def main() -> int:
    # --- 1. device ---
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    phase("device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    os.makedirs(RUN_DIR, exist_ok=True)

    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import integrator, kernels, wavefront as wf
    from path_tracer_tpu_torch.ops import shade_tiled, traverse
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import (C_DEPTH_SUM, C_DO_CTRL,
                                                 C_DONE, C_N_OCC, C_RAYS,
                                                 C_STACK_OVF, C_TRAV_STEPS,
                                                 C_WALK_STEPS, FL_FINISHED,
                                                 FL_RESAMPLE, MAT_SSS_SIMPLE,
                                                 MAT_SSS_VOLUMETRIC, PH_EXIT,
                                                 RenderConfig)
    from path_tracer_tpu_torch.render.renderer import Renderer
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
    eng = wf.WaveEngine(scene, flags, bvh, cam_a, cfg, 0, SPP, key,
                        queue_size=32768, steps_per_wave=32, ctrl_den=8)
    phase("kernels", f"R={eng.R} stride={eng.stride} sd={eng.sd} "
          f"nodes={tuple(bvh.nodes.shape)} max_stack={bvh.max_stack}")
    ws = eng.init_state(torch.zeros((H, W, 3), device=dev))
    for _ in range(48):                       # a mid-flight pool
        for op in wf.KERNELS:
            op(eng, ws)
    torch.cuda.synchronize()

    results = {}
    fields_int = ("cur", "sp", "best_pt", "best_pi")

    def restore(dst, src):
        for f in src.__dataclass_fields__:
            getattr(dst, f).copy_(getattr(src, f))

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
    ok = frac >= 0.9999 and float(rel.max()) <= 1e-5 and bool(
        k_ws.ctr[C_DO_CTRL] == p_ws.ctr[C_DO_CTRL])
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
    phase("kernels", f"trace_step: match {frac:.6f} of lanes, best_t max rel "
          f"{float(rel.max()):.2e}, {ms:.3f} ms (twin {pms:.2f} ms) "
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
    byts = n_ready * (2 * 96 + 72 + 32 + 36 + 12)
    ops = n_ready * (600 + 12 * 110)
    results["shade"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms, bytes=byts,
                            ops=ops, library_ms=None)
    phase("kernels", f"shade: {n_ready} ready lanes, alive/depth/flag match "
          f"{frac:.6f}, float max abs err {err:.2e}, {ms:.3f} ms "
          f"(twin {pms:.2f} ms) {'PASS' if ok else 'FAIL'}")

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
    byts = n_fin * (4 + 12 + 4 * 5) + int(retire_m.sum()) * 24
    ops = n_fin * 10
    results["retire"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms, bytes=byts,
                             ops=ops, library_ms=lms)
    phase("kernels", f"retire: {n_fin} finished, accum max abs err {err:.2e}, "
          f"counters/hist exact {ok}, {ms:.3f} ms (twin {pms:.2f} ms, "
          f"index_add_ {lms:.3f} ms) {'PASS' if ok else 'FAIL'}")

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
    n_new = int(mk.sum())
    byts = n_new * (12 * 4 + 4 * 10 + 4)
    ops = n_new * (6 * 110 + 60)
    results["spawn"] = dict(ok=ok, err=err, ms=ms, plain_ms=pms, bytes=byts,
                            ops=ops, library_ms=None)
    phase("kernels", f"spawn: {n_new} renewed slots, items equal {ok_items}, "
          f"uniforms bit-equal and rays rel err {err:.2e}, {ms:.3f} ms "
          f"(twin {pms:.2f} ms) {'PASS' if ok else 'FAIL'}")
    del ws, snap, k_ws, p_ws, k3, p3, k4, p4, k2, p2, work
    torch.cuda.empty_cache()

    def mega_pair(meng, w, h):
        """K5 and its twin on sample 0 from a zero frame: the share of pixels
        with equal iters and depth, the graded colour rule, the counters and
        depth histogram (exact: both sides round alike, --fmad=false, the same
        libdevice functions); then K5's time."""
        zero = torch.zeros((h, w, 3), device=dev)
        mk, mp = meng.init_state(zero), meng.init_state(zero)
        integrator.megakernel(meng, mk, 0)
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
        out["ms"] = cuda_ms(lambda: integrator.megakernel(meng, mk, 0))
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
    big = bv_q.nodes.shape[0] >= 256
    qeng = wf.WaveEngine(sc_q, fl_q, bv_q, ca_q, cf_q, 0, QSPP, key,
                         queue_size=32768 if big else 8192,
                         steps_per_wave=32 if big else 12, ctrl_den=8)
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

    # --- 4. the main path through the public entry points ---
    rec = {}
    rec["main"] = frame_phase(
        "main", lambda: Renderer(world, cam, engine="wavefront", device=dev),
        W, H, SPP, DEPTH, WAVE_KERNELS, kernels)
    png = os.path.join(RUN_DIR, "vol2_final_800x450_10spp.png")
    rec["main"].pop("r").write_image(png)
    phase("main", f"image mean {float(rec['main'].pop('img').mean()):.5f}, "
          f"written to {png}")

    # --- 5. the megakernel on the same frame ---
    rec["main-mega"] = frame_phase(
        "main-mega",
        lambda: Renderer(world, cam, engine="megakernel", device=dev),
        W, H, SPP, DEPTH, ("megakernel",), kernels)
    png = os.path.join(RUN_DIR, "vol2_final_800x450_10spp_mega.png")
    rec["main-mega"].pop("r").write_image(png)
    phase("main-mega", f"image mean "
          f"{float(rec['main-mega'].pop('img').mean()):.5f}, written to {png}")

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

    # --- 8. the kernel table ---
    launches = dict(rec["main"]["launches"])
    launches["megakernel"] = rec["main-mega"]["launches"]["megakernel"]
    table = []
    for n, (srcf, repl) in KERNELS.items():
        res = results[n]
        t_bytes = res["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = res["ops"] / H100_F32_OPS_PER_S * 1e3
        table.append({
            "name": n, "route": "cuda", "source": srcf, "replaces": repl,
            "launches": launches[n], "max_abs_err": res["err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": res["library_ms"], "pass": bool(res["ok"])})
    with open(os.path.join(RUN_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "frames": rec,
                   "shade_sss": results["shade"]["sss"],
                   "megakernel_sss": results["megakernel"]["sss"],
                   "kernels": table},
                  f, indent=1)
    failed = [t["name"] for t in table if not t["pass"]]
    print(json.dumps({"kernels": table}), flush=True)
    if failed or not agree:
        print(f"chip_smoke: FAILED {failed} agree={agree}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
