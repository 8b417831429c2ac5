"""The port's ``bench.py``: upper-bound Mrays/s of vol2_final on one card.

    python path_tracer_tpu_torch/scripts/bench.py

Renders ``bench.py:104-106``'s configuration, vol2_final_scene(
sphere_cluster=1000) at 800x450, 10 spp, depth 10, stack depth 32, through
the wavefront (``wavefront.render_batch``: K1-K4 in the device wave loop,
queue 32768, 32 steps per wave), with ``bench.py``'s schedule: one warm-up
batch of 9 samples into a throwaway frame, then 9 timed samples in one batch,
then one instrumented sample for the traced-segment count.  The same
schedule then runs the megakernel (``integrator.render_batch``, K5) and the
tiled engine (``integrator_tiled.render_tiled``, K7 + K8 in its kept trip
graph; it renders samples 0-8, so its warm-up renders them too).  Prints
``bench.py``'s one JSON line (``metric``, ``value`` in upper-bound Mrays/s =
pixels x spp x depth / wall, ``unit``, ``vs_baseline``, ``mrays_measured``,
for the wavefront) with a ``megakernel`` and a ``tiled`` entry of the same
two rates (the tiled engine counts no segments: its measured rate takes the
wavefront's count, the same sample set) and the card's ``nvidia-smi`` name
and power limit.  It needs a CUDA card and has no other configuration: a
failure raises.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

BASELINE_MRAYS = 0.80  # bench.py:18, the reference's complex-scene megakernel
W, H, SPP, DEPTH = 800, 450, 10, 10
QUEUE, STEPS, BATCH = 32768, 32, 9


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import integrator, wavefront
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng

    dev = torch.device("cuda")
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    cam.samples_per_pixel, cam.max_depth = SPP, DEPTH
    scene = ptt.compile_scene(world, device=dev)
    bvh = ptt.build_from_scene(scene)
    flags = SceneFlags.from_scene(scene)
    cam_a = cam.initialize(device=dev)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH, stack_depth=32)
    key = rng.key(0, device=dev)
    zero = torch.zeros((H, W, 3), device=dev)

    engines = {
        "wavefront": lambda acc, s0, n: wavefront.render_batch(
            scene, flags, bvh, cam_a, cfg, acc, s0, n, key, queue_size=QUEUE,
            steps_per_wave=STEPS),
        "megakernel": lambda acc, s0, n: integrator.render_batch(
            scene, flags, bvh, cam_a, cfg, acc, s0, n, key),
        "tiled": lambda acc, s0, n: acc + n * ptt.render_tiled(
            scene, flags, bvh, cam_a, cfg, key, spp=n)}
    nb = min(BATCH, max(SPP - 1, 1))
    n_timed = max((SPP // nb) * nb, nb)
    _, stats = wavefront.render_batch(scene, flags, bvh, cam_a, cfg, zero, 0,
                                      1, key, queue_size=QUEUE,
                                      steps_per_wave=STEPS, with_stats=True)
    segments = int(stats["rays"])             # one sample's traced segments
    rates = {}
    for name, run in engines.items():
        run(zero, 0, nb)                               # warm-up
        torch.cuda.synchronize()
        out = zero
        t0 = time.perf_counter()
        for i in range(n_timed // nb):
            out = run(out, i * nb, nb)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"non-finite pixels in the {name} render")
        rates[name] = (W * H * n_timed * DEPTH / dt / 1e6,
                       segments * n_timed / dt / 1e6)
    mrays, mrays_meas = rates["wavefront"]
    print(json.dumps({
        "metric": "mrays_per_s_chip_vol2_final", "value": round(mrays, 3),
        "unit": "Mrays/s", "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "mrays_measured": round(mrays_meas, 3),
        **{n: {"value": round(rates[n][0], 3),
               "mrays_measured": round(rates[n][1], 3)}
           for n in ("megakernel", "tiled")},
        "card": card(), "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
