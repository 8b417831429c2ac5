"""Sweep of the wavefront's pool size and steps a wave on one card.

    python path_tracer_tpu_torch/scripts/bench_queue_sweep.py [--cpu]
        [queue:steps ...]          e.g. 32768:16 65536:16

The port of ``tools/bench_queue_sweep.py`` on its configuration:
vol2_final_scene (``sphere_cluster=1000``) at 800x450, 10 spp, depth 10,
``stack_depth=32``, key 0, through ``wavefront.render_batch`` (K1-K4 in
the device wave loop).  For each ``(queue, steps)``: one warm-up sample
(sample 0; its first run builds the kernels and captures the loop, so its
seconds are reported where JAX reports its compile), then samples 1-9
timed between ``torch.cuda.synchronize()`` calls.  Prints one line per
configuration: upper-bound Mrays/s (pixels x depth / wall), ms a sample,
the first run's seconds and the mean |Δ| of the image to the first
configuration's (pools reorder float adds only), then the waves the first
sample took (each wave pays a fixed launch and barrier cost), after the card's
``nvidia-smi`` name and power limit.  The defaults are JAX's (16384, 16),
(32768, 16), (65536, 16) and (65536, 24).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

W, H, SPP, DEPTH = 800, 450, 10, 10
CONFIGS = [(16384, 16), (32768, 16), (65536, 16), (65536, 24)]


def setup(width=W, height=H, spp=SPP, depth=DEPTH, device="cuda"):
    """(scene, flags, bvh, camera arrays, config) of the sweep's frame."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig

    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio = width / height
    cam.img_width = width
    cam.samples_per_pixel = spp
    cam.max_depth = depth
    scene = ptt.compile_scene(world, device=device)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth, stack_depth=32)
    return (scene, SceneFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=device), cfg)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(scene, flags, bvh, cam, cfg, queue, steps):
    """One configuration → (upper-bound Mrays/s, s a sample, first run's
    s, the (H, W, 3) mean image, the first sample's waves).  The frame
    comes from ``cfg``."""
    from path_tracer_tpu_torch.ops import wavefront
    from path_tracer_tpu_torch.utils import rng

    dev = scene.sph_c0.device
    key = rng.key(0, device=dev)
    spp = cfg.samples_per_pixel

    def step(acc, s0, with_stats=False):
        return wavefront.render_batch(scene, flags, bvh, cam, cfg, acc, s0,
                                      1, key, queue_size=queue,
                                      steps_per_wave=steps,
                                      with_stats=with_stats)

    accum = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    out, stats = step(accum, 0, with_stats=True)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in range(1, spp):
        out = step(out, s)
    _sync(dev)
    dt = time.perf_counter() - t0
    img = out.cpu().numpy() / spp
    assert np.isfinite(img).all()
    mrays_ub = cfg.width * cfg.height * (spp - 1) * cfg.max_depth / dt / 1e6
    return mrays_ub, dt / (spp - 1), first_s, img, int(stats["waves"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs="*", help="queue:steps")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    cfgs = [tuple(map(int, a.split(":"))) for a in args.configs] or CONFIGS
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --cpu for the twins)", file=sys.stderr)
        return 2
    from path_tracer_tpu_torch.scripts.bench_ladder import card
    print(card(), flush=True)
    inputs = setup(device=device)
    ref_img = None
    for queue, steps in cfgs:
        mrays_ub, s_sample, first_s, img, waves = run(*inputs, queue, steps)
        if ref_img is None:
            ref_img, agree = img, 0.0
        else:                   # another pool reorders float adds only
            agree = float(np.abs(img - ref_img).mean())
        print(f"queue={queue:6d} steps={steps:2d}  {mrays_ub:7.2f} Mrays/s "
              f"(ub: pixels x depth)  {s_sample * 1e3:8.3f} ms/sample  "
              f"(first run {first_s:.2f} s, mean|Δ|={agree:.2e}; {waves} "
              f"waves a sample)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
