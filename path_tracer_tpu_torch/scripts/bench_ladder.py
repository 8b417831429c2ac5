"""The BASELINE.json config ladder on one card: Mrays/s per config.

    python path_tracer_tpu_torch/scripts/bench_ladder.py [--spp-cap N]
        [--json out.json] [--cpu]

The port of ``tools/bench_ladder.py``: the five ``BASELINE.json`` configs at
their own sizes, spp and depths, with that tool's pool sizes, each through
``wavefront.render_batch`` (K1-K4 in the device wave loop on the card): one
warm-up batch into a throwaway frame, then every sample of the config in
batches of 9 (the last one shorter), timed from the first launch to the
last synchronize.  Prints one JSON line per config: the wall, ms a sample,
upper-bound Mrays/s (pixels x spp x depth / wall, ``bench.py``'s count) and
measured Mrays/s (the traced segments the render counted / wall), waves,
host reads, paths, stack overflows, SSS walk steps where the scene has them,
and the card's ``nvidia-smi`` name and power limit.  ``--cpu`` runs the
plain-torch twins (slow; for a check at ``--spp-cap 1``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# (name, scene, W, H, spp, depth, queue, steps): tools/bench_ladder.py:23-43
CONFIGS = [
    # 1: "wavefront_comparison scene: few spheres, Lambertian+Metal,
    #     200x150 @ 16 spp"
    ("1_wavefront_comparison", "wavefront_comparison", 200, 152, 16, 10,
     8192, 12),
    # 2: "Glass + emissive Cornell-style scene with depth-of-field,
    #     400x300 @ 64 spp"
    ("2_cornell_glass_dof", "cornell_glass_dof", 400, 300, 64, 20, 16384, 16),
    # 3: "Random-spheres scene (~500 prims) exercising SAH BVH + motion
    #     blur" (vol2_sec2_6, the book's moving random spheres)
    ("3_motion_blur_500", "vol2_sec2_6", 400, 224, 32, 16, 32768, 32),
    # 4: "OBJ mesh scene with Perlin textures and subsurface scattering"
    ("4_mesh_perlin_sss", "mesh_perlin_sss", 400, 224, 32, 12, 32768, 32),
    # 5: "vol2_final_scene: 1000+ objects with volumetric fog/smoke,
    #     800x600 @ 256 spp"
    ("5_vol2_final", "vol2_final_scene", 800, 600, 256, 10, 32768, 32),
]
BATCH = 9
STACK_DEPTH = 32


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def setup(scene_name, W, H, spp, depth, device="cuda"):
    """(scene, flags, bvh, camera arrays, config, key) of one config."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng

    world, cam = ptt.scenes.SCENES[scene_name]()
    cam.aspect_ratio, cam.img_width = W / H, W
    cam.samples_per_pixel, cam.max_depth = spp, depth
    scene = ptt.compile_scene(world, device=device)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_depth=depth, stack_depth=STACK_DEPTH)
    return (scene, SceneFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=device), cfg, rng.key(0, device=device))


def run_config(name, scene_name, W, H, spp, depth, queue, steps,
               spp_cap=None, device="cuda"):
    """Render one config → (JSON row, (H, W, 3) mean image on the device,
    the inputs of :func:`setup`)."""
    from path_tracer_tpu_torch.ops import wavefront

    spp = min(spp, spp_cap) if spp_cap else spp
    inputs = setup(scene_name, W, H, spp, depth, device)
    scene, flags, bvh, cam, cfg, key = inputs

    def run(acc, s0, n):
        return wavefront.render_batch(scene, flags, bvh, cam, cfg, acc, s0,
                                      n, key, queue_size=queue,
                                      steps_per_wave=steps, with_stats=True)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    zero = torch.zeros((H, W, 3), device=device)
    run(zero, 0, min(BATCH, spp))                       # warm-up
    sync()
    out, tot, done = zero, {}, 0
    t0 = time.perf_counter()
    while done < spp:
        n = min(BATCH, spp - done)
        out, st = run(out, done, n)
        for k in ("paths", "rays", "waves", "host_reads", "walk_steps",
                  "stack_overflows"):
            tot[k] = tot.get(k, 0) + int(st[k])
        done += n
    sync()
    wall = time.perf_counter() - t0
    row = {
        "config": name, "scene": scene_name, "res": f"{W}x{H}", "spp": spp,
        "depth": depth, "queue": queue, "steps": steps,
        "wall_s": wall, "ms_per_sample": 1e3 * wall / spp,
        "mrays_ub": W * H * spp * depth / wall / 1e6,
        "mrays_measured": tot["rays"] / wall / 1e6,
        "segments": tot["rays"], "paths": tot["paths"],
        "waves": tot["waves"], "host_reads": tot["host_reads"],
        "stack_overflows": tot["stack_overflows"], "card": card()}
    if tot["walk_steps"]:
        row["walk_steps"] = tot["walk_steps"]
        row["mwork_measured"] = (tot["rays"] + tot["walk_steps"]) / wall / 1e6
    return row, out / spp, inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp-cap", type=int, default=None,
                    help="cap each config's spp")
    ap.add_argument("--json", default=None, help="write the rows here too")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain-torch twins on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("bench_ladder: no CUDA device (--cpu for the twins)",
              file=sys.stderr)
        return 2
    rows = []
    for c in CONFIGS:
        row, img, _ = run_config(*c, spp_cap=args.spp_cap, device=device)
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"{c[0]}: non-finite pixels")
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
