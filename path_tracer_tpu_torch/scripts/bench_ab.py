"""Megakernel vs wavefront A/B on one card: walls, speed-up, image agreement.

    python path_tracer_tpu_torch/scripts/bench_ab.py \
        --scene wavefront_comparison --width 400 --spp 8 --depth 10 \
        [--cpu] [--save-dir DIR] [--outlier-bound F]

The port of ``tools/bench_ab.py``: both engines render the same scene
through ``Renderer(..., engine=, seed=0)``, a 1-spp warm-up renderer first
(it builds the kernels and captures the wave loop), then a fresh renderer
timed over ``render(spp=spp, batch=1)`` between ``torch.cuda.synchronize()``
calls.  The engines integrate the same (sample, pixel) set, so their
images must agree under :func:`~..utils.image.graded_agreement`, the
repo's engine oracle.  Prints JAX's result dict as JSON, with the card's
``nvidia-smi`` name and power limit; exits 1 when the images disagree.
``--cpu`` runs the plain-torch twins.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from path_tracer_tpu_torch.scripts.bench_ladder import card  # noqa: E402


def scene_builder(scene_name: str):
    """The catalog scene, or ``vol2_final_scene:N`` for N cluster spheres."""
    from path_tracer_tpu_torch import scenes as S

    if scene_name.startswith("vol2_final_scene:"):
        n = int(scene_name.split(":")[1])
        return lambda: S.vol2_final_scene(sphere_cluster=n)
    return S.SCENES[scene_name]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(scene_name: str, width: int, spp: int, depth: int,
        save_dir: str | None = None, outlier_bound: float = 0.01,
        device="cuda") -> dict:
    """Both engines on ``scene_name`` → JAX's result dict (per engine:
    ``total_s``, ``ms_per_sample``, ``mpix_per_s`` and the four
    ``RenderStats.summary`` keys; ``speedup_wavefront`` and the graded
    agreement's readings), plus ``card``."""
    from path_tracer_tpu_torch.render.renderer import Renderer
    from path_tracer_tpu_torch.utils.image import graded_agreement, write_png

    world, cam = scene_builder(scene_name)()
    cam.img_width = width
    cam.samples_per_pixel = spp
    cam.max_depth = depth

    results = {}
    images = {}
    for engine in ("megakernel", "wavefront"):
        Renderer(world, cam, engine=engine, seed=0,
                 device=device).render(spp=1, batch=1)
        r2 = Renderer(world, cam, engine=engine, seed=0, device=device)
        _sync(device)
        t0 = time.perf_counter()
        img = r2.render(spp=spp, batch=1)
        _sync(device)
        dt = time.perf_counter() - t0
        results[engine] = {
            "total_s": round(dt, 3),
            "ms_per_sample": round(1000 * dt / spp, 2),
            "mpix_per_s": round(width * r2.cfg.height * spp / dt / 1e6, 3),
            **{k: v for k, v in r2.stats.summary(r2.cfg).items()
               if k in ("mrays_per_s", "rays_traced", "mean_path_depth",
                        "mean_occupancy")},
        }
        images[engine] = np.asarray(img)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            write_png(os.path.join(save_dir, f"{scene_name}_{engine}.png"),
                      images[engine], 1)

    diff = np.abs(images["megakernel"] - images["wavefront"])
    per_pix = diff.max(axis=-1)
    agree, outliers, clean_mean = graded_agreement(
        images["megakernel"], images["wavefront"], outlier_bound)
    results["speedup_wavefront"] = round(
        results["megakernel"]["total_s"] / results["wavefront"]["total_s"], 3)
    results["image_max_diff"] = float(diff.max())
    results["image_outlier_frac"] = round(outliers, 5)
    results["image_outlier_frac_1e2"] = round(float((per_pix > 1e-2).mean()), 5)
    results["image_outlier_frac_1e1"] = round(float((per_pix > 1e-1).mean()), 5)
    results["image_clean_mean_diff"] = clean_mean
    results["images_agree"] = bool(agree)
    results["card"] = card()
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="wavefront_comparison")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=10)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--outlier-bound", type=float, default=0.01,
                   help="max fraction of pixels allowed to differ > 1e-3 "
                        "(raise for volumetric scenes at low spp: fog "
                        "free-flight coins are chaotic per path)")
    args = p.parse_args(argv)
    out = run(args.scene, args.width, args.spp, args.depth, args.save_dir,
              args.outlier_bound, device="cpu" if args.cpu else "cuda")
    print(json.dumps({"scene": args.scene, **out}, indent=2))
    return 0 if out["images_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
