"""The JAX package's golden images, held against the port.

    python path_tracer_tpu_torch/scripts/golden.py [--cpu] [--engine E]
        [names...]

``tests/golden/<name>.npz`` holds the JAX wavefront's image of each case of
``tests/test_golden.py``: fixed scenes, key 123, a 2048-slot pool, 8 steps a
wave.  The files need no JAX to read, so the same check runs on the card.
:data:`CASES` is that file's table through the port's scenes, :func:`render`
its ``_render`` (``engine="megakernel"`` renders the same sample set through
K5), and :func:`golden_close` its ``_assert_golden_close``: the worst 1% of
pixels trimmed, a mean |diff| below 3e-5 over the rest, at most 1% of
pixels beyond 1e-4.  The goldens are read in place and never written.

The two vol2_final cases are held to :func:`vol2_final_close` instead.
Some of their paths carry radiance that differs from JAX's by more than
1e-4.  Each was traced on the CPU (ROADMAP.md C): JAX run op by op
(``jax.disable_jit``) with ``lax.rsqrt`` replaced by the port's ``1 /
sqrt`` gives the port's radiance bit for bit, so what differs is XLA's CPU
code: multiply-adds contracted into FMAs (the marble sphere's Perlin
turbulence turns one-ulp hit points into 1e-3 of radiance; a grazing hit
moves by 1e-2) and its rsqrt, an x86 estimate refined by two Newton steps,
one ulp off ``1 / sqrt`` on 36.5% of inputs.  A share :data:`PATH_RATE` of
the paths differs so (measured at 32x32, 4 spp,
``tests/test_torch_golden.py``), and at 32 spp one pixel in fourteen holds
such a path, beyond JAX's 1% share; ``vol2_final_small``'s golden also
differs from today's JAX in 4 of 576 pixels.  So the rule holds the clean
pixels, the share of pixels that hold a differing path, and the image's
signed mean, each to what that evidence allows.

Prints one JSON line per case and engine: the trimmed mean, the share of
pixels beyond 1e-4, the signed mean of the difference and the verdict;
exits 1 if any case fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
KEY, QUEUE, STEPS = 123, 2048, 8

# name -> (scene, scene kwargs, width, spp, depth): tests/test_golden.py:40-61
CASES = {
    "wavefront_comparison": ("wavefront_comparison", {}, 32, 4, 6),
    "cornell_box": ("cornell_box", {}, 24, 4, 6),
    "cornell_smoke": ("cornell_smoke", {}, 24, 4, 8),
    "vol2_sec2_6_motion_dof": ("vol2_sec2_6", {}, 32, 4, 6),
    "subsurface": ("subsurface_scattering", {}, 24, 4, 8),
    "vol2_final_small": ("vol2_final_scene", {"sphere_cluster": 40}, 24, 2, 6),
    "vol2_final_mid": ("vol2_final_scene", {"sphere_cluster": 300}, 128, 32,
                       8),
    "mesh_hipoly": ("mesh_hipoly", {}, 32, 2, 6),
}
VOL2_FINAL = ("vol2_final_small", "vol2_final_mid")

# JAX's rule (tests/test_golden.py:83-104).
TRIM, MEAN_LIMIT, OUTLIER_AT, OUTLIER_SHARE = 0.99, 3e-5, 1e-4, 0.01
# The vol2_final rule: the clean-pixel limit of the graded rule
# (tools/bench_ab.py:86-89); the share of paths whose radiance differs from
# JAX's by more than 1e-4, measured on the CPU at 0.26% (vol2_final_small)
# to 0.415% (the 32x32 frame at 40 to 1,000 cluster spheres, depth 8 or 12),
# and the margin on it.
CLEAN_LIMIT = 1e-5
PATH_RATE = 0.004
RATE_MARGIN = 1.5


def setup(name, device="cuda"):
    """(scene, flags, bvh, camera arrays, config) of case ``name``."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig

    scene_name, kw, width, spp, depth = CASES[name]
    world, cam = ptt.scenes.SCENES[scene_name](**kw)
    cam.img_width = width
    cam.samples_per_pixel = spp
    cam.max_depth = depth
    height = max(1, int(width / cam.aspect_ratio))
    scene = ptt.compile_scene(world, device=device)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth)
    return (scene, SceneFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=device), cfg)


def render(name, engine="wavefront", device="cuda"):
    """Case ``name`` through the port (JAX's ``_render``) → the (H, W, 3)
    mean as numpy."""
    from path_tracer_tpu_torch.ops import integrator, wavefront
    from path_tracer_tpu_torch.utils import rng

    scene, flags, bvh, cam, cfg = setup(name, device)
    spp = cfg.samples_per_pixel
    accum = torch.zeros((cfg.height, cfg.width, 3), device=device)
    key = rng.key(KEY, device=device)
    if engine == "wavefront":
        out = wavefront.render_batch(scene, flags, bvh, cam, cfg, accum, 0,
                                     spp, key, queue_size=QUEUE,
                                     steps_per_wave=STEPS)
    elif engine == "megakernel":
        out = integrator.render_batch(scene, flags, bvh, cam, cfg, accum, 0,
                                      spp, key)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return out.cpu().numpy() / spp


def load(name) -> np.ndarray:
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as z:
        return z["img"]


def golden_close(img, ref):
    """JAX's ``_assert_golden_close`` → ``(ok, trimmed_mean,
    outlier_frac)``: the mean of the per-pixel max |diff| over the best 99%
    of pixels below 3e-5, at most 1% of pixels beyond 1e-4, every value
    finite, the shapes equal."""
    if img.shape != ref.shape:
        return False, float("inf"), 1.0
    dpix = np.abs(img - ref).max(axis=-1).ravel()
    keep = max(1, int(np.ceil(dpix.size * TRIM)))
    mean = float(np.sort(dpix)[:keep].mean())
    outliers = float((dpix > OUTLIER_AT).mean())
    ok = (bool(np.isfinite(img).all()) and mean < MEAN_LIMIT
          and outliers <= OUTLIER_SHARE)
    return ok, mean, outliers


def outlier_limit(spp: int, rate: float = PATH_RATE,
                  margin: float = RATE_MARGIN) -> float:
    """The share of pixels that may hold a diverted path: ``1 - (1 -
    r)^spp`` at ``r = margin * rate``."""
    return 1.0 - (1.0 - margin * rate) ** spp


def vol2_final_close(img, ref, spp: int):
    """The rule of the two vol2_final cases → ``(ok, reading)``:

    * the clean pixels (every channel within 1e-4 of the golden) agree to
      rounding: their mean |diff| is below :data:`CLEAN_LIMIT`;
    * the share of pixels beyond 1e-4 is at most :func:`outlier_limit`
      (each holds at least one differing path);
    * the signed mean of the difference lies within three standard errors
      of the signed mean that the pixels beyond 1e-4 alone give: the clean
      pixels carry no bias beyond their own rounding noise."""
    d = img.astype(np.float64) - ref.astype(np.float64)
    npix = d.shape[0] * d.shape[1]
    flat = d.reshape(npix, -1)
    out = np.abs(flat).max(axis=-1) > OUTLIER_AT
    clean = flat[~out]
    clean_mean = float(np.abs(clean).mean()) if clean.size else 0.0
    frac = float(out.mean())
    signed = float(d.mean())
    from_outliers = float(flat[out].sum() / d.size)
    se = (float(clean.std() * np.sqrt(clean.size)) / d.size
          if clean.size else 0.0)
    limit = outlier_limit(spp)
    ok = (img.shape == ref.shape and bool(np.isfinite(img).all())
          and clean_mean < CLEAN_LIMIT and frac <= limit
          and abs(signed - from_outliers) <= 3.0 * se)
    return ok, dict(clean_mean=clean_mean, outlier_frac=frac,
                    outlier_limit=limit, signed_mean=signed,
                    signed_from_outliers=from_outliers, signed_se=se)


def check(name, img):
    """Case ``name``'s image against its golden → (ok, reading dict)."""
    ref = load(name)
    ok_j, mean, frac = golden_close(img, ref)
    reading = dict(case=name, trimmed_mean=mean, outlier_frac=frac,
                   signed_mean=float((img.astype(np.float64) - ref).mean()),
                   jax_rule=ok_j)
    if name in VOL2_FINAL:
        ok, extra = vol2_final_close(img, ref, CASES[name][3])
        reading.update(extra, rule="vol2_final")
    else:
        ok = ok_j
        reading["rule"] = "jax"
    reading["ok"] = bool(ok)
    return bool(ok), reading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", default=sorted(CASES))
    p.add_argument("--engine", default="wavefront",
                   choices=("wavefront", "megakernel"))
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --cpu for the twins)", file=sys.stderr)
        return 2
    all_ok = True
    for name in args.names:
        ok, reading = check(name, render(name, args.engine, device))
        all_ok &= ok
        print(json.dumps(dict(reading, engine=args.engine)), flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
