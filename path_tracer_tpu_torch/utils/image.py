"""Image I/O: gamma transform, PNG/PPM writing, texture-image loading.

Replaces the reference's ``util/color.py:14-48`` (gamma-2 + PPM writer) and
``util/rtw_image.py:5-130`` (PIL loader with search paths + magenta fallback).
Port of ``path_tracer_tpu/utils/image.py``: the writers/loaders are host-side
numpy; only :func:`linear_to_gamma` touches tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def linear_to_gamma(linear: torch.Tensor) -> torch.Tensor:
    """Gamma-2 transform (sqrt), matching color.py:17-21."""
    return torch.sqrt(torch.clamp(linear, min=0.0))


def tonemap(accum: np.ndarray, samples: int) -> np.ndarray:
    """accum buffer -> uint8 image: scale by 1/samples, gamma, clip.

    Mirrors ``preview.py:117-132 buffer_to_image`` / ``color.py:24-48``
    (clamp to [0, 0.999] then scale by 256).
    """
    scale = 1.0 / max(int(samples), 1)
    img = np.sqrt(np.maximum(np.asarray(accum, dtype=np.float32) * scale, 0.0))
    return (np.clip(img, 0.0, 0.999) * 256.0).astype(np.uint8)


def write_png(path: str, accum: np.ndarray, samples: int) -> None:
    """Write a PNG via PIL (reference renderer.py:436-442)."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(tonemap(accum, samples), mode="RGB").save(path)


def write_ppm(path: str, accum: np.ndarray, samples: int) -> None:
    """Write a text PPM (reference color.py:24-48 / camera.py:141-143)."""
    img = tonemap(accum, samples)
    h, w = img.shape[:2]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in img:
            f.write("\n".join(f"{r} {g} {b}" for r, g, b in row))
            f.write("\n")


def graded_agreement(a, b, outlier_bound: float = 0.01):
    """The engines' graded agreement rule (``tools/bench_ab.py:74-89``) →
    ``(agree, outlier_frac, clean_mean)``.

    Two images of one sample set agree when at most ``outlier_bound`` of
    the pixels differ by more than 1e-3 (a path that went another way moves
    its pixel by a whole path's radiance) and the other pixels' mean
    per-pixel max |diff| is below 1e-5 (float accumulation order)."""
    per_pix = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    outliers = float((per_pix > 1e-3).mean())
    clean = per_pix[per_pix <= 1e-3]
    clean_mean = float(clean.mean()) if clean.size else 0.0
    return (outliers <= outlier_bound and clean_mean < 1e-5, outliers,
            clean_mean)


_SEARCH_DEPTH = 6


def load_image(filename: str) -> np.ndarray | None:
    """Load an image file to float32 [0,1] RGB, searching like the reference.

    Search order (rtw_image.py:14-43): the literal path, ``$RTW_IMAGES``, then
    ``images/`` walking up to 6 parent directories.  Returns ``None`` when not
    found; callers substitute the magenta fallback (rtw_image.py:120-127).
    """
    candidates = [filename]
    env_dir = os.environ.get("RTW_IMAGES", "")
    if env_dir:
        candidates.append(os.path.join(env_dir, filename))
    # Repo-root-relative (so "assets/images/x.jpg" works from any cwd).
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates.append(os.path.join(pkg_root, filename))
    prefix = "images"
    for _ in range(_SEARCH_DEPTH):
        candidates.append(os.path.join(prefix, filename))
        prefix = os.path.join("..", prefix)
    for cand in candidates:
        if os.path.isfile(cand):
            try:
                from PIL import Image

                with Image.open(cand) as im:
                    arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
                return arr
            except Exception:
                return None
    return None


MAGENTA = np.array([1.0, 0.0, 1.0], dtype=np.float32)
