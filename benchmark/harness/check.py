"""Whether what the timed path produced is correct.

For a progressive render the timed path produces the frame's per-pixel
radiance sums over samples ``0 .. n-1``.  Once the window has closed and
the program is freed, a sample of frame pixels drawn from the seed is
rendered again by the plain reference (:mod:`reference`) over the same
samples, and the sums are compared:

``frame_l1_gap`` — ``sum |frame - reference| / sum |reference|`` over the
sampled pixels and their three channels.  A path that turns another way
at a rounding tie moves its pixel by about one path's radiance, so sound
runs read about twice the share of such paths; black pixels, which agree
trivially, add nothing to either sum.

The number of pixels is the cell's ``paths_budget`` over the samples (at
least ``min_pixels``), so the reference's time stays below the window's.
"""
from __future__ import annotations

import time

import torch


def sample_pixels(seed: int, npix: int, count: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return torch.randperm(npix, generator=g)[:count]


def reference_sums(desc, config, seed, pixels, samples, device,
                   dtype=torch.float32):
    from reference import scene as rscene
    from reference import tracer
    sc = rscene.compile_desc(desc, device=device, dtype=dtype)
    ig = config.get("integrator", {})
    cfg = tracer.Integrator(width=config["width"], height=config["height"],
                            max_depth=config["max_depth"], **ig)
    return tracer.render_pixels(sc, desc.camera, cfg, seed, pixels,
                                range(samples), dtype=dtype)


def pixel_count(limits: dict, npix: int, samples: int) -> int:
    """Pixels compared: the cell's ``paths_budget`` over the samples, at
    least ``min_pixels``, at most the frame."""
    return min(npix, max(int(limits["min_pixels"]),
                         int(limits["paths_budget"]) // max(samples, 1)))


def l1_gap(frame_px: torch.Tensor, ref: torch.Tensor) -> float:
    """The compared number (see the module docstring); inf where the
    frame holds a value that is not finite."""
    f = frame_px.double().cpu()
    r = ref.double().cpu()
    if not bool(torch.isfinite(f).all()):
        return float("inf")
    return float((f - r).abs().sum() / r.abs().sum().clamp(min=1e-30))


def check_frame(output: dict, limits: dict, device) -> tuple:
    """→ (correct, numbers {name: {"value", "limit"}}, facts)."""
    t0 = time.perf_counter()
    n = int(output["samples"])
    npix = output["width"] * output["height"]
    count = pixel_count(limits, npix, n)
    pixels = sample_pixels(output["seed"], npix, count)
    frame_px = output["frame"].index_select(0, pixels.to(output["frame"].device))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_sums(output["desc"], output["config"], output["seed"],
                         pixels, n, device)
    value = l1_gap(frame_px, ref)
    lim = float(limits["frame_l1_gap"]["limit"])
    numbers = {"frame_l1_gap": {"value": value, "limit": lim}}
    diff = (frame_px.double().cpu() - ref.double().cpu()).abs().sum(1)
    worst = int(diff.argmax())
    facts = {"pixels": count, "samples": n,
             "reference_s": time.perf_counter() - t0,
             "worst_pixel": int(pixels[worst]),
             "worst_pixel_l1": float(diff[worst]),
             "reference_l1": float(ref.double().abs().sum())}
    return value <= lim, numbers, facts
