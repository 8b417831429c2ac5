"""Renderer facade: compile once, render progressively (both engines).

Port of ``path_tracer_tpu/render/renderer.py``: scene compile → BVH build →
device upload in the constructor, then ``render()`` accumulates sample
batches through the megakernel (:func:`~..ops.integrator.render_batch`, the
default engine, as in JAX) or the wavefront
(:func:`~..ops.wavefront.render_batch`, with the JAX ``_render_batch``
presets: queue 32768 / 32 steps per wave for big scenes, 8192 / 12
otherwise).  Not ported yet: checkpoints, metrics files and ``autotune``
(ROADMAP.md A.8); they are absent rather than doing something else.
"""
from __future__ import annotations

import time as _time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.camera import Camera
from ..models.compile import compile_scene
from ..ops import integrator, wavefront
from ..ops.bvh_build import build_from_scene
from ..ops.shade import SceneFlags
from ..ops.types import RenderConfig
from ..utils import rng
from ..utils.image import write_png, write_ppm


@dataclass
class RenderStats:
    """Measured per-run counters (``rays`` = traced segments)."""

    samples: int = 0
    wall_s: float = 0.0
    sample_times: list = field(default_factory=list)
    paths: int = 0
    rays: int = 0
    depth_sum: int = 0
    depth_hist: np.ndarray | None = None
    occ_sum: int = 0
    waves: int = 0
    ctrls: int = 0
    slots: int = 0
    host_reads: int = 0
    walk_steps: int = 0        # SSS-volumetric walk trips (work, not segments)
    pixel_paths: np.ndarray | None = None   # per-pixel paths (wavefront only)

    @property
    def ms_per_sample(self) -> float:
        return 1000.0 * float(np.mean(self.sample_times)) if self.sample_times else 0.0

    def mpix_per_s(self, width: int, height: int) -> float:
        if not self.sample_times:
            return 0.0
        return width * height / float(np.mean(self.sample_times)) / 1e6

    def summary(self, cfg: RenderConfig) -> dict:
        """The JAX renderer's summary fields (``renderer.py:70-100``)."""
        out = {
            "samples": self.samples,
            "wall_s": round(self.wall_s, 3),
            "ms_per_sample": round(self.ms_per_sample, 3),
            "mpix_per_s": round(self.mpix_per_s(cfg.width, cfg.height), 3),
        }
        if len(self.sample_times) >= 2:
            t = np.asarray(self.sample_times)
            out["sample_ms_p50"] = round(1000 * float(np.percentile(t, 50)), 3)
            out["sample_ms_p95"] = round(1000 * float(np.percentile(t, 95)), 3)
            out["sample_cv"] = round(float(t.std() / max(t.mean(), 1e-12)), 4)
        if self.rays:
            out["rays_traced"] = self.rays
            out["mrays_per_s"] = round(self.rays / max(self.wall_s, 1e-9) / 1e6, 3)
            out["mean_path_depth"] = round(self.depth_sum / max(self.paths, 1), 2)
        if self.walk_steps:
            # Walk trips are real work the segment counter does not see.
            out["walk_steps"] = int(self.walk_steps)
            out["mwork_per_s"] = round(
                (self.rays + self.walk_steps) / max(self.wall_s, 1e-9) / 1e6, 3)
        if self.depth_hist is not None:
            out["depth_hist"] = [int(x) for x in self.depth_hist]
        if self.waves and self.slots:
            out["mean_occupancy"] = round(
                self.occ_sum / (self.waves * self.slots), 4)
        return out


# RenderConfig fields that only the wavefront engine reads.
WAVEFRONT_KNOBS = ("sample_stride", "queue_size", "steps_per_wave",
                   "ctrl_den")


class Renderer:
    """Compile once, render progressively on ``device`` (default CUDA).

    The megakernel ignores :data:`WAVEFRONT_KNOBS` and warns when ``cfg``
    sets any of them."""

    ENGINES = ("megakernel", "wavefront")

    def __init__(self, world, camera: Camera, engine: str = "megakernel",
                 cfg: RenderConfig | None = None, seed: int = 0,
                 device="cuda"):
        if engine not in self.ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{self.ENGINES}")
        t0 = _time.perf_counter()
        self.device = torch.device(device)
        self.camera = camera
        self.cfg = cfg or RenderConfig(
            width=camera.img_width, height=camera.img_height,
            samples_per_pixel=camera.samples_per_pixel,
            max_depth=camera.max_depth)
        self.engine = engine
        knobs = [k for k in WAVEFRONT_KNOBS if getattr(self.cfg, k)]
        if engine == "megakernel" and knobs:
            warnings.warn(f"Renderer(engine='megakernel') ignores the "
                          f"wavefront knobs {', '.join(knobs)}", stacklevel=2)
        self.scene = compile_scene(world, device=self.device)
        self.flags = SceneFlags.from_scene(self.scene)
        t1 = _time.perf_counter()
        self.bvh = build_from_scene(self.scene)
        t2 = _time.perf_counter()
        self.cam_arrays = camera.initialize(device=self.device)
        self.key = rng.key(seed, device=self.device)
        self.setup_times = {"scene_compile_s": t1 - t0, "bvh_build_s": t2 - t1}
        self.stats = RenderStats()
        self.accum = torch.zeros((self.cfg.height, self.cfg.width, 3),
                                 dtype=torch.float32, device=self.device)
        self.samples_done = 0

    def render(self, spp: int | None = None, batch: int = 4,
               verbose: bool = False):
        """Accumulate ``spp`` samples; returns the (H, W, 3) mean."""
        spp = spp if spp is not None else self.cfg.samples_per_pixel
        t_start = _time.perf_counter()
        while self.samples_done < spp:
            n = min(batch, spp - self.samples_done)
            t0 = _time.perf_counter()
            self.accum, bstats = _render_batch(
                self.scene, self.flags, self.bvh, self.cam_arrays, self.cfg,
                self.accum, self.samples_done, n, self.key, self.engine)
            self._add_stats(bstats)
            dt = _time.perf_counter() - t0
            self.samples_done += n
            self.stats.sample_times.append(dt / n)
            if verbose:
                print(f"  sample {self.samples_done}/{spp}  "
                      f"{1000 * dt / n:.1f} ms/sample")
        self.stats.samples = self.samples_done
        self.stats.wall_s = _time.perf_counter() - t_start
        return self.image()

    def _add_stats(self, b: dict) -> None:
        s = self.stats
        s.paths += int(b["paths"])
        s.rays += int(b["rays"])
        s.depth_sum += int(b["depth_sum"])
        s.occ_sum += int(b["occ_sum"])
        s.waves += int(b["waves"])
        s.ctrls += int(b["ctrls"])
        s.slots = int(b["slots"])
        s.host_reads += int(b["host_reads"])
        s.walk_steps += int(b["walk_steps"])
        if int(b["stack_overflows"]):
            raise RuntimeError("traversal stack overflowed (pushes dropped)")
        hist = b["depth_hist"].cpu().numpy().astype(np.int64)
        s.depth_hist = hist if s.depth_hist is None else s.depth_hist + hist
        if b["pixel_paths"] is not None:
            pp = b["pixel_paths"].cpu().numpy().astype(np.int64)
            s.pixel_paths = pp if s.pixel_paths is None else s.pixel_paths + pp

    def image(self) -> np.ndarray:
        """Mean radiance so far (H, W, 3) float32."""
        return self.accum.cpu().numpy() / max(self.samples_done, 1)

    def write_image(self, path: str) -> None:
        """PNG or PPM by extension."""
        acc = self.accum.cpu().numpy()
        n = max(self.samples_done, 1)
        (write_ppm if path.endswith(".ppm") else write_png)(path, acc, n)


def _render_batch(scene, flags, bvh, cam, cfg, accum, start_sample,
                  n_samples, key, engine):
    """One batch through the engine → (accum, stats with the same keys)."""
    if engine == "megakernel":
        accum, st = integrator.render_batch(scene, flags, bvh, cam, cfg,
                                            accum, start_sample, n_samples,
                                            key, with_stats=True)
        # ``paths`` is the kernel's count of finished paths; the megakernel
        # keeps no per-pixel count, so ``pixel_paths`` stays None.  Wave and
        # occupancy fields stay 0, as in JAX.
        return accum, dict(st, waves=0, ctrls=0, occ_sum=0, slots=0,
                           host_reads=0, pixel_paths=None)
    big = bvh.nodes.shape[0] >= 256
    queue = cfg.queue_size or (32768 if big else 8192)
    steps = cfg.steps_per_wave or (32 if big else 12)
    kw = {"ctrl_den": cfg.ctrl_den} if cfg.ctrl_den else {}
    if cfg.sample_stride:
        kw["sample_stride"] = cfg.sample_stride
    return wavefront.render_batch(scene, flags, bvh, cam, cfg, accum,
                                  start_sample, n_samples, key,
                                  queue_size=queue, steps_per_wave=steps,
                                  with_stats=True, **kw)


def render_scene(world, camera: Camera, engine: str = "megakernel",
                 spp: int | None = None, seed: int = 0, device="cuda",
                 **kwargs):
    """One-call convenience: compile, render, return (H, W, 3) radiance."""
    r = Renderer(world, camera, engine=engine, seed=seed, device=device)
    return r.render(spp=spp, **kwargs)
