"""Renderer facade: compile once, render progressively (both engines).

Port of ``path_tracer_tpu/render/renderer.py``: scene compile → BVH build →
device upload in the constructor, then ``render()`` accumulates sample
batches through the megakernel (:func:`~..ops.integrator.render_batch`, the
default engine, as in JAX) or the wavefront
(:func:`~..ops.wavefront.render_batch`, with the pool of
:func:`wave_preset`: on a card as many slots as K1 keeps resident there,
on the CPU JAX's ``_render_batch`` presets, queue 32768 / 32 steps per
wave for big scenes, 8192 / 12 otherwise; or the values
:meth:`Renderer.autotune` measured).

The progressive state ``(accum, samples_done, key)`` is written to a
checkpoint (JAX's npz fields) every ``checkpoint_every`` samples, at the end
and on ``KeyboardInterrupt``; a render given an existing checkpoint resumes
from it, and refuses one of another resolution, scene, camera or
configuration.  ``metrics_path`` appends one JSON line per batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time as _time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.camera import Camera
from ..models.compile import compile_scene
from ..ops import integrator, kernels, wavefront
from ..ops.bvh_build import build_from_scene
from ..ops.shade import SceneFlags
from ..ops.types import STATS, RenderConfig
from ..utils import rng
from ..utils.image import write_png, write_ppm
from ..utils.spans import count, span


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
        self._tuned = None       # (queue, steps, ctrl_den, stride): autotune
        self.tuning = None       # autotune's probe, candidates and choice

    # --- wavefront engine tuning -----------------------------------------
    def autotune(self, verbose: bool = False, samples: int = 2):
        """Pick the wavefront's ``(queue, steps, ctrl_den, stride)`` for this
        scene: one stats probe of one sample at the preset predicts them
        (:func:`predict_tuning`, JAX's rule), then the prediction and the
        preset are each timed over ``max(2, samples)`` samples and the
        faster is kept.  Values pinned in ``cfg`` hold in every candidate.
        On the card each candidate's first render pays its build and graph
        capture; the second, between two ``torch.cuda.synchronize()``, is
        timed.  Records ``self.tuning`` and returns the choice; on the
        megakernel it warns and returns None."""
        if self.engine != "wavefront":
            warnings.warn("Renderer.autotune tunes the wavefront's slot pool; "
                          "Renderer(engine='megakernel') ignores it",
                          stacklevel=2)
            return None
        cfg = self.cfg
        resident = kernels.resident_lanes(self.device, self.bvh.branching)
        preset = tuning_preset(cfg, self.bvh.nodes.shape[0], resident)

        def run_batch(q, s, d, stride, n, with_stats=False):
            scratch = torch.zeros_like(self.accum)
            return wavefront.render_batch(
                self.scene, self.flags, self.bvh, self.cam_arrays, cfg,
                scratch, 0, n, self.key, queue_size=q, steps_per_wave=s,
                ctrl_den=d, sample_stride=stride, with_stats=with_stats)

        _, st = run_batch(*preset, 1, with_stats=True)
        probe = {k: int(st[k]) for k in PROBE_COUNTERS}
        predicted, reading = predict_tuning(cfg, preset, probe)
        if verbose:
            print(f"  autotune probe: occ={reading['occ']:.2f} steps/seg="
                  f"{reading['steps_seg']:.1f} waves={reading['waves']} "
                  f"ctrls={reading['ctrls']} -> predict q={predicted[0]} "
                  f"s={predicted[1]} den={predicted[2]} "
                  f"stride={predicted[3]}")
        n_t = max(2, samples)
        timed = {}
        for cand in dict.fromkeys([predicted, preset]):
            run_batch(*cand, n_t)                    # build, capture, warm
            _sync(self.device)
            t0 = _time.perf_counter()
            run_batch(*cand, n_t)
            _sync(self.device)
            timed[cand] = (_time.perf_counter() - t0) / n_t
            if verbose:
                print(f"  autotune q={cand[0]} s={cand[1]} den={cand[2]} "
                      f"stride={cand[3]}: {timed[cand] * 1e3:.1f} ms/sample")
        self._tuned = min(timed, key=timed.get)
        self.tuning = dict(probe=probe, reading=reading, preset=preset,
                           predicted=predicted,
                           ms_per_sample={c: 1e3 * t for c, t in timed.items()},
                           chosen=self._tuned)
        return self._tuned

    # --- progressive rendering -------------------------------------------
    def render(self, spp: int | None = None, batch: int = 4,
               checkpoint_path: str | None = None, checkpoint_every: int = 0,
               metrics_path: str | None = None, verbose: bool = False,
               autotune: bool = False):
        """Accumulate ``spp`` samples (resumable); returns the (H, W, 3)
        mean.  An existing ``checkpoint_path`` is resumed from; the state is
        saved there every ``checkpoint_every`` samples, at the end and on
        ``KeyboardInterrupt`` (then re-raised).  ``autotune`` runs
        :meth:`autotune` first unless it ran or ``cfg`` pins the queue and
        the steps; on the megakernel it warns.  Host time is timed by the
        spans of :mod:`..utils.spans`: ``renderer.render`` (the loop, the
        saves and the frame's return), and inside it ``renderer.batch``
        (``renderer.wait``, ``renderer.stats_read``) and
        ``renderer.frame_return``."""
        spp = spp if spp is not None else self.cfg.samples_per_pixel
        if checkpoint_path and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)
        if autotune and (self.engine != "wavefront" or (
                self._tuned is None and not (self.cfg.queue_size
                                             and self.cfg.steps_per_wave))):
            self.autotune(verbose=verbose)
        t_start = _time.perf_counter()
        with span("renderer.render"):
            try:
                self._render_loop(spp, batch, checkpoint_path,
                                  checkpoint_every, metrics_path, verbose)
            except KeyboardInterrupt:
                if checkpoint_path:
                    self.save_checkpoint(checkpoint_path)
                raise
            self.stats.samples = self.samples_done
            self.stats.wall_s = _time.perf_counter() - t_start
            if checkpoint_path:
                self.save_checkpoint(checkpoint_path)
            with span("renderer.frame_return"):
                return self.image()

    def _render_loop(self, spp, batch, checkpoint_path, checkpoint_every,
                     metrics_path, verbose):
        while self.samples_done < spp:
            n = min(batch, spp - self.samples_done)
            with span("renderer.batch") as sp:
                accum, bstats = _render_batch(
                    self.scene, self.flags, self.bvh, self.cam_arrays,
                    self.cfg, self.accum, self.samples_done, n, self.key,
                    self.engine, tuned=self._tuned)
                with span("renderer.wait"):
                    _sync(self.device)
                with span("renderer.stats_read"):
                    self._add_stats(bstats)
                # One commit: an interrupt leaves no uncounted samples in
                # accum.
                self.accum, self.samples_done = accum, self.samples_done + n
            dt = sp.seconds
            self.stats.sample_times.append(dt / n)
            if verbose:
                print(f"  sample {self.samples_done}/{spp}  "
                      f"{1000 * dt / n:.1f} ms/sample  "
                      f"{self.cfg.width * self.cfg.height * n / dt / 1e6:.2f}"
                      f" Mpix/s")
            if metrics_path:
                self._log_metrics(metrics_path, n, dt)
            if (checkpoint_path and checkpoint_every
                    and self.samples_done % checkpoint_every == 0):
                self.save_checkpoint(checkpoint_path)

    def _add_stats(self, b: dict) -> None:
        """Add a batch's stats to ``self.stats``; on the wavefront also to
        the counters of :mod:`..utils.spans`: ``wavefront.waves``,
        ``wavefront.live_lanes`` (occupied slots at each wave's start,
        summed) and ``wavefront.slot_waves`` (slots x waves).  The counter
        vector comes over in one copy and the depth histogram in one more
        where the engine hands them on the device (the megakernel); the
        wavefront hands them on the host."""
        s = self.stats
        ctr = b["ctr"].tolist()
        c = {name: ctr[i] for name, i in STATS.items()}
        occ, waves = c["occ_sum"], c["waves"]
        s.paths += c["paths"]
        s.rays += c["rays"]
        s.depth_sum += c["depth_sum"]
        s.occ_sum += occ
        s.waves += waves
        s.ctrls += c["ctrls"]
        s.slots = int(b["slots"])
        s.host_reads += int(b["host_reads"])
        s.walk_steps += c["walk_steps"]
        if c["stack_overflows"]:
            raise RuntimeError("traversal stack overflowed (pushes dropped)")
        hist = b["depth_hist"].cpu().numpy().astype(np.int64)
        s.depth_hist = hist if s.depth_hist is None else s.depth_hist + hist
        if self.engine == "wavefront":
            count("wavefront.waves", waves)
            count("wavefront.live_lanes", occ)
            count("wavefront.slot_waves", s.slots * waves)

    def image(self) -> np.ndarray:
        """Mean radiance so far (H, W, 3) float32."""
        return self.accum.cpu().numpy() / max(self.samples_done, 1)

    def write_image(self, path: str) -> None:
        """PNG or PPM by extension."""
        acc = self.accum.cpu().numpy()
        n = max(self.samples_done, 1)
        (write_ppm if path.endswith(".ppm") else write_png)(path, acc, n)

    # --- checkpoint / resume ----------------------------------------------
    def _fingerprint(self) -> str:
        """sha256 of the scene, camera and configuration of this render
        (:func:`fingerprint`)."""
        return fingerprint(self.scene, self.cam_arrays, self.cfg)

    def save_checkpoint(self, path: str) -> None:
        """Write ``accum`` (H, W, 3) float32, ``samples_done``, ``key`` (the
        (2,) uint32 key data) and ``fingerprint``, JAX's npz fields,
        through a ``.tmp.npz`` file and ``os.replace``."""
        save_npz(path, accum=self.accum.cpu().numpy(),
                 samples_done=self.samples_done,
                 key=self.key.cpu().numpy().astype(np.uint32),
                 fingerprint=self._fingerprint())

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``path``; raises ``ValueError`` for a checkpoint of
        another resolution (naming both shapes) or of another scene, camera
        or configuration (the fingerprint)."""
        with np.load(path) as z:
            accum = z["accum"]
            expected = (self.cfg.height, self.cfg.width, 3)
            if accum.shape != expected:
                raise ValueError(
                    f"checkpoint {path!r} has accum shape {accum.shape}, but "
                    f"this renderer is configured for {expected}: it belongs "
                    "to a different render configuration")
            if "fingerprint" in z:
                saved, mine = str(z["fingerprint"]), self._fingerprint()
                if saved != mine:
                    raise ValueError(
                        f"checkpoint {path!r} was written by a different "
                        f"scene/camera/config (fingerprint {saved[:12]}… != "
                        f"{mine[:12]}…): resuming it here would blend two "
                        "different renders")
            self.accum = torch.from_numpy(accum.astype(np.float32)).to(
                self.device)
            self.samples_done = int(z["samples_done"])
            self.key = torch.from_numpy(z["key"].astype(np.int64)).to(
                self.device)

    def _log_metrics(self, path: str, n: int, dt: float) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({
                "ts": _time.time(), "samples_done": self.samples_done,
                "batch": n, "batch_s": round(dt, 4),
                "mpix_per_s": round(
                    self.cfg.width * self.cfg.height * n / dt / 1e6, 3),
            }) + "\n")


def fingerprint(scene, cam, cfg, *extra) -> str:
    """sha256 over the compiled scene's tensors and the camera arrays (each
    field in declaration order: its name, shape and bytes, from a CPU copy),
    ``repr(cfg)`` and ``repr(extra)``: the same on every rank of a job.
    ``cfg`` includes the camera's sample count, as in JAX, so a checkpoint
    of a 4-spp camera is refused by an 8-spp one; ``Renderer.render(spp=)``
    does not change ``cfg`` and resumes to more samples."""
    h = hashlib.sha256()
    for obj in (scene, cam):
        for f in dataclasses.fields(obj):
            a = getattr(obj, f.name).detach().cpu().contiguous().numpy()
            h.update(f.name.encode() + repr(a.shape).encode() + a.tobytes())
    h.update(repr(cfg).encode())
    if extra:
        h.update(repr(extra).encode())
    return h.hexdigest()


def save_npz(path: str, **fields) -> None:
    """``np.savez`` to ``path + ".tmp.npz"``, then ``os.replace`` onto
    ``path``: a reader never sees a partial file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **fields)
    os.replace(tmp, path)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The probe's counters that predict_tuning reads (wavefront render_batch).
PROBE_COUNTERS = ("waves", "ctrls", "rays", "slots", "occ_sum")


def _pool_cap(cfg: RenderConfig) -> int:
    """The largest pool worth tuning: one fill of the frame's pixels."""
    return max(256, 1 << (cfg.width * cfg.height - 1).bit_length())


def pin_tuning(cfg: RenderConfig, q, s, d, stride) -> tuple:
    """``(queue, steps, ctrl_den, stride)`` with the values ``cfg`` pins in
    place of these, the queue at most :func:`_pool_cap`."""
    return (min(cfg.queue_size or q, _pool_cap(cfg)),
            cfg.steps_per_wave or s, cfg.ctrl_den or d,
            cfg.sample_stride or stride)


def wave_preset(cfg: RenderConfig, rows: int, items: int | None,
                resident: int | None) -> tuple:
    """The wavefront's ``(queue, steps, ctrl_den)`` where neither ``cfg``
    nor autotune pins them, for a BVH of ``rows`` node rows.

    Steps a wave and ``ctrl_den`` follow the scene's depth: 32 and 16 for a
    BVH of 256 rows or more, else 12 and 8 (JAX ``renderer.py:169-170``).
    The pool follows the card: ``resident``, the slots K1 keeps resident
    there (:func:`..ops.kernels.resident_lanes`), at most the batch's
    ``items`` (samples x pixels; None: not capped) and :func:`_pool_cap`,
    so that K1's grid fills the card in each wave.  That is a floor, not
    the fastest pool: on an H100, pools pinned at twice the resident lanes
    (K1 then strides over its slots) ran faster still in every wavefront
    scene measured.  Without a card (``resident`` None) it is JAX's
    preset, 32768 or 8192 slots by the same rows."""
    big = rows >= 256
    queue, steps, den = (32768, 32, 16) if big else (8192, 12, 8)
    if resident:
        queue = min(resident, _pool_cap(cfg), items or resident)
    return queue, steps, den


def tuning_preset(cfg: RenderConfig, rows: int,
                  resident: int | None) -> tuple:
    """Autotune's preset candidate: :func:`wave_preset`'s pool, steps and
    ``ctrl_den`` (the pool the untuned batches run) with the engine's
    default stride, pinned as :func:`pin_tuning`."""
    return pin_tuning(cfg, *wave_preset(cfg, rows, None, resident), None)


def predict_tuning(cfg: RenderConfig, preset: tuple, probe: dict):
    """JAX's prediction (``renderer.py:178-206``) from the counters of one
    sample rendered at ``preset`` (:func:`tuning_preset`) → ``(predicted,
    reading)``.

    The pool halves where mean occupancy is under 0.75; the steps a wave
    are 1.5x the steps a segment, rounded to 4 and clipped to [8, 32];
    ctrl_den is 16 where control runs on 80% of the waves or more, else 8;
    pools of 1/8 to 1/2 of the frame's pixels take stride 2 where control
    runs on 40% of the waves or more, else 1, and other pools the engine's
    default.  ``reading`` holds the occupancy, steps a segment, waves and
    control waves it used."""
    total = cfg.width * cfg.height
    waves = max(int(probe["waves"]), 1)
    ctrls = max(int(probe["ctrls"]), 1)
    segs = max(float(probe["rays"]), 1.0)
    slots = int(probe["slots"])
    occ = float(probe["occ_sum"]) / (waves * slots)
    steps_seg = float(probe["occ_sum"]) * preset[1] / segs
    q = preset[0] // 2 if occ < 0.75 else preset[0]
    q = max(256, min(q, _pool_cap(cfg)))
    s = int(min(32, max(8, round(1.5 * steps_seg / 4) * 4)))
    d = 16 if ctrls >= waves * 0.8 else 8
    if 2 * slots <= total < 8 * slots:
        stride = 2 if ctrls >= waves * 0.4 else 1
    else:
        stride = None
    return pin_tuning(cfg, q, s, d, stride), dict(
        occ=occ, steps_seg=steps_seg, waves=waves, ctrls=ctrls)


def _render_batch(scene, flags, bvh, cam, cfg, accum, start_sample,
                  n_samples, key, engine, tuned=None):
    """One batch through the engine → (accum, stats with the same keys);
    ``tuned`` is autotune's ``(queue, steps, ctrl_den, stride)``, under
    the values ``cfg`` pins; :func:`wave_preset` gives the queue and the
    steps neither pins, and ``ctrl_den`` and the stride are then the
    engine's defaults, as in JAX.  A batch whose pool is the card's adds 1
    to the counter ``wavefront.pool_from_card``."""
    if engine == "megakernel":
        return integrator.render_batch(scene, flags, bvh, cam, cfg, accum,
                                       start_sample, n_samples, key,
                                       with_stats=True)
    resident = kernels.resident_lanes(accum.device, bvh.branching)
    p_q, p_s, _ = wave_preset(cfg, bvh.nodes.shape[0],
                              n_samples * cfg.width * cfg.height, resident)
    t_q, t_s, t_d, t_st = tuned if tuned else (None,) * 4
    queue = cfg.queue_size or t_q
    if not queue:
        queue = p_q
        if resident:
            count("wavefront.pool_from_card", 1)
    steps = cfg.steps_per_wave or t_s or p_s
    den, stride = cfg.ctrl_den or t_d, cfg.sample_stride or t_st
    kw = {"ctrl_den": den} if den else {}
    if stride:
        kw["sample_stride"] = stride
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
