"""Generators that drive the program, one per kind of traffic mix.

A traffic file names its generator (``"driver"``) and holds its
parameters; the generator builds the program's inputs from the cell's
configuration and the seed, sets the program up, warms up every shape the
window uses, and then measures.  It returns a :class:`Record`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Record:
    """What a run measured and what it leaves for the check."""

    setup_s: float
    setup: dict                     # set-up parts, seconds
    window_s: float                 # first timed frame's start to the last's end
    unit_s: list                    # wall seconds of every batch in the window
    units: int                      # batches in the window
    work: float                     # pixel-samples completed in the window
    counters: dict                  # program counters over the window
    memory_peak_bytes: int
    output: dict = field(default_factory=dict)   # what the check compares
    trace: dict | None = None       # the traced slice (trace runs)
    slice_counters: dict | None = None


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


COUNTERS = ("paths", "rays", "waves", "ctrls", "walk_steps", "host_reads")


def progressive(bench, config, traffic, seed, seconds, trace, device, t0,
                fault=None):
    """A CLI user's render, frame after frame: ``Renderer.render(spp=<the
    configuration's samples>, batch=traffic["batch"])`` from an empty frame
    each time, as ``render/cli.py`` calls it once for its frame (the same
    batch loop, the frame returned once at its end).  The window runs
    whole frames until ``seconds`` have passed.  A batch is timed from one
    batch call's start to the next one's (its counters read back; the
    frame's last batch also pays the frame's return), so the batch times
    add up to the window.  A traced run then profiles the fewest whole
    frames that hold ``traffic["profile_batches"]`` batches.  ``fault``,
    where given, wraps the engine's batch call (tests and controls)."""
    import torch

    t_imp = time.perf_counter()
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.render import renderer as rmod

    from . import port_adapter
    setup = {"process_start_to_driver_s": t_imp - t0,
             "import_s": time.perf_counter() - t_imp}
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
        kernels.build()
    setup["kernel_load_s"] = time.perf_counter() - t

    t = time.perf_counter()
    desc = scene_description(bench, config)
    world, cam = port_adapter.port_world(desc)
    cam.samples_per_pixel = config["samples_per_pixel"]
    cam.max_depth = config["max_depth"]
    setup["describe_s"] = time.perf_counter() - t
    r = ptt.Renderer(world, cam, engine=traffic["engine"], seed=seed,
                     device=device)
    setup.update(r.setup_times)
    batch = int(traffic["batch"])
    frame_spp = int(config["samples_per_pixel"])
    per_frame = -(-frame_spp // batch)
    marks = []                       # host clock at each batch call

    orig_batch = rmod._render_batch
    inner = orig_batch if fault is None else fault(orig_batch)

    def timed_batch(*args, **kwargs):
        marks.append(time.perf_counter())
        return inner(*args, **kwargs)

    def frame():
        r.accum.zero_()
        r.samples_done = 0
        r.render(spp=frame_spp, batch=batch)

    rmod._render_batch = timed_batch
    try:
        t = time.perf_counter()
        r.render(spp=batch, batch=batch)         # builds, captures, warms
        _sync(device)
        r.stats = rmod.RenderStats()
        setup["warmup_s"] = time.perf_counter() - t

        marks.clear()
        frames = 0
        start = end = time.perf_counter()
        while end - start < seconds:
            frame()
            frames += 1
            end = time.perf_counter()
        window_s = end - start
        times = [b - a for a, b in zip([start] + marks[1:], marks[1:] + [end])]
        s = r.stats
        counters = {k: getattr(s, k) for k in COUNTERS}
        npix = r.cfg.width * r.cfg.height
        mem = (torch.cuda.max_memory_allocated()
               if torch.device(device).type == "cuda" else 0)

        tr = slice_counters = None
        if trace:
            from . import trace as trace_mod
            n_frames = -(-int(traffic["profile_batches"]) // per_frame)
            before = {k: getattr(s, k) for k in COUNTERS}

            def run_slice():
                for _ in range(n_frames):
                    frame()

            tr = trace_mod.profile_slice(run_slice,
                                         tuple(kernels.LAUNCHES),
                                         kernels.LAUNCHES,
                                         kernels.reset_launches)
            slice_counters = {k: getattr(r.stats, k) - before[k]
                              for k in COUNTERS}
            slice_counters.update(frames=n_frames, pixels=npix,
                                  samples=n_frames * frame_spp,
                                  pixel_samples=n_frames * frame_spp * npix)
    finally:
        rmod._render_batch = orig_batch
    output = dict(desc=desc, config=config, seed=seed,
                  frame=r.accum.detach().reshape(-1, 3).clone(),
                  samples=r.samples_done, width=r.cfg.width,
                  height=r.cfg.height)
    del r
    samples = frames * frame_spp
    return Record(setup_s=start - t0, setup=setup, window_s=window_s,
                  unit_s=times, units=len(times), work=samples * npix,
                  counters=dict(counters, samples=samples, frames=frames,
                                pixels=npix, engine=traffic["engine"]),
                  memory_peak_bytes=int(mem), output=output, trace=tr,
                  slice_counters=slice_counters)


def scene_description(bench, config):
    """The configuration's scene description (:mod:`.describe`)."""
    from . import describe as D
    c = config["camera"]
    cam = D.CameraDesc(width=config["width"], height=config["height"],
                       vfov=c["vfov"], lookfrom=tuple(c["lookfrom"]),
                       lookat=tuple(c["lookat"]),
                       vup=tuple(c.get("vup", (0.0, 1.0, 0.0))),
                       defocus_angle=c.get("defocus_angle", 0.0),
                       focus_distance=c.get("focus_distance", 10.0),
                       background=(None if c.get("background") is None
                                   else tuple(c["background"])))
    return bench.scene_module(config["scene"]).build(
        cam, **config.get("scene_args", {}))


DRIVERS = {"progressive": progressive}
