"""Command-line entry point of the port (``path_tracer_tpu/render/cli.py``).

Usage::

    python -m path_tracer_tpu_torch.render.cli --scene cornell_box --spp 64 \
        --width 400 --engine wavefront --out /tmp/cornell.png \
        --checkpoint /tmp/cornell.ckpt.npz --metrics /tmp/metrics.jsonl

Renders on the CUDA card unless ``--cpu`` asks for the plain-torch twins on
the CPU; with no card and no ``--cpu`` it exits 2.  Prints the scene line,
each batch, and a closing JSON line ``{"out": ..., **stats.summary(cfg),
"spans": ...}``, the host-time spans of :mod:`..utils.spans` in
milliseconds (``--profile``'s ``trace.json`` holds them too) and the wave
loop graph's captures per batch.
``--coordinator/--num-processes/--process-id`` run one rank of a
``torch.distributed`` job (every rank the same command with its own
``--process-id``): the ranks render data-parallel through
:func:`..parallel.render_dist.render_distributed` and rank 0 writes
``--out`` (``.npz``, ``.ppm`` or ``.png``).  ``--backend`` picks NCCL (one
card per rank, the default on a card) or gloo (ranks sharing one card, or
the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="path-tracer-tpu-torch",
        description="differentiable path tracer, PyTorch and CUDA port")
    p.add_argument("--scene", default="vol2_test_scene",
                   help="scene name (see --list-scenes)")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--engine", default="wavefront",
                   choices=("megakernel", "wavefront"))
    p.add_argument("--width", type=int, default=None,
                   help="override image width")
    p.add_argument("--spp", type=int, default=None,
                   help="override samples per pixel")
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--batch", type=int, default=8,
                   help="samples per progressive batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out.png",
                   help="output image (.png/.ppm; .npz with --coordinator)")
    p.add_argument("--checkpoint", default=None,
                   help="progressive accumulation checkpoint path (.npz); "
                        "resumes if it exists")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N samples (0 = only at end)")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the plain-torch twins)")
    p.add_argument("--queue-size", type=int, default=None,
                   help="wavefront slot-pool size (default: auto)")
    p.add_argument("--steps-per-wave", type=int, default=None,
                   help="suspended-traversal steps per wave (default: auto)")
    p.add_argument("--autotune", action="store_true",
                   help="measure-and-pick wavefront pool parameters for "
                        "this scene before rendering (one probe sample, then "
                        "the prediction and the preset timed)")
    p.add_argument("--sample-stride", type=int, default=None,
                   help="in-slot samples per work item (default: engine "
                        "heuristic)")
    p.add_argument("--ctrl-den", type=int, default=None,
                   help="control-step density knob (default: auto)")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace (trace.json) into this "
                        "directory")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address of a torch.distributed job")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend (default: nccl on a card, "
                        "gloo with --cpu); gloo for ranks sharing one card")
    p.add_argument("--local-devices", type=int, default=None,
                   help="JAX's virtual CPU devices per process; one device a "
                        "rank here, so only 1 (use --backend for the rest)")
    return p


def _main_distributed(args, world, cam, device) -> int:
    """One rank of a multi-process render: join the job, render
    data-parallel, rank 0 writes the image."""
    import numpy as np
    import torch.distributed as dist

    from ..parallel import render_dist
    from ..utils.image import write_png, write_ppm

    backend = args.backend or ("gloo" if device == "cpu" else "nccl")
    render_dist.init_distributed(args.coordinator, args.num_processes,
                                 args.process_id, backend=backend)
    print(f"rank {dist.get_rank()}/{dist.get_world_size()} up: backend "
          f"{backend}, device {device}", flush=True)
    try:
        img = render_dist.render_distributed(
            world, cam, spp=args.spp, seed=args.seed,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, batch=args.batch,
            device=device)
    except KeyboardInterrupt:
        # The checkpoint was saved inside render_distributed: the same
        # command again resumes from it.
        print("interrupted: checkpoint saved", flush=True)
        dist.destroy_process_group()
        return 130
    if dist.get_rank() == 0:
        if args.out.endswith(".npz"):
            np.savez(args.out, img=img)
        else:
            (write_ppm if args.out.endswith(".ppm") else write_png)(
                args.out, img, 1)
        print(json.dumps({"out": args.out, "processes": dist.get_world_size(),
                          "backend": backend}), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .. import scenes as scene_mod

    if args.list_scenes:
        for name in sorted(scene_mod.SCENES):
            print(name)
        return 0
    if args.scene not in scene_mod.SCENES:
        print(f"unknown scene {args.scene!r}; use --list-scenes",
              file=sys.stderr)
        return 2
    if args.local_devices not in (None, 1):
        print("--local-devices: one device per rank in this port; start one "
              "process per rank and pick the transport with --backend "
              "(gloo for ranks that share a card or run on the CPU)",
              file=sys.stderr)
        return 2

    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the port renders on the card; pass --cpu to "
              "render on the CPU", file=sys.stderr)
        return 2

    world, cam = scene_mod.SCENES[args.scene]()
    if args.width:
        cam.img_width = args.width
    if args.spp:
        cam.samples_per_pixel = args.spp
    if args.max_depth:
        cam.max_depth = args.max_depth

    if args.coordinator:
        return _main_distributed(args, world, cam, device)

    from ..ops import wavefront
    from ..ops.types import RenderConfig
    from ..utils import spans
    from .renderer import Renderer

    # With --engine megakernel the Renderer warns about a wavefront flag
    # (the knobs in cfg, --autotune) instead of dropping it silently.
    cfg = None
    if (args.queue_size or args.steps_per_wave or args.ctrl_den
            or args.sample_stride):
        cfg = RenderConfig(
            width=cam.img_width, height=cam.img_height,
            samples_per_pixel=cam.samples_per_pixel,
            max_depth=cam.max_depth, queue_size=args.queue_size,
            steps_per_wave=args.steps_per_wave, ctrl_den=args.ctrl_den,
            sample_stride=args.sample_stride)
    r = Renderer(world, cam, engine=args.engine, seed=args.seed, cfg=cfg,
                 device=device)
    print(f"scene={args.scene} {r.cfg.width}x{r.cfg.height} "
          f"spp={cam.samples_per_pixel} engine={args.engine} device={device} "
          f"setup={r.setup_times}", flush=True)

    def run():
        r.render(batch=args.batch, checkpoint_path=args.checkpoint,
                 checkpoint_every=args.checkpoint_every,
                 metrics_path=args.metrics, verbose=True,
                 autotune=args.autotune)

    spans.reset()
    captures0 = wavefront.CAPTURES
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            run()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        run()

    r.write_image(args.out)
    print(json.dumps({"out": args.out, **r.stats.summary(r.cfg),
                      "spans": spans_ms(spans.snapshot(),
                                        wavefront.CAPTURES - captures0,
                                        spans.counters())}))
    return 0


def spans_ms(snap: dict, captures: int = 0,
             counts: dict | None = None) -> dict:
    """:func:`..utils.spans.snapshot` in milliseconds: ``{name: {"count",
    "total_ms", "self_ms"}}``; ``wavefront.captures``: ``{"count",
    "per_batch"}``, the device wave loop's graph captures
    (``wavefront.CAPTURES``) over the ``renderer.batch`` spans; and each of
    ``counts`` (:func:`..utils.spans.counters`) the same way."""
    out = {name: {"count": a["count"],
                  "total_ms": round(1e3 * a["total_s"], 3),
                  "self_ms": round(1e3 * a["self_s"], 3)}
           for name, a in snap.items()}
    batches = snap.get("renderer.batch", {}).get("count", 0)
    for name, n in {"wavefront.captures": captures, **(counts or {})}.items():
        out[name] = {"count": n, "per_batch": n / batches if batches else 0.0}
    return out


if __name__ == "__main__":
    sys.exit(main())
