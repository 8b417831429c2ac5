"""Scaling efficiency over gloo ranks: rays/s at 1..N ranks (BASELINE #3).

    python path_tracer_tpu_torch/scripts/bench_scaling.py [max_devices=8]
        [width=256] [engine=wavefront|megakernel] [--cpu]

The port of ``tools/bench_scaling.py`` (:17-79) on its configuration:
wavefront_comparison at ``width`` x ``int(width * 9 / 16)``, 2 spp, depth
8, key 0, sizes 1, 2, 4, 8, 16, 32 up to ``max_devices``.  Each size is a
job of its own: n rank processes of a gloo job (``parallel.launch``), each
running ``parallel.render_sharded_wavefront(..., spp=2)`` (K1-K4 over its
pixel block) or ``parallel.render_sharded(..., 2)`` (K5) with JAX's pool
defaults.  Every rank makes one warm-up call, then ``dist.barrier()``, a
synchronize, one timed call and a synchronize; the size's wall is the
slowest rank's, as JAX's ``block_until_ready`` waits on the whole sharded
frame.  The kernels are built once here before any rank starts, so the
ranks only load them.

Prints one line a size in JAX's format (upper-bound Mrays/s = pixels x 2 x
depth / wall, efficiency against n times the one-rank rate), then the
measured Mrays/s from the rays the ranks traced (the wavefront's summed
``stats["rays"]``; the megakernel returns no counters), the backend and the
card's ``nvidia-smi`` name and power limit, or ``cpu``.  On the card the
ranks share one device: the figure measures sharing it and gloo, not
scaling across cards (NCCL refuses ranks that share a device).  Without
``--cpu`` every rank runs on ``cuda:0`` and a missing card exits 2;
``--cpu`` runs the plain-torch twins, one intra-op thread a rank (n ranks
on n cores).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

_HERE = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
sys.path.insert(0, _REPO)

SIZES = (1, 2, 4, 8, 16, 32)
RANK_TIMEOUT_S = 600          # a size's job, process starts included
SPP, DEPTH = 2, 8
WAVE_KERNELS = ("trace_step", "spawn", "shade", "retire")


def config(width: int):
    """(width, height) of JAX's frame for ``width``."""
    return width, int(width * 9 / 16)


def setup(width: int, device):
    """(scene, flags, bvh, camera arrays, config, key) of the frame."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng

    world, cam = ptt.scenes.wavefront_comparison()
    cam.img_width = width
    scene = ptt.compile_scene(world, device=device)
    w, h = config(width)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=SPP,
                       max_depth=DEPTH)
    return (scene, SceneFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=device), cfg, rng.key(0, device=device))


def rank_main(argv) -> int:
    """One rank: ``--rank RANK WORLD PORT DIR WIDTH ENGINE DEVICE``.  Saves
    ``DIR/scaling<WORLD>.<RANK>.pt`` (wall, launches, counters, image)."""
    import torch.distributed as dist
    from path_tracer_tpu_torch import parallel as par
    from path_tracer_tpu_torch.ops import kernels

    rank, world, port, out_dir = (int(argv[0]), int(argv[1]), argv[2],
                                  argv[3])
    width, engine, device = int(argv[4]), argv[5], torch.device(argv[6])
    cuda = device.type == "cuda"
    torch.set_num_threads(2 if cuda else 1)
    par.init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    if cuda:
        kernels.build()
    scene, flags, bvh, cam, cfg, key = setup(width, device)
    mesh = par.make_mesh(world)

    def call():
        if engine == "wavefront":
            return par.render_sharded_wavefront(scene, flags, bvh, cam, cfg,
                                                key, mesh, spp=SPP,
                                                with_stats=True)
        return par.render_sharded(scene, flags, bvh, cam, cfg, key, mesh,
                                  SPP), None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    call()                                   # warm-up
    dist.barrier()
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    image, stats = call()
    sync()
    wall = time.perf_counter() - t0
    out = {"wall": wall, "launches": dict(kernels.LAUNCHES),
           "image": image.cpu(),
           "stats": ({k: int(stats[k]) for k in ("paths", "rays", "waves")}
                     if stats is not None else None)}
    torch.save(out, os.path.join(out_dir, f"scaling{world}.{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def line(row: dict, where: str) -> str:
    """JAX's line for one size, then the measured rate, backend and card."""
    measured = (f"{row['mrays']:7.2f}" if row["mrays"] is not None
                else "    n/a")
    return (f"devices={row['n']:2d}: {row['wall_s'] * 1e3:8.1f} ms  "
            f"{row['mrays_ub']:7.2f} Mrays/s(ub)  "
            f"efficiency={row['efficiency']:5.1%}  {measured} Mrays/s"
            f"(measured)  backend=gloo  {where}")


def run(max_devices: int = 8, width: int = 256, engine: str = "wavefront",
        device="cuda", log_dir: str | None = None, out=None) -> list:
    """Every size up to ``max_devices`` → one row each: ``n``, ``wall_s``
    (the slowest rank's), ``mrays_ub``, ``mrays`` (None for the
    megakernel), ``efficiency``, ``paths``, ``launches`` (one dict a rank)
    and ``image`` (the (H, W, 3) frame, equal on every rank).  ``out``,
    when given, takes each size's :func:`line` as it is measured.  On the
    card it raises when K1-K4 (wavefront) or K5 (megakernel) did not
    launch on every rank."""
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.parallel.launch import run_ranks

    if engine not in ("wavefront", "megakernel"):
        raise ValueError(f"engine must be wavefront or megakernel, not "
                         f"{engine!r}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_scaling: no CUDA device (--cpu runs "
                               "the twins)")
        kernels.build()          # once, before any rank loads the kernels
        device = torch.device("cuda:0")
        from path_tracer_tpu_torch.scripts.bench_ladder import card
        where = f"gloo ranks sharing one card: {card()}"
    else:
        where = "cpu"
    need = WAVE_KERNELS if engine == "wavefront" else ("megakernel",)
    w, h = config(width)
    tmp = None
    if log_dir is None:
        tmp = tempfile.TemporaryDirectory()
        log_dir = tmp.name
    env = dict(os.environ, PYTHONPATH=_REPO)
    rows, base = [], None
    try:
        for n in (s for s in SIZES if s <= max_devices):
            run_ranks(n, lambda r, port: [
                sys.executable, _HERE, "--rank", str(r), str(n), str(port),
                log_dir, str(width), engine, str(device)], log_dir,
                RANK_TIMEOUT_S, env=env, cwd=_REPO)
            outs = []
            for r in range(n):
                path = os.path.join(log_dir, f"scaling{n}.{r}.pt")
                outs.append(torch.load(path))
                os.remove(path)
            if not all(torch.equal(o["image"], outs[0]["image"])
                       for o in outs):
                raise RuntimeError(f"{n} ranks returned different frames")
            if device.type == "cuda":
                idle = [(r, k) for r, o in enumerate(outs) for k in need
                        if o["launches"][k] == 0]
                if idle:
                    raise RuntimeError(f"{n} ranks: kernels not launched "
                                       f"(rank, kernel): {idle}")
            wall = max(o["wall"] for o in outs)
            rate = w * h * SPP * DEPTH / wall / 1e6
            base = rate if base is None else base
            stats = outs[0]["stats"]
            row = {"n": n, "wall_s": wall, "rank_walls": [o["wall"]
                                                          for o in outs],
                   "mrays_ub": rate, "efficiency": rate / (base * n),
                   "mrays": (stats["rays"] / wall / 1e6
                             if stats is not None else None),
                   "paths": stats["paths"] if stats is not None else None,
                   "waves": stats["waves"] if stats is not None else None,
                   "launches": [o["launches"] for o in outs],
                   "image": outs[0]["image"].numpy()}
            rows.append(row)
            if out is not None:
                out(line(row, where))
    finally:
        if tmp is not None:
            tmp.cleanup()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("max_devices", nargs="?", type=int, default=8)
    p.add_argument("width", nargs="?", type=int, default=256)
    p.add_argument("engine", nargs="?", default="wavefront",
                   choices=("wavefront", "megakernel"))
    p.add_argument("--cpu", action="store_true",
                   help="run the plain-torch twins on the CPU")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench_scaling: no CUDA device (use --cpu for the twins)",
              file=sys.stderr)
        return 2
    run(args.max_devices, args.width, args.engine,
        device="cpu" if args.cpu else "cuda",
        out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
