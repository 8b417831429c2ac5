"""P0 on the card: the row gather ``table[idx, :]`` against its bound.

    python path_tracer_tpu_torch/scripts/bench_gather.py [--json FILE]

The counterpart of ``tools/bench_gather.py``, which asks on the TPU whether
anything gathers scattered rows faster than XLA's gather.  Its one-hot MXU
matmul and its Pallas/Mosaic formulations are TPU workarounds (Mosaic cannot
lower a per-lane row gather) with no counterpart here; the gather is one
hand-written CUDA kernel, ``csrc/gather.cu`` (``ops/gather.py``).

Each case checks the kernel equal to ``torch.index_select`` and times, in
device ms per call, 20 calls captured in one CUDA graph and replayed (as
``chip_smoke.py`` times P0, so no host launch work is inside): the kernel,
``index_select`` (the library call) and the launch floor, an empty kernel
on the kernel's own grid (``gather.gather_rows_floor``).  Beside them: the
event ms of one call (CUDA events, median of 25; host launch work in), the
plain ``table[idx]``'s, and the bound, the bytes the gather must move (the
table and the indices read once, the rows written once) over 3.35 TB/s.

1. P0's own shape: table (512, 80) float32, R = 16384 random and sorted
   indices.
2. Row widths 80, 96 and 184 floats (P0's, the BVH4 and the BVH8 node rows,
   ``ops/types.py:bvh_layout``), R = 16384 random indices into 4096 rows.
3. The vol2_final BVH4 node table (sphere_cluster=1000) with the rows K1
   fetches: ``cur`` of the walking slots of a wave 48 waves into the
   800x450 frame (a 32768-slot pool, 32 steps per wave; the waves run by
   the plain versions of the wave kernels, which K1 to K4 equal).

An A/B of designs of ``gather.cu`` between checkouts on these cases is
``scripts/mega_ab.py --gather``.

Prints one JSON object per case and the card's ``nvidia-smi`` name and
power limit; needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

from graph_timer import N_GRAPH, graph_ms   # this script's directory

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO)

BYTES_PER_S = 3.35e12          # H100 SXM HBM3


def cuda_ms(fn, reps=25):
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(B: int, W: int, R: int) -> float:
    """The bytes P0 must move for R rows of a (B, W) table, over the card's
    memory rate: the table and the indices read once, the rows written
    once."""
    return (B * W * 4 + R * 4 + R * W * 4) / BYTES_PER_S * 1e3


def k1_rows(dev):
    """(vol2_final node table, cur of the walking slots 48 waves in)."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops import traverse
    from path_tracer_tpu_torch.ops import wavefront as wf
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig
    from path_tracer_tpu_torch.utils import rng
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = 800 / 450, 800
    scene = ptt.compile_scene(world, device=dev)
    bvh = ptt.build_from_scene(scene)
    cfg = RenderConfig(width=800, height=450, samples_per_pixel=10,
                       max_depth=10)
    eng = wf.WaveEngine(scene, SceneFlags.from_scene(scene), bvh,
                        cam.initialize(device=dev), cfg, 0, 10,
                        rng.key(0, device=dev), queue_size=32768,
                        steps_per_wave=32, ctrl_den=8)
    ws = eng.init_state(torch.zeros((450, 800, 3), device=dev))
    for _ in range(48):
        for op in wf.PLAIN:
            op(eng, ws)
    cur = ws.cur[ws.cur != traverse._DONE].contiguous()
    return bvh.nodes.contiguous(), cur


def cases(dev):
    """[(name, table, idx)] of the probe, every case of the docstring."""
    g = torch.Generator(device=dev).manual_seed(0)
    R = 16384
    table = torch.randn((512, 80), device=dev, generator=g)
    idx = torch.randint(0, 512, (R,), device=dev, generator=g,
                        dtype=torch.int32)
    out = [("P0 random", table, idx),
           ("P0 sorted", table, torch.sort(idx).values.contiguous())]
    for W in (80, 96, 184):
        t = torch.randn((4096, W), device=dev, generator=g)
        i = torch.randint(0, 4096, (R,), device=dev, generator=g,
                          dtype=torch.int32)
        out.append((f"width {W}", t, i))
    out.append(("vol2_final K1 rows", *k1_rows(dev)))
    return out


def measure(name, table, idx):
    """One case through the repo's ``gather_rows`` → its record (ms)."""
    from path_tracer_tpu_torch.ops import gather
    B, W = table.shape
    R = idx.shape[0]
    got = gather.gather_rows(table, idx)
    lib = torch.index_select(table, 0, idx)
    out = torch.empty_like(lib)
    gather.gather_rows_floor(table, idx, out)
    torch.cuda.synchronize()
    return {"case": name, "B": B, "W": W, "R": R,
            "equal": bool(torch.equal(got, lib)),
            "ms": cuda_ms(lambda: gather.gather_rows(table, idx)),
            "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx)),
            "plain_ms": cuda_ms(lambda: gather.gather_rows_plain(table, idx)),
            "device_ms": graph_ms(
                [lambda: gather.gather_rows(table, idx)] * N_GRAPH),
            "library_device_ms": graph_ms(
                [lambda: torch.index_select(table, 0, idx)] * N_GRAPH),
            "floor_device_ms": graph_ms(
                [lambda: gather.gather_rows_floor(table, idx, out)] * N_GRAPH),
            "bound_ms": bound_ms(B, W, R), "bound_by": "bytes"}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rows = [measure(name, t, i) for name, t, i in cases(torch.device("cuda"))]
    for r in rows:
        print(json.dumps(r), flush=True)
    print(card, flush=True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump({"card": card, "cases": rows}, f, indent=1)
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
