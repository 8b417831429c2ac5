"""The readings a cell's correctness limit is set from, and the check's
verdict on a broken timed path (not run by the benchmark's own runs).

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        [--seeds 11 12 13 ...] [--control-seeds 21 22 23] \
        [--fault-seeds 31 32 33]

For each ``--seeds`` value: one run of the cell as the benchmark makes it
(set-up, a window of ``--seconds``, the check), its ``frame_l1_gap`` the
lower reading.  For each ``--control-seeds`` value: the control, the
reference computed in bfloat16 and put in the program's place for the
frame the cell renders, judged by the cell's own check (its pixel sample
and limit): its ``frame_l1_gap`` the upper reading, and its ``correct``.
For each ``--fault-seeds`` value and each fault of :mod:`faults`: one run
with that fault planted under the Renderer's batch call, and its
``correct``.  Everything runs in this one process; one JSON line each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402
from faults import FAULTS  # noqa: E402
from harness import check, drivers, registry  # noqa: E402


def control_output(bench, cell_name, seed, device, resize=None):
    """The check's input with the bfloat16 reference's sums in the
    program's place, on the pixels the cell's check samples for ``seed``
    (the rest of the frame is never read), over the cell's frame."""
    import torch
    cell = bench.cell(cell_name)
    config = dict(bench.config(cell["config"]), **(resize or {}))
    limits = bench.limits(cell_name)
    desc = drivers.scene_description(bench, config)
    npix = config["width"] * config["height"]
    samples = int(config["samples_per_pixel"])
    pixels = check.sample_pixels(seed, npix, check.pixel_count(
        limits, npix, samples))
    low = check.reference_sums(desc, config, seed, pixels, samples, device,
                               dtype=torch.bfloat16)
    frame = torch.zeros(npix, 3, dtype=torch.float32)
    frame[pixels] = low.float().cpu()
    return dict(desc=desc, config=config, seed=seed, frame=frame,
                samples=samples, width=config["width"],
                height=config["height"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = registry.Bench()
    limits = bench.limits(args.workload)
    runs = [("program", s, None) for s in args.seeds]
    runs += [(name, s, f) for s in args.fault_seeds
             for name, f in sorted(FAULTS.items())]
    for kind, seed, fault in runs:
        out = run.run_cell(bench, args.workload, seed, args.seconds, False,
                           "cuda", t0=time.perf_counter(), fault=fault)
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": out["correct"], **out["reference"],
                          "frame_l1_gap": out["checks"]["frame_l1_gap"]
                          ["value"]}), flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        output = control_output(bench, args.workload, seed, "cuda")
        correct, numbers, facts = check.check_frame(output, limits, "cuda")
        print(json.dumps({"kind": "control_bf16", "seed": seed,
                          "correct": bool(correct), **facts,
                          "frame_l1_gap": numbers["frame_l1_gap"]["value"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
