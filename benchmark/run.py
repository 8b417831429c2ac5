"""One run of one benchmark cell of the port (path_tracer_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets the cell's program up from its configuration and the seed, warms up,
drives it for ``--seconds`` with the cell's traffic mix, checks the output
against the plain reference once the window has closed, and prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` (last) holds each compared number beside its
limit, which also end standard error.  Exits non-zero with no result when
CUDA has fewer devices than the cell asks for, or when the JAX package or
JAX itself was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import check, drivers, endtoend, registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "path_tracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared as a whole name."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench, cell_name, seed, seconds, trace, device, t0=T0,
             fault=None, resize=None, traffic_resize=None):
    """One run → the result dict (without checking the device count).
    ``fault`` wraps the engine's batch call; ``resize`` and
    ``traffic_resize`` replace configuration and traffic entries (the
    tests' small frames); a benchmark run passes none of them."""
    cell = bench.cell(cell_name)
    config = dict(bench.config(cell["config"]), **(resize or {}))
    traffic = dict(bench.traffic(cell["traffic"]), **(traffic_resize or {}))
    limits = bench.limits(cell_name)
    driver = drivers.DRIVERS[traffic["driver"]]
    rec = driver(bench, config, traffic, seed, seconds, trace, device, t0,
                 fault=fault)
    correct, numbers, facts = check.check_frame(rec.output, limits, device)
    if trace:
        ctx = dict(record=rec, config=config, traffic=traffic, cell=cell)
        metrics = {}
        for m in bench.per_layer(cell_name):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if rec.trace and not rec.trace["consistent"]:
            print(f"benchmark: kernel and idle metrics left out: "
                  f"{rec.trace['reason']}", file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": endtoend.METRICS[m["name"]](rec),
                               "unit": m["unit"]}
                   for m in bench.end_to_end(cell_name)}
    import torch
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": rec.units, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and rec.trace:
        if rec.trace["busy_s"]:
            dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["setup_parts_s"] = rec.setup
    out["window"] = {"seconds": rec.window_s, "batches": rec.units,
                     "frames": rec.counters.get("frames"),
                     "first_batch_ms": 1e3 * rec.unit_s[0],
                     "median_batch_ms": 1e3 * sorted(rec.unit_s)[rec.units // 2],
                     "tenths_ms": tenths(rec.unit_s)}
    out["reference"] = facts
    out["checks"] = numbers
    return out


def tenths(times) -> list:
    """Mean batch milliseconds in each tenth of the window, in order."""
    out, t, k, acc, n = [], 0.0, 1, 0.0, 0
    total = sum(times)
    for x in times:
        acc, n, t = acc + x, n + 1, t + x
        if t >= total * k / 10 - 1e-12:
            out.append(1e3 * acc / n)
            acc, n, k = 0.0, 0, k + 1
    return out


def finite(obj):
    """``obj`` with each float that is not finite written as a string
    (``"inf"``, ``"nan"``), so that the result line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.Bench()
    cell = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {n}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules that must not load were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    out["device"]["power"] = power_limit()
    print(json.dumps(finite(out), allow_nan=False))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
