"""The CPU twins' cost on ``test_torch_renderer.py::test_metrics_jsonl``'s batch.

    JAX_PLATFORMS=cpu python tests/torch_twin_probe.py [--copies N]
        [--busy M] [--repo DIR]
    JAX_PLATFORMS=cpu python tests/torch_twin_probe.py --gathers

Runs that test's render, ``_port(w=16).render(spp=2, batch=1,
metrics_path=...)`` (the megakernel twin on 16x8 pixels, two batches of one
sample), in N processes at once, beside M processes that each open an
OpenMP parallel region every 20 ms (a sum over 2M floats), and prints each
process's ``(batch_s, mpix_per_s)`` pairs from its metrics file, then the
largest ``batch_s`` of all batches and of the last ones (the test reads the
last line).  ``_log_metrics`` rounds ``mpix_per_s`` to 3 decimals,
so a batch slower than 0.256 s logs 0.0 and fails the test.  ``--repo``
takes the package and the test helper from another checkout (a ``git
archive`` of the parent, say).  Each process imports JAX first, as the test
module does.

``--gathers`` times 128-row gathers from that renderer's one-row node table
right after one OpenMP parallel region (the sum above): ``nodes[idx]``
(``aten::index``, which opens a region itself) and ``index_select``, each
call's ms and its seconds since the region.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(repo: str) -> None:
    sys.path[:0] = [os.path.join(repo, "tests"), repo]
    import jax  # noqa: F401  (the test module imports it first)
    from test_torch_renderer import _port

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        _port(w=16).render(spp=2, batch=1, metrics_path=path)
        lines = [json.loads(x) for x in open(path)]
    print(json.dumps([[x["batch_s"], x["mpix_per_s"]] for x in lines]))


def gathers(repo: str) -> None:
    sys.path[:0] = [os.path.join(repo, "tests"), repo]
    import torch
    from test_torch_renderer import _port

    nodes = _port(w=16).bvh.nodes
    idx = torch.zeros(128, dtype=torch.int64)
    for name, fn in (("nodes[idx]", lambda: nodes[idx]),
                     ("index_select", lambda: nodes.index_select(0, idx))):
        torch.randn(2_000_000).sum()         # one parallel region
        t0 = time.perf_counter()
        row = []
        for _ in range(30):
            t = time.perf_counter()
            fn()
            row.append(f"{(time.perf_counter() - t) * 1e3:.3f}ms"
                       f"@{time.perf_counter() - t0:.2f}s")
        print(name, " ".join(row))


def busy(seconds: float) -> None:
    import torch

    x = torch.randn(2_000_000)
    end = time.time() + seconds
    while time.time() < end:
        (x * 1.0001).sum()
        time.sleep(0.02)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--copies", type=int, default=1)
    p.add_argument("--busy", type=int, default=0)
    p.add_argument("--repo", default=REPO)
    p.add_argument("--gathers", action="store_true")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--busy-for", type=float, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.one:
        one(os.path.abspath(a.repo))
        return 0
    if a.gathers:
        gathers(os.path.abspath(a.repo))
        return 0
    if a.busy_for is not None:
        busy(a.busy_for)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    me = [sys.executable, os.path.abspath(__file__)]
    loaders = [subprocess.Popen(me + ["--busy-for", "120"], env=env)
               for _ in range(a.busy)]
    if loaders:
        time.sleep(3)
    try:
        runs = [subprocess.Popen(me + ["--one", "--repo", a.repo], env=env,
                                 stdout=subprocess.PIPE, text=True)
                for _ in range(a.copies)]
        outs = [json.loads(r.communicate()[0].strip().splitlines()[-1])
                for r in runs]
    finally:
        for q in loaders:
            q.kill()
            q.wait()
    for o in outs:
        print(o)
    print("largest batch_s", max(b for o in outs for b, _ in o),
          "last batch (the test's)", max(o[-1][0] for o in outs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
