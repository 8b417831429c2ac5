"""Everything of a cell, found by the names in ``BENCHMARK.json``.

* ``configs/<config>.json``: the configuration as it is run (scene module
  and arguments, frame, samples, depth, integrator constants);
* ``scenes/<scene>.py``: ``build(camera, **args)`` → scene description;
* ``traffic/<mix>.json``: the traffic mix's parameters; its ``driver``
  names the generator in :mod:`.drivers` that reads them;
* ``limits/<cell>.json``: each number the correctness check compares, with
  its limit and the readings the limit was set from;
* ``metrics/<metric>.py``: ``read(ctx)`` → the per-layer metric, or None.

A new cell, configuration, traffic mix or per-layer metric is a new file
and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file ``path`` as module ``name`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` with by-name lookups (``root`` defaults to the
    checkout that holds this folder)."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root, self.dir = root, bench_dir
        self.spec = _json(os.path.join(root, "BENCHMARK.json"))

    def _named(self, key, name):
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def cell(self, name):
        return self._named("workloads", name)

    def config(self, name) -> dict:
        entry = self._named("configs", name)
        return dict(_json(os.path.join(self.root, entry["file"])), name=name)

    def traffic(self, name) -> dict:
        return dict(_json(os.path.join(self.dir, "traffic", name + ".json")),
                    name=name)

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(self.dir, "limits", cell + ".json"))

    def scene_module(self, scene: str):
        return load_module(os.path.join(self.dir, "scenes", scene + ".py"),
                           f"bench_scene_{scene}")

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports: those whose
        ``workloads`` list it, and those without a list."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics whose ``workloads`` list the cell."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))
