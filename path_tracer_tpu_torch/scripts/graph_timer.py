"""Device ms of calls captured in one CUDA graph: the timer that
``chip_smoke.py`` and the scripts of this directory share.

The scripts import it as ``graph_timer`` from their own directory, which is
on ``sys.path`` also where an A/B runs them inside another checkout;
``chip_smoke.py`` imports ``path_tracer_tpu_torch.scripts.graph_timer``.
"""
from __future__ import annotations

import statistics

import torch

N_GRAPH = 20                   # calls a graph where one call is repeated


def graph_ms(calls, restore=None, reps=5):
    """Device ms per call: ``calls`` (each one launch or library call,
    already run once outside the graph) captured in one CUDA graph and
    replayed, the replay timed with CUDA events and divided by their number
    (``restore`` untimed before each replay); median of ``reps``.  No host
    launch work is inside."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    times = []
    for _ in range(reps):
        if restore is not None:
            restore()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / len(calls))
    return statistics.median(times)
