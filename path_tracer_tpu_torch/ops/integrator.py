"""Path state shared by the engines (port of ``PathState``, ``ops/integrator.py``).

The per-pixel megakernel of the JAX package (``trace_ray``,
``render_sample``) is not ported yet; see ROADMAP.md queue A.9.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PathState(NamedTuple):
    origin: torch.Tensor       # (R, 3)
    direction: torch.Tensor    # (R, 3)
    time: torch.Tensor         # (R,)
    color: torch.Tensor        # (R, 3) accumulated radiance
    throughput: torch.Tensor   # (R, 3)
    depth: torch.Tensor        # (R,) int32 scatter bounces taken
    iters: torch.Tensor        # (R,) int32 loop trips (incl. passthrough)
    alive: torch.Tensor        # (R,) bool
