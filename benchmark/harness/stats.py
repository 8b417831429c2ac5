"""The arithmetic of the end-to-end metrics, over every batch or step of
the window."""
from __future__ import annotations

import math


def rate(units: float, seconds: float) -> float:
    """Units completed per second of the window (all work, all time)."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return units / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value, by linear interpolation
    between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

