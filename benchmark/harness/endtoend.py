"""End-to-end metrics, taken by the benchmark's own clock from a
:class:`.drivers.Record`: all the work and all the time of the window."""
from __future__ import annotations

from . import stats


def msamples_per_s(rec):
    """Pixel-samples completed in the window per second, in millions."""
    return stats.rate(rec.work, rec.window_s) / 1e6


def batch_ms_p95(rec):
    """95th percentile of the wall time of every batch in the window."""
    return 1e3 * stats.percentile(rec.unit_s, 95)


def setup_s(rec):
    """Process start to the first timed call."""
    return rec.setup_s


METRICS = {"msamples_per_s": msamples_per_s, "batch_ms_p95": batch_ms_p95,
           "setup_s": setup_s}
