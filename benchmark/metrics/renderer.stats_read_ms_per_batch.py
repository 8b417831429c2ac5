"""Milliseconds a batch of the Renderer's read-back of the counters and
the depth histogram (``renderer.stats_read``); None without spans."""
from harness import spans


def read(ctx):
    return spans.ms_per_batch("renderer.stats_read",
                              plus=("renderer.stats_read",))
