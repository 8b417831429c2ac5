"""Milliseconds of the frame's return to the host (``renderer.frame_return``:
``Renderer.image()`` once a ``render()`` call), a mean over its runs; None
without spans."""
from harness import spans


def read(ctx):
    snap = spans.snapshot()
    agg = (snap or {}).get("renderer.frame_return", {})
    if not agg.get("count"):
        return None
    return 1e3 * agg["total_s"] / agg["count"]
