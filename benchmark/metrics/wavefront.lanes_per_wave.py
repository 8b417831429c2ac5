"""Live lanes a wave of the wavefront's device loop: occupied slots at each
wave's start, summed (``wavefront.live_lanes``), over the waves
(``wavefront.waves``); the port's counters (``utils/spans.py``
``counters()``) at the end of the run, over its warm-up, window and traced
slice.  None where the program has no counters (an older checkout) or ran
no wave (the megakernel)."""
import sys

from harness import spans


def read(ctx):
    counters = getattr(sys.modules.get(spans.MODULE), "counters", None)
    c = counters() if callable(counters) else {}
    if not c.get("wavefront.waves"):
        return None
    return c["wavefront.live_lanes"] / c["wavefront.waves"]
