"""Share of the wavefront's slot pool that is live at a wave's start:
100 x ``wavefront.live_lanes`` / ``wavefront.slot_waves`` (slots x waves),
in %; the port's counters (``utils/spans.py`` ``counters()``) at the end
of the run, over its warm-up, window and traced slice.  None where the
program has no counters (an older checkout) or ran no wave (the
megakernel)."""
import sys

from harness import spans


def read(ctx):
    counters = getattr(sys.modules.get(spans.MODULE), "counters", None)
    c = counters() if callable(counters) else {}
    if not c.get("wavefront.slot_waves"):
        return None
    return 100.0 * c["wavefront.live_lanes"] / c["wavefront.slot_waves"]
