"""The host's milliseconds a batch: the ``renderer.batch`` span less the
spans in which the host waits for the device (``renderer.wait``,
``wavefront.wait``), over every batch of the run; None without spans."""
from harness import spans


def read(ctx):
    return spans.ms_per_batch(
        "renderer.batch", plus=("renderer.batch",),
        minus=("renderer.wait", "wavefront.wait"))
